"""Run logging (port of rift_tpu/utils/logger.py's `Logger`): a JSONL
metric stream and the live results text of a run directory.
"""

from __future__ import annotations

import json
import os
import time


class Logger:
    def __init__(self, out_dir: str | None = None):
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def log_metrics(self, step: int, **metrics):
        """Append one {"step", "time", **metrics} line to metrics.jsonl."""
        if self.out_dir:
            with open(os.path.join(self.out_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")

    def write_live_results(self, text: str):
        if self.out_dir:
            with open(os.path.join(self.out_dir, "live_results.txt"), "w") as f:
                f.write(text)
