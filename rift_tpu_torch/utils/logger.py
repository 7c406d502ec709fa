"""Run logging (port of rift_tpu/utils/logger.py's `Logger`): the live
results text of a run directory. The metric stream is the run's tracking
directory (utils/tracking.py).
"""

from __future__ import annotations

import os


class Logger:
    def __init__(self, out_dir: str | None = None):
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def write_live_results(self, text: str):
        if self.out_dir:
            with open(os.path.join(self.out_dir, "live_results.txt"), "w") as f:
                f.write(text)
