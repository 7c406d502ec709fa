"""Experiment tracking in plain files (port of rift_tpu/utils/tracking.py):
one directory per run with its config, an append-only metric stream and a
summary, in the JAX package's layout, so that its readers (`list_runs`,
`read_metrics`, tools/runs.py) read the port's runs too.

    run = init_run("train_cbv", name="rift_pluto-seed0", config=vars(args))
    run.log({"loss": 0.2, "episode": 3})
    run.summary["driving_score"] = 94.7
    run.finish()

Layout: <base>/<project>/<YYYYmmdd-HHMMSS>-<name>/
    config.json    the run's config
    meta.json      start and end time, git commit, argv, status
    metrics.jsonl  one JSON object per log() call (with _step, _wall)
    summary.json   the last value of each scalar, and explicit summary writes
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _git_commit() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ).stdout.strip() or None
    except Exception:
        return None


class Run:
    def __init__(self, run_dir: str, config: dict | None = None):
        self.dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.summary: dict = {}
        self._step = 0
        self._t0 = time.time()
        self._finished = False
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(_jsonable(config or {}), f, indent=2)
        with open(os.path.join(run_dir, "meta.json"), "w") as f:
            json.dump({"started": time.strftime("%Y-%m-%d %H:%M:%S"), "git": _git_commit(),
                       "argv": sys.argv, "status": "running"}, f, indent=2)
        self._mf = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def log(self, metrics: dict, step: int | None = None):
        """Append one metric row; its scalars roll into the summary."""
        if step is not None:
            self._step = step
        row = {"_step": self._step, "_wall": round(time.time() - self._t0, 3)}
        row.update(_jsonable(metrics))
        self._mf.write(json.dumps(row) + "\n")
        self._mf.flush()
        for k, v in row.items():
            if not k.startswith("_") and isinstance(v, (int, float)):
                self.summary[k] = v
        self._step += 1

    def finish(self, status: str = "finished"):
        if self._finished:
            return
        self._finished = True
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(_jsonable(self.summary), f, indent=2)
        meta_path = os.path.join(self.dir, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta.update(status=status, ended=time.strftime("%Y-%m-%d %H:%M:%S"),
                    runtime_s=round(time.time() - self._t0, 1))
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=2)
        self._mf.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        self.finish("failed" if exc_type else "finished")


def init_run(project: str, name: str = "run", config: dict | None = None,
             base_dir: str | None = None) -> Run:
    """A new run directory under `base_dir` (default $RIFT_TPU_RUNS or
    log/runs), unique even for runs started in the same second."""
    base = base_dir or os.environ.get("RIFT_TPU_RUNS", "log/runs")
    stamp = time.strftime("%Y%m%d-%H%M%S")
    run_dir = os.path.join(base, project, f"{stamp}-{name}")
    i = 1
    while os.path.exists(run_dir):
        run_dir = os.path.join(base, project, f"{stamp}-{name}-{i}")
        i += 1
    return Run(run_dir, config)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def list_runs(base_dir: str = "log/runs", project: str | None = None):
    """[(project, run_dir, meta, summary)], newest first."""
    out = []
    if not os.path.isdir(base_dir):
        return out
    for proj in [project] if project else sorted(os.listdir(base_dir)):
        pdir = os.path.join(base_dir, proj)
        if not os.path.isdir(pdir):
            continue
        for name in sorted(os.listdir(pdir), reverse=True):
            rdir = os.path.join(pdir, name)
            try:
                with open(os.path.join(rdir, "meta.json")) as f:
                    meta = json.load(f)
            except OSError:
                continue
            summary = {}
            try:
                with open(os.path.join(rdir, "summary.json")) as f:
                    summary = json.load(f)
            except OSError:
                pass
            out.append((proj, rdir, meta, summary))
    return out


def read_metrics(run_dir: str) -> list[dict]:
    path = os.path.join(run_dir, "metrics.jsonl")
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    return rows
