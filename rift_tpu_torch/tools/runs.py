"""Run browser/compare CLI for the offline tracking dirs (port of
tools/runs.py on the port's utils/tracking.py; the sync + notebook half of
the reference's wandb flow: scripts/sync_all_wandb.sh + eval.ipynb
cross-run tables).

    python -m rift_tpu_torch.tools.runs list [--project train_cbv]
    python -m rift_tpu_torch.tools.runs show <run_dir>
    python -m rift_tpu_torch.tools.runs compare --project train_cbv --keys loss,driving_score
"""

from __future__ import annotations

import argparse
import os

from ..utils.tracking import list_runs, read_metrics


def cmd_list(args):
    rows = list_runs(args.base_dir, args.project)
    if not rows:
        print("no runs found")
        return
    for proj, rdir, meta, summary in rows:
        keys = ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in list(summary.items())[:4]
        )
        print(
            f"{proj:<14} {os.path.basename(rdir):<40} "
            f"{meta.get('status', '?'):<9} {keys}"
        )


def cmd_show(args):
    rows = read_metrics(args.run_dir)
    for r in rows[-args.tail:]:
        print(r)


def cmd_compare(args):
    keys = args.keys.split(",")
    rows = list_runs(args.base_dir, args.project)
    header = ["run", "status"] + keys
    widths = [40, 9] + [12] * len(keys)
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)))
    for proj, rdir, meta, summary in rows:
        cells = [os.path.basename(rdir), meta.get("status", "?")]
        for k in keys:
            v = summary.get(k, "-")
            cells.append(f"{v:.4g}" if isinstance(v, float) else str(v))
        print(" | ".join(c.ljust(w) for c, w in zip(cells, widths)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", default="log/runs")
    sub = p.add_subparsers(dest="cmd", required=True)
    pl = sub.add_parser("list")
    pl.add_argument("--project", default=None)
    pl.set_defaults(fn=cmd_list)
    ps = sub.add_parser("show")
    ps.add_argument("run_dir")
    ps.add_argument("--tail", type=int, default=20)
    ps.set_defaults(fn=cmd_show)
    pc = sub.add_parser("compare")
    pc.add_argument("--project", default=None)
    pc.add_argument("--keys", default="loss")
    pc.set_defaults(fn=cmd_compare)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
