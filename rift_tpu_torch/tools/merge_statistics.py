"""Merge multi-seed eval statistics into the paper's metric table.

Port of tools/merge_statistics.py on the port's StatisticsManager; the
counterpart of the reference's scripts/merge_statistics.py +
tools/plot/plot_eval_result.py:60-120: find `*seed<k>` run dirs under a base
directory, load each `simulation_results.json`, compute the per-seed metric
table, and aggregate mean ± std across seeds (single-value metrics: sample
std of per-seed values; mean±std metrics: pooled variance + variance of
means, plot_eval_result.py:100-121).

    python -m rift_tpu_torch.tools.merge_statistics --base_dir log/eval
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
from collections import defaultdict

from ..scenario.statistics import StatisticsManager


def find_seed_runs(base_dir: str) -> dict[str, dict[int, str]]:
    """{group_tag: {seed: results.json path}} for dirs `<ego>-<cbv>-seed<k>`."""
    runs: dict[str, dict[int, str]] = defaultdict(dict)
    for root, _, files in os.walk(base_dir):
        if "simulation_results.json" not in files:
            continue
        tag = os.path.basename(root)
        if "seed" not in tag:
            continue
        group, _, seed_s = tag.rpartition("seed")
        try:
            seed = int(seed_s)
        except ValueError:
            continue
        runs[group.rstrip("-_")][seed] = os.path.join(
            root, "simulation_results.json"
        )
    return dict(runs)


def seed_table(path: str) -> dict:
    sm = StatisticsManager(path, resume=True)
    return sm.compute_metric_table()


def aggregate(tables: list[dict]) -> dict[str, str]:
    """mean ± std across seeds; (mean, std) tuples pool variances."""
    out = {}
    keys = tables[0].keys()
    for k in keys:
        vals = [t[k] for t in tables]
        if isinstance(vals[0], (tuple, list)):
            means = [v[0] for v in vals]
            stds = [v[1] for v in vals]
            if any(isinstance(m, float) and math.isnan(m) for m in means):
                out[k] = "n/a"
                continue
            m = statistics.mean(means)
            var = statistics.mean([s**2 for s in stds]) + (
                statistics.variance(means) if len(means) > 1 else 0.0
            )
            out[k] = f"{m:.2f} ± {math.sqrt(var):.2f}"
        else:
            if any(isinstance(v, float) and math.isnan(v) for v in vals):
                out[k] = "n/a"
                continue
            m = statistics.mean(vals)
            s = statistics.stdev(vals) if len(vals) > 1 else 0.0
            out[k] = f"{m:.2f} ± {s:.2f}"
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", default="log/eval")
    p.add_argument("--out", default="", help="optional merged-JSON output path")
    args = p.parse_args(argv)

    runs = find_seed_runs(args.base_dir)
    if not runs:
        print(f"no seed runs found under {args.base_dir}")
        return {}
    results = {}
    for group, seeds in sorted(runs.items()):
        tables = [seed_table(p) for _, p in sorted(seeds.items())]
        results[group] = aggregate(tables)
        print(f"\n== {group} ({len(seeds)} seeds: {sorted(seeds)}) ==")
        for k, v in results[group].items():
            print(f"  {k:>22}: {v}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"\nwrote {args.out}")
    return results


if __name__ == "__main__":
    main()
