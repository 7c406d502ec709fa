"""Validate eval result files for completeness and consistency.

Port of tools/check_eval.py, the counterpart of the reference's
scripts/check_eval.py + the validation half of
statistics_manager.validate_and_write_statistics (:790-838): every
`simulation_results.json` under the base dir must (a) parse, (b) have
progress == number of records, (c) match the expected route count when
given, (d) contain only finite scores within range, (e) carry the behavior
distributions. Exits non-zero on the first inconsistency (CI-friendly).

    python -m rift_tpu_torch.tools.check_eval --base_dir log/eval --expected_routes 10
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

VALID_STATUS = {"Completed", "Blocked", "Deviated", "Timeout", "Incomplete"}


def check_file(path: str, expected_routes: int | None = None) -> list[str]:
    errors = []
    try:
        with open(path) as f:
            data = json.load(f)
    except Exception as e:  # noqa: BLE001
        return [f"{path}: unparseable ({e})"]
    records = data.get("records", [])
    progress = data.get("progress", [0, 0])
    if progress[0] != len(records):
        errors.append(
            f"{path}: progress {progress[0]} != {len(records)} records"
        )
    if expected_routes is not None and len(records) != expected_routes:
        errors.append(
            f"{path}: {len(records)} routes, expected {expected_routes}"
        )
    for r in records:
        rid = r.get("route_id", "?")
        ds = r.get("driving_score", -1)
        rc = r.get("route_completion", -1)
        ip = r.get("infraction_penalty", -1)
        if not (0.0 <= ds <= 100.0) or math.isnan(ds):
            errors.append(f"{path}:{rid}: driving_score {ds} out of range")
        if not (0.0 <= rc <= 100.0):
            errors.append(f"{path}:{rid}: route_completion {rc} out of range")
        if not (0.0 <= ip <= 1.0):
            errors.append(f"{path}:{rid}: infraction_penalty {ip} out of range")
        if r.get("status") not in VALID_STATUS:
            errors.append(f"{path}:{rid}: bad status {r.get('status')!r}")
        if not r.get("cbv_distributions"):
            errors.append(f"{path}:{rid}: missing cbv_distributions")
    return errors


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", default="log/eval")
    p.add_argument("--expected_routes", type=int, default=None)
    args = p.parse_args(argv)

    n_files = 0
    all_errors = []
    for root, _, files in os.walk(args.base_dir):
        if "simulation_results.json" in files:
            n_files += 1
            all_errors += check_file(
                os.path.join(root, "simulation_results.json"),
                args.expected_routes,
            )
    for e in all_errors:
        print(f"ERROR: {e}")
    print(f"checked {n_files} result files, {len(all_errors)} errors")
    if all_errors:
        sys.exit(1)
    return n_files


if __name__ == "__main__":
    main()
