"""Learned-ego closed-loop evidence, on the port: tools/
ego_zoo_experiment.py with its arguments, defaults, stages and layout.

Reproduces the reference's learned-ego axes end to end on-device:

  stage 1  collect: PDM-Lite expert drives, states logged to HDF5
           (carla_runner.py:364 collect_data)
  stage 2  PlanT BC: train PlanT_medium on the collected boxes->tokens
           dataset (rift/ego/plant/lit_module.py training contract)
  stage 3  E2E BC: bootstrap vad / uniad / sparsedrive by cloning the
           expert closed-loop over the semantic camera bridge
           (run.py train_ego; the reference trains b2d stacks offline)
  stage 4  eval matrix: each learned ego (+ an UNTRAINED E2E baseline
           row) vs CBV methods x seeds (BASELINE.md Table 2 protocol:
           PlanT ego x {standard, pluto, rift}; e2e_agent.py:20-142)
  stage 5  merge seeds -> results/torch/ego_zoo/RESULTS.md

Resumable: existing artifacts are reused. Stages 1, 3 and 4 run
`python -m rift_tpu_torch.run`, stage 2 PlanT's fit
(rift_tpu_torch.models.plant.train), on CUDA (`--cpu`: `--device cpu`);
the runs and artifacts go under `log/torch/ego_zoo` (`--out`), the full
run's table under `results/torch/ego_zoo/` (`--results_dir`). Stages 1-2
write and read HDF5: without h5py, stage 1 raises ImportError before it
starts.

    python -m rift_tpu_torch.tools.ego_zoo_experiment            # full
    python -m rift_tpu_torch.tools.ego_zoo_experiment --smoke    # minutes-scale sanity
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time

from . import ROOT, merge_statistics

# the reference's Bench2Drive dev10 route file, in a `reference/` checkout of
# it inside this one (the repository ships no route file)
ROUTES_XML = os.path.join(
    ROOT, "reference", "rift", "scenario", "route",
    "drivetransformer_bench2drive_dev10.xml",
)
E2E_EGOS = ["vad", "uniad", "sparsedrive"]


def run_cli(argv: list[str], cpu: bool = False):
    """Fresh subprocess per rift_tpu_torch.run (see
    quality_experiment.run_cli: in-process chaining corrupted late eval
    rows in round 5). `cpu` runs it with `--device cpu`."""
    import subprocess

    argv = (["--device", "cpu"] if cpu else []) + list(argv)
    print(f"\n=== rift_tpu_torch.run {' '.join(argv)}", flush=True)
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "rift_tpu_torch.run", *argv], cwd=ROOT
    )
    if r.returncode != 0:
        raise RuntimeError(f"rift_tpu_torch.run failed rc={r.returncode}")
    print(f"=== done in {time.time() - t0:.0f}s", flush=True)


def plant_train(argv: list[str]):
    """PlanT's behaviour-cloning fit in this process
    (rift_tpu_torch.models.plant.train.main)."""
    from ..models.plant.train import main

    return main(argv)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(ROOT, "log", "torch", "ego_zoo"))
    p.add_argument("--routes", default=ROUTES_XML)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run every stage on the CPU (--device cpu)")
    p.add_argument("--num_scenario", type=int, default=5)
    p.add_argument("--num_agents", type=int, default=16)
    p.add_argument("--collect_episodes", type=int, default=6)
    p.add_argument("--bc_episodes", type=int, default=8)
    p.add_argument("--train_ticks", type=int, default=300)
    p.add_argument("--eval_ticks", type=int, default=600)
    p.add_argument("--eval_episodes", type=int, default=2)
    p.add_argument("--plant_epochs", type=int, default=20)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--plant_cbvs", default="standard,pluto,rift_pluto",
                   help="CBV methods for the PlanT Table-2 rows; pluto/"
                        "rift_pluto load npzs from --quality_artifacts")
    p.add_argument("--quality_artifacts",
                   default=os.path.join(ROOT, "log", "torch", "quality", "artifacts"))
    p.add_argument("--results_dir",
                   default=os.path.join(ROOT, "results", "torch", "ego_zoo"),
                   help="where the full run's RESULTS.md, merged table and runs go")
    args = p.parse_args(argv)
    # the stages' runs start in the checkout: paths given relative to the
    # caller's directory stay its own
    args.out, args.routes = os.path.abspath(args.out), os.path.abspath(args.routes)
    args.quality_artifacts = os.path.abspath(args.quality_artifacts)

    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    e2e_egos = list(E2E_EGOS)
    if args.smoke:
        args.num_scenario, args.num_agents = 2, 8
        args.collect_episodes = args.bc_episodes = 1
        args.train_ticks, args.eval_ticks, args.eval_episodes = 40, 40, 1
        args.plant_epochs = 1
        seeds, e2e_egos = [0], ["vad"]
        args.plant_cbvs = "standard"

    art = os.path.join(args.out, "artifacts")
    os.makedirs(art, exist_ok=True)
    common = [
        "--routes", args.routes,
        "--num_scenario", str(args.num_scenario),
        "--num_agents", str(args.num_agents),
    ]

    # ------------- stage 1: expert data collection -------------------------
    h5 = os.path.join(args.out, "collect", "collect_data",
                      "pdm_lite-standard-seed0", "pdm_lite_standard.hdf5")
    if not os.path.exists(h5):
        if importlib.util.find_spec("h5py") is None:
            raise ImportError(
                "h5py is not installed: stage 1 (--mode collect_data) writes "
                f"HDF5 and stage 2 reads it; install h5py, or put a collected "
                f"file at {h5}"
            )
        run_cli([
            "--mode", "collect_data", "--ego_cfg", "pdm_lite",
            "--cbv_cfg", "standard",
            "--num_episodes", str(args.collect_episodes),
            "--max_ticks", str(args.train_ticks),
            "--out_dir", os.path.join(args.out, "collect"),
            *common,
        ], cpu=args.cpu)
        assert os.path.exists(h5), f"collect did not produce {h5}"
    else:
        print(f"stage 1: reusing {h5}")

    # ------------- stage 2: PlanT BC ----------------------------------------
    plant_npz = os.path.join(art, "plant_medium.npz")
    if not os.path.exists(plant_npz):
        plant_train([
            str(h5), "--out", plant_npz,
            "--epochs", str(args.plant_epochs),
            *(["--device", "cpu"] if args.cpu else []),
        ])
    else:
        print(f"stage 2: reusing {plant_npz}")

    # ------------- stage 3: E2E BC bootstrap --------------------------------
    e2e_npz = {}
    for ego in e2e_egos:
        dst = os.path.join(art, f"{ego}_bc.npz")
        e2e_npz[ego] = dst
        if os.path.exists(dst):
            print(f"stage 3: reusing {dst}")
            continue
        run_cli([
            "--mode", "train_ego", "--ego_cfg", ego, "--cbv_cfg", "standard",
            "--num_episodes", str(args.bc_episodes),
            "--max_ticks", str(args.train_ticks),
            "--out_dir", os.path.join(args.out, "bc"),
            *common,
        ], cpu=args.cpu)
        src = os.path.join(args.out, "bc", "train_ego",
                           f"{ego}-standard-seed0", "model_ckpt",
                           f"{ego}_bc.npz")
        shutil.copy(src, dst)

    # ------------- stage 4: eval matrix --------------------------------------
    eval_dir = os.path.join(args.out, "eval")
    quality = args.quality_artifacts
    plant_rows = []
    for cbv in [c for c in args.plant_cbvs.split(",") if c]:
        npz = None
        if cbv != "standard":
            cand = os.path.join(
                quality,
                "pluto_pretrain.npz" if cbv == "pluto" else f"{cbv}.npz",
            )
            if not os.path.exists(cand):
                print(f"stage 4: skipping plant x {cbv} (no {cand})")
                continue
            npz = cand
        plant_rows.append(("plant", plant_npz, cbv, npz))
    matrix = plant_rows + [
        (ego, e2e_npz[ego], "standard", None) for ego in e2e_egos
    ] + [
        # untrained baseline: is BC actually doing something?
        (ego, None, "standard", None) for ego in e2e_egos[:1]
    ]
    for ego, weights, cbv, cbv_npz in matrix:
        for seed in seeds:
            tag = f"{ego}-{cbv}-seed{seed}"
            out_base = (
                eval_dir if weights else os.path.join(args.out, "eval_rand")
            )
            res = os.path.join(out_base, "eval", tag,
                               "simulation_results.json")
            if os.path.exists(res):
                with open(res) as f:
                    if json.load(f).get("records"):
                        print(f"stage 4: reusing {res}")
                        continue
            argv = [
                "--mode", "eval", "--ego_cfg", ego, "--cbv_cfg", cbv,
                "--num_episodes", str(args.eval_episodes),
                "--max_ticks", str(args.eval_ticks),
                "--seed", str(seed),
                "--out_dir", out_base,
                *common,
            ]
            if weights:
                argv += ["--ego_weights", weights]
            if cbv_npz:
                argv += ["--pretrain", cbv_npz]
            run_cli(argv, cpu=args.cpu)

    # ------------- stage 5: merge + RESULTS.md -------------------------------
    merged = merge_statistics.main(["--base_dir", os.path.join(eval_dir, "eval")])
    rand_dir = os.path.join(args.out, "eval_rand", "eval")
    merged_rand = (
        merge_statistics.main(["--base_dir", rand_dir])
        if os.path.isdir(rand_dir)
        else {}
    )
    if not args.smoke:
        write_results_md(args, merged, merged_rand, eval_dir)
    return merged


COLUMNS = [
    ("Driving Score", "DS ↑"), ("Route Completion", "RC ↑"),
    ("Infraction Penalty", "IP ↑"), ("Ego Blocked Ratio", "EBR ↓"),
    ("CPK", "CPK ↓"), ("RP", "RP ↑"), ("RTTC", "RTTC ↑"), ("ACT", "ACT ↑"),
]


def write_results_md(args, merged, merged_rand, eval_dir):
    res_dir = args.results_dir
    os.makedirs(res_dir, exist_ok=True)
    rows = []
    for key in sorted(merged):
        cells = [merged[key].get(c, "n/a") for c, _ in COLUMNS]
        rows.append("| " + " | ".join([key] + cells) + " |")
    for key in sorted(merged_rand):
        cells = [merged_rand[key].get(c, "n/a") for c, _ in COLUMNS]
        rows.append("| " + " | ".join([f"{key} (RANDOM-INIT)"] + cells) + " |")
    header = "| ego-cbv | " + " | ".join(h for _, h in COLUMNS) + " |"
    sep = "|" + "---|" * (len(COLUMNS) + 1)
    md = [
        "# Learned-ego closed loop — PlanT + E2E camera stacks",
        "",
        "Produced end-to-end by `python -m rift_tpu_torch.tools.ego_zoo_experiment` "
        f"on one device (`{'cpu' if args.cpu else 'cuda'}`): PDM-Lite expert "
        "collect -> PlanT_medium BC (models/plant/train.py) + E2E BC "
        "bootstrap (vad/uniad/sparsedrive over the semantic camera bridge, "
        "models/e2e/train.py) -> eval matrix over the dev10-derived routes "
        f"x seeds {args.seeds}.",
        "",
        "The PlanT rows re-measure BASELINE.md Table 2 post the "
        "densify_local_waypoints fix (the r1 PlanT numbers were invalidated "
        "by it, docs/HANDOFF.md); E2E rows match the reference's config[4] "
        "axis (rift/ego/b2d/e2e_agent.py:20-142). RANDOM-INIT rows are the "
        "untrained-baseline control for the BC'd E2E stacks.",
        "",
        header, sep, *rows, "",
    ]
    with open(os.path.join(res_dir, "RESULTS.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    raw_dir = os.path.join(res_dir, "runs")
    os.makedirs(raw_dir, exist_ok=True)
    for base in (os.path.join(eval_dir, "eval"),
                 os.path.join(args.out, "eval_rand", "eval")):
        if not os.path.isdir(base):
            continue
        for tag in sorted(os.listdir(base)):
            src = os.path.join(base, tag, "simulation_results.json")
            if os.path.exists(src):
                shutil.copy(src, os.path.join(raw_dir, f"{tag}.json"))
    print(f"wrote {res_dir}/RESULTS.md (+ runs/)")


if __name__ == "__main__":
    main()
