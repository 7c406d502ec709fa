"""The committed quality-parity experiment, on the port: tools/
quality_experiment.py with its arguments, defaults, stages and layout.

Reproduces the reference's Table-1 protocol (eval.ipynb cell 1;
BASELINE.md) end to end on-device, without the unavailable
`pluto_1M_aux_cil.ckpt`:

  stage 1  bootstrap-pretrain: behavior-clone the full Pluto against the
           privileged lane-follow teacher (policies.BCPlutoPolicy — the
           stand-in for the nuPlan-1M IL pretrain,
           rift/cbv/planning/pluto/pluto.py:130-137) -> pluto_pretrain.npz
  stage 2  closed-loop fine-tune every RLFT/SFT variant from that pretrain
           (train_cbv; rlft_pluto.py:206-247 alternating loop)
  stage 3  eval matrix: {standard, frozen pluto, fine-tuned variants}
           x 3 seeds over the dev10-derived routes, walkers+statics on
           (carla_runner.py:311-362)
  stage 4  merge seeds (merge_statistics = reference
           scripts/merge_statistics.py) -> RESULTS.md

Every stage is resumable: existing artifacts are reused, so a crashed run
continues where it stopped. Each stage runs `python -m rift_tpu_torch.run`
on CUDA (`--cpu`: `--device cpu`); the runs and artifacts go under
`log/torch/quality` (`--out`), the full run's table under
`results/torch/quality/` (`--results_dir`). At `--smoke`'s 8 agents rule
recognition finds no CBV by tick 40 and the 4096-sample buffers never fill,
so nothing fits, as in the JAX tool.

    python -m rift_tpu_torch.tools.quality_experiment            # full experiment
    python -m rift_tpu_torch.tools.quality_experiment --smoke    # minutes-scale sanity run
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import ROOT, merge_statistics

# the reference's Bench2Drive dev10 route file, in a `reference/` checkout of
# it inside this one (the repository ships no route file)
ROUTES_XML = os.path.join(
    ROOT, "reference", "rift", "scenario", "route",
    "drivetransformer_bench2drive_dev10.xml",
)

# fine-tuned variants in the eval matrix (>=6 CBV methods incl. the two
# frozen rows, VERDICT item 1 protocol)
METHODS = [
    "sft_pluto",
    "rtr_pluto",
    "reinforce_pluto",
    "rs_pluto",
    "ppo_pluto",
    "grpo_pluto",
    "rift_pluto",
]
SEEDS = [0, 1, 2]


def run_cli(argv: list[str], cpu: bool = False):
    """Each rift_tpu_torch.run invocation runs in a FRESH subprocess.

    Round-5 finding: chaining main() calls in one process produced
    corrupted eval rows late in the chain (driving scores collapsing to
    ~0 via outside-lane accounting on runs that are clean when executed
    in a fresh process) — cross-run in-process state is not trustworthy
    over a 40-run campaign. A subprocess per run also mirrors the
    reference's one-process-per-run.py execution model. `cpu` runs it with
    `--device cpu`."""
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


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(ROOT, "log", "torch", "quality"))
    p.add_argument("--routes", default=ROUTES_XML)
    p.add_argument("--cpu", action="store_true",
                   help="run every stage on the CPU (--device cpu)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes / 1 seed / 2 methods — CI sanity")
    p.add_argument("--num_scenario", type=int, default=5)
    p.add_argument("--num_agents", type=int, default=16)
    p.add_argument("--train_scenarios", type=int, default=24,
                   help="scenario count for the fine-tune stage only: more "
                        "parallel scenarios -> more buffer-fill fit rounds "
                        "per episode (the compounding the reference gets "
                        "from its 220-route training set)")
    p.add_argument("--cl_lr_decay", type=float, default=0.98,
                   help="per-fit-round closed-loop lr decay for stage 2. "
                        "The reference's 0.9 assumes ~1 fit/episode; at "
                        "train_scenarios=24 an episode fits ~6x more often, "
                        "so the decay is softened to keep the same decay "
                        "per collected experience")
    p.add_argument("--pretrain_episodes", type=int, default=16)
    p.add_argument("--finetune_episodes", type=int, default=16)
    p.add_argument("--train_ticks", type=int, default=300)
    # 1200 covers the loader's long episode-3/4 chained routes (up to
    # ~570 m); the fused runner exits early when every scenario is done,
    # so short routes pay nothing (run.py:150)
    p.add_argument("--eval_ticks", type=int, default=1200)
    p.add_argument("--eval_episodes", type=int, default=4)
    p.add_argument("--methods", default=",".join(METHODS))
    p.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    p.add_argument("--results_dir",
                   default=os.path.join(ROOT, "results", "torch", "quality"),
                   help="where the full run's RESULTS.md, merged table and runs go")
    args = p.parse_args(argv)
    # the stages' runs start in the checkout: paths given relative to the
    # caller's directory stay its own
    args.out, args.routes = os.path.abspath(args.out), os.path.abspath(args.routes)

    methods = [m for m in args.methods.split(",") if m]
    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    if args.smoke:
        args.num_scenario, args.num_agents = 2, 8
        args.train_scenarios = 2
        args.pretrain_episodes = args.finetune_episodes = 1
        args.train_ticks, args.eval_ticks, args.eval_episodes = 40, 40, 1
        methods, seeds = ["rift_pluto"], [0]

    art = os.path.join(args.out, "artifacts")
    os.makedirs(art, exist_ok=True)
    common = [
        "--routes", args.routes,
        "--num_scenario", str(args.num_scenario),
        "--num_agents", str(args.num_agents),
    ]

    # ---------------- stage 1: bootstrap pretrain --------------------------
    pretrain = os.path.join(art, "pluto_pretrain.npz")
    if not os.path.exists(pretrain):
        run_cli([
            "--mode", "train_cbv", "--ego_cfg", "pdm_lite",
            "--cbv_cfg", "bc_pluto",
            "--num_episodes", str(args.pretrain_episodes),
            "--max_ticks", str(args.train_ticks),
            "--out_dir", os.path.join(args.out, "pretrain"),
            "--save_pretrain", pretrain,
            *common,
        ], cpu=args.cpu)
    else:
        print(f"stage 1: reusing {pretrain}")

    # ---------------- stage 2: closed-loop fine-tunes ----------------------
    tuned = {}
    for m in methods:
        out_npz = os.path.join(art, f"{m}.npz")
        tuned[m] = out_npz
        if os.path.exists(out_npz):
            print(f"stage 2: reusing {out_npz}")
            continue
        ft_common = [
            "--routes", args.routes,
            "--num_scenario", str(max(args.train_scenarios, args.num_scenario)),
            "--num_agents", str(args.num_agents),
            # one persistent town for the whole fine-tune: kills the
            # ~2-min-per-episode batch-map rebuild (the reference likewise
            # keeps one CARLA town loaded across episodes)
            "--shared_town",
        ]
        run_cli([
            "--mode", "train_cbv", "--ego_cfg", "pdm_lite", "--cbv_cfg", m,
            "--num_episodes", str(args.finetune_episodes),
            "--max_ticks", str(args.train_ticks),
            "--out_dir", os.path.join(args.out, "train"),
            "--pretrain", pretrain,
            "--save_pretrain", out_npz,
            *ft_common,
            f"train.cl_lr_decay={args.cl_lr_decay}",
        ], cpu=args.cpu)

    # ---------------- stage 3: eval matrix ---------------------------------
    eval_dir = os.path.join(args.out, "eval")
    matrix = [("standard", None), ("pluto", pretrain)] + [
        (m, tuned[m]) for m in methods
    ]
    for cbv, npz in matrix:
        for seed in seeds:
            tag = f"pdm_lite-{cbv}-seed{seed}"
            res = os.path.join(
                eval_dir, "eval", tag, "simulation_results.json"
            )
            if os.path.exists(res):
                with open(res) as f:
                    if json.load(f).get("records"):
                        print(f"stage 3: reusing {res}")
                        continue
            argv = [
                "--mode", "eval", "--ego_cfg", "pdm_lite", "--cbv_cfg", cbv,
                "--num_episodes", str(args.eval_episodes),
                "--max_ticks", str(args.eval_ticks),
                "--seed", str(seed),
                "--out_dir", eval_dir,
                *common,
            ]
            if npz:
                argv += ["--pretrain", npz]
            run_cli(argv, cpu=args.cpu)

    # ---------------- stage 4: merge + RESULTS.md --------------------------
    merged = merge_statistics.main([
        "--base_dir", os.path.join(eval_dir, "eval"),
        "--out", os.path.join(args.out, "merged.json"),
    ])
    print(json.dumps({k: v for k, v in merged.items()}, indent=2)[:2000])
    if not args.smoke:
        write_results_md(args, merged, eval_dir)
    return merged


# columns in BASELINE.md Table-1 order; arrows mark the better direction
COLUMNS = [
    ("Driving Score", "DS ↑"), ("Route Completion", "RC ↑"),
    ("Infraction Penalty", "IP ↑"), ("Ego Blocked Ratio", "EBR ↓"),
    ("ORR", "ORR ↓"), ("UC (%)", "UC (%)"), ("CPK", "CPK ↓"),
    ("RP", "RP ↑"), ("SW speed", "SW speed ↑"), ("WD speed", "WD speed ↓"),
    ("SW acc", "SW acc ↑"), ("RTTC", "RTTC ↑"), ("ACT", "ACT ↑"),
]


def write_results_md(args, merged, eval_dir):
    """Committable RESULTS.md + raw simulation_results.json set under
    `--results_dir` (VERDICT r1 item 1 deliverable). The table mirrors BASELINE.md
    Table 1 (eval.ipynb cell 1) with our bootstrap-pretrained Pluto in
    place of the unshipped pluto_1M_aux_cil.ckpt."""
    import shutil

    res_dir = args.results_dir
    os.makedirs(res_dir, exist_ok=True)
    order = ["standard", "pluto"] + [m for m in METHODS if m != "rift_pluto"]
    order.append("rift_pluto")
    base = os.path.join(eval_dir, "eval")
    rows = []
    for cbv in order:
        key = f"pdm_lite-{cbv}"
        if key not in merged:
            continue
        # honest per-row seed count from the run files actually merged
        n_seeds = len([
            t for t in os.listdir(base)
            if t.startswith(f"pdm_lite-{cbv}-seed")
            and os.path.exists(
                os.path.join(base, t, "simulation_results.json")
            )
        ]) if os.path.isdir(base) else 0
        cells = [merged[key].get(c, "n/a") for c, _ in COLUMNS]
        name = "**RIFT (ours)**" if cbv == "rift_pluto" else cbv
        rows.append(
            "| " + " | ".join([name, str(n_seeds)] + cells) + " |"
        )
    header = (
        "| CBV method | seeds | "
        + " | ".join(h for _, h in COLUMNS) + " |"
    )
    sep = "|" + "---|" * (len(COLUMNS) + 2)
    md = [
        "# Quality-parity experiment — PDM-Lite ego (BASELINE.md Table 1 protocol)",
        "",
        "Produced end-to-end on one device "
        f"(`{'cpu' if args.cpu else 'cuda'}` device) by "
        "`python -m rift_tpu_torch.tools.quality_experiment`:",
        "bootstrap BC-pretrain Pluto on EXPERT rollouts (CBVs execute the",
        "privileged accelerate-to-target teacher; stand-in for the unshipped",
        "nuPlan `pluto_1M_aux_cil.ckpt`, rift/cbv/planning/pluto/pluto.py:130-137),",
        "closed-loop fine-tune every RLFT/SFT variant from that pretrain",
        "(rlft_pluto.py:206-247), then the eval matrix over the dev10-derived",
        "routes (per-row seed counts in the `seeds` column; the flagship",
        "standard/pluto/grpo/rift rows carry extra seeds for statistical",
        "power, VERDICT r4 item 3) (walkers+statics on, stop junctions at",
        f"ratio {getattr(args, 'stop_ratio', 0.25)}, traffic lights frozen",
        "green as in the reference protocol, env_wrapper.py:91).",
        "",
        "Fine-tune regime: fit on EVERY buffer-full event, mid-episode,",
        f"with updated params rolling out the rest of the episode",
        f"(rlft_pluto.py:206-247); closed-loop lr decay {args.cl_lr_decay}",
        f"per fit round (reference 0.9/episode at ~1 fit/episode,",
        f"rift_training.yaml cl_lr_decay), {args.finetune_episodes} episodes",
        f"x {args.train_scenarios} scenarios per method. Eval: max_cbvs 2,",
        "train: 3 (recognition-level, rule.yaml:28).",
        "Raw per-run `simulation_results.json` files accompany this table.",
        "",
        header, sep, *rows, "",
        "Direction to match BASELINE.md Table 1: the RIFT row should dominate",
        "the frozen-pluto row on DS / EBR / RP (94.78 vs 77.84 DS there).",
        "Absolute values are not comparable 1:1 — the reference evaluates",
        "pretrained-on-1M-nuPlan planners inside CARLA towns; this table is",
        "bootstrap-pretrained inside the port's world model (rift_tpu_torch).",
    ]
    md += subset_section(os.path.join(eval_dir, "eval"), order)
    md += paired_delta_section(os.path.join(eval_dir, "eval"))
    with open(os.path.join(res_dir, "RESULTS.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    shutil.copy(
        os.path.join(args.out, "merged.json"),
        os.path.join(res_dir, "merged.json"),
    )
    raw_dir = os.path.join(res_dir, "runs")
    os.makedirs(raw_dir, exist_ok=True)
    base = os.path.join(eval_dir, "eval")
    for tag in sorted(os.listdir(base)):
        src = os.path.join(base, tag, "simulation_results.json")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(raw_dir, f"{tag}.json"))
    print(f"wrote {res_dir}/RESULTS.md (+ merged.json, runs/)")


def subset_section(base: str, order: list[str]) -> list[str]:
    """Secondary table over the SHORT-ROUTE subset (record indices 0-9 =
    the two dev10-length episodes, the r4-comparable protocol). The full
    table's episodes 3-4 chain routes through multiple junctions where
    background-traffic queues block the ego regardless of CBV method —
    that headroom is a sim-realism gap (VERDICT r4 weak #8), not a CBV
    effect, so the subset shows method quality without it."""
    import math

    out = ["", "## Short-route subset (record indices 0-9; r4-comparable)",
           "",
           "| CBV method | DS ↑ | RC ↑ | EBR ↓ | RP ↑ |",
           "|---|---|---|---|---|"]
    for cbv in order:
        per_seed = {"ds": [], "rc": [], "ebr": [], "rp": []}
        for seed in range(8):
            p = os.path.join(
                base, f"pdm_lite-{cbv}-seed{seed}",
                "simulation_results.json",
            )
            if not os.path.exists(p):
                continue
            with open(p) as f:
                recs = [
                    r for r in json.load(f).get("records", [])
                    if r["index"] < 10
                ]
            if not recs:
                continue
            n = len(recs)
            per_seed["ds"].append(sum(r["driving_score"] for r in recs) / n)
            per_seed["rc"].append(
                sum(r["route_completion"] for r in recs) / n
            )
            per_seed["ebr"].append(
                100.0 * sum(bool(r["blocked"]) for r in recs) / n
            )
            per_seed["rp"].append(
                sum(r.get("cbv_progress", 0.0) for r in recs) / n
            )
        if not per_seed["ds"]:
            continue
        def ms(v):
            m = sum(v) / len(v)
            s = (
                math.sqrt(sum((x - m) ** 2 for x in v) / (len(v) - 1))
                if len(v) > 1 else 0.0
            )
            return f"{m:.2f} ± {s:.2f}"
        name = "**RIFT (ours)**" if cbv == "rift_pluto" else cbv
        out.append(
            f"| {name} | {ms(per_seed['ds'])} | {ms(per_seed['rc'])} "
            f"| {ms(per_seed['ebr'])} | {ms(per_seed['rp'])} |"
        )
    return out


def paired_delta_section(base: str) -> list[str]:
    """Per-route PAIRED driving-score deltas between key method pairs
    (VERDICT r4 item 3): two methods' eval runs at the same seed sample
    the same routes, so differencing per (seed, route_id, index) removes
    the large between-route variance that swamps the 3-seed mean+-std."""
    import math

    def load(cbv, seed):
        p = os.path.join(
            base, f"pdm_lite-{cbv}-seed{seed}", "simulation_results.json"
        )
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return {
                (r["route_id"], r["index"]): r["driving_score"]
                for r in json.load(f).get("records", [])
            }

    out = ["", "## Paired per-route driving-score deltas", "",
           "| pair | n routes | mean Δ DS | std Δ | sem | mean/sem |",
           "|---|---|---|---|---|---|"]
    pairs = [
        ("rift_pluto", "pluto"), ("rift_pluto", "grpo_pluto"),
        ("grpo_pluto", "pluto"),
    ]
    for a, b in pairs:
        deltas = []
        for seed in range(8):
            ra, rb = load(a, seed), load(b, seed)
            if not ra or not rb:
                continue
            for key in ra.keys() & rb.keys():
                deltas.append(ra[key] - rb[key])
        if len(deltas) < 2:
            out.append(f"| {a} − {b} | <2 | n/a | n/a | n/a | n/a |")
            continue
        n = len(deltas)
        mean = sum(deltas) / n
        var = sum((d - mean) ** 2 for d in deltas) / (n - 1)
        std = math.sqrt(var)
        sem = std / math.sqrt(n)
        ratio = mean / sem if sem > 0 else float("inf")
        out.append(
            f"| {a} − {b} | {n} | {mean:+.2f} | {std:.2f} | {sem:.2f} "
            f"| {ratio:+.1f} |"
        )
    out += ["",
            "mean/sem >= ~2 reads as a separable gap at this sample size; "
            "below that the ordering is directional only."]
    return out


if __name__ == "__main__":
    main()
