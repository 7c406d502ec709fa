"""CLI entry: mode dispatch over the policy zoos (port of rift_tpu/run.py,
the modes `eval` and `train_cbv` on the synthetic towns).

  eval       closed-loop benchmark and leaderboard statistics
  train_cbv  fine-tune the CBV policy: buffer full -> fit -> the updated
             weights drive the next ticks

    python -m rift_tpu_torch.run --mode eval --ego_cfg pdm_lite \\
        --cbv_cfg rift_pluto --num_scenario 4 --num_episodes 3 --town grid

The defaults are the JAX package's: the `pdm_lite` ego, Pluto on legacy
per-CBV tokens (the override `canonical_tokens=true` picks the
frame-invariant ones), and in eval 2 walkers and 2 static obstacles per
scenario (`--num_walkers`, `--num_statics`; 0 in train_cbv).

Ticks run in chunks of FUSED_CHUNK through rollout.rollout_chunk, with
the ego's waypoints computed every tick inside the chunk (FUSED_EGO_KIND).
Everything runs on CUDA unless `--device cpu`. Not ported yet
(ROADMAP.md): the modes train_ego and collect_data, route files and the
shared town, rendering, the per-tick host loop, attention recognition,
ego weights, run tracking, and the egos `expert_disturb`, `plant` and the
E2E stacks (asking for one raises, naming the ported egos).
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import numpy as np
import torch

from .map import make_grid_town, make_straight_town
from .policies import CBV_POLICY_LIST, EGO_POLICY_LIST
from .rollout import rollout_chunk
from .scenario import TrafficEnv
from .scenario.statistics import StatisticsManager
from .utils.checkpoint import CheckpointManager
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device
from .utils.logger import Logger

FUSED_CHUNK = 20  # ticks per rollout_chunk call
# egos whose waypoints rollout_chunk computes in its tick loop
FUSED_EGO_KIND = {
    "pdm_lite": "pdm",
    "expert": "expert",  # pdm + privileged lane changes
    "behavior": "rule",
}


def build_map(args, device):
    if args.town == "grid":
        return make_grid_town(blocks=args.blocks, num_lanes=2, device=device)
    return make_straight_town(length=600.0, num_lanes=2, device=device)


def run_episode_fused(env, ego, cbv, state, crit, spec, max_ticks, train=False,
                      chunk=FUSED_CHUNK, fit_hook=None):
    """The tick loop in chunks of `chunk` ticks: the ego's waypoints,
    policy act and env step (rollout.rollout_chunk, with the ego's kind
    from FUSED_EGO_KIND). `fit_hook` (train mode) is called after every
    chunk that fills the policy's buffer: the fine-tune runs on every
    buffer-full event, and later chunks roll out with the updated weights.
    Returns (state, crit)."""
    ego_kind = FUSED_EGO_KIND[ego.name]
    with_policy = hasattr(cbv, "model")  # the Pluto family
    train_extras = train and with_policy and cbv.trainable
    n_chunks = max((max_ticks + chunk - 1) // chunk, 1)
    for _ in range(n_chunks):
        state, crit, extras = rollout_chunk(
            cbv.model if with_policy else None, env.tmap, spec, state, crit,
            max_cbvs=env.max_cbvs, num_steps=chunk, train=train_extras,
            with_policy=with_policy, ego=ego_kind,
            canonical=with_policy and cbv.canonical,
            map_tok=cbv.map_tokens() if with_policy else None,
            execute_teacher=with_policy and cbv.execute_teacher, tick=env.advance(chunk),
        )
        if train_extras and extras is not None:
            cbv.store_chunk(extras)
            if fit_hook is not None and cbv.buffer_full():
                fit_hook()
        if env.all_done(crit):
            break
    return state, crit


def _buf_size(cbv) -> int:
    buf = getattr(cbv, "buffer", None)
    return 0 if buf is None else int(buf.size)


def _check_new_samples(cbv, pre_size: int, ep: int, streak: int = 0) -> int:
    """A train_cbv episode that adds no valid buffer sample warns; three in
    a row raise (the recognition or advantage plumbing is broken). Returns
    the updated streak."""
    if not hasattr(cbv, "buffer"):
        return 0
    post = _buf_size(cbv)
    if post > pre_size or post >= cbv.buffer_capacity:
        return 0
    warnings.warn(
        f"train_cbv episode {ep} added no valid buffer samples "
        f"(size {pre_size} -> {post}, consecutive empties: {streak + 1})",
        stacklevel=2,
    )
    if streak + 1 >= 3:
        raise RuntimeError(
            f"3 consecutive train_cbv episodes added no valid buffer samples "
            f"(last: episode {ep}, size {post}): no CBV produced a valid advantage"
        )
    return streak + 1


def parse_args(argv=None):
    p = argparse.ArgumentParser("rift_tpu_torch")
    p.add_argument("--mode", default="eval", choices=["eval", "train_cbv"])
    p.add_argument("--ego_cfg", default="pdm_lite")
    p.add_argument("--cbv_cfg", default="rift_pluto")
    p.add_argument("--num_scenario", type=int, default=4)
    p.add_argument("--num_agents", type=int, default=16)
    p.add_argument("--num_episodes", type=int, default=2)
    p.add_argument("--max_ticks", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--town", default="grid", choices=["grid", "straight"])
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--out_dir", default="log")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--num_walkers", type=int, default=-1,
                   help="crossing pedestrians per scenario (-1: 2 in eval, 0 "
                        "otherwise)")
    p.add_argument("--num_statics", type=int, default=-1,
                   help="static obstacles per scenario (-1: 2 in eval, 0 otherwise)")
    p.add_argument("--max_cbvs", type=int, default=-1,
                   help="max CBVs per scenario (-1: 2 in eval, 3 otherwise)")
    p.add_argument("--lights", default="green", choices=["green", "cycle"],
                   help="'green' freezes every light green (the reference's "
                        "protocol); 'cycle' runs the light phases")
    p.add_argument("--pretrain", default="",
                   help="npz of pretrained Pluto params (either package's "
                        "save_params_npz) loaded into the Pluto-family CBV "
                        "before the run; also anchors GRPO's KL reference")
    p.add_argument("--save_pretrain", default="",
                   help="after the run, save the CBV's params as a pretrain npz")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    p.add_argument("overrides", nargs="*", help="hydra-style key=value")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    ego_cfg = load_config(args.ego_cfg)
    cbv_cfg = apply_overrides(load_config(args.cbv_cfg), args.overrides)
    # the CBV count is recognition config (train 3 / eval 2); an explicit
    # --max_cbvs or a max_cbvs=N override wins
    if args.max_cbvs >= 0:
        max_cbvs = args.max_cbvs
    else:
        max_cbvs = cbv_cfg.get("max_cbvs", 2 if args.mode == "eval" else 3)
    cbv_cfg["max_cbvs"] = max_cbvs
    cbv_cfg.setdefault("seed", args.seed)
    ego_cls = EGO_POLICY_LIST[ego_cfg.get("policy", args.ego_cfg)]
    cbv_cls = CBV_POLICY_LIST[cbv_cfg.get("policy", args.cbv_cfg)]

    tmap = build_map(args, device)
    if args.lights == "green":  # light group -1: unsignalised, always green
        tmap = tmap.replace(light_group=torch.full_like(tmap.light_group, -1))
    # eval runs with the full criteria surface: walkers and statics on
    auto = lambda n: n if n >= 0 else (2 if args.mode == "eval" else 0)
    env = TrafficEnv(tmap, num_scenarios=args.num_scenario, num_agents=args.num_agents,
                     max_cbvs=max_cbvs, seed=args.seed, num_walkers=auto(args.num_walkers),
                     num_statics=auto(args.num_statics), device=device)
    ego = ego_cls(tmap, ego_cfg)
    cbv = cbv_cls(tmap, cbv_cfg)
    if args.pretrain and hasattr(cbv, "load_pretrain"):
        cbv.load_pretrain(args.pretrain)
        print(f"loaded pretrain {args.pretrain}")

    tag = f"{ego.name}-{cbv.name}-seed{args.seed}"
    out_dir = os.path.join(args.out_dir, args.mode, tag)
    os.makedirs(out_dir, exist_ok=True)
    stats = StatisticsManager(os.path.join(out_dir, "simulation_results.json"),
                              resume=args.resume)
    ckpt = CheckpointManager(os.path.join(out_dir, "model_ckpt"))
    logger = Logger(out_dir)

    start_ep = 0
    if args.resume:
        if args.mode == "eval":
            start_ep = stats.resume_index // args.num_scenario
        elif hasattr(cbv, "load"):
            start_ep = cbv.load(ckpt) or 0

    train = args.mode == "train_cbv"
    trainable = train and hasattr(cbv, "buffer_full")
    empty_streak = 0
    for ep in range(start_ep, args.num_episodes):
        state, crit, spec = env.reset()
        pre_size = _buf_size(cbv)
        fit_losses: list = []
        fit_hook = (lambda: fit_losses.extend(cbv.train_round())) if trainable else None
        state, crit = run_episode_fused(env, ego, cbv, state, crit, spec, args.max_ticks,
                                        train=train, fit_hook=fit_hook)
        if trainable and cbv.buffer_full():
            fit_losses.extend(cbv.train_round())
        if train:
            # a fit within the episode shows that samples were collected,
            # though it emptied the buffer
            empty_streak = 0 if fit_losses else _check_new_samples(
                cbv, pre_size, ep, empty_streak)
        if fit_losses:
            print(f"episode {ep}: fine-tune losses {fit_losses[:4]}... "
                  f"({len(fit_losses)} this episode, {cbv.train_rounds} rounds in all)")
            cbv.save(ckpt, ep)
        stats.register_episode(crit, state, spec)
        logger.write_live_results(stats.live_results_text())
        ds = float(np.mean([r.driving_score for r in stats.records[-args.num_scenario:]]))
        logger.log_metrics(ep, driving_score=ds,
                           **({"loss": float(fit_losses[-1])} if fit_losses else {}))
        print(f"episode {ep}: DS={ds:.1f}")

    if args.save_pretrain and hasattr(cbv, "save_pretrain"):
        cbv.save_pretrain(args.save_pretrain)
        print(f"saved pretrain {args.save_pretrain}")
    g = stats.compute_global_statistics()
    print(json.dumps(g.__dict__, indent=2))
    return g


if __name__ == "__main__":
    main()
