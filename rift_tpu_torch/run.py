"""CLI entry: mode dispatch over the policy zoos (port of rift_tpu/run.py,
the modes `eval`, `train_cbv`, `train_ego` and `collect_data` on the
synthetic towns and on route files).

  eval          closed-loop benchmark and leaderboard statistics
  train_cbv     fine-tune the CBV policy: buffer full -> fit -> the updated
                weights drive the next ticks (the Pluto family); GAE PPO
                rounds at each episode's end (the classic rl CBVs)
  train_ego     PPO on the rl-type ego (`ppo`) through env_step's `ego_ctrl`;
                for the il-type E2E camera egos (`vad`, `uniad`,
                `sparsedrive`) a behaviour-cloning fit of the PDM expert
                every episode (models/e2e/train.py), saved as
                `<out_dir>/train_ego/<tag>/model_ckpt/<ego>_bc.npz`
  collect_data  every tick's SimState into `<out_dir>/collect_data/<tag>/
                <ego>_<cbv>.hdf5` (rl/collect.py; needs h5py), the dataset of
                PlanT's behaviour cloning (models/plant/train.py); with
                `--resume` an existing file is kept and nothing runs

    python -m rift_tpu_torch.run --mode eval --ego_cfg pdm_lite \\
        --cbv_cfg rift_pluto --num_scenario 4 --num_episodes 3 --town grid
    python -m rift_tpu_torch.run --mode eval --routes routes.xml \\
        --ego_cfg plant --cbv_recog attention

The defaults are the JAX package's: the `pdm_lite` ego, Pluto on legacy
per-CBV tokens (the override `canonical_tokens=true` picks the
frame-invariant ones), and in eval 2 walkers and 2 static obstacles per
scenario (`--num_walkers`, `--num_statics`; 0 in train_cbv).

A Bench2Drive route file (`--routes`, `--routes_subset`) runs its routes
in batches of `--num_scenario` through the Eval/TrainDataLoader, each
batch on a junction town built from its routes (map/from_route.py, with
`--stop_ratio` of the junctions all-way stops), or with `--shared_town`
on one town of all the run's routes built up front. The last, partial
batch is padded with its last route; only the real routes become records,
each with its route id and weather. The `plant` ego (PlanT_medium,
`--ego_weights`), the E2E camera egos (`--ego_weights`, or `weights` in
their config) and attention recognition (`--cbv_recog attention`, a
PlanT scorer of dim 128, 4 layers, 4 heads, `--recog_weights`) take
weights in the JAX package's npz format; without them they start from
seeded weights. `--pretrain` loads the Pluto-family CBV only, as in the
JAX CLI.

In eval and the Pluto family's train_cbv, ticks run in chunks of
FUSED_CHUNK through rollout.rollout_chunk, with the ego's waypoints
computed every tick inside the chunk (FUSED_EGO_KIND). Everything else
(`--no_fused`, an ego outside FUSED_EGO_KIND such as `expert_disturb` or
`ppo`, a classic rl CBV, train_ego) runs the per-tick loop `run_episode`:
the ego's and the CBVs' act, then one env step, with an `on_tick`
observer that collects the classic PPO transitions. Each invocation opens
a run directory under `<out_dir>/<mode>/<tag>/runs` (utils/tracking.py);
`RIFT_TPU_TIMING=1` prints each episode's phase times. As in the JAX CLI,
`--seed` seeds the scenes and the recognizer, not the policies (their
configs' `seed`), and `--resume` outside eval and collect_data restores
nothing: the run starts again at episode 0. Everything runs on CUDA unless
`--device cpu`. `--repetitions` is parsed and read by neither CLI.

`--render` (eval and train_cbv; it runs the per-tick loop) records a BEV
video of scenario 0 per episode, `<out_dir>/<mode>/<tag>/video_ep<N>/
ep<N>.mp4` (a GIF without cv2) and `ep<N>_last.png`, a frame every 5
ticks with the route, the executed CBV trajectories in the world frame
and the route's weather (viz/render.py); it needs matplotlib and Pillow.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from .map import make_grid_town, make_straight_town, route_waypoints
from .map.from_route import map_from_routes, shared_map_from_routes
from .models.plant import PlanTModel, init_plant_weights
from .models.plant.train import load_plant_weights
from .policies import CBV_POLICY_LIST, EGO_POLICY_LIST
from .rl.classic import GOAL_RADIUS, cbv_full_train_reward, ego_shaped_reward
from .rl.collect import CollectBuffer
from .rl.losses import gae
from .rollout import flush_pending, rollout_chunk, tick_extras
from .scenario import TrafficEnv
from .scenario.routes import EvalDataLoader, TrainDataLoader, parse_routes_file
from .scenario.statistics import StatisticsManager
from .utils.checkpoint import CheckpointManager
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device
from .utils.logger import Logger
from .utils.tracking import init_run

FUSED_CHUNK = 20  # ticks per rollout_chunk call
FLUSH_K = 16  # per-tick fine-tune samples stored together (returns, GAE horizon)
PAD_ROUTE_LANES = 256  # lane padding of the per-batch route towns
# egos whose waypoints rollout_chunk computes in its tick loop
FUSED_EGO_KIND = {
    "pdm_lite": "pdm",
    "expert": "expert",  # pdm + privileged lane changes
    "behavior": "rule",
    "plant": "plant",
    "vad": "e2e",  # the E2E camera stacks
    "uniad": "e2e",
    "sparsedrive": "e2e",
}
# the attention recognizer's PlanT scorer
RECOG_DIMS = {"dim": 128, "num_layers": 4, "num_heads": 4}


def build_map(args, device):
    """(tmap, None) for a synthetic town, or (None, route configs) for a
    route file, whose towns are built per batch."""
    if args.routes:
        return None, parse_routes_file(args.routes, args.routes_subset)
    if args.town == "grid":
        return make_grid_town(blocks=args.blocks, num_lanes=2, device=device), None
    return make_straight_town(length=600.0, num_lanes=2, device=device), None


def run_episode_fused(env, ego, cbv, state, crit, spec, max_ticks, train=False,
                      chunk=FUSED_CHUNK, fit_hook=None):
    """The tick loop in chunks of `chunk` ticks: the ego's waypoints,
    policy act and env step (rollout.rollout_chunk, with the ego's kind
    from FUSED_EGO_KIND). `fit_hook` (train mode) is called after every
    chunk that fills the policy's buffer: the fine-tune runs on every
    buffer-full event, and later chunks roll out with the updated weights.
    Returns (state, crit)."""
    ego_kind = FUSED_EGO_KIND[ego.name]
    ego_model = ego.init() if ego_kind in ("plant", "e2e") else None  # made at first use
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
            execute_teacher=with_policy and cbv.execute_teacher, ego_model=ego_model,
            recog_model=env.recog_model, tick=env.advance(chunk),
        )
        if train_extras and extras is not None:
            cbv.store_chunk(extras)
            if fit_hook is not None and cbv.buffer_full():
                fit_hook()
        if env.all_done(crit):
            break
    return state, crit


def _step_kwargs(ego_out, cbv_out) -> dict:
    """Route the policies' outputs to env_step's control inputs: an ego
    dict's raw `ctrl`, [S, T, 2] waypoints or [S, 3] raw controls; the
    CBVs' waypoints `traj` or raw controls `ctrl`, each with its mask."""
    kw = {}
    if isinstance(ego_out, dict):
        kw["ego_ctrl"] = ego_out["ctrl"]
    elif ego_out.dim() == 3:
        kw["ego_traj"] = ego_out
    elif ego_out.dim() == 2:
        kw["ego_ctrl"] = ego_out
    if "traj" in cbv_out:
        kw["cbv_traj"], kw["cbv_traj_mask"] = cbv_out["traj"], cbv_out["mask"]
    elif "ctrl" in cbv_out:
        kw["cbv_ctrl"], kw["cbv_ctrl_mask"] = cbv_out["ctrl"], cbv_out["mask"]
    return kw


def world_frame_candidates(cbv_out, prev_state, scenario: int = 0):
    """The executed CBV trajectories of one scenario in the world frame, on
    the host: each masked CBV's local waypoints `traj` [K, T, 2] rotated by
    its heading and moved to its position in the state they were planned
    from. None when the policy gives no waypoints or no CBV acts."""
    if "traj" not in cbv_out:
        return None
    mask = cbv_out["mask"][scenario]
    if not bool(mask.any()):
        return None
    tr = cbv_out["traj"][scenario][mask]
    hd = prev_state.heading[scenario][mask][:, None]
    ps = prev_state.pos[scenario][mask][:, None]
    c, s = torch.cos(hd), torch.sin(hd)
    world = torch.stack([tr[..., 0] * c - tr[..., 1] * s + ps[..., 0],
                         tr[..., 0] * s + tr[..., 1] * c + ps[..., 1]], dim=-1)
    return world.cpu().numpy()


def render_observer(env, spec, recorder, weather=None):
    """An `on_tick` observer that hands scenario 0 to `recorder` on its
    capture ticks, with the ego's route, the executed CBV trajectories in
    the world frame and the weather at the ego's route progress. The tick
    is the host's (`env.tick`), so the other ticks read nothing back from
    the device."""
    route = spec.ego_route[0, :int(spec.ego_route_len[0]), :2].cpu().numpy()

    def on_tick(prev_state, state, crit_now, ego_out, cbv_out):
        tick = env.tick
        if not recorder.keeps(tick):
            return
        w = None
        if weather is not None:
            pct = 100.0 * float(state.ego_route_cursor[0]) / max(float(spec.ego_route_len[0]),
                                                                1.0)
            w = weather.at(pct)
        recorder.maybe_capture(state, 0, tick=tick, route=route,
                               candidates=world_frame_candidates(cbv_out, prev_state), weather=w)

    return on_tick


def _ego_act(ego, spec, state, train):
    """The ego's act; an ego whose `act` takes no `train` is called without
    (as the JAX CLI does, on a TypeError)."""
    try:
        return ego.act(spec, state, train=train)
    except TypeError:
        return ego.act(spec, state)


def run_episode(env, ego, cbv, state, crit, spec, max_ticks, train=False, on_tick=None):
    """The per-tick loop: the ego's and the CBVs' act, then one env step.
    `on_tick(prev_state, state, crit, ego_out, cbv_out)` observes every
    transition. In train mode a policy with `store_chunk` whose act gave
    `old_logits` (the fine-tuned Pluto family) stores its samples in
    windows of FLUSH_K ticks, also in train_ego, which never fits them (as
    the JAX CLI). Returns (state, crit)."""
    pending = []
    store = getattr(cbv, "store_chunk", None)
    for _ in range(max_ticks):
        ego_out = _ego_act(ego, spec, state, train)
        cbv_out = cbv.act(spec, state, train=train)
        prev_state = state
        state, crit = env.step(state, crit, **_step_kwargs(ego_out, cbv_out))
        if train and store is not None and "old_logits" in cbv_out:
            pending.append(tick_extras(env.tmap, cbv_out, state, crit))
            if len(pending) >= FLUSH_K:
                flush_pending(store, pending)
        if on_tick is not None:
            on_tick(prev_state, state, crit, ego_out, cbv_out)
        if env.all_done(crit):
            break
    if store is not None:
        flush_pending(store, pending)
    return state, crit


TRAJ_KEYS = ("obs", "action", "logp", "value", "reward", "done", "valid")


def _gae_batch(ppo, traj, bootstrap_value):
    """traj: [T, B, ...] stacks of obs, action, logp, value, reward, done
    and valid. GAE per column, bootstrapped with `bootstrap_value` [B];
    returns (the flattened train batch over the steps where the column was
    valid, up to and including its first done, the number of steps)."""
    values = torch.cat([traj["value"], bootstrap_value[None]], dim=0)
    adv, ret = gae(traj["reward"], values, traj["done"], ppo.gamma, ppo.lam)
    done = traj["done"].bool()
    after_done = torch.cat([torch.zeros_like(done[:1]), torch.cumsum(done, 0)[:-1] > 0])
    keep = traj["valid"].bool() & ~after_done
    return {
        "obs": traj["obs"][keep], "action": traj["action"][keep],
        "old_log_prob": traj["logp"][keep], "advantage": adv[keep], "returns": ret[keep],
    }, int(keep.sum())


def train_ego_episode(env, ego, cbv, state, crit, spec, max_ticks, tmap):
    """One batched episode of the rl ego's transitions (the shaped reward
    from its lateral offset on its lane), then its PPO round on them with
    GAE. Returns (state, crit, losses)."""
    traj = {k: [] for k in TRAJ_KEYS}

    def on_tick(prev_state, state, crit_now, ego_out, cbv_out):
        # projected on `tmap`, the map the CLI built first, not env.tmap:
        # the JAX CLI's, a stale map on per-batch route towns (ROADMAP.md)
        _, lane_lat, _ = tmap.project(state.lane[:, 0].long(), state.pos[:, 0])
        traj["reward"].append(ego_shaped_reward(
            speed_lon=state.speed[:, 0], steer=ego_out["ctrl"][:, 1], lane_dist=lane_lat,
            collided=state.collision[:, 0]))
        for k in ("obs", "action", "logp", "value"):
            traj[k].append(ego_out[k])
        traj["done"].append(crit_now.done)
        traj["valid"].append(torch.ones_like(crit_now.done))

    state, crit = run_episode(env, ego, cbv, state, crit, spec, max_ticks, train=True,
                              on_tick=on_tick)
    if not traj["obs"]:
        return state, crit, []
    stacked = {k: torch.stack(v) for k, v in traj.items()}
    batch, n = _gae_batch(ego.ppo, stacked, ego.ppo.value(stacked["obs"][-1]))
    return state, crit, ego.train_round(batch) if n > 0 else []


def train_classic_cbv_episode(env, ego, cbv, state, crit, spec, max_ticks):
    """One batched episode of the classic rl CBVs' transitions (goal
    progress, carried across ticks while a slot keeps its agent; collisions
    with agents other than the ego; reaching the goal), then a PPO round on
    them with GAE. Returns (state, crit, losses)."""
    traj = {k: [] for k in TRAJ_KEYS}
    prev = None  # (slots, goal distance) of the last tick

    def on_tick(prev_state, state, crit_now, ego_out, cbv_out):
        nonlocal prev
        slots = cbv_out["cbv_slots"]  # [S, C]
        valid = slots >= 0
        sl = torch.clamp(slots, min=0)
        scen = torch.arange(slots.shape[0], device=slots.device)[:, None]
        goal_dist = torch.linalg.norm(state.goal[scen, sl] - state.pos[scen, sl], dim=-1)
        if prev is None:
            gd_prev, same = goal_dist, torch.ones_like(valid)
        else:
            same = prev[0] == slots
            gd_prev = torch.where(same, prev[1], goal_dist)
        collided = state.collision[scen, sl] & valid
        with_other = collided & (state.collided_with[scen, sl] != 0)
        reached = (goal_dist < GOAL_RADIUS) & valid
        traj["reward"].append(cbv_full_train_reward(gd_prev, goal_dist, with_other, reached))
        traj["done"].append(collided | reached | crit_now.done[:, None] | ~same)
        traj["valid"].append(valid)
        for k in ("obs", "action", "logp", "value"):
            traj[k].append(cbv_out[k])
        prev = (slots, goal_dist)

    state, crit = run_episode(env, ego, cbv, state, crit, spec, max_ticks, train=True,
                              on_tick=on_tick)
    if not traj["obs"]:
        return state, crit, []
    # the CBV axis joins the batch axis: [T, S, C, ...] -> [T, S*C, ...]
    stacked = {k: torch.stack(v).flatten(1, 2) for k, v in traj.items()}
    batch, n = _gae_batch(cbv.ppo, stacked, cbv.ppo.value(stacked["obs"][-1]))
    return state, crit, cbv.train_round(batch) if n > 0 else []


def collect_episode(env, ego, cbv, state, crit, spec, max_ticks, buffer):
    """The per-tick loop in eval mode, storing every tick's state in
    `buffer` (reference collect_buffer.py:130). Returns (state, crit).

    The ego route is the episode's static: `set_static` replaces it every
    episode, so a file of several episodes keeps the last one's route
    only, while the frames of all episodes follow one another in one
    stream. PlanT's dataset (models/plant/train.py) then builds earlier
    episodes' route tokens from that route and takes labels across the
    episode resets. The JAX CLI does the same; the port keeps it for
    parity (ROADMAP.md §3)."""
    buffer.set_static({"ego_route": spec.ego_route, "ego_route_len": spec.ego_route_len})

    def on_tick(prev_state, state, crit_now, ego_out, cbv_out):
        buffer.store(state)

    return run_episode(env, ego, cbv, state, crit, spec, max_ticks, train=False,
                       on_tick=on_tick)


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
    p.add_argument("--mode", default="eval",
                   choices=["eval", "train_cbv", "train_ego", "collect_data"])
    p.add_argument("--ego_cfg", default="pdm_lite")
    p.add_argument("--cbv_cfg", default="rift_pluto")
    p.add_argument("--num_scenario", type=int, default=4)
    p.add_argument("--num_agents", type=int, default=16)
    p.add_argument("--num_episodes", type=int, default=2)
    p.add_argument("--max_ticks", type=int, default=600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--town", default="grid", choices=["grid", "straight"])
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--routes", default="",
                   help="a Bench2Drive route XML: its routes run in batches of "
                        "--num_scenario, each batch on a junction town built "
                        "from its routes")
    p.add_argument("--routes_subset", default="",
                   help="route ids of the file to run, e.g. '1,3-5'")
    p.add_argument("--repetitions", type=int, default=1)
    p.add_argument("--stop_ratio", type=float, default=0.25,
                   help="fraction of route-map junctions converted to "
                        "all-way-stop (stop-sign criteria, penalty 0.8)")
    p.add_argument("--shared_town", action="store_true",
                   help="compile ALL of the run's routes into ONE "
                        "persistent TensorMap up front (routes within "
                        "CROSS_EPS keep true relative town geometry; "
                        "transversal crossings become shared signalised "
                        "junctions) instead of rebuilding a per-batch "
                        "corridor map every episode — the reference's "
                        "one-CarlaMap-per-town contract "
                        "(nuplan_map_utils.py:46-66)")
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
    p.add_argument("--cbv_recog", default="rule", choices=["rule", "attention"],
                   help="CBV recognition (CBV_RECOGNITION_LIST equivalent): "
                        "rule interaction matching or the PlanT attention "
                        "scorer (attn_cbv.py:20-30)")
    p.add_argument("--recog_weights", default="",
                   help="npz of trained PlanT scorer params "
                        "(models/plant/train.py) for --cbv_recog attention")
    p.add_argument("--ego_weights", default="",
                   help="npz of trained ego params (PlanT or an E2E stack, in "
                        "the JAX package's npz format) loaded into the ego before the "
                        "run — the reference's team_code checkpoint load "
                        "(plant_agent.py:29)")
    p.add_argument("--pretrain", default="",
                   help="npz of pretrained Pluto params (either package's "
                        "save_params_npz) loaded into the Pluto-family CBV "
                        "before the run; also anchors GRPO's KL reference")
    p.add_argument("--save_pretrain", default="",
                   help="after the run, save the CBV's params as a pretrain npz")
    p.add_argument("--no_fused", action="store_true",
                   help="force the per-tick host loop (debugging); by "
                        "default eval/train_cbv run fused chunks")
    p.add_argument("--render", action="store_true",
                   help="record a BEV video of scenario 0 with the executed CBV "
                        "trajectories overlaid (eval and train_cbv, per tick; needs "
                        "matplotlib and Pillow)")
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
    ego_cls = EGO_POLICY_LIST[ego_cfg.get("policy", args.ego_cfg)]
    cbv_cls = CBV_POLICY_LIST[cbv_cfg.get("policy", args.cbv_cfg)]
    S = args.num_scenario

    def apply_lights(tm):  # light group -1: unsignalised, always green
        if args.lights == "green":
            tm = tm.replace(light_group=torch.full_like(tm.light_group, -1))
        return tm

    tmap, route_configs = build_map(args, device)
    loader = shared_paths = None
    route_pad = PAD_ROUTE_LANES  # grows if a batch needs more lanes
    last_town = {}  # the last batch's (route configs, pad) -> its town

    def route_town(cfgs):
        """map_from_routes of a batch of route configs -> (tmap, lane_paths),
        padded to `route_pad` lanes. A batch equal to the last one built is
        not built again: the town built up front serves the first eval
        batch when that batch is the file's first S routes."""
        key = (tuple(map(id, cfgs)), route_pad)
        if key not in last_town:
            last_town.clear()
            last_town[key] = map_from_routes(
                [c.keypoints for c in cfgs], num_lanes=2, pad_lanes_to=route_pad,
                stop_ratio=args.stop_ratio, device=device)
        return last_town[key]

    if route_configs is not None:
        if args.mode == "eval":
            loader = EvalDataLoader(route_configs, S)
        else:
            loader = TrainDataLoader(route_configs, S, seed=args.seed)
        if args.shared_town:
            tmap, shared_paths = shared_map_from_routes(
                [c.keypoints for c in route_configs], num_lanes=2,
                stop_ratio=args.stop_ratio, device=device)
            cfg_route_idx = {id(c): i for i, c in enumerate(route_configs)}
        else:
            tmap, _ = route_town(route_configs[:S])
            # map_from_routes grows the pad for a junction-heavy batch; it
            # is carried forward, so the episode maps keep one shape
            route_pad = max(route_pad, tmap.num_lanes)
    tmap = apply_lights(tmap)
    # eval runs with the full criteria surface: walkers and statics on
    auto = lambda n: n if n >= 0 else (2 if args.mode == "eval" else 0)
    env = TrafficEnv(tmap, num_scenarios=S, num_agents=args.num_agents,
                     max_cbvs=max_cbvs, seed=args.seed, num_walkers=auto(args.num_walkers),
                     num_statics=auto(args.num_statics), device=device)
    ego = ego_cls(tmap, ego_cfg)
    cbv = cbv_cls(tmap, cbv_cfg)
    if args.ego_weights:
        if not hasattr(ego, "load"):
            raise ValueError(f"the {ego.name} ego takes no weights")
        ego.load(args.ego_weights)
        print(f"loaded ego weights {args.ego_weights}")
    if args.cbv_recog == "attention":
        recog = PlanTModel(**RECOG_DIMS)
        if args.recog_weights:
            load_plant_weights(recog, args.recog_weights)
        else:
            warnings.warn(
                "--cbv_recog attention without --recog_weights: scoring with a "
                "randomly-initialised PlanT", stacklevel=1,
            )
            init_plant_weights(recog, torch.Generator().manual_seed(args.seed))
            # the JAX CLI resets the env once here for its init's token
            # shapes; so does the port, so that a seed spawns the same scenes
            env.reset()
        env.set_recognition(recog.to(device).eval().requires_grad_(False))
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

    # --resume: eval runs only the missing episodes; the train modes
    # restore nothing and start at episode 0, as the JAX CLI (whose
    # restore needs params a policy has not made yet; ROADMAP.md)
    start_ep = 0
    if args.resume and args.mode == "eval":
        start_ep = stats.resume_index // S
        if loader is not None:
            loader.configs = loader.configs[stats.resume_index:]
    collect_buffer = None
    if args.mode == "collect_data":
        collect_buffer = CollectBuffer(out_dir, ego.name, cbv.name)
        if collect_buffer.exists() and args.resume:
            print(f"collect_data: {collect_buffer.h5_path} exists, skipping")
            return collect_buffer.h5_path

    def reset_env():
        """A new episode: (state, crit, spec, the batch's real route configs
        or None). On a route file each scenario drives its own route: on a
        town built for the sampled batch (padded to `route_pad` lanes, the
        lights applied), or on lane paths of the shared town; the final
        partial batch is padded by repeating its last route, and the
        duplicates are no records."""
        nonlocal route_pad
        batch = loader.sampler() if loader is not None else None
        if not batch:
            return (*env.reset(), None)
        real = list(batch)
        batch = (batch + [batch[-1]] * S)[:S]
        if shared_paths is not None:
            # the shared town never changes: an episode picks lane paths
            lane_paths = [shared_paths[cfg_route_idx[id(c)]] for c in batch]
        else:
            new_tmap, lane_paths = route_town(batch)
            route_pad = max(route_pad, new_tmap.num_lanes)
            env.tmap = apply_lights(new_tmap)
            for pol in (ego, cbv):
                pol.tmap = env.tmap
        routes = [route_waypoints(env.tmap, p) for p in lane_paths]
        state, crit, spec = env.reset(routes=routes, lane_paths=lane_paths)
        # weather -> sensor visibility
        vis = torch.tensor([c.weather.visibility() for c in batch], dtype=torch.float32)
        return state, crit, spec.replace(visibility=vis.to(device)), real

    train_cbv = args.mode == "train_cbv"
    ego_is_rl = getattr(ego, "type", "") == "rl"
    cbv_is_classic_rl = getattr(cbv, "type", "") == "rl"
    can_fuse = (not args.no_fused and not args.render and args.mode in ("eval", "train_cbv")
                and not cbv_is_classic_rl and ego.name in FUSED_EGO_KIND)
    trainable = train_cbv and hasattr(cbv, "buffer_full")
    # one run directory per invocation (the reference's offline tracking)
    track = init_run(args.mode, name=tag, config=vars(args),
                     base_dir=os.path.join(out_dir, "runs"))
    # RIFT_TPU_TIMING=1: each episode's seconds by phase
    timing = os.environ.get("RIFT_TPU_TIMING", "") == "1"
    t_phase = dict.fromkeys(("reset", "rollout", "fit", "save", "stats"), 0.0)
    t_last = time.perf_counter()

    def mark(phase):
        nonlocal t_last
        now = time.perf_counter()
        t_phase[phase] += now - t_last
        t_last = now

    empty_streak = 0
    for ep in range(start_ep, args.num_episodes):
        ep_losses: list = []
        mark("stats")
        state, crit, spec, batch_cfgs = reset_env()
        mark("reset")
        if args.mode == "train_ego" and ego_is_rl:
            state, crit, ep_losses = train_ego_episode(env, ego, cbv, state, crit, spec,
                                                       args.max_ticks, tmap)
            if ep_losses:
                print(f"episode {ep}: ego PPO losses {ep_losses[:3]}...")
            ego.save(ckpt, ep)
        elif args.mode == "train_ego" and hasattr(ego, "train_bc"):
            # the il-type E2E egos clone the PDM expert closed-loop, from
            # fresh weights every episode (as the JAX CLI; ROADMAP.md §3)
            ep_losses = ego.train_bc(spec, state, crit, ticks=args.max_ticks)
            print(f"episode {ep}: {ego.name} BC loss {ep_losses[0]:.4f} -> "
                  f"{ep_losses[-1]:.4f}")
            npz = os.path.join(out_dir, "model_ckpt", f"{ego.name}_bc.npz")
            os.makedirs(os.path.dirname(npz), exist_ok=True)
            ego.save(npz)
        elif train_cbv and cbv_is_classic_rl:
            state, crit, ep_losses = train_classic_cbv_episode(env, ego, cbv, state, crit,
                                                               spec, args.max_ticks)
            if ep_losses:
                print(f"episode {ep}: classic CBV PPO losses {ep_losses[:3]}...")
            cbv.save(ckpt, ep)
        elif collect_buffer is not None:
            state, crit = collect_episode(env, ego, cbv, state, crit, spec, args.max_ticks,
                                          collect_buffer)
        elif can_fuse:
            pre_size = _buf_size(cbv)
            fit_s = 0.0

            def fit_round():
                nonlocal fit_s
                t0 = time.perf_counter()
                ep_losses.extend(cbv.train_round())
                fit_s += time.perf_counter() - t0

            state, crit = run_episode_fused(env, ego, cbv, state, crit, spec, args.max_ticks,
                                            train=train_cbv,
                                            fit_hook=fit_round if trainable else None)
            if trainable and cbv.buffer_full():
                fit_round()
            mark("rollout")
            t_phase["rollout"] -= fit_s
            t_phase["fit"] += fit_s
            if train_cbv:
                # a fit within the episode shows that samples were
                # collected, though it emptied the buffer
                empty_streak = 0 if ep_losses else _check_new_samples(
                    cbv, pre_size, ep, empty_streak)
            if ep_losses:
                print(f"episode {ep}: fine-tune losses {ep_losses[:4]}... "
                      f"({len(ep_losses)} this episode, {cbv.train_rounds} rounds in all)")
                cbv.save(ckpt, ep)
                mark("save")
        else:
            on_tick = recorder = None
            if args.render:
                from .viz import VideoRecorder

                recorder = VideoRecorder(env.tmap, os.path.join(out_dir, f"video_ep{ep}"),
                                         every_n_ticks=5)
                on_tick = render_observer(env, spec, recorder,
                                          batch_cfgs[0].weather if batch_cfgs else None)
            pre_size = _buf_size(cbv)
            state, crit = run_episode(env, ego, cbv, state, crit, spec, args.max_ticks,
                                      train=train_cbv, on_tick=on_tick)
            if recorder is not None:
                print(f"episode {ep}: wrote {recorder.save(f'ep{ep}')}")
            if train_cbv:
                empty_streak = _check_new_samples(cbv, pre_size, ep, empty_streak)
            if trainable and cbv.buffer_full():
                ep_losses = cbv.train_round()
                print(f"episode {ep}: fine-tune losses {ep_losses}")
                cbv.save(ckpt, ep)
        if batch_cfgs is not None:
            stats.register_episode(crit, state, spec, route_ids=[c.name for c in batch_cfgs],
                                   num_valid=len(batch_cfgs),
                                   weathers=[c.weather for c in batch_cfgs])
            n_new = len(batch_cfgs)
        else:
            stats.register_episode(crit, state, spec)
            n_new = S
        logger.write_live_results(stats.live_results_text())
        ds = float(np.mean([r.driving_score for r in stats.records[-n_new:]]))
        track.log({"episode": ep, "driving_score": ds,
                   **({"loss": float(ep_losses[-1])} if ep_losses else {})}, step=ep)
        print(f"episode {ep}: DS={ds:.1f}")
        if timing:
            mark("stats")
            print("  timing " + " ".join(f"{k}={v:.1f}s" for k, v in t_phase.items()))
            for k in t_phase:
                t_phase[k] = 0.0

    if collect_buffer is not None:
        path = collect_buffer.save()
        print(f"collect_data: wrote {path}")
        track.finish()
        return path
    if args.save_pretrain and hasattr(cbv, "save_pretrain"):
        cbv.save_pretrain(args.save_pretrain)
        print(f"saved pretrain {args.save_pretrain}")
    g = stats.compute_global_statistics()
    track.summary.update({k: v for k, v in g.__dict__.items() if isinstance(v, (int, float))})
    track.finish()
    print(json.dumps(g.__dict__, indent=2))
    return g


if __name__ == "__main__":
    main()
