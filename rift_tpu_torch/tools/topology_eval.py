"""Real-topology town eval, on the port: tools/topology_eval.py with its
arguments, defaults and outputs, in one process.

The shipped Bench2Drive routes compile to corridor towns; this experiment
exercises REFERENCE-LIKE topology instead — a connected multi-junction
road mesh with per-road lane-change adjacency (the structure
data/gen_hdmap.py extracts from CARLA OpenDRIVE and
nuplan_map_utils.py:493-621 DFS-walks for reference lines):

  * grid town, blocks=2, 2 lanes per direction (Manhattan mesh of
    signalised junctions, left/right_adj populated on every road),
  * every ego route REQUIRES a lane change (the Dijkstra path steps
    through left/right_adj at least once — route_waypoints renders it as
    a smooth lateral blend) and crosses >= 3 junction lanes,
  * the EXPERT ego (PDM core + privileged lane changes,
    privileged_route_planner.py:869 semantics) drives it closed loop
    with standard-mode autopilot CBVs and with frozen-Pluto CBVs.

Acceptance is checked from the simulated state itself, not the route
plan: the ego's lane trace must contain an adjacency transition (an
actual lane change) and >= 3 distinct junction lanes.

    python -m rift_tpu_torch.tools.topology_eval   # writes results/torch/topology/
    python -m rift_tpu_torch.tools.topology_eval --cpu --ticks 150   # CI-scale sanity

Runs on CUDA unless `--cpu`. The `pluto` row loads `--pretrain` (by
default the quality protocol's stage-1 artifact under log/torch/quality)
and is skipped without it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..map import make_grid_town
from ..map.routing import host_map, route_waypoints, trace_route
from ..policies import CBV_POLICY_LIST, EGO_POLICY_LIST
from ..rollout import rollout_chunk
from ..scenario import TrafficEnv
from ..scenario.statistics import StatisticsManager
from ..utils.config import load_config
from ..utils.device import resolve_device
from ..utils.tensors import to_numpy
from . import ROOT


def find_topology_routes(tmap, num_routes: int, seed: int = 0):
    """Routes whose lane path includes a lane-change edge and >= 3 junction
    lanes. Returns (routes [N,3] list, lane_paths)."""
    h = host_map(tmap)
    isj = to_numpy(tmap.is_junction)
    left, right, length = h["left_adj"], h["right_adj"], h["length"]
    valid = np.flatnonzero(h["valid"])
    rng = np.random.default_rng(seed)
    routes, paths = [], []
    for _ in range(8000):
        if len(routes) >= num_routes:
            break
        s, g = rng.choice(valid, 2, replace=False)
        path, dist = trace_route(tmap, int(s), int(g))
        # bounded length so a 600-tick episode can complete the route
        if path is None or not (180 <= dist <= 380):
            continue
        lc_at = [
            k for k in range(len(path) - 1)
            if path[k + 1] in (int(left[path[k]]), int(right[path[k]]))
        ]
        if not lc_at or isj[path].sum() < 3:
            continue
        # the lane change must land in the first 60% of the route so the
        # verification actually exercises it within the tick budget
        lc_arclen = float(length[path[: lc_at[0]]].sum())
        if lc_arclen > 0.6 * dist:
            continue
        routes.append(route_waypoints(tmap, path))
        paths.append(path)
    if len(routes) < num_routes:
        raise RuntimeError(
            f"only {len(routes)}/{num_routes} lane-change routes found"
        )
    return routes, paths


def lane_trace_verdicts(tmap, trace) -> list[dict]:
    """Per scenario of a [K, S] trace of the ego's lane: whether it stepped
    to an adjacent lane (an actual lane change) and how many distinct
    junction lanes it entered."""
    h = host_map(tmap)
    isj, left, right = to_numpy(tmap.is_junction), h["left_adj"], h["right_adj"]
    verify = []
    for s in range(trace.shape[1]):
        seq = trace[:, s]
        seq = seq[np.concatenate([[True], np.diff(seq) != 0])]
        lane_changed = any(
            int(seq[k + 1]) in (int(left[seq[k]]), int(right[seq[k]]))
            for k in range(len(seq) - 1)
        )
        junctions = len({int(l) for l in seq if isj[l]})
        verify.append({"lane_change": bool(lane_changed),
                       "junction_lanes": junctions})
    return verify


def run_one(tmap, routes, lane_paths, cbv_name: str, args):
    """One eval episode batch; returns (global_stats dict, verification,
    driving scores)."""
    env = TrafficEnv(
        tmap, num_scenarios=len(routes), num_agents=args.num_agents,
        max_cbvs=2, seed=args.seed, num_walkers=0, num_statics=0,
        device=tmap.device,
    )
    ego = EGO_POLICY_LIST["expert"](tmap, load_config("pdm_lite"))
    cbv_cfg = load_config(cbv_name)
    cbv_cfg["max_cbvs"] = 2
    cbv = CBV_POLICY_LIST[cbv_cfg.get("policy", cbv_name)](tmap, cbv_cfg)
    state, crit, spec = env.reset(routes=routes, lane_paths=lane_paths)
    with_policy = hasattr(cbv, "model")
    if with_policy and args.pretrain and hasattr(cbv, "load_pretrain"):
        cbv.load_pretrain(args.pretrain)

    # chunked rollout with a lane-trace sample per chunk (0.5 s granularity:
    # junction connectors are 15-25 m, several seconds at town speeds)
    chunk = 5
    lane_trace = [state.lane[:, 0].cpu().numpy()]
    for _ in range(args.ticks // chunk):
        state, crit, _ = rollout_chunk(
            cbv.model if with_policy else None,
            tmap, spec, state, crit,
            max_cbvs=env.max_cbvs, num_steps=chunk,
            train=False, with_policy=with_policy, ego="expert",
            canonical=getattr(cbv, "canonical", False),
            map_tok=cbv.map_tokens() if hasattr(cbv, "map_tokens") else None,
            tick=env.advance(chunk),
        )
        lane_trace.append(state.lane[:, 0].cpu().numpy())
        if env.all_done(crit):
            break

    stats = StatisticsManager()
    stats.register_episode(
        crit, state, spec, route_ids=[f"topo_{i}" for i in range(len(routes))]
    )
    g = stats.compute_global_statistics()

    # ------- verification from the simulated lane trace -----------------
    verify = lane_trace_verdicts(tmap, np.stack(lane_trace))  # [K, S]
    return (
        {k: v for k, v in g.__dict__.items() if isinstance(v, (int, float))},
        verify,
        [r.driving_score for r in stats.records],
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--ticks", type=int, default=600)
    p.add_argument("--num_routes", type=int, default=4)
    p.add_argument("--num_agents", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrain", default=os.path.join(
        ROOT, "log", "torch", "quality", "artifacts", "pluto_pretrain.npz"))
    p.add_argument("--cbvs", default="standard,pluto")
    p.add_argument("--out", default=os.path.join(ROOT, "results", "torch", "topology"))
    args = p.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    tmap = make_grid_town(blocks=2, num_lanes=2, device=device)
    # frozen-green protocol (reference env_wrapper.py:91)
    tmap = tmap.replace(light_group=torch.full_like(tmap.light_group, -1))

    routes, paths = find_topology_routes(tmap, args.num_routes, args.seed)
    isj = to_numpy(tmap.is_junction)
    route_meta = [
        {"lanes": len(p), "junction_lanes": int(isj[p].sum()),
         "length_m": int(len(routes[i]))}
        for i, p in enumerate(paths)
    ]

    rows = {}
    for cbv_name in args.cbvs.split(","):
        if not os.path.exists(args.pretrain) and cbv_name != "standard":
            print(f"skipping {cbv_name}: no pretrain at {args.pretrain}")
            continue
        g, verify, ds = run_one(tmap, routes, paths, cbv_name, args)
        rows[cbv_name] = {"stats": g, "verify": verify, "ds": ds}
        print(f"{cbv_name}: DS={g.get('avg_driving_score', 0):.1f} verify={verify}")

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "topology.json"), "w") as f:
        json.dump({"routes": route_meta, "rows": rows}, f, indent=2)

    md = [
        "# Real-topology town eval (grid mesh, lane-change routes)",
        "",
        "Town: 2x2-block Manhattan grid, 2 lanes per direction, connected",
        "junction mesh with left/right lane adjacency on every road — the",
        "OpenDRIVE-like structure of the reference's CARLA towns",
        "(nuplan_map_utils.py:46-66, data/gen_hdmap.py). Every ego route's",
        "Dijkstra lane path includes >= 1 lane-change edge and >= 3 junction",
        "lanes; the EXPERT ego (PDM + privileged lane changes) drives it",
        "closed loop. Verification is from the simulated lane trace, not",
        "the plan: `lane_change` = the ego actually stepped to an adjacent",
        "lane; `junction_lanes` = distinct junction lanes entered.",
        "",
        "| route | path lanes | junction lanes | length (m) |",
        "|---|---|---|---|",
    ]
    for i, m in enumerate(route_meta):
        md.append(
            f"| {i} | {m['lanes']} | {m['junction_lanes']} | {m['length_m']} |"
        )
    md += [
        "",
        "| CBV | DS | RC | lane changes (sim) | junction lanes (sim, per route) |",
        "|---|---|---|---|---|",
    ]
    for name, r in rows.items():
        lc = sum(v["lane_change"] for v in r["verify"])
        jl = ", ".join(str(v["junction_lanes"]) for v in r["verify"])
        md.append(
            f"| {name} | {r['stats'].get('avg_driving_score', 0):.1f} "
            f"| {r['stats'].get('avg_route_completion', 0):.1f} "
            f"| {lc}/{len(r['verify'])} routes | {jl} |"
        )
    with open(os.path.join(args.out, "RESULTS.md"), "w") as f:
        f.write("\n".join(md) + "\n")
    print(f"wrote {args.out}/RESULTS.md")


if __name__ == "__main__":
    main()
