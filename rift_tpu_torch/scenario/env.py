"""TrafficEnv: batched closed-loop scenarios in one state (port of
rift_tpu/scenario/env.py).

Reset is host-side numpy, as in the JAX package, and consumes the
`numpy.random.Generator` in the same order, so both packages spawn the same
scenes from the same seed. The result moves to the device in one `.to()`.
`env_step` advances every scenario one tick on the device: lazy BV
activation, controls, the world tick, criteria, CBV churn and, on its
cadence, recognition (the rule, or a PlanT scorer's attention).
"""

from __future__ import annotations

import numpy as np
import torch

from ..map.reference_lines import build_lane_chains
from ..map.routing import (
    host_map,
    route_distance_field,
    route_road_lane_ids,
    route_waypoints,
    trace_route,
)
from ..ego.rule_ego import rule_ego_waypoints
from ..map.tensor_map import TensorMap
from ..sim.pid import extend_path
from ..sim.state import (
    CLASS_STATIC,
    CLASS_WALKER,
    DEFAULT_SHAPE,
    STATIC_SHAPE,
    WALKER_SHAPE,
    ScenarioSpec,
    SimState,
    init_sim_state_host,
)
from ..sim.world import cbv_reached_goal
from ..sim.world import step as world_step
from ..utils.device import resolve_device
from ..utils.tensors import to_numpy
from .criteria import CriteriaState, init_criteria, update_criteria
from .recognition import (
    RECOG_INTERVAL,
    RECOG_WARMUP_TICKS,
    attn_recognize_cbvs,
    recognize_cbvs,
)

ROUTE_PAD = 1024  # max route waypoints (1 m spacing -> 1 km routes)
RIDS_PAD = 64
BV_SPACING_MIN = 12.0  # min distance between spawned vehicles
EGO_CLEARANCE = 15.0  # no BV spawned this close to the ego start
BV_ACTIVATE_RADIUS = 150.0  # lazy-activation radius (route_scenario.py:176)
TIMEOUT_SEC_PER_M = 1.0  # reference: 1 s per route meter (route_scenario.py:110)


# ---------------------------------------------------------------------------
# Reset (host)
# ---------------------------------------------------------------------------
def sample_route(tmap: TensorMap, rng: np.random.Generator, min_length: float = 200.0):
    """Random drivable route on the map (host). Returns (waypoints [N,3],
    lane_path)."""
    valid = np.flatnonzero(host_map(tmap)["valid"])
    for _ in range(64):
        start, goal = rng.choice(valid, 2, replace=False)
        path, dist = trace_route(tmap, int(start), int(goal))
        if path is not None and dist >= min_length:
            return route_waypoints(tmap, path), path
    # fall back to the longest straight chain from a random lane
    start = int(rng.choice(valid))
    path = [start]
    succ = host_map(tmap)["successors"]
    while len(path) < 16:
        nxt = succ[path[-1], 0]
        if nxt < 0:
            break
        path.append(int(nxt))
    return route_waypoints(tmap, path), path


def make_scenario_spec(
    tmap: TensorMap,
    routes: list[np.ndarray],
    lane_paths: list[list[int]],
    ego_target_speed: float = 8.0,
    fps: int = 10,
) -> ScenarioSpec:
    """Episode-static spec, host-side (numpy): routes, route lane masks and
    lane chains (computed on the map's device) and the route-distance
    field. Move it with `.to(device)`."""
    S = len(routes)
    ego_route = np.zeros((S, ROUTE_PAD, 3), np.float32)
    ego_route_len = np.zeros(S, np.int32)
    rr = np.full((S, RIDS_PAD), -1, np.int32)
    rl = np.zeros((S, RIDS_PAD), np.int32)
    timeout = np.zeros(S, np.int32)
    for i, (wps, path) in enumerate(zip(routes, lane_paths)):
        n = min(len(wps), ROUTE_PAD)
        ego_route[i, :n] = wps[:n]
        # pad tail with the final waypoint so interpolation stays put
        ego_route[i, n:] = wps[n - 1] if n > 0 else 0.0
        ego_route_len[i] = n
        rr[i], rl[i] = route_road_lane_ids(tmap, path, pad_to=RIDS_PAD)
        timeout[i] = int(n * TIMEOUT_SEC_PER_M * fps)

    # episode-static lane tables: on-route mask + reference-line chains
    # (the per-tick topology walk of the reference becomes this one-time
    # precompute; see map/reference_lines.py)
    dev = tmap.device
    route_lane_mask = tmap.on_route_mask(
        torch.from_numpy(rr).long().to(dev), torch.from_numpy(rl).long().to(dev)
    )
    lane_chains = build_lane_chains(tmap, route_lane_mask)

    # route-distance field per scenario (host Dijkstra, reset-rare)
    L = tmap.num_lanes
    lane_route_dist = np.full((S, L), 1e9, np.float32)
    lane_route_join = np.zeros((S, L), np.float32)
    for i, path in enumerate(lane_paths):
        D, J = route_distance_field(tmap, path)
        lane_route_dist[i] = np.where(np.isfinite(D), D, 1e9)
        lane_route_join[i] = np.where(np.isfinite(J), J, 0.0)

    return ScenarioSpec(
        ego_route=ego_route,
        ego_route_len=ego_route_len,
        route_road_ids=rr,
        route_lane_ids=rl,
        ego_target_speed=np.full((S,), ego_target_speed, np.float32),
        timeout_ticks=timeout,
        route_lane_mask=to_numpy(route_lane_mask),
        lane_chains=to_numpy(lane_chains),
        lane_route_dist=lane_route_dist,
        lane_route_join=lane_route_join,
    )


def spawn_agents(
    tmap: TensorMap,
    spec: ScenarioSpec,
    num_agents: int,
    rng: np.random.Generator,
    traffic_intensity: float = 0.6,
    num_walkers: int = 0,
    num_statics: int = 0,
) -> SimState:
    """Host-side (numpy) spawn; the caller moves the result with
    `.to(device)`. Place the ego at each route start and background
    vehicles on lane points near the route (filter_spawn_points semantics,
    rift/gym_carla/utils/common.py:72-133: seeded sampling, spacing filter,
    ego-clearance filter).

    The last `num_walkers + num_statics` agent slots become crossing
    pedestrians (patrolling perpendicular to the route) and static layout
    obstacles at the lane edge — the collision classes the leaderboard
    scores separately (atomic_criteria.py:289-423 blueprint dispatch,
    penalties statistics_manager.py:27-44)."""
    S = int(spec.ego_route_len.shape[0])
    A = num_agents
    h = host_map(tmap)
    ego_route = to_numpy(spec.ego_route)
    route_len = to_numpy(spec.ego_route_len)
    centerline = h["centerline"]
    headings_l = h["headings"]
    valid_lanes = h["valid"]

    pos = np.zeros((S, A, 2), np.float32)
    heading = np.zeros((S, A), np.float32)
    alive = np.zeros((S, A), bool)
    pool = np.zeros((S, A), bool)
    agent_class = np.zeros((S, A), np.int32)
    shape = np.broadcast_to(
        np.asarray(DEFAULT_SHAPE, np.float32), (S, A, 2)
    ).copy()
    speed0 = np.zeros((S, A), np.float32)
    anchor = np.zeros((S, A, 2), np.float32)
    bits = rng.integers(0, 2**32, size=(S, A), dtype=np.uint32)

    n_special = min(num_walkers + num_statics, max(A - 2, 0))
    n_walkers = min(num_walkers, n_special)
    n_statics = n_special - n_walkers

    flat_all = centerline[valid_lanes].reshape(-1, 2)

    def _curb_lat(wp, side, margin):
        """Lateral offset `margin` m past the outermost lane edge on `side`
        of the route waypoint (+1 = left of route heading). The road is two
        carriageways wide now, so a fixed 4-7 m offset would sit INSIDE the
        oncoming lanes."""
        rel = flat_all - wp[:2]
        near = np.linalg.norm(rel, axis=1) < 15.0
        if not near.any():
            return (4.0 + margin) * side
        lat = -np.sin(wp[2]) * rel[near, 0] + np.cos(wp[2]) * rel[near, 1]
        half_w = 0.5 * 3.5
        if side > 0:
            return float(lat.max()) + half_w + margin
        return float(lat.min()) - half_w - margin

    for s in range(S):
        n = int(route_len[s])
        start = ego_route[s, 0]
        pos[s, 0] = start[:2]
        heading[s, 0] = start[2]
        alive[s, 0] = True
        placed = [start[:2]]

        # walkers: cross the route ahead of the ego, patrolling perpendicular
        # to the road; statics: parked at the lane edge along the route
        slot = A - n_special
        for w in range(n_walkers):
            wi = int(rng.integers(max(n // 4, 1), max(n - 10, 2)))
            wp = ego_route[s, wi]
            perp = wp[2] + np.pi / 2
            lat = _curb_lat(
                wp, float(rng.choice([-1.0, 1.0])), float(rng.uniform(1.0, 3.0))
            )
            pos[s, slot] = wp[:2] + lat * np.array(
                [np.cos(perp), np.sin(perp)], np.float32
            )
            heading[s, slot] = perp + (np.pi if lat > 0 else 0.0)
            # intrinsic walking speed derives from the spawn bits — the
            # SAME formula sim/world.py's patrol uses, so the dwell phases
            # (speed 0) never lose it; the upper bits hold a small patrol
            # phase offset so every walker starts outbound (staggered
            # within 10 s — CARLA's DynamicObjectCrossing triggers when
            # the ego approaches)
            bits[s, slot] = (int(bits[s, slot]) & 0xFFFF) | (
                int(rng.integers(0, 100)) << 16
            )
            speed0[s, slot] = 0.8 + 0.8 * (
                (int(bits[s, slot]) >> 8) & 0xFF
            ) / 255.0
            agent_class[s, slot] = CLASS_WALKER
            shape[s, slot] = WALKER_SHAPE
            anchor[s, slot] = pos[s, slot]
            alive[s, slot] = True
            slot += 1
        for _ in range(n_statics):
            wi = int(rng.integers(max(n // 3, 1), max(n - 10, 2)))
            wp = ego_route[s, wi]
            perp = wp[2] + np.pi / 2
            # ego-side lane edge only (construction blocking the route,
            # ParkedObstacle semantics) — the +side is the oncoming
            # carriageway now, where a static would dam the reverse flow
            lat = -2.2
            pos[s, slot] = wp[:2] + lat * np.array(
                [np.cos(perp), np.sin(perp)], np.float32
            )
            heading[s, slot] = wp[2]
            agent_class[s, slot] = CLASS_STATIC
            shape[s, slot] = STATIC_SHAPE
            alive[s, slot] = True
            placed.append(pos[s, slot])
            slot += 1

        # candidate spawn points: lane centerline vertices within 50 m of a
        # random subset of route waypoints (spawn_radius 50,
        # recognition/config/rule.yaml:14 — with the closed network BVs
        # then CIRCULATE near the corridor instead of draining away)
        wp_sel = ego_route[s, rng.integers(0, max(n, 1), size=64), :2]
        flat = centerline[valid_lanes].reshape(-1, 2)
        flat_h = headings_l[valid_lanes].reshape(-1)
        d = np.linalg.norm(
            flat[None, :, :] - wp_sel[:, None, :], axis=-1
        ).min(0)
        cand = np.flatnonzero(d < 50.0)
        rng.shuffle(cand)
        n_veh = A - 1 - n_special
        n_bv = min(n_veh, int(traffic_intensity * n_veh) + 1)
        k = 1
        for ci in cand:
            if k > n_bv:
                break
            p = flat[ci]
            if np.linalg.norm(p - pos[s, 0]) < EGO_CLEARANCE:
                continue
            if any(np.linalg.norm(p - q) < BV_SPACING_MIN for q in placed):
                continue
            pos[s, k] = p
            heading[s, k] = flat_h[ci]
            # lazy activation (route_scenario.py:157-186): vehicles beyond
            # BV_ACTIVATE_RADIUS of the ego start in the inactive pool and
            # wake in env_step when the ego approaches
            if np.linalg.norm(p - pos[s, 0]) <= BV_ACTIVATE_RADIUS:
                alive[s, k] = True
            else:
                pool[s, k] = True
            placed.append(p)
            k += 1

    # host-side assembly, single device transfer
    state = init_sim_state_host(
        S, A, rng=rng.integers(0, 2**32, size=(S, 2), dtype=np.uint32)
    )
    # host nearest-lane
    d2 = ((centerline[None, None] - pos[:, :, None, None, :]) ** 2).sum(-1).min(-1)
    d2[:, :, ~valid_lanes] = np.inf
    lane = d2.argmin(-1).astype(np.int32)

    state = state.replace(pos=pos, heading=heading, alive=alive, lane=lane,
                          bv_pool=pool, bv_branch_bits=bits,
                          agent_class=agent_class, shape=shape, speed=speed0,
                          goal=anchor)
    state.hist_pos[:, :, -1] = pos
    state.hist_heading[:, :, -1] = heading
    state.hist_valid[:, :, -1] = alive
    return state



def wake_all_bvs(state):
    """Activate every pooled background vehicle immediately.

    Test/fixture helper: the lazy BV pool (route_scenario.py:157-186
    semantics) leaves far-from-ego vehicles alive=False at spawn, which
    breaks fixtures that force `is_cbv` on a specific slot at tick 0."""
    return state.replace(
        alive=state.alive | state.bv_pool,
        bv_pool=torch.zeros_like(state.bv_pool),
    )


def env_step(tmap: TensorMap, spec: ScenarioSpec, state: SimState, crit: CriteriaState,
             cbv_traj=None, cbv_traj_mask=None, ego_traj=None, ego_ctrl=None, cbv_ctrl=None,
             cbv_ctrl_mask=None, max_cbvs: int = 3, dt: float = 0.1, recog_model=None, *,
             tick: int):
    """One environment tick for every scenario -> (state, crit).

    The ego follows `ego_traj` [S, T, 2] local waypoints when given (the
    PDM-Lite, expert and PlanT egos) or the raw throttle/steer/brake
    `ego_ctrl` [S, 3] (the rl-type ego), else the rule ego's; CBVs follow
    `cbv_traj` [S, A, T, 2] local waypoints where `cbv_traj_mask` [S, A]
    holds (the Pluto family) or raw controls `cbv_ctrl` [S, A, 3] where
    `cbv_ctrl_mask` holds (the classic rl CBVs); everyone else runs the IDM
    autopilot. With `recog_model` (a
    PlanTModel) recognition ranks the rule's candidates by its attention
    (attn_recognize_cbvs), else it is the rule's. `tick` is the state's tick
    before the step, the
    same in every scenario (ticks advance in lockstep); the caller keeps it
    on the host, so the recognition cadence costs no device read."""
    S, A = state.alive.shape
    dev = state.pos.device

    # lazy BV activation: pooled vehicles wake within 150 m of the ego
    d_ego = torch.linalg.norm(state.pos - state.pos[:, :1], dim=-1)
    wake = state.bv_pool & (d_ego < BV_ACTIVATE_RADIUS)
    state = state.replace(alive=state.alive | wake, bv_pool=state.bv_pool & ~wake)

    if ego_traj is None:
        ego_traj = rule_ego_waypoints(spec, state, dt, tmap=tmap)
    T = ego_traj.shape[-2]
    traj = torch.zeros((S, A, T, 2), device=dev)
    traj[:, 0] = ego_traj
    traj_mask = torch.zeros((S, A), dtype=torch.bool, device=dev)
    traj_mask[:, 0] = True
    if cbv_traj is not None:
        # constant-velocity extension: the tracker averages the segments
        Tm = max(T, cbv_traj.shape[-2])
        traj = torch.where(
            cbv_traj_mask[..., None, None], extend_path(cbv_traj, Tm), extend_path(traj, Tm)
        )
        traj_mask = traj_mask | cbv_traj_mask

    # raw-control agents (the rl-type action converters) take `ctrl` where
    # `ctrl_mask` holds; finished scenarios are frozen: everyone brakes
    brake = torch.zeros((S, A, 3), device=dev)
    brake[..., 2] = 1.0
    frozen = crit.done[:, None].expand(S, A)
    ctrl, ctrl_mask = brake, frozen
    if cbv_ctrl is not None or ego_ctrl is not None:
        raw_mask = torch.zeros((S, A), dtype=torch.bool, device=dev)
        if cbv_ctrl is not None:
            ctrl = torch.where(cbv_ctrl_mask[..., None], cbv_ctrl, ctrl)
            raw_mask = raw_mask | cbv_ctrl_mask
        if ego_ctrl is not None:
            ctrl = torch.cat([ego_ctrl[:, None].to(ctrl.dtype), ctrl[:, 1:]], dim=1)
            raw_mask[:, 0] = True
            traj_mask[:, 0] = False
        ctrl = torch.where(frozen[..., None], brake, ctrl)
        ctrl_mask = raw_mask | frozen

    state = world_step(
        tmap, spec, state, traj=traj, traj_mask=traj_mask & ~ctrl_mask,
        ctrl=ctrl, ctrl_mask=ctrl_mask, dt=dt,
    )
    crit = update_criteria(crit, state, spec, dt, tmap=tmap)

    # CBV churn: reach goal -> plain BV again; collision -> destroyed. Plain
    # BVs that collide are removed too (the kinematic tick has no contact
    # resolution); the ego persists
    reached = cbv_reached_goal(state)
    cbv_collided = state.collision & state.is_cbv
    bv_collided = state.collision & ~state.is_cbv
    bv_collided[:, 0] = False
    state = state.replace(
        is_cbv=state.is_cbv & ~reached & ~cbv_collided,
        goal_valid=state.goal_valid & ~reached & ~cbv_collided,
        alive=state.alive & ~cbv_collided & ~bv_collided,
    )

    # recognition on its cadence (after the warm-up, every RECOG_INTERVAL
    # ticks), skipped whole on the other ticks
    new_tick = tick + 1
    if new_tick > RECOG_WARMUP_TICKS and new_tick % RECOG_INTERVAL == 0:
        if recog_model is None:
            recog = recognize_cbvs(tmap, spec, state, max_cbvs)
        else:
            from ..models.plant.train import plant_attn_scores

            scores = plant_attn_scores(recog_model, spec, state)
            recog = attn_recognize_cbvs(tmap, spec, state, lambda _s: scores, max_cbvs)
        new_is_cbv, goal, gvalid, _, promote = recog
        gate = ~crit.done[:, None]
        promote = promote & gate
        state = state.replace(
            is_cbv=torch.where(gate, new_is_cbv, state.is_cbv),
            goal=torch.where(promote[..., None], goal, state.goal),
            goal_valid=torch.where(promote, gvalid, state.goal_valid),
            # fresh controllers for promoted CBVs
            tracker=state.tracker.reset_where(promote),
        )
    return state, crit


class TrafficEnv:
    """Host-side wrapper: reset and episode bookkeeping. The scenes live on
    the map's device, which must be `device` (CUDA unless the caller names
    another)."""

    def __init__(
        self,
        tmap: TensorMap,
        num_scenarios: int = 4,
        num_agents: int = 16,
        max_cbvs: int = 3,
        dt: float = 0.1,
        seed: int = 0,
        num_walkers: int = 0,
        num_statics: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        if tmap.device.type != self.device.type:
            raise ValueError(
                f"TrafficEnv on {self.device} got a map on {tmap.device}"
            )
        self.tmap = tmap
        self.num_scenarios = num_scenarios
        self.num_agents = num_agents
        self.max_cbvs = max_cbvs
        self.dt = dt
        self.num_walkers = num_walkers
        self.num_statics = num_statics
        self.rng = np.random.default_rng(seed)
        self.tick = 0  # the scenes' tick, kept on the host (lockstep)
        self.recog_model = None  # a PlanT scorer: attention recognition

    def set_recognition(self, model=None):
        """Attention CBV recognition by a PlanT scorer (a PlanTModel on the
        env's device) from the next step on; no model reverts to the rule."""
        self.recog_model = model

    def reset(self, routes=None, lane_paths=None):
        """New scenes: returns (state, crit, spec) on the env's device."""
        if routes is None:
            routes, lane_paths = [], []
            for _ in range(self.num_scenarios):
                wps, path = sample_route(self.tmap, self.rng)
                routes.append(wps)
                lane_paths.append(path)
        self.spec = make_scenario_spec(self.tmap, routes, lane_paths).to(
            self.device
        )
        state = spawn_agents(
            self.tmap, self.spec, self.num_agents, self.rng,
            num_walkers=self.num_walkers, num_statics=self.num_statics,
        )
        self.tick = 0
        crit = init_criteria(self.num_scenarios, self.num_agents, self.device)
        return state.to(self.device), crit, self.spec

    def advance(self, ticks: int) -> int:
        """Move the host tick on by `ticks` steps of the scenes; returns the
        tick they start from (the `tick` of env_step and rollout_chunk)."""
        start = self.tick
        self.tick += ticks
        return start

    def step(self, state, crit, cbv_traj=None, cbv_traj_mask=None, ego_traj=None,
             ego_ctrl=None, cbv_ctrl=None, cbv_ctrl_mask=None):
        """One tick of the scenes of the last reset -> (state, crit)."""
        return env_step(
            self.tmap, self.spec, state, crit, cbv_traj=cbv_traj,
            cbv_traj_mask=cbv_traj_mask, ego_traj=ego_traj, ego_ctrl=ego_ctrl,
            cbv_ctrl=cbv_ctrl, cbv_ctrl_mask=cbv_ctrl_mask, max_cbvs=self.max_cbvs,
            dt=self.dt, recog_model=self.recog_model, tick=self.advance(1),
        )

    def all_done(self, crit) -> bool:
        return bool(crit.done.all())
