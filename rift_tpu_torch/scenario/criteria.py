"""Vectorized leaderboard criteria (port of rift_tpu/scenario/criteria.py).

Boolean kernels over SimState with the leaderboard's event semantics:

  collision vehicle      penalty 0.6 per event
  blocked                speed < 0.1 m/s for > 3 s  -> terminate
  route deviation        > 30 m from the route      -> terminate
  outside route lanes    fraction of route driven off lane, scales RC
  scenario timeout       penalty 0.7
  route completion       percent of route arclength covered

All criteria state lives in a [S]-shaped container updated once per tick
by `update_criteria`, with the CBV behaviour accumulators and histograms.
Counts are int64 here (int32 in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..sim.state import ScenarioSpec, SimState
from ..utils.tensors import TensorDataclass
from .metrics import ego_criticality

BLOCKED_SPEED = 0.1  # m/s
BLOCKED_TICKS = 30  # 3 s @ 10 fps
ROUTE_DEVIATION_M = 30.0
COMPLETION_RADIUS = 10.0  # done when near the final waypoint

PENALTY_COLLISION_PEDESTRIAN = 0.5
PENALTY_COLLISION_VEHICLE = 0.6
PENALTY_COLLISION_STATIC = 0.65
PENALTY_RED_LIGHT = 0.7
PENALTY_STOP_SIGN = 0.8
PENALTY_TIMEOUT = 0.7

# behaviour-distribution bin edges (the leaderboard statistics' published
# CBV_DATA_BINS / EGO_DATA_BINS / EGO_SPEED_BINS)
CBV_SPEED_EDGES = np.array([0.0, 0.5, 1, 1.5, 2, 2.5, 3, 4, 6, 8, 10, 12, 14], np.float32)
CBV_DELTA_SPEED_EDGES = np.array(
    [-2.5, -2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1, 1.5, 2, 2.5, 3, 3.5, 4.5,
     5.0, 6.5, 7.5, 8.0, 8.5, 9.0], np.float32
)
CBV_TARGET_SPEED_EDGES = np.array([5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0, 12.0], np.float32)
CBV_ACC_EDGES = np.array(
    [-1.5, -1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 2.5, 3.0],
    np.float32,
)
CBV_JERK_EDGES = np.array(
    [-10.0, -8.0, -6.0, -4.0, -2.0, 0.0, 2.0, 4.0, 6.0, 8.0, 10.0], np.float32
)
EGO_SPEED_EDGES = np.array(
    [0.0, 0.5, 1, 1.5, 2, 2.5, 3, 3.5, 4, 4.5, 5, 5.5, 6, 8, 10], np.float32
)
EGO_METRIC_EDGES = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0], np.float32
)

# uncomfortable-motion bounds: acc.x in (-4.05, 2.40), |acc.y| < 4.89,
# |jerk| < 8.37
UNCOMFORT_ACC_LON = (-4.05, 2.40)
UNCOMFORT_ACC_LAT = 4.89
UNCOMFORT_JERK = 8.37

CRITICALITY_RADIUS = 60.0  # ego nearby-agent search radius

_EDGES: dict = {}


def _edges(edges: np.ndarray, device) -> torch.Tensor:
    """Bin edges on `device`, copied there once."""
    key = (id(edges), str(device))
    if key not in _EDGES:
        _EDGES[key] = torch.from_numpy(edges).to(device)
    return _EDGES[key]


def _bin(edges, values):
    """(bin index, in range) of `values`: searchsorted(side="left") - 1, as
    the leaderboard's bisect_left; values below the first edge, at or above
    the last, or not finite fall in no bin."""
    e = _edges(edges, values.device)
    idx = torch.clamp(torch.searchsorted(e, values.contiguous()) - 1, 0, len(edges) - 2)
    ok = (values >= e[0]) & (values < e[-1]) & torch.isfinite(values)
    return idx, ok


def _one_hot(idx, n):
    """Elementwise one-hot (F.one_hot checks its range with a device sync)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _hist_add_1d(hist, edges, values, weight):
    """Add `values` [S, A] where `weight` holds into `hist` [S, B]."""
    idx, ok = _bin(edges, values)
    return hist + (_one_hot(idx, len(edges) - 1) & (ok & weight)[..., None]).sum(1)


def _hist_add_2d(hist, row_edges, col_edges, row_val, col_val, weight):
    """Add one (row_val, col_val) [S] pair per scenario into `hist`
    [S, R, C]."""
    ri, rok = _bin(row_edges, row_val)
    ci, cok = _bin(col_edges, col_val)
    R, C = len(row_edges) - 1, len(col_edges) - 1
    oh = _one_hot(ri * C + ci, R * C).reshape(-1, R, C)
    return hist + (oh & (weight & rok & cok)[:, None, None])


@dataclass
class CriteriaState(TensorDataclass):
    # ego events
    collisions_vehicle: torch.Tensor  # [S] event count
    collisions_pedestrian: torch.Tensor  # [S]
    collisions_static: torch.Tensor  # [S]
    prev_ego_collision: torch.Tensor  # [S] bool (rising-edge dedupe)
    blocked_ticks: torch.Tensor  # [S] consecutive slow ticks
    blocked: torch.Tensor  # [S] bool
    route_deviation: torch.Tensor  # [S] bool
    outside_lane_meters: torch.Tensor  # [S] float32
    driven_meters: torch.Tensor  # [S] float32
    timeout: torch.Tensor  # [S] bool
    route_complete: torch.Tensor  # [S] bool
    red_light_infractions: torch.Tensor  # [S]
    stop_infractions: torch.Tensor  # [S]
    prev_ego_in_stop_zone: torch.Tensor  # [S] bool (exit-edge detection)
    # minimum-speed accumulators: ego speed vs the mean speed of background
    # traffic within 60 m (recorded, not penalised)
    min_speed_ego_sum: torch.Tensor  # [S] float32
    min_speed_bg_sum: torch.Tensor  # [S] float32
    min_speed_points: torch.Tensor  # [S]
    done: torch.Tensor  # [S] bool
    done_tick: torch.Tensor  # [S]
    # CBV live accumulators (behaviour metrics)
    cbv_speed_sum: torch.Tensor  # [S] float32
    cbv_acc_sum: torch.Tensor  # [S]
    cbv_jerk_sum: torch.Tensor  # [S]
    cbv_count: torch.Tensor  # [S] CBV-ticks (x dt = game time)
    cbv_offroad_ticks: torch.Tensor  # [S]
    cbv_uncomfortable_ticks: torch.Tensor  # [S]
    cbv_collisions: torch.Tensor  # [S]
    prev_cbv_collision: torch.Tensor  # [S, A] bool
    prev_cbv_acc: torch.Tensor  # [S, A] float32 |acc| (for jerk)
    # second moments and extra sums for mean +- std reporting
    cbv_speed_sq: torch.Tensor  # [S] float32
    cbv_acc_sq: torch.Tensor  # [S]
    cbv_jerk_sq: torch.Tensor  # [S]
    cbv_target_speed_sum: torch.Tensor  # [S]
    cbv_target_speed_sq: torch.Tensor  # [S]
    cbv_delta_speed_sum: torch.Tensor  # [S]
    cbv_delta_speed_sq: torch.Tensor  # [S]
    # progress and churn counters
    cbv_progress_m: torch.Tensor  # [S] float32 summed per-tick CBV movement
    cbv_reach_goal: torch.Tensor  # [S]
    cbv_new_count: torch.Tensor  # [S] distinct promotions
    prev_is_cbv: torch.Tensor  # [S, A] bool (promotion edge)
    # behaviour distributions
    cbv_speed_hist: torch.Tensor  # [S, 12]
    cbv_delta_speed_hist: torch.Tensor  # [S, 19]
    cbv_target_speed_hist: torch.Tensor  # [S, 7]
    cbv_acc_hist: torch.Tensor  # [S, 13]
    cbv_jerk_hist: torch.Tensor  # [S, 10]
    # ego criticality distributions: speed bin x metric bin
    ego_rttc_hist: torch.Tensor  # [S, 14, 10]
    ego_act_hist: torch.Tensor  # [S, 14, 10]
    ego_ei_hist: torch.Tensor  # [S, 14, 10]


def init_criteria(num_scenarios: int, num_agents: int, device=None) -> CriteriaState:
    S, A = num_scenarios, num_agents
    z = lambda *s: torch.zeros(s or (S,), dtype=torch.long, device=device)
    f = lambda *s: torch.zeros(s or (S,), dtype=torch.float32, device=device)
    b = lambda *s: torch.zeros(s or (S,), dtype=torch.bool, device=device)
    hist = lambda edges: z(S, len(edges) - 1)
    ego_hist = lambda: z(S, len(EGO_SPEED_EDGES) - 1, len(EGO_METRIC_EDGES) - 1)
    return CriteriaState(
        collisions_vehicle=z(), collisions_pedestrian=z(), collisions_static=z(),
        prev_ego_collision=b(), blocked_ticks=z(), blocked=b(), route_deviation=b(),
        outside_lane_meters=f(), driven_meters=f(), timeout=b(), route_complete=b(),
        red_light_infractions=z(), stop_infractions=z(), prev_ego_in_stop_zone=b(),
        min_speed_ego_sum=f(), min_speed_bg_sum=f(), min_speed_points=z(),
        done=b(), done_tick=z(),
        cbv_speed_sum=f(), cbv_acc_sum=f(), cbv_jerk_sum=f(), cbv_count=z(),
        cbv_offroad_ticks=z(), cbv_uncomfortable_ticks=z(), cbv_collisions=z(),
        prev_cbv_collision=b(S, A), prev_cbv_acc=f(S, A),
        cbv_speed_sq=f(), cbv_acc_sq=f(), cbv_jerk_sq=f(),
        cbv_target_speed_sum=f(), cbv_target_speed_sq=f(),
        cbv_delta_speed_sum=f(), cbv_delta_speed_sq=f(),
        cbv_progress_m=f(), cbv_reach_goal=z(), cbv_new_count=z(), prev_is_cbv=b(S, A),
        cbv_speed_hist=hist(CBV_SPEED_EDGES),
        cbv_delta_speed_hist=hist(CBV_DELTA_SPEED_EDGES),
        cbv_target_speed_hist=hist(CBV_TARGET_SPEED_EDGES),
        cbv_acc_hist=hist(CBV_ACC_EDGES),
        cbv_jerk_hist=hist(CBV_JERK_EDGES),
        ego_rttc_hist=ego_hist(), ego_act_hist=ego_hist(), ego_ei_hist=ego_hist(),
    )


def update_criteria(crit: CriteriaState, state: SimState, spec: ScenarioSpec,
                    dt: float = 0.1, tmap=None) -> CriteriaState:
    dev = state.pos.device
    ego_speed = state.speed[:, 0]
    ego_pos = state.pos[:, 0]
    ego_collision = state.collision[:, 0]
    running = ~crit.done

    # collision events: rising edge only, classified by the hit agent's class
    new_collision = ego_collision & ~crit.prev_ego_collision & running
    hit_slot = torch.clamp(state.collided_with[:, 0], min=0)
    hit_class = torch.gather(state.agent_class, 1, hit_slot[:, None])[:, 0]
    count = lambda cls: (new_collision & (hit_class == cls)).long()

    slow = ego_speed < BLOCKED_SPEED
    blocked_ticks = torch.where(slow & running, crit.blocked_ticks + 1, 0)
    blocked = crit.blocked | (blocked_ticks > BLOCKED_TICKS)

    # route deviation: distance to the nearest route waypoint
    route_pts = spec.ego_route[..., :2]
    valid = torch.arange(route_pts.shape[1], device=dev)[None] < spec.ego_route_len[:, None]
    d2 = ((route_pts - ego_pos[:, None]) ** 2).sum(-1)
    dist_to_route = torch.sqrt(torch.where(valid, d2, torch.inf).amin(-1))
    route_deviation = crit.route_deviation | ((dist_to_route > ROUTE_DEVIATION_M) & running)

    # meters driven off-road or against the bound lane (> 120 degrees)
    step_m = ego_speed * dt * running
    outside_now = state.offroad[:, 0]
    if tmap is not None:
        _, _, lane_hd = tmap.project(torch.clamp(state.lane[:, 0], min=0), ego_pos)
        wrong_dir = torch.cos(state.heading[:, 0] - lane_hd) < -0.5
        outside_now = outside_now | (wrong_dir & (state.lane[:, 0] >= 0))

    # stop sign: the ego left the zone without having halted inside it
    in_zone_ego = state.in_stop_zone[:, 0]
    exit_edge = crit.prev_ego_in_stop_zone & ~in_zone_ego
    stop_event = exit_edge & ~state.stopped_at_stop[:, 0] & running

    # minimum speed vs the surrounding background traffic (60 m)
    near = state.alive & (state.agent_class == 0)
    near[:, 0] = False
    near &= torch.linalg.norm(state.pos - ego_pos[:, None], dim=-1) < 60.0
    n_near = near.sum(-1)
    has_bg = (n_near > 0) & running
    bg_mean = (state.speed * near).sum(-1) / torch.clamp(n_near, min=1)

    timeout = crit.timeout | ((state.tick >= spec.timeout_ticks) & running)
    total = torch.clamp(spec.ego_route_len.float() - 1.0, min=1.0)
    route_complete = crit.route_complete | (
        (state.ego_route_cursor >= total - COMPLETION_RADIUS) & running
    )
    done = crit.done | blocked | route_deviation | timeout | route_complete
    done_tick = torch.where(done & ~crit.done, state.tick, crit.done_tick)

    # ---- CBV statistics: per-tick speed / |acc| / jerk samples, game-time
    # ratios, progress, target and delta speed, reach-goal and promotions
    cbv = state.is_cbv & state.alive
    acc_lon = state.accel
    acc_lat = state.speed * state.yaw_rate  # centripetal
    acc_mag = torch.hypot(acc_lon, acc_lat)
    jerk = (acc_mag - crit.prev_cbv_acc) / dt
    cbv_live = cbv & running[:, None]
    cbv_f = cbv_live.float()
    uncomfortable = ~(
        (acc_lon > UNCOMFORT_ACC_LON[0]) & (acc_lon < UNCOMFORT_ACC_LON[1])
        & (torch.abs(acc_lat) < UNCOMFORT_ACC_LAT) & (torch.abs(jerk) < UNCOMFORT_JERK)
    )
    new_cbv_col = state.collision & cbv & ~crit.prev_cbv_collision
    # per-tick movement (the history ring holds last tick's position)
    step_dist = torch.linalg.norm(
        state.hist_pos[:, :, -1] - state.hist_pos[:, :, -2], dim=-1
    ) * state.hist_valid[:, :, -2]
    if tmap is not None:
        target_speed = tmap.speed_limit[state.lane]
    else:
        target_speed = torch.full_like(state.speed, 8.0)
    delta_speed = target_speed - state.speed
    reached = (
        state.is_cbv & state.goal_valid
        & (torch.linalg.norm(state.pos - state.goal, dim=-1) < 3.0)
    )
    promoted = state.is_cbv & ~crit.prev_is_cbv
    csum = lambda x: (x * cbv_f).sum(-1)
    live_count = lambda m: (m & cbv_live).sum(-1)

    # ---- ego criticality: min RTTC / ACT, max EI over nearby agents
    nbr_valid = state.alive & (
        torch.linalg.norm(state.pos - ego_pos[:, None], dim=-1) < CRITICALITY_RADIUS
    )
    nbr_valid[:, 0] = False
    critm = ego_criticality(
        ego_pos, state.heading[:, 0], ego_speed, state.shape[:, 0],
        state.pos, state.heading, state.speed, state.shape, nbr_valid,
    )
    ego_hist = lambda h, key: _hist_add_2d(
        h, EGO_SPEED_EDGES, EGO_METRIC_EDGES, ego_speed, critm[key], running
    )

    return crit.replace(
        collisions_vehicle=crit.collisions_vehicle + count(0),
        collisions_pedestrian=crit.collisions_pedestrian + count(1),
        collisions_static=crit.collisions_static + count(2),
        prev_ego_collision=ego_collision,
        blocked_ticks=blocked_ticks,
        blocked=blocked,
        route_deviation=route_deviation,
        outside_lane_meters=crit.outside_lane_meters + step_m * outside_now,
        driven_meters=crit.driven_meters + step_m,
        timeout=timeout,
        route_complete=route_complete,
        red_light_infractions=crit.red_light_infractions + (state.ego_red_entry & running).long(),
        stop_infractions=crit.stop_infractions + stop_event.long(),
        prev_ego_in_stop_zone=in_zone_ego,
        min_speed_ego_sum=crit.min_speed_ego_sum + ego_speed * has_bg,
        min_speed_bg_sum=crit.min_speed_bg_sum + bg_mean * has_bg,
        min_speed_points=crit.min_speed_points + has_bg.long(),
        done=done,
        done_tick=done_tick,
        cbv_speed_sum=crit.cbv_speed_sum + csum(state.speed),
        cbv_acc_sum=crit.cbv_acc_sum + csum(acc_mag),
        cbv_jerk_sum=crit.cbv_jerk_sum + csum(jerk),
        cbv_count=crit.cbv_count + cbv.sum(-1) * running,
        cbv_offroad_ticks=crit.cbv_offroad_ticks + live_count(state.offroad),
        cbv_uncomfortable_ticks=crit.cbv_uncomfortable_ticks + live_count(uncomfortable),
        cbv_collisions=crit.cbv_collisions + (new_cbv_col & running[:, None]).sum(-1),
        prev_cbv_collision=state.collision & cbv,
        prev_cbv_acc=acc_mag,
        cbv_speed_sq=crit.cbv_speed_sq + csum(state.speed ** 2),
        cbv_acc_sq=crit.cbv_acc_sq + csum(acc_mag ** 2),
        cbv_jerk_sq=crit.cbv_jerk_sq + csum(jerk ** 2),
        cbv_target_speed_sum=crit.cbv_target_speed_sum + csum(target_speed),
        cbv_target_speed_sq=crit.cbv_target_speed_sq + csum(target_speed ** 2),
        cbv_delta_speed_sum=crit.cbv_delta_speed_sum + csum(delta_speed),
        cbv_delta_speed_sq=crit.cbv_delta_speed_sq + csum(delta_speed ** 2),
        cbv_progress_m=crit.cbv_progress_m + csum(step_dist),
        cbv_reach_goal=crit.cbv_reach_goal + (reached & running[:, None]).sum(-1),
        cbv_new_count=crit.cbv_new_count + (promoted & running[:, None]).sum(-1),
        prev_is_cbv=state.is_cbv,
        cbv_speed_hist=_hist_add_1d(crit.cbv_speed_hist, CBV_SPEED_EDGES, state.speed, cbv_live),
        cbv_delta_speed_hist=_hist_add_1d(
            crit.cbv_delta_speed_hist, CBV_DELTA_SPEED_EDGES, delta_speed, cbv_live
        ),
        cbv_target_speed_hist=_hist_add_1d(
            crit.cbv_target_speed_hist, CBV_TARGET_SPEED_EDGES, target_speed, cbv_live
        ),
        cbv_acc_hist=_hist_add_1d(crit.cbv_acc_hist, CBV_ACC_EDGES, acc_mag, cbv_live),
        cbv_jerk_hist=_hist_add_1d(crit.cbv_jerk_hist, CBV_JERK_EDGES, jerk, cbv_live),
        ego_rttc_hist=ego_hist(crit.ego_rttc_hist, "RTTC"),
        ego_act_hist=ego_hist(crit.ego_act_hist, "ACT"),
        ego_ei_hist=ego_hist(crit.ego_ei_hist, "EI"),
    )


def route_completion_percent(crit: CriteriaState, state: SimState, spec: ScenarioSpec):
    total = torch.clamp(spec.ego_route_len.float() - 1.0, min=1.0)
    rc = torch.clamp(state.ego_route_cursor / total, 0.0, 1.0) * 100.0
    return torch.where(crit.route_complete, 100.0, rc)


def driving_score(crit: CriteriaState, state: SimState, spec: ScenarioSpec):
    """Leaderboard score_composed = route completion x infraction penalty.
    Returns (score, route completion, penalty), each [S]."""
    rc = route_completion_percent(crit, state, spec)
    # outside-route-lanes scales RC down by the off-lane fraction
    frac_outside = torch.where(
        crit.driven_meters > 0,
        crit.outside_lane_meters / torch.clamp(crit.driven_meters, min=1e-6),
        0.0,
    )
    pen = lambda base, n: torch.pow(torch.tensor(base, device=n.device), n.float())
    penalty = (
        pen(PENALTY_COLLISION_VEHICLE, crit.collisions_vehicle)
        * pen(PENALTY_COLLISION_PEDESTRIAN, crit.collisions_pedestrian)
        * pen(PENALTY_COLLISION_STATIC, crit.collisions_static)
        * pen(PENALTY_RED_LIGHT, crit.red_light_infractions)
        * pen(PENALTY_STOP_SIGN, crit.stop_infractions)
        * torch.where(crit.timeout, PENALTY_TIMEOUT, 1.0)
    )
    return rc * (1.0 - frac_outside) * penalty, rc, penalty
