"""The world tick: one step for all scenarios and agents (port of
rift_tpu/sim/world.py).

One call advances every scenario of the batch; every op is batched on
[S, A]. Control merge order per agent slot:
  1. raw control (`ctrl_mask`): external throttle/steer/brake;
  2. trajectory tracking (`traj_mask`): local waypoints through the shared
     PID tracker (Pluto CBVs and the waypoint egos);
  3. otherwise the IDM lane-follow autopilot.

Branch bits are uint32 in the JAX package and int64 here: the LCG update
masks to 32 bits. New speeds, accelerations and yaw rates have their
subnormals flushed to zero, as XLA computes them.
"""

from __future__ import annotations

import torch

from ..geometry.obb import obb_overlap
from ..geometry.se2 import wrap_angle
from ..map.tensor_map import TensorMap
from ..utils.tensors import flush_subnormals
from .autopilot import (
    IDM_BRAKE,
    IDM_MIN_GAP,
    LOOKAHEAD_WAYPOINTS,
    TM_SPEED_FACTOR,
    find_leaders,
    idm_target_speed,
    lane_follow_waypoints,
    yield_target_speed,
)
from .dynamics import bicycle_step
from .pid import extend_path, track_step
from .state import CLASS_STATIC, CLASS_WALKER, ScenarioSpec, SimState
from .stop_signs import stop_target_speed, stop_zone_info, update_stop_memory
from .traffic_lights import ego_red_light_entry, red_ahead

GOAL_RADIUS = 3.0  # CBV reach-goal distance
WALKER_RANGE = 15.0  # crossing distance from the curb anchor before halting
# walker patrol: one outbound and one homebound leg per period, curb dwell
# filling whatever the leg does not use
WALKER_PERIOD = 500
LCG_MUL, LCG_ADD, U32 = 1664525, 1013904223, 0xFFFFFFFF


def _lights_yield_stop(tmap: TensorMap, state: SimState, v_target):
    """Red lights, junction yield and stop signs applied to a target speed."""
    must_stop, _ = red_ahead(tmap, state.lane, state.pos, state.tick)
    v_target = torch.where(must_stop, 0.0, v_target)
    v_target = yield_target_speed(tmap, state, v_target)
    return stop_target_speed(tmap, state.lane, state.pos, state.stopped_at_stop, v_target)


def autopilot_target_speed(tmap: TensorMap, state: SimState, dt: float = 0.1):
    """Privileged IDM target speed per agent [S, A]: leader gap, speed
    limit, red lights, junction yield and stop signs."""
    leaders = find_leaders(state.pos, state.heading, state.speed, state.shape, state.alive)
    v_limit = tmap.speed_limit[state.lane] * TM_SPEED_FACTOR
    return _lights_yield_stop(tmap, state, idm_target_speed(state.speed, v_limit, leaders, dt))


def autopilot_steady_speed(tmap: TensorMap, state: SimState) -> torch.Tensor:
    """Privileged desired speed per agent [S, A]: what a competent motorist
    settles at given the leader gap, the speed limit, lights and stop
    signs, independent of its own speed (a stopped agent's teacher says
    "accelerate to the limit")."""
    gap, leader_speed = find_leaders(
        state.pos, state.heading, state.speed, state.shape, state.alive
    )
    v_limit = tmap.speed_limit[state.lane] * TM_SPEED_FACTOR
    # from gap g a vehicle can go leader speed + sqrt(2 b (g - s0)) and still
    # settle behind the leader
    slack = torch.clamp(gap - IDM_MIN_GAP, min=0.0)
    v_app = leader_speed + torch.sqrt(2.0 * IDM_BRAKE * slack)
    v_target = torch.where(torch.isfinite(gap), torch.minimum(v_limit, v_app), v_limit)
    return _lights_yield_stop(tmap, state, v_target)


def autopilot_waypoints(tmap: TensorMap, state: SimState, dt: float):
    """IDM lane-follow waypoints for every agent -> [S, A, N, 2] local."""
    spacing = torch.clamp(autopilot_target_speed(tmap, state, dt) * dt, min=1e-3)
    return lane_follow_waypoints(
        tmap, state.lane, state.pos, state.heading, state.bv_branch_bits, spacing
    )


def step(tmap: TensorMap, spec: ScenarioSpec, state: SimState, traj=None,
         traj_mask=None, ctrl=None, ctrl_mask=None, dt: float = 0.1) -> SimState:
    """Advance every scenario one tick. traj [S, A, T, 2] local waypoints
    with traj_mask [S, A]; ctrl [S, A, 3] raw controls with ctrl_mask."""
    A = state.num_agents
    dev = state.pos.device

    # ---- 1-2. control resolution: the tracker gets the full horizon
    wp = autopilot_waypoints(tmap, state, dt)  # [S, A, N, 2]
    if traj is not None:
        n = max(traj.shape[-2], LOOKAHEAD_WAYPOINTS)
        wp = torch.where(traj_mask[..., None, None], extend_path(traj, n), extend_path(wp, n))
    action, tracker = track_step(state.tracker, wp, state.speed)
    if ctrl is not None:
        action = torch.where(ctrl_mask[..., None], ctrl, action)
    # dead agents brake; walkers get zero control (they move by patrol)
    brake = torch.zeros_like(action)
    brake[..., 2] = 1.0
    action = torch.where(state.alive[..., None], action, brake)
    is_walker = state.agent_class == CLASS_WALKER
    is_static = state.agent_class == CLASS_STATIC
    action = torch.where(is_walker[..., None], 0.0, action)

    # ---- 3-4. dynamics
    new_pos, new_heading, new_speed = bicycle_step(
        state.pos, state.heading, state.speed, action, dt
    )
    # walkers patrol curb to curb from their anchor (held in `goal`); the
    # walking speed comes from the spawn bits, so a dwell never loses it
    bits = state.bv_branch_bits
    walker_v = 0.8 + 0.8 * ((bits >> 8) & 0xFF).float() / 255.0
    phase = (state.tick[:, None] + (bits >> 16) % WALKER_PERIOD) % WALKER_PERIOD
    outbound = phase < (WALKER_PERIOD // 2)
    disp = state.pos - state.goal
    progress = torch.linalg.norm(disp, dim=-1)
    go_out = outbound & (progress < WALKER_RANGE)
    go_home = ~outbound & (progress > 0.3)
    # the heading follows the walk direction: away from the anchor while
    # outbound, toward it while homebound
    away = torch.where(
        (progress > 0.15)[..., None],
        disp / torch.clamp(progress, min=1e-6)[..., None],
        torch.stack([torch.cos(state.heading), torch.sin(state.heading)], -1),
    )
    walk_vec = torch.where(go_out[..., None], away, -away)
    walking = go_out | go_home
    walk_heading = torch.where(
        walking, torch.atan2(walk_vec[..., 1], walk_vec[..., 0]), state.heading
    )
    walker_speed = walker_v * walking.float()
    walker_pos = state.pos + walker_speed[..., None] * dt * walk_vec
    new_pos = torch.where(is_walker[..., None], walker_pos, new_pos)
    new_heading = torch.where(is_walker, walk_heading, new_heading)
    new_speed = torch.where(is_walker, walker_speed, new_speed)
    # dead agents and statics never move
    frozen = ~state.alive | is_static
    new_pos = torch.where(frozen[..., None], state.pos, new_pos)
    new_heading = torch.where(frozen, state.heading, new_heading)
    new_speed = torch.where(state.alive & ~is_static, new_speed, 0.0)
    new_speed = flush_subnormals(new_speed)

    accel = flush_subnormals((new_speed - state.speed) / dt)
    yaw_rate = flush_subnormals(wrap_angle(new_heading - state.heading) / dt)

    # ---- 5. history ring (shift left, append)
    vel = new_speed[..., None] * torch.stack([torch.cos(new_heading), torch.sin(new_heading)], -1)
    push = lambda hist, x: torch.cat([hist[:, :, 1:], x[:, :, None]], dim=2)
    hist_pos = push(state.hist_pos, new_pos)
    hist_heading = push(state.hist_heading, new_heading)
    hist_vel = push(state.hist_vel, vel)
    hist_valid = push(state.hist_valid, state.alive)

    # ---- 6. lane binding, red-light entry, stop-sign memory
    new_lane = tmap.nearest_lane(new_pos, new_heading)
    red_entry = ego_red_light_entry(tmap, state.lane[:, 0], new_lane[:, 0], state.tick)
    _, in_zone_now, _ = stop_zone_info(tmap, new_lane, new_pos)
    in_stop_zone, stopped_at_stop = update_stop_memory(
        state.in_stop_zone, state.stopped_at_stop, in_zone_now, new_speed
    )
    # a fresh pseudo-random fork choice at each lane change (uint32 LCG)
    branch_bits = torch.where(
        new_lane != state.lane, (bits * LCG_MUL + LCG_ADD) & U32, bits
    )

    # ---- 7. collisions: all pairs within each scenario
    overlap = obb_overlap(
        new_pos[:, :, None], new_heading[:, :, None], state.shape[:, :, None],
        new_pos[:, None, :], new_heading[:, None, :], state.shape[:, None, :],
    )
    eye = torch.eye(A, dtype=torch.bool, device=dev)[None]
    hit = overlap & state.alive[:, :, None] & state.alive[:, None, :] & ~eye
    collision = hit.any(-1)
    # the first hit slot, as jnp.argmax of a bool row
    collided_with = torch.where(collision, torch.argmax(hit.to(torch.uint8), dim=-1), -1)

    # ---- 8. off-road: vehicles only (walkers legitimately leave the road)
    offroad = ~tmap.on_road(new_pos) & state.alive & ~is_walker & ~is_static

    # ---- 9. ego route progress (1 m waypoint spacing: index ~ meters)
    route_pts = spec.ego_route[..., :2]
    route_valid = torch.arange(route_pts.shape[1], device=dev)[None] < spec.ego_route_len[:, None]
    d2r = ((route_pts - new_pos[:, 0][:, None]) ** 2).sum(-1)
    proj = torch.argmin(torch.where(route_valid, d2r, torch.inf), dim=-1).float()
    cursor = torch.maximum(state.ego_route_cursor, proj)

    return state.replace(
        pos=new_pos,
        heading=new_heading,
        speed=new_speed,
        accel=accel,
        yaw_rate=yaw_rate,
        control=action,
        hist_pos=hist_pos,
        hist_heading=hist_heading,
        hist_vel=hist_vel,
        hist_valid=hist_valid,
        lane=new_lane,
        bv_branch_bits=branch_bits,
        in_stop_zone=in_stop_zone,
        stopped_at_stop=stopped_at_stop,
        tracker=tracker,
        collision=collision,
        collided_with=collided_with,
        offroad=offroad,
        ego_red_entry=red_entry,
        ego_route_cursor=cursor,
        tick=state.tick + 1,
    )


def cbv_reached_goal(state: SimState) -> torch.Tensor:
    """[S, A] bool: CBV within GOAL_RADIUS of its goal."""
    d = torch.linalg.norm(state.pos - state.goal, dim=-1)
    return state.is_cbv & state.goal_valid & (d < GOAL_RADIUS)
