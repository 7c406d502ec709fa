"""PDM-Lite-style privileged rule ego with forecast-based hazard avoidance
(port of rift_tpu/ego/pdm_ego.py).

Every nearby vehicle is forecast with the constant-control kinematic
bicycle, the ego's planned route positions are swept against the
forecast boxes (oriented-box overlap), and the earliest hazard feeds an
Euler step of IDM for the target speed. Red lights, stop signs and a
stuck-recovery creep then clamp it, and route following turns it into
local waypoints for the world tick's tracker. Crossing traffic at
junctions is seen because hazards come from forecasts crossing the route,
not only from same-lane leaders (the rule ego's leader gap).

The JAX package runs the 40-step forecast in a `lax.scan`; here it is a
Python loop over tensors that reads nothing back from the device.
"""

from __future__ import annotations

import torch

from ..geometry.obb import obb_overlap
from ..sim.autopilot import path_follow_waypoints
from ..sim.dynamics import bicycle_forecast_step
from ..sim.state import ScenarioSpec, SimState
from ..sim.stop_signs import stop_target_speed
from ..sim.traffic_lights import red_ahead

# IDM parameters of the reference's PDM-Lite config
IDM_A_MAX = 24.0  # maximum acceleration (the expert is aggressive)
IDM_B_HIGH = 3.72  # comfortable braking, high speed
IDM_B_LOW = 8.7  # comfortable braking, low speed
IDM_B_THRESHOLD = 6.02  # speed threshold between the two
IDM_DELTA = 4.0
IDM_T_BOUND = 0.05
IDM_S0_VEHICLE = 4.0
IDM_T_VEHICLE = 0.25

FORECAST_STEPS = 40  # 4 s at 10 fps
SAFETY_WIDTH_INFLATION = 1.2
# stuck-recovery creep
STUCK_WINDOW = 15  # history ticks of near-zero displacement = stuck
CREEP_SPEED = 1.5  # m/s un-wedging speed
CREEP_MIN_GAP = 5.5  # never creep toward a hazard closer than this
EGO_SPEED_DEFAULT = 8.0  # m/s cruise if the spec has none

LC_BLOCK_AHEAD = 30.0  # leader window that triggers or holds a lane change (m)
LC_BEHIND = -2.0  # a leader counts as ahead until fully passed
LC_OCC_BACK, LC_OCC_AHEAD = -8.0, 35.0  # adjacent-lane clearance window
LC_RAMP_M = 8.0  # arclength over which the lateral shift ramps in


def _idm_target_speed(desired_speed, ego_speed, hazard_speed, hazard_distance,
                      hazard_length):
    """One Euler step of IDM over IDM_T_BOUND toward the hazard."""
    b = torch.where(ego_speed > IDM_B_THRESHOLD, IDM_B_HIGH, IDM_B_LOW)
    speed_diff = ego_speed - hazard_speed
    s_star = IDM_S0_VEHICLE + ego_speed * IDM_T_VEHICLE + ego_speed * speed_diff / (
        2.0 * torch.sqrt(IDM_A_MAX * b)
    )
    s = torch.clamp(hazard_distance - hazard_length, min=0.1)
    dvdt = IDM_A_MAX * (
        1.0
        - (ego_speed / torch.clamp(desired_speed, min=0.1)) ** IDM_DELTA
        - (s_star / s) ** 2
    )
    return torch.clamp(ego_speed + IDM_T_BOUND * dvdt, min=0.0)


def pdm_ego_waypoints(spec: ScenarioSpec, state: SimState, tmap=None, dt: float = 0.1,
                      num_points: int = 30, lane_change: bool = False) -> torch.Tensor:
    """[S, num_points, 2] local-frame waypoints for agent slot 0.

    `lane_change` is the 'expert' behaviour: when a slow leader blocks the
    route corridor and an adjacent lane is clear, the waypoints shift
    laterally into that lane to overtake, and merge back once past.
    Without it ('pdm_lite') the ego stays in lane and brakes by IDM.
    Without `tmap` lights, stop signs and lane changes are not seen."""
    S, A = state.alive.shape
    dev = state.pos.device
    ar = torch.arange(S, device=dev)

    # ---- forecast every agent (constant control) over FORECAST_STEPS
    p, h, v = state.pos, state.heading, state.speed
    fp, fh, fv = [], [], []
    for _ in range(FORECAST_STEPS):
        p, h, v = bicycle_forecast_step(p, h, v, state.control)
        fp.append(p)
        fh.append(h)
        fv.append(v)
    fp, fh, fv = (torch.stack(x, dim=2) for x in (fp, fh, fv))  # [S, A, T, ...]

    # ---- the ego's route sweep: positions along the route at the forecast
    # times, at the current speed (at least 2 m/s)
    route = spec.ego_route  # [S, RW, 3]
    rw = route.shape[1]
    route_valid = torch.arange(rw, device=dev)[None] < spec.ego_route_len[:, None]
    d2r = ((route[..., :2] - state.pos[:, 0][:, None]) ** 2).sum(-1)
    cursor = torch.argmin(torch.where(route_valid, d2r, torch.inf), dim=-1)  # [S]
    t_idx = torch.arange(FORECAST_STEPS, dtype=torch.float32, device=dev)
    adv = torch.clamp(state.speed[:, 0:1], min=2.0) * dt * t_idx[None]  # [S, T] m
    sweep_idx = torch.minimum(
        cursor[:, None] + adv.to(torch.int32), spec.ego_route_len[:, None] - 1
    ).long()
    sweep_pos = torch.gather(route[..., :2], 1, sweep_idx[..., None].expand(S, -1, 2))
    sweep_heading = torch.gather(route[..., 2], 1, sweep_idx)
    ego_shape = state.shape[:, 0] * torch.tensor([SAFETY_WIDTH_INFLATION, 1.0], device=dev)

    # ---- hazard: the ego's swept box against every agent's forecast box
    T = FORECAST_STEPS
    hit = obb_overlap(
        sweep_pos[:, None], sweep_heading[:, None], ego_shape[:, None, None].expand(S, 1, T, 2),
        fp, fh, state.shape[:, :, None].expand(S, A, T, 2),
    )  # [S, A, T]
    other = torch.arange(A, device=dev) != 0
    hit = hit & (state.alive & other)[:, :, None]
    hit_t = hit.any(dim=1)  # [S, T]
    any_hit = hit_t.any(dim=-1)
    first_t = torch.where(any_hit, torch.argmax(hit_t.to(torch.uint8), dim=-1), T - 1)
    hazard_agent = torch.argmax(hit[ar, :, first_t].to(torch.uint8), dim=-1)
    hazard_dist = adv[ar, first_t]
    hazard_speed = fv[ar, hazard_agent, first_t]
    hazard_len = state.shape[ar, hazard_agent, 1]

    desired = torch.where(spec.ego_target_speed > 0, spec.ego_target_speed, EGO_SPEED_DEFAULT)
    v_idm = _idm_target_speed(desired, state.speed[:, 0], hazard_speed, hazard_dist, hazard_len)
    v_target = torch.where(any_hit, torch.minimum(v_idm, desired), desired)

    # stuck-recovery creep: an ego that has barely moved for STUCK_WINDOW
    # ticks with no imminent hazard creeps forward (red lights and stop
    # signs below still force 0)
    disp = torch.linalg.norm(
        state.hist_pos[:, 0, -1] - state.hist_pos[:, 0, -STUCK_WINDOW], dim=-1
    )
    stuck = (disp < 0.2) & state.hist_valid[:, 0, -STUCK_WINDOW] & (state.speed[:, 0] < 0.5)
    safe_gap = ~any_hit | (hazard_dist > CREEP_MIN_GAP)
    v_target = torch.where(stuck & safe_gap, torch.clamp(v_target, min=CREEP_SPEED), v_target)

    if tmap is not None:
        must_stop, _ = red_ahead(tmap, state.lane[:, :1], state.pos[:, :1], state.tick)
        v_target = torch.where(must_stop[:, 0], 0.0, v_target)
        # stop signs: creep to the line, halt once, then proceed
        v_target = stop_target_speed(
            tmap, state.lane[:, 0], state.pos[:, 0], state.stopped_at_stop[:, 0], v_target
        )

    offset = None
    if lane_change and tmap is not None:
        offset, v_target = _lane_change(tmap, state, route, cursor, desired, any_hit,
                                        hazard_agent, v_target)

    spacing = torch.clamp(v_target * dt, min=1e-3)
    wp = path_follow_waypoints(
        spec.ego_route, spec.ego_route_len, state.pos[:, 0], state.heading[:, 0],
        spacing, num_points,
    )
    if offset is not None:
        # the lateral shift ramps in over LC_RAMP_M of arclength (local +y
        # is road-left while aligned with the route)
        arclen = spacing[:, None] * torch.arange(num_points, dtype=torch.float32, device=dev)
        ramp = torch.clamp(arclen / LC_RAMP_M, 0.0, 1.0)
        wp = torch.stack([wp[..., 0], wp[..., 1] + ramp * offset[:, None]], dim=-1)
    return wp


def _lane_change(tmap, state, route, cursor, desired, any_hit, hazard_agent, v_target):
    """The expert's overtake in the route's frame: (lateral offset [S],
    target speed [S]). The bands are anchored to the route corridor, not
    the ego's current lane, so the decision holds while the ego is
    displaced mid-overtake."""
    S, A = state.alive.shape
    dev = state.pos.device
    ar = torch.arange(S, device=dev)
    r_pt = route[ar, cursor, :2]  # the ego's route projection
    r_hd = route[ar, cursor, 2]
    c0, s0 = torch.cos(r_hd), torch.sin(r_hd)
    rel = state.pos - r_pt[:, None]  # [S, A, 2]
    ax = rel[..., 0] * c0[:, None] + rel[..., 1] * s0[:, None]
    ay = -rel[..., 0] * s0[:, None] + rel[..., 1] * c0[:, None]
    others = state.alive & (torch.arange(A, device=dev)[None] != 0)

    lane0 = torch.clamp(state.lane[:, 0], min=0)
    w = tmap.width[lane0]
    slow = state.speed < 0.6 * desired[:, None]
    # blocked: a slow vehicle in the route corridor ahead (holds while
    # passing, clears once the blocker is behind)
    in_route_band = (torch.abs(ay) < 0.6 * w[:, None]) & (ax > LC_BEHIND) & (ax < LC_BLOCK_AHEAD)
    blocked = (in_route_band & others & slow).any(-1)

    def clear(side):
        band = (
            (torch.abs(ay - side * w[:, None]) < 0.6 * w[:, None])
            & (ax > LC_OCC_BACK)
            & (ax < LC_OCC_AHEAD)
        )
        return ~(band & others).any(-1)

    # a pass lane exists where the road is drivable one lane width off the
    # route centreline
    normal = torch.stack([-s0, c0], -1)  # route-left unit
    probe_base = r_pt + (0.5 * LC_OCC_AHEAD) * torch.stack([c0, s0], -1)
    exists_l = tmap.on_road(probe_base + w[:, None] * normal)
    exists_r = tmap.on_road(probe_base - w[:, None] * normal)
    can_left = exists_l & clear(1.0)
    can_right = exists_r & clear(-1.0)
    do_change = blocked & (can_left | can_right) & ~tmap.is_junction[lane0]
    offset = torch.where(do_change, torch.where(can_left, 1.0, -1.0) * w, 0.0)
    # while overtaking, no IDM braking for the blocker being passed
    hz_in_band = (
        any_hit
        & (ax[ar, hazard_agent] > LC_BEHIND)
        & (torch.abs(ay[ar, hazard_agent]) < 0.6 * w)
    )
    return offset, torch.where(do_change & hz_in_band, desired, v_target)
