"""PlanT ego policy: SimState -> object tokens -> waypoints (port of
rift_tpu/models/plant/policy.py).

Vehicles become type-1 tokens [x, y, yaw, speed, extent_x, extent_y] in the
ego frame; upcoming route segments become type-2 tokens with the segment id
in the speed slot. The predicted waypoints feed the world tick's trajectory
interface (the shared tracker runs the PID on them).
"""

from __future__ import annotations

import torch

from ...geometry.se2 import wrap_angle
from ...sim.pid import densify_local_waypoints
from ...sim.state import ScenarioSpec, SimState
from .model import LIDAR_OFFSET_X, PlanTModel

MAX_VEHICLE_TOKENS = 16
NUM_ROUTE_TOKENS = 2
ROUTE_SEG_LEN = 10  # route waypoints (1 m apart) per route token
DETECTION_RADIUS = 30.0
TARGET_POINT_AHEAD = 30  # route waypoints ahead of the cursor


def build_plant_tokens(spec: ScenarioSpec, state: SimState, return_vehicle_index: bool = False):
    """Returns (tokens [S, O, 7], target_point [S, 2], light_hazard [S, 1])
    and, with `return_vehicle_index`, the agent slot behind each vehicle
    token [S, MAX_VEHICLE_TOKENS] (-1 for padding), through which the
    recognition scorer scatters attention back.

    The nearest vehicles are taken as the JAX package's `top_k(-d)` takes
    them, ties to the lower slot: a stable sort on (distance, slot). Its
    radius test reads `-neg > -DETECTION_RADIUS` on the negated distances,
    which holds for every finite distance, so every live vehicle among the
    nearest 16 becomes a token; the port keeps that."""
    S, A = state.alive.shape
    dev = state.pos.device
    ego_pos, ego_heading = state.pos[:, 0], state.heading[:, 0]
    c, sn = torch.cos(-ego_heading), torch.sin(-ego_heading)

    def to_local(p):  # [S, ..., 2] world -> ego frame
        shape = (S,) + (1,) * (p.dim() - 2)
        rel = p - ego_pos.reshape(shape + (2,))
        cc, ss = c.reshape(shape), sn.reshape(shape)
        return torch.stack([rel[..., 0] * cc - rel[..., 1] * ss,
                            rel[..., 0] * ss + rel[..., 1] * cc], dim=-1)

    # vehicle tokens
    d = torch.linalg.norm(state.pos - ego_pos[:, None], dim=-1)
    keep = state.alive & (torch.arange(A, device=dev) != 0)
    d = torch.where(keep, d, torch.inf)
    k = min(MAX_VEHICLE_TOKENS, A)
    idx = torch.argsort(d, dim=-1, stable=True)[:, :k]
    dk = torch.gather(d, 1, idx)
    valid = torch.isfinite(dk) & (dk > -DETECTION_RADIUS)
    take = lambda x: torch.gather(x, 1, idx)
    shape = state.shape[torch.arange(S, device=dev)[:, None], idx]  # [S, k, 2]
    veh = torch.cat([
        valid.float()[..., None],
        to_local(state.pos[torch.arange(S, device=dev)[:, None], idx]),
        wrap_angle(take(state.heading) - ego_heading[:, None])[..., None],
        take(state.speed)[..., None],
        shape[..., 1:2] * 0.5,  # extent_x
        shape[..., 0:1] * 0.5,  # extent_y
    ], dim=-1)
    veh = torch.where(valid[..., None], veh, 0.0)
    vid = torch.where(valid, idx, -1)
    if k < MAX_VEHICLE_TOKENS:
        veh = torch.nn.functional.pad(veh, (0, 0, 0, MAX_VEHICLE_TOKENS - k))
        vid = torch.nn.functional.pad(vid, (0, MAX_VEHICLE_TOKENS - k), value=-1)

    # route tokens: segments ahead of the ego's route projection
    route = spec.ego_route[..., :2]
    n = spec.ego_route_len.long()
    cursor = state.ego_route_cursor.to(torch.int32).long()
    at = lambda i: to_local(torch.gather(route, 1, i[:, None, None].expand(S, 1, 2))[:, 0])
    segs = []
    for i in range(NUM_ROUTE_TOKENS):
        s0 = torch.minimum(cursor + i * ROUTE_SEG_LEN, n - 2)
        s1 = torch.minimum(s0 + ROUTE_SEG_LEN, n - 1)
        p0, p1 = at(s0), at(s1)
        vec = p1 - p0
        segs.append(torch.cat([
            torch.full((S, 1), 2.0, device=dev),
            0.5 * (p0 + p1),
            torch.atan2(vec[:, 1], vec[:, 0])[:, None],
            torch.full((S, 1), float(i), device=dev),  # the id in the speed slot
            torch.linalg.norm(vec, dim=-1)[:, None] * 0.5,
            torch.ones((S, 1), device=dev),
        ], dim=-1))
    tokens = torch.cat([veh, torch.stack(segs, dim=1)], dim=1)
    target_point = at(torch.minimum(cursor + TARGET_POINT_AHEAD, n - 1))
    light = torch.zeros((S, 1), device=dev)  # all green, as the CBV features assume
    if return_vehicle_index:
        return tokens, target_point, light, vid
    return tokens, target_point, light


@torch.no_grad()
def plant_ego_waypoints(model: PlanTModel, spec: ScenarioSpec, state: SimState) -> torch.Tensor:
    """[S, N, 2] local waypoints for env_step's `ego_traj` (no gradient:
    the serving path)."""
    tokens, target, light = build_plant_tokens(spec, state)
    wp = model(tokens, target, light)["pred_wp"]
    # undo the lidar shift: waypoints in the vehicle frame
    wp = torch.cat([wp[..., :1] + LIDAR_OFFSET_X, wp[..., 1:]], dim=-1)
    # 0.5 s-spaced predictions -> the tracker's 0.1 s grid
    return densify_local_waypoints(wp, wp_dt=0.5)
