"""Background-traffic autopilot: IDM speed + lane-follow steering (port of
rift_tpu/sim/autopilot.py).

Vectorized over [S, A]: each vehicle chains lane successors (fork choices
from its branch bits), finds its leader in a lane-width corridor, integrates
IDM toward its target speed, yields at junction entries, and places
waypoints along its lane chain (or, for the rule ego, along its route).
"""

from __future__ import annotations

import math

import torch

from ..geometry.se2 import wrap_angle
from ..map.tensor_map import LANE_POINTS, TensorMap

# IDM parameters
IDM_MAX_ACCEL = 2.5  # m/s^2 traffic-flow accel
IDM_BRAKE = 3.8  # comfortable deceleration
IDM_MIN_GAP = 4.0  # s0
IDM_HEADWAY = 1.0  # T
IDM_EXPONENT = 4.0
TM_SPEED_FACTOR = 0.8  # TrafficManager: 20% under the speed limit

LOOKAHEAD_WAYPOINTS = 30  # local path length handed to the tracker
CHAIN_LANES = 4  # lanes chained ahead for the local path

YIELD_DIST = 12.0  # start negotiating this far from the junction entry
YIELD_STOP = 5.0  # hold distance while blocked
YIELD_CRAWL = 2.0  # m/s creep while negotiating
YIELD_FLOOR = 0.6  # m/s hold-line creep
CONFLICT_RADIUS = 12.0  # junction box radius around the connector midpoint


def find_leaders(pos, heading, speed, shape, alive, max_range: float = 50.0,
                 lateral_tol: float = 1.8):
    """Per-agent leading vehicle: the nearest alive agent ahead within a
    lane-width corridor. Returns (gap [S, A] bumper to bumper, inf if none;
    leader speed [S, A], 0 if none)."""
    rel = pos[:, None, :, :] - pos[:, :, None, :]  # [S, A(self), A(other), 2]
    c = torch.cos(heading)[:, :, None]
    s = torch.sin(heading)[:, :, None]
    lon = rel[..., 0] * c + rel[..., 1] * s
    lat = -rel[..., 0] * s + rel[..., 1] * c
    A = pos.shape[1]
    eye = torch.eye(A, dtype=torch.bool, device=pos.device)
    cand = (
        alive[:, None, :] & alive[:, :, None] & ~eye[None]
        & (lon > 0.0) & (lon < max_range) & (torch.abs(lat) < lateral_tol)
    )
    lon_masked = torch.where(cand, lon, torch.inf)
    leader_lon = lon_masked.amin(-1)
    leader_idx = torch.argmin(lon_masked, dim=-1)  # first among equal minima
    leader_half = torch.gather(shape[..., 1], 1, leader_idx) * 0.5
    gap = leader_lon - shape[..., 1] * 0.5 - leader_half
    leader_speed = torch.gather(speed, 1, leader_idx)
    has = torch.isfinite(leader_lon)
    return (
        torch.where(has, torch.clamp(gap, min=0.1), torch.inf),
        torch.where(has, leader_speed, 0.0),
    )


def idm_target_speed(speed, v0, leader, dt: float, horizon_steps: float = 10.0):
    """IDM acceleration integrated over a short horizon -> target speed.
    `leader` is find_leaders' (gap, leader speed)."""
    gap, leader_speed = leader
    v0 = torch.clamp(v0, min=0.1)
    s_star = IDM_MIN_GAP + speed * IDM_HEADWAY + speed * (speed - leader_speed) / (
        2.0 * math.sqrt(IDM_MAX_ACCEL * IDM_BRAKE)
    )
    s_star = torch.clamp(s_star, min=0.0)
    interaction = torch.where(torch.isfinite(gap), (s_star / gap) ** 2, 0.0)
    accel = IDM_MAX_ACCEL * (1.0 - (speed / v0) ** IDM_EXPONENT - interaction)
    accel = torch.clamp(accel, -2 * IDM_BRAKE, IDM_MAX_ACCEL)
    return torch.clamp(speed + accel * dt * horizon_steps, min=0.0).minimum(v0 * 1.05)


def chain_lanes_free(tmap: TensorMap, lane, branch_bits, n_lanes: int = CHAIN_LANES):
    """Chain `n_lanes` lanes from `lane`, choosing forks by the per-agent
    branch bits (2 bits per hop). Returns [..., n_lanes], -1 past a dead
    end."""
    chain, cur = [lane], lane
    for i in range(n_lanes - 1):
        succ = tmap.successors[torch.clamp(cur, min=0)]  # [..., K]
        # valid successors are front-packed, so the choice-th valid one is
        # succ[choice]
        n_ok = (succ >= 0).sum(-1)
        # the JAX package takes the shifted uint32 bits as int32 (wrapping
        # above 2^31) before the floor modulo; int64 bits do the same here
        hop = branch_bits >> (2 * i)
        hop = torch.where(hop >= 2**31, hop - 2**32, hop)
        choice = hop % torch.clamp(n_ok, min=1)
        nxt = torch.gather(succ, -1, choice[..., None])[..., 0]
        cur = torch.where((n_ok > 0) & (cur >= 0), nxt, -1)
        chain.append(cur)
    return torch.stack(chain, dim=-1)


def junction_yield(tmap: TensorMap, lane, pos, heading, speed, alive, agent_class,
                   branch_bits):
    """TrafficManager-style junction negotiation: a vehicle about to enter
    a junction connector waits while cross traffic or a walker occupies
    the junction box. Returns (approaching, blocked, dist_end) [S, A]."""
    li = torch.clamp(lane, min=0)
    on_junction = tmap.is_junction[li] & (lane >= 0)
    nxt = chain_lanes_free(tmap, lane, branch_bits, n_lanes=2)[..., 1]
    nxt_j = tmap.is_junction[torch.clamp(nxt, min=0)] & (nxt >= 0)
    s_on, _, _ = tmap.project(li, pos)
    dist_end = torch.clamp(tmap.length[li] - s_on, min=0.0)
    approaching = (
        alive & (agent_class == 0) & ~on_junction & nxt_j & (dist_end < YIELD_DIST)
    )
    P = tmap.centerline.shape[1]
    center = tmap.centerline[torch.clamp(nxt, min=0), P // 2]  # [S, A, 2]
    h_entry = tmap.headings[li, -1]  # [S, A]
    rel = center[:, :, None, :] - pos[:, None, :, :]  # other -> my box center
    inside = torch.linalg.norm(rel, dim=-1) < CONFLICT_RADIUS
    other_on_j = on_junction[:, None, :]
    dh = torch.abs(wrap_angle(heading[:, None, :] - h_entry[:, :, None]))
    crossing = (dh > torch.pi / 4) & (dh < 3 * torch.pi / 4)
    vel = speed[..., None] * torch.stack([torch.cos(heading), torch.sin(heading)], -1)
    leaving = (vel[:, None, :, :] * rel).sum(-1) < -1.0
    is_veh = (agent_class == 0) & alive
    is_walker = (agent_class == 1) & alive
    conflict = inside & ~leaving & (
        (is_veh[:, None, :] & other_on_j & crossing) | is_walker[:, None, :]
    )
    A = pos.shape[1]
    conflict &= ~torch.eye(A, dtype=torch.bool, device=pos.device)[None]
    return approaching, approaching & conflict.any(-1), dist_end


def yield_target_speed(tmap: TensorMap, state, v_target, floor: float = YIELD_FLOOR):
    """Clamp `v_target` for junction negotiation: creep toward the entry
    while the box is occupied, hold-line creep at the line."""
    _, blocked, dist_end = junction_yield(
        tmap, state.lane, state.pos, state.heading, state.speed,
        state.alive, state.agent_class, state.bv_branch_bits,
    )
    v = torch.where(blocked, torch.clamp(v_target, max=YIELD_CRAWL), v_target)
    return torch.where(blocked & (dist_end < YIELD_STOP), torch.clamp(v_target, max=floor), v)


def lane_follow_waypoints(tmap: TensorMap, lane, pos, heading, branch_bits, spacing,
                          num_points: int = LOOKAHEAD_WAYPOINTS,
                          n_chain: int = CHAIN_LANES):
    """Local-frame waypoints along the agent's lane chain -> [..., N, 2].
    `spacing` [...] places the points evenly; [..., N] is a speed profile
    (point k sits sum(spacing[..k]) meters along the chain). Lane
    centerlines are arclength-uniform, so a chain arclength maps to (lane,
    fractional vertex) by cumulative-length bucketing."""
    chain = chain_lanes_free(tmap, lane, branch_bits, n_lanes=n_chain)
    ch = torch.clamp(chain, min=0)
    lens = tmap.length[ch] * (chain >= 0)  # [..., C]
    cum = torch.cat([torch.zeros_like(lens[..., :1]), torch.cumsum(lens, -1)], -1)
    s0, _, _ = tmap.project(torch.clamp(lane, min=0), pos)
    if spacing.dim() == pos.dim() - 1:  # one spacing per agent
        spacing = spacing[..., None].expand(spacing.shape + (num_points,))
    targets = s0[..., None] + torch.cumsum(spacing, -1)  # [..., N]
    targets = torch.minimum(targets, cum[..., -1:])  # stop at the chain end
    j = torch.clamp(
        (targets[..., None] >= cum[..., None, 1:]).sum(-1), 0, chain.shape[-1] - 1
    )
    # a target at the chain's total length buckets past the last valid
    # link: pin it to that link, never to the -1 padding
    n_valid = (chain >= 0).sum(-1)
    j = torch.minimum(j, torch.clamp(n_valid - 1, min=0)[..., None])
    lane_j = torch.gather(ch, -1, j)
    u = targets - torch.gather(cum, -1, j)
    P = LANE_POINTS
    frac = torch.clamp(u / torch.clamp(tmap.length[lane_j], min=1e-3), 0.0, 1.0) * (P - 1)
    i0 = torch.clamp(frac.to(torch.int32), 0, P - 2).long()
    w = (frac - i0)[..., None]
    p0 = tmap.centerline[lane_j, i0]
    p1 = tmap.centerline[lane_j, i0 + 1]
    world_wp = p0 * (1.0 - w) + p1 * w
    rel = world_wp - pos[..., None, :]
    c = torch.cos(heading)[..., None]
    sn = torch.sin(heading)[..., None]
    return torch.stack(
        [rel[..., 0] * c + rel[..., 1] * sn, -rel[..., 0] * sn + rel[..., 1] * c], dim=-1
    )


def path_follow_waypoints(path, path_len, pos, heading, spacing,
                          num_points: int = LOOKAHEAD_WAYPOINTS):
    """Local waypoints along a dense (1 m) route polyline path [..., N, 3]
    with `path_len` [...] valid points -> [..., num_points, 2]: the rule
    ego's route following. At 1 m spacing arclength is the index, so the
    targets are fractional indices from the nearest route point on."""
    n = path.shape[-2]
    valid = torch.arange(n, device=path.device) < path_len[..., None]
    pts = path[..., :2]
    d2 = ((pts - pos[..., None, :]) ** 2).sum(-1)
    d2 = torch.where(valid, d2, torch.inf)
    i0 = torch.argmin(d2, dim=-1).float()  # first among equal distances
    last = torch.clamp(path_len - 1, min=0).float()
    steps = 1.0 + torch.arange(num_points, dtype=torch.float32, device=path.device)
    idx_f = torch.minimum(
        torch.clamp(i0[..., None] + steps * spacing[..., None], min=0.0), last[..., None]
    )
    j0 = torch.clamp(idx_f.to(torch.int32), 0, n - 2).long()
    w = (idx_f - j0)[..., None]
    take = lambda j: torch.gather(pts, -2, j[..., None].expand(j.shape + (2,)))
    world_wp = take(j0) * (1.0 - w) + take(j0 + 1) * w
    rel = world_wp - pos[..., None, :]
    c = torch.cos(heading)[..., None]
    sn = torch.sin(heading)[..., None]
    return torch.stack(
        [rel[..., 0] * c + rel[..., 1] * sn, -rel[..., 0] * sn + rel[..., 1] * c], dim=-1
    )
