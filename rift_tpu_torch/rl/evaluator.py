"""Trajectory evaluator: candidate rollout, dense reward and GRPO advantage
(port of rift_tpu/rl/evaluator.py: the constants, `dense_reward`,
`sparse_reward`, `executed_cbv_reward`, `rollout_candidates`,
`derive_kinematics`, `forecast_neighbors`, `ref_line_matrices`,
`grpo_advantage_batched` and its single-CBV wrapper `grpo_advantage`).

    candidates [B, R, M, T, 6] (local frame)
      -> ref-line distance and angle          (ops/refline.py, kernel 4)
      -> PID + bicycle re-tracking, 40 steps  (ops/retrack.py, kernel 3)
      -> neighbour constant-control forecast
      -> all-pairs OBB collision matrix, raster off-road test
      -> dense reward, discounted return (gamma 0.98, stop at collision)
      -> group z-score advantage per CBV

The two kernels run on CUDA tensors; on CPU tensors their plain versions
do. The collision matrix and the off-road test are plain torch, as they
are plain XLA in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.obb import obb_overlap
from ..geometry.se2 import rotate, wrap_angle
from ..map.tensor_map import TensorMap
from ..ops.refline import refline_matrices
from ..ops.retrack import retrack_rollout
from ..sim.dynamics import bicycle_forecast_step
from ..utils.tensors import flush_subnormals as _ftz

GAMMA = 0.98
NUM_FRAMES = 40  # evaluator horizon (traj_evaluator.py:86 num_frames)
BBOX_INFLATION = 1.1

# neighbour bbox inflation schedule (PDM-Lite forecasting uncertainty)
SLOW_EXTENT_FACTOR = 1.0
SPEED_THRESHOLD = 1.0
MIN_EXTENT_X = 1.2
MIN_EXTENT_X_LANE_CHANGE = 2.0
MIN_EXTENT_Y = 1.0
EXTENT_Y_FACTOR = 1.3

# dense reward (reward_model.py:34-50)
REWARD_PARAMS = dict(
    alpha_collision=20.0,
    alpha_boundary=5.0,
    alpha_comfort=0.8,
    alpha_l_align=0.5,
    alpha_vel_align=0.05,
    alpha_l_center=0.6,
    alpha_center_bias=0.0,
    alpha_velocity=0.1,
    alpha_timestep=0.1,
)

def dense_reward(delta_dis, delta_angle, speed, acc, angular_vel, angular_acc,
                 collision, offroad, p=REWARD_PARAMS, components=False):
    """The RIFT dense reward, elementwise over broadcastable tensors;
    delta_dis and delta_angle are absolute values. With `components`, a
    dict of its seven terms instead of their sum (diagnostics)."""
    cos_a = torch.cos(delta_angle)
    r_collision = -(p["alpha_collision"] + torch.abs(speed)) * collision
    r_offroad = -p["alpha_boundary"] * offroad
    r_comfort = -p["alpha_comfort"] * (
        (torch.abs(acc) > 4).float() + (torch.abs(angular_acc) > 4).float()
    )
    r_align = p["alpha_l_align"] * (
        torch.clamp(cos_a, max=0.0)
        + p["alpha_vel_align"] * torch.clamp(cos_a * speed, max=0.0)
        + 0.25 * (1.0 - torch.abs(delta_angle) / (torch.pi / 2))
    )
    dev = torch.abs(delta_dis - p["alpha_center_bias"])
    r_center = -p["alpha_l_center"] * (cos_a > 0.5).float() * (dev - 0.05 / torch.exp(dev - 0.5))
    in_band = (torch.abs(speed) > 3) & (torch.abs(speed) < 20)
    r_velocity = (
        p["alpha_velocity"] * torch.clamp(cos_a, min=0.0) * in_band.float() * torch.abs(speed)
    )
    moving = (torch.abs(speed) > 0) | (torch.abs(acc) > 0)
    r_time = -p["alpha_timestep"] * moving.float()
    if components:
        return {
            "collision": r_collision, "offroad": r_offroad, "comfort": r_comfort,
            "align": r_align, "center": r_center, "velocity": r_velocity, "time": r_time,
        }
    return r_collision + r_offroad + r_comfort + r_align + r_center + r_velocity + r_time


def sparse_reward(collision, offroad, alpha_collision=15.0, alpha_boundary=15.0):
    """The sparse infraction reward (reward_model.py:60-85)."""
    return -alpha_collision * collision - alpha_boundary * offroad


def executed_cbv_reward(tmap: TensorMap, state, slots):
    """[S, C] dense reward of the executed transition of the CBV slots
    (the env reward a fine-tune round stores per tick): lane-relative
    alignment stands in for the reference-line projection; the events come
    from the world tick. Padded slots (-1) get 0."""
    scen = torch.arange(slots.shape[0], device=slots.device)[:, None]
    sl = torch.clamp(slots, min=0)
    _, lat, lane_hdg = tmap.project(state.lane[scen, sl], state.pos[scen, sl])
    r = dense_reward(
        torch.abs(lat),
        torch.abs(wrap_angle(state.heading[scen, sl] - lane_hdg)),
        state.speed[scen, sl],
        state.accel[scen, sl],
        state.yaw_rate[scen, sl],
        torch.zeros_like(lat),
        state.collision[scen, sl].float(),
        state.offroad[scen, sl].float(),
    )
    return torch.where(slots >= 0, r, 0.0)


def rollout_candidates(ref_pos, ref_heading, init_speed, dt: float = 0.1,
                       num_frames: int = NUM_FRAMES):
    """Re-track each candidate (ref_pos [G, T, 2] world frame, ref_heading
    [G, T] of which the start is read, init_speed [G] or scalar) with the
    shared PID + bicycle model: the CUDA kernel on the card, its plain
    version on the CPU. Returns (center [G, Tr, 2], heading [G, Tr], speed
    [G, Tr])."""
    G = ref_pos.shape[0]
    v0 = torch.as_tensor(init_speed, dtype=torch.float32, device=ref_pos.device)
    return retrack_rollout(
        ref_pos[:, :num_frames].contiguous(),
        ref_heading[:, 0].contiguous(),
        v0.expand(G).contiguous(),
        dt,
    )


def _sg_matrix(T: int) -> np.ndarray:
    """[T, T] reflect-padded window-5 Savitzky-Golay smoothing (order 2)."""
    k = np.array([-3.0, 12.0, 17.0, 12.0, -3.0]) / 35.0
    M = np.zeros((T, T), np.float32)
    for i in range(T):
        for j, kv in enumerate(k):
            src = i + j - 2
            if src < 0:
                src = -src
            elif src >= T:
                src = 2 * T - 2 - src
            M[i, src] += kv
    return M


def _diff_matrix(T: int):
    """[T, T] unscaled difference operator D and per-row scale so that
    (x @ D.T) * scale / dt is the one-sided/central difference."""
    D = np.zeros((T, T), np.float32)
    scale = np.empty(T, np.float32)
    D[0, 1], D[0, 0], scale[0] = 1.0, -1.0, 1.0
    D[T - 1, T - 1], D[T - 1, T - 2], scale[T - 1] = 1.0, -1.0, 1.0
    for i in range(1, T - 1):
        D[i, i + 1], D[i, i - 1], scale[i] = 1.0, -1.0, 0.5
    return D, scale


def derive_kinematics(heading, speed, dt: float = 0.1):
    """(smoothed speed, accel, yaw rate, yaw accel) from heading and speed
    sequences [..., T], as [T, T] matrix products, subnormals flushed."""
    T = speed.shape[-1]
    dev = speed.device
    S = torch.from_numpy(_sg_matrix(T)).to(dev)
    D, dscale = _diff_matrix(T)
    D = torch.from_numpy(D).to(dev)
    dscale = torch.from_numpy(dscale).to(dev) / dt
    speed_s = _ftz(_ftz(speed) @ S.T)
    accel = _ftz(_ftz(speed_s @ D.T) * dscale)
    heading_s = _ftz(_ftz(heading) @ S.T)
    yaw_rate = _ftz(wrap_angle(_ftz(heading_s @ D.T)) * dscale)
    yaw_accel = _ftz(_ftz(yaw_rate @ D.T) * dscale)
    return speed_s, accel, yaw_rate, yaw_accel


def forecast_neighbors(pos, heading, speed, control, shape, valid,
                       num_frames: int = NUM_FRAMES, near_lane_change: bool = True):
    """Constant-control bicycle forecast with speed-inflated boxes over any
    leading batch: pos [..., N, 2], heading/speed [..., N], control
    [..., N, 3], shape [..., N, 2]. Returns (centers [..., N, Tr, 2],
    headings [..., N, Tr], shapes [..., N, Tr, 2], valid)."""
    steps = [(pos, heading, speed)]
    for _ in range(num_frames):
        steps.append(bicycle_forecast_step(*steps[-1], control))
    ps, hs, vs = zip(*steps[1:])
    centers = torch.stack(ps, dim=-2)
    headings = torch.stack(hs, dim=-1)
    speeds = torch.stack(vs, dim=-1)
    t_frac = torch.arange(num_frames, dtype=torch.float32, device=pos.device) / num_frames
    sx = MIN_EXTENT_X_LANE_CHANGE if near_lane_change else MIN_EXTENT_X
    fx = torch.clamp(MIN_EXTENT_X * t_frac, min=sx)
    fy = torch.clamp(EXTENT_Y_FACTOR * t_frac, min=MIN_EXTENT_Y)
    slow = speeds < SPEED_THRESHOLD
    fx_t = torch.where(slow, SLOW_EXTENT_FACTOR, fx)
    fy_t = torch.where(slow, SLOW_EXTENT_FACTOR, fy)
    shapes = (
        torch.stack([shape[..., None, 0] * fy_t, shape[..., None, 1] * fx_t], dim=-1)
        * BBOX_INFLATION
    )
    return centers, headings, shapes, valid


def ref_line_matrices(cand_pos, cand_heading, ref_pos, ref_heading, ref_valid):
    """Signed lateral offset and heading error of each candidate point
    (cand_pos [R, M, T, 2], cand_heading [R, M, T], local frame) against
    its own reference line (ref_pos [R, Nr, 2], ref_heading [R, Nr],
    ref_valid [R, Nr]) -> (delta_dis, delta_angle) [R, M, T]: one launch of
    the reference-line kernel on CUDA tensors, its plain version on CPU
    tensors."""
    R, M, T, _ = cand_pos.shape
    dd, da = refline_matrices(
        cand_pos.reshape(R, M * T, 2).contiguous(),
        cand_heading.reshape(R, M * T).contiguous(),
        ref_pos.contiguous(), ref_heading.contiguous(), ref_valid.contiguous(),
    )
    return dd.reshape(R, M, T), da.reshape(R, M, T)


def grpo_advantage_batched(
    tmap: TensorMap,
    trajectories,  # [B, R, M, T, 6] local-frame model output
    r_valid,  # [B, R] valid reference lines
    ref_pos,  # [B, R, Nr, 2] local-frame reference lines
    ref_heading,  # [B, R, Nr]
    ref_point_valid,  # [B, R, Nr]
    center_pos,  # [B, 2] world position of each CBV
    center_heading,  # [B]
    center_speed,  # [B]
    center_shape,  # [B, 2] width, length
    nbr_pos,  # [B, N, 2] world neighbour states
    nbr_heading,  # [B, N]
    nbr_speed,  # [B, N]
    nbr_control,  # [B, N, 3]
    nbr_shape,  # [B, N, 2]
    nbr_valid,  # [B, N]
    dt: float = 0.1,
    num_frames: int = NUM_FRAMES,
    debug: bool = False,
):
    """Group-relative advantage of every candidate of B CBVs. The
    re-tracking runs once over the flattened [B*R*M] candidates (one
    kernel launch) and the ref-line matrices once over the [B*R] (CBV,
    line) pairs (one kernel launch). Returns {"advantage", "valid_mask",
    "rollout_return"} each [B, R, M]; with `debug` also each candidate's
    discounted sum of every reward term (`dbg_collision`, `dbg_offroad`,
    `dbg_comfort`, `dbg_align`, `dbg_center`, `dbg_velocity`, `dbg_time`)
    and its rollout's `dbg_collided`, `dbg_offroad_frac`, `dbg_mean_speed`
    and `dbg_mean_absdd`."""
    B, R, M = trajectories.shape[:3]
    G = R * M
    Tn = num_frames
    traj = trajectories[:, :, :, :Tn]
    cand_pos_local = traj[..., :2]
    cand_heading_local = torch.atan2(traj[..., 3], traj[..., 2])

    # 1. ref-line matrices in the local frame
    Nr = ref_pos.shape[2]
    dd, da = refline_matrices(
        cand_pos_local.reshape(B * R, M * Tn, 2).contiguous(),
        cand_heading_local.reshape(B * R, M * Tn).contiguous(),
        ref_pos.reshape(B * R, Nr, 2).contiguous(),
        ref_heading.reshape(B * R, Nr).contiguous(),
        ref_point_valid.reshape(B * R, Nr).contiguous(),
    )
    delta_dis = torch.abs(dd).reshape(B, G, Tn)
    delta_angle = torch.abs(da).reshape(B, G, Tn)

    # 2. candidates to the world frame, anchored at the CBV pose (first
    #    point forced to the origin)
    flat_pos = cand_pos_local.reshape(B, G, Tn, 2)
    flat_pos = flat_pos - flat_pos[:, :, :1]
    world_pos = rotate(flat_pos, center_heading[:, None, None]) + center_pos[:, None, None]
    world_heading = cand_heading_local.reshape(B, G, Tn) + center_heading[:, None, None]

    # 3. PID re-tracking over the flattened [B*G] candidates
    roll_pos, roll_heading, roll_speed = rollout_candidates(
        world_pos.reshape(B * G, Tn, 2),
        world_heading.reshape(B * G, Tn),
        center_speed.repeat_interleave(G),
        dt,
        Tn,
    )
    roll_speed, roll_acc, roll_yaw_rate, roll_yaw_acc = derive_kinematics(
        roll_heading, roll_speed, dt
    )
    roll_pos = roll_pos.reshape(B, G, Tn, 2)
    roll_heading = roll_heading.reshape(B, G, Tn)
    roll_speed, roll_acc, roll_yaw_rate, roll_yaw_acc = (
        x.reshape(B, G, Tn) for x in (roll_speed, roll_acc, roll_yaw_rate, roll_yaw_acc)
    )

    # 4. neighbour forecast
    nb_center, nb_heading, nb_shape, nb_valid = forecast_neighbors(
        nbr_pos, nbr_heading, nbr_speed, nbr_control, nbr_shape, nbr_valid, Tn
    )

    # 5. collision matrix [B, G, Tr]
    N = nb_center.shape[1]
    hit = obb_overlap(
        roll_pos[:, :, None],  # [B, G, 1, Tr, 2]
        roll_heading[:, :, None],
        center_shape[:, None, None, None],
        nb_center[:, None],  # [B, 1, N, Tr, 2]
        nb_heading[:, None],
        nb_shape[:, None],
    )  # [B, G, N, Tr]
    hit = hit & nb_valid[:, None, :, None]
    collision = hit.any(dim=2)

    # 6. off-road: raster lookup
    offroad = ~tmap.on_road_raster(roll_pos.reshape(-1, 2)).reshape(B, G, Tn)

    # 7. reward -> discounted return, zeroed after the first collision (the
    #    colliding step itself still counts)
    r = dense_reward(
        delta_dis, delta_angle, roll_speed, roll_acc, roll_yaw_rate, roll_yaw_acc,
        collision.float(), offroad.float(),
    )
    hits = torch.cumsum(collision.int(), dim=-1)[..., :-1] > 0
    collided_before = torch.cat([torch.zeros_like(hits[..., :1]), hits], dim=-1)
    discount = GAMMA ** torch.arange(Tn, dtype=torch.float32, device=r.device)
    ret = torch.sum(r * (~collided_before) * discount, dim=-1)  # [B, G]

    # 8. group z-score over the valid candidates of each CBV
    cand_valid = r_valid[:, :, None].expand(B, R, M).reshape(B, G)
    n = torch.clamp(cand_valid.sum(-1, keepdim=True), min=1)
    mean = torch.sum(ret * cand_valid, -1, keepdim=True) / n
    var = torch.sum((ret - mean) ** 2 * cand_valid, -1, keepdim=True) / n
    adv = (ret - mean) / (torch.sqrt(var) + 1e-5)
    out = {
        "advantage": (adv * cand_valid).reshape(B, R, M),
        "valid_mask": cand_valid.reshape(B, R, M),
        "rollout_return": (ret * cand_valid).reshape(B, R, M),
    }
    if debug:
        comps = dense_reward(
            delta_dis, delta_angle, roll_speed, roll_acc, roll_yaw_rate, roll_yaw_acc,
            collision.float(), offroad.float(), components=True,
        )
        for k, v in comps.items():
            out[f"dbg_{k}"] = torch.sum(v * ((~collided_before) * discount),
                                        dim=-1).reshape(B, R, M)
        out["dbg_collided"] = collision.any(-1).reshape(B, R, M)
        out["dbg_offroad_frac"] = offroad.float().mean(-1).reshape(B, R, M)
        out["dbg_mean_speed"] = roll_speed.mean(-1).reshape(B, R, M)
        out["dbg_mean_absdd"] = delta_dis.mean(-1).reshape(B, R, M)
    return out


def grpo_advantage(tmap: TensorMap, trajectories, r_valid, ref_pos, ref_heading,
                   ref_point_valid, center_pos, center_heading, center_speed, center_shape,
                   nbr_pos, nbr_heading, nbr_speed, nbr_control, nbr_shape, nbr_valid,
                   dt: float = 0.1, num_frames: int = NUM_FRAMES):
    """`grpo_advantage_batched` for one CBV (B = 1): trajectories [R, M, T,
    6], r_valid [R], ref_* [R, Nr(, 2)], center_* [2] or [], nbr_* [N, ...].
    Returns {"advantage", "valid_mask", "rollout_return"} each [R, M]."""
    args = (trajectories, r_valid, ref_pos, ref_heading, ref_point_valid, center_pos,
            center_heading, center_speed, center_shape, nbr_pos, nbr_heading, nbr_speed,
            nbr_control, nbr_shape, nbr_valid)
    out = grpo_advantage_batched(tmap, *(torch.as_tensor(a)[None] for a in args), dt=dt,
                                 num_frames=num_frames)
    return {k: v[0] for k, v in out.items()}
