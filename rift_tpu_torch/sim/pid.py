"""Stateless batched PID + trajectory-tracking controller (port of
rift_tpu/sim/pid.py).

Controller semantics of the reference tracker (pid_controller.py:14-100):
waypoints resampled every `sample_interval` steps, desired speed = mean
resampled segment length; aim point = the waypoint whose distance is
closest to clip(0.5 v + 2.5, 5, 8) m; brake below 0.4 m/s desired or
above 1.1x it; steering from the aim-point angle (degrees / 90), zeroed
when braking or stopped; speed PID (5, .5, 1), turn PID (1.25, .75, .3),
window 20. The CUDA re-tracking kernel (ops/retrack.py) takes these
constants at launch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.tensors import TensorDataclass

PID_WINDOW = 20

SPEED_KP, SPEED_KI, SPEED_KD = 5.0, 0.5, 1.0
TURN_KP, TURN_KI, TURN_KD = 1.25, 0.75, 0.3

MAX_THROTTLE = 1.0
BRAKE_SPEED = 0.4
BRAKE_RATIO = 1.1
CLIP_DELTA = 1.0
AIM_ALPHA, AIM_BETA = 0.5, 2.5
MIN_AIM_DIS, MAX_AIM_DIS = 5.0, 8.0


@dataclass
class PIDState(TensorDataclass):
    """Ring buffer of recent errors; all fields share leading batch shape."""

    buf: torch.Tensor  # [..., PID_WINDOW]
    ptr: torch.Tensor  # [...]
    count: torch.Tensor  # [...]

    @classmethod
    def zeros(cls, batch_shape: tuple = (), device=None) -> "PIDState":
        return cls(
            buf=torch.zeros(batch_shape + (PID_WINDOW,), device=device),
            ptr=torch.zeros(batch_shape, dtype=torch.long, device=device),
            count=torch.zeros(batch_shape, dtype=torch.long, device=device),
        )

    def reset_where(self, mask) -> "PIDState":
        """Zero the controllers where `mask` holds (fresh CBVs)."""
        return PIDState(
            buf=torch.where(mask[..., None], 0.0, self.buf),
            ptr=torch.where(mask, 0, self.ptr),
            count=torch.where(mask, 0, self.count),
        )


@dataclass
class TrackerState(TensorDataclass):
    """Per-vehicle trajectory tracker (speed PID + turn PID)."""

    speed: PIDState
    turn: PIDState

    @classmethod
    def zeros(cls, batch_shape: tuple = (), device=None) -> "TrackerState":
        return cls(
            PIDState.zeros(batch_shape, device), PIDState.zeros(batch_shape, device)
        )

    def reset_where(self, mask) -> "TrackerState":
        return TrackerState(self.speed.reset_where(mask), self.turn.reset_where(mask))


def pid_step(state: PIDState, error, kp: float, ki: float, kd: float):
    """One PID update. The window is pre-filled with zeros, so the integral
    is the mean over the full window and the derivative is
    `error - previous_error` (0 before the first step)."""
    idx = state.ptr
    prev = torch.gather(state.buf, -1, ((idx - 1) % PID_WINDOW)[..., None])[..., 0]
    slot = torch.arange(PID_WINDOW, device=idx.device) == idx[..., None]
    buf = torch.where(slot, error[..., None], state.buf)
    integral = buf.sum(-1) / float(PID_WINDOW)
    out = kp * error + ki * integral + kd * (error - prev)
    return out, PIDState(
        buf=buf,
        ptr=(idx + 1) % PID_WINDOW,
        count=torch.clamp(state.count + 1, max=PID_WINDOW),
    )


def densify_local_waypoints(wp, wp_dt: float = 0.5, dt: float = 0.1,
                            num_points: int = 30):
    """Sparse planner waypoints [..., K, 2] (the first at t = wp_dt) -> the
    tracker's dt-per-point trajectory [..., num_points, 2]: linear between
    knots, constant-velocity extrapolation past the last one (the tracker
    reads desired speed from the spacing, so padding with the last point
    would read as "stop")."""
    K = wp.shape[-2]
    knots = torch.cat([torch.zeros_like(wp[..., :1, :]), wp], dim=-2)
    t = (torch.arange(num_points, dtype=torch.float32, device=wp.device) + 1.0) * dt / wp_dt
    idx = torch.clamp(torch.floor(t).long(), 0, K - 1)
    frac = (t - idx)[:, None]  # > 1 past the last knot: extrapolation
    p0, p1 = knots[..., idx, :], knots[..., idx + 1, :]
    return p0 + frac * (p1 - p0)


def extend_path(wp, n: int):
    """Pad [..., T, 2] waypoints to n points by extrapolating the last
    segment (constant velocity): the tracker's desired speed averages the
    segments of the whole window, which repetition would deflate; a
    stationary tail extrapolates to more stationary points."""
    T = wp.shape[-2]
    if T >= n:
        return wp[..., :n, :]
    if T < 2:
        return torch.cat([wp] + [wp[..., -1:, :]] * (n - T), dim=-2)
    delta = wp[..., -1:, :] - wp[..., -2:-1, :]
    k = torch.arange(1, n - T + 1, dtype=wp.dtype, device=wp.device)[:, None]
    return torch.cat([wp, wp[..., -1:, :] + delta * k], dim=-2)


def track_step(state: TrackerState, local_waypoints, speed, sample_interval: int = 10):
    """One control step of the trajectory tracker: `local_waypoints`
    [..., T, 2] in the vehicle frame (x forward), `speed` [...]. Returns
    (action [..., 3] = throttle/steer/brake, new state)."""
    T = local_waypoints.shape[-2]
    if T >= sample_interval:
        wp = local_waypoints[..., sample_interval - 1 :: sample_interval, :]
    else:
        wp = local_waypoints[..., -1:, :]
    if wp.shape[-2] > 1:
        seg = wp[..., 1:, :] - wp[..., :-1, :]
        desired_v = torch.linalg.norm(seg, dim=-1).mean(-1)
        aim_dist = torch.clamp(AIM_ALPHA * speed + AIM_BETA, MIN_AIM_DIS, MAX_AIM_DIS)
        norms = torch.linalg.norm(wp[..., :-1, :], dim=-1)
        # first index among equal distances, as jnp.argmin
        idx = torch.argmin(torch.abs(norms - aim_dist[..., None]), dim=-1)
        aim = torch.gather(wp, -2, idx[..., None, None].expand(idx.shape + (1, 2)))[
            ..., 0, :
        ]
    else:
        desired_v = torch.zeros_like(speed)
        aim = wp[..., 0, :]

    brake = (desired_v < BRAKE_SPEED) | (
        speed / torch.clamp(desired_v, min=1e-4) > BRAKE_RATIO
    )
    delta = torch.clamp(desired_v - speed, 0.0, CLIP_DELTA)
    throttle, speed_pid = pid_step(state.speed, delta, SPEED_KP, SPEED_KI, SPEED_KD)
    throttle = torch.clamp(throttle, 0.0, MAX_THROTTLE) * (~brake)

    angle = torch.rad2deg(torch.atan2(aim[..., 1], aim[..., 0])) / 90.0
    angle = torch.where((speed < 0.01) | brake, 0.0, angle)
    steer, turn_pid = pid_step(state.turn, angle, TURN_KP, TURN_KI, TURN_KD)
    steer = torch.clamp(steer, -1.0, 1.0)
    action = torch.stack([throttle, steer, brake.float()], dim=-1)
    return action, TrackerState(speed=speed_pid, turn=turn_pid)
