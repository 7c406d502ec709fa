"""Closed-loop re-tracking of GRPO candidates (port of
rift_tpu/ops/retrack.py).

`retrack_rollout` runs the hand-written CUDA kernel (`csrc/retrack.cu`,
the port of the TPU kernel `retrack_rollout_pallas`) on CUDA tensors and
its plain PyTorch version `retrack_rollout_ref` on CPU tensors; there is
no fallback from one to the other. The plain version is the JAX package's
`lax.scan` path of `rollout_candidates` (rl/evaluator.py:179-204): each
of G candidate paths is followed for T-1 steps by the shared PID tracker
(sim/pid.py:track_step) and the bicycle model (sim/dynamics.py). The
kernel takes the tracker's and the model's constants from those modules
at launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..geometry.se2 import rotate
from ..sim import dynamics, pid

FUTURE_LEN = 30  # tracker lookahead points (the kernel's aim offsets 9/19/29)
MAX_T = 256

# kernel launches since the counter was last set to 0
launches = 0


def retrack_rollout_ref(ref_pos, init_heading, init_speed, dt: float = 0.1):
    """Plain PyTorch version: ref_pos [G, T, 2] world-frame candidate
    points, init_heading [G], init_speed [G] -> (center [G, T, 2], heading
    [G, T], speed [G, T]), row 0 the start."""
    G, T = ref_pos.shape[:2]
    dev = ref_pos.device
    pos, heading, speed = ref_pos[:, 0], init_heading, init_speed
    tracker = pid.TrackerState.zeros((G,), device=dev)
    closest = torch.zeros(G, dtype=torch.long, device=dev)
    ahead = torch.arange(FUTURE_LEN, device=dev)
    outs = [(pos, heading, speed)]
    for _ in range(T - 1):
        idx = torch.clamp(closest[:, None] + ahead, max=T - 1)
        pts = torch.gather(ref_pos, 1, idx[..., None].expand(G, FUTURE_LEN, 2))
        local = rotate(pts - pos[:, None], -heading[:, None])
        action, tracker = pid.track_step(tracker, local, speed)
        pos, heading, speed = dynamics.bicycle_step(pos, heading, speed, action, dt)
        d2 = ((ref_pos - pos[:, None]) ** 2).sum(-1)
        closest = torch.argmin(d2, dim=-1)  # first index among equal minima
        outs.append((pos, heading, speed))
    center, head, spd = (torch.stack(x, dim=1) for x in zip(*outs))
    return center, head, spd


@functools.lru_cache(maxsize=None)
def _constants(dt: float):
    """The kernel's constants, in the order of csrc/retrack.cu's enum: one
    ctypes array per dt, built on first use (the kernel copies it at each
    launch)."""
    d = dynamics
    vals = (
        dt,
        pid.SPEED_KP, pid.SPEED_KI, pid.SPEED_KD,
        pid.TURN_KP, pid.TURN_KI, pid.TURN_KD,
        pid.MAX_THROTTLE, pid.BRAKE_SPEED, pid.BRAKE_RATIO, pid.CLIP_DELTA,
        pid.AIM_ALPHA, pid.AIM_BETA, pid.MIN_AIM_DIS, pid.MAX_AIM_DIS,
        d.REAR_WB / (d.FRONT_WB + d.REAR_WB), d.REAR_WB, d.STEER_GAIN,
        d.THROTTLE_MIN_EFFECT, *d.BRAKE_POLY, *d.THROTTLE_POLY,
    )
    return (ctypes.c_float * len(vals))(*vals)


def retrack_rollout(ref_pos, init_heading, init_speed, dt: float = 0.1):
    """[G, T, 2], [G], [G] -> (center [G, T, 2], heading [G, T], speed
    [G, T]). The CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if ref_pos.device.type == "cpu":
        return retrack_rollout_ref(ref_pos, init_heading, init_speed, dt)
    if ref_pos.device.type != "cuda":
        raise ValueError(f"retrack_rollout: unsupported device {ref_pos.device}")
    if pid.PID_WINDOW != 20:
        raise ValueError("retrack_rollout: the kernel's PID window is 20")
    G, T = ref_pos.shape[:2]
    if ref_pos.shape != (G, T, 2) or init_heading.shape != (G,) or init_speed.shape != (G,):
        raise ValueError(
            f"retrack_rollout: ref_pos {tuple(ref_pos.shape)}, heading "
            f"{tuple(init_heading.shape)}, speed {tuple(init_speed.shape)}"
        )
    if not 1 <= T <= MAX_T:
        raise ValueError(f"retrack_rollout: T={T} outside 1..{MAX_T}")
    for t in (ref_pos, init_heading, init_speed):
        if t.device != ref_pos.device or not t.is_contiguous():
            raise ValueError("retrack_rollout: inputs must be contiguous on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"retrack_rollout: {t.dtype} input, f32 expected")
    center = torch.empty((G, T, 2), dtype=torch.float32, device=ref_pos.device)
    heading = torch.empty((G, T), dtype=torch.float32, device=ref_pos.device)
    speed = torch.empty((G, T), dtype=torch.float32, device=ref_pos.device)
    consts = _constants(dt)
    err = _lib().rift_retrack_fwd(
        ref_pos.data_ptr(), init_heading.data_ptr(), init_speed.data_ptr(),
        center.data_ptr(), heading.data_ptr(), speed.data_ptr(), G, T,
        consts, len(consts), torch.cuda.current_stream(ref_pos.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"retrack kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return center, heading, speed


def _lib():
    from .build import load

    lib = load("retrack")
    fn = lib.rift_retrack_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I, I, ctypes.POINTER(ctypes.c_float), I, P]
        fn.restype = ctypes.c_int
    return lib
