"""Vehicle dynamics: kinematic bicycle with CARLA-calibrated response (port
of rift_tpu/sim/dynamics.py).

World-on-Rails fits (reference track_propogate.py:160-315): slip-angle
bicycle geometry plus throttle/brake speed polynomials in km/h.
`bicycle_step` is the full response (controlled vehicles, candidate
rollouts); `bicycle_forecast_step` the constant-accel approximation used
to forecast other vehicles. The polynomial coefficients are plain Python
floats, so the CUDA re-tracking kernel takes the same values
(ops/retrack.py passes them at launch).
"""

from __future__ import annotations

import torch

# geometry: distances from the rear axle (meters)
FRONT_WB = -0.090769015
REAR_WB = 1.4178275
STEER_GAIN = 0.36848336

# brake: next_v = sum_i coeff[i] * v^(i+1), km/h
BRAKE_POLY = (
    9.31711370e-03, 8.20967431e-02, -2.83832427e-03, 5.06587474e-05,
    -4.90357228e-07, 2.44419284e-09, -4.91381935e-12,
)
# throttle: features [v, v^2, t, t^2, v*t, v*t^2, v^2*t, v^2*t^2], km/h
THROTTLE_POLY = (
    9.63873001e-01, 4.37535692e-04, -3.80192912e-01, 1.74950069e+00,
    9.16787414e-02, -7.05461530e-02, -1.05996152e-03, 6.71079346e-04,
)
THROTTLE_MIN_EFFECT = 0.3  # below this throttle the speed holds (coasting)

# constant-accel forecast rates for other vehicles (m/s^2)
FORECAST_BRAKE_ACCEL = -4.952399
FORECAST_THROTTLE_ACCEL = 0.5633837


def _slip(steer: torch.Tensor) -> torch.Tensor:
    wheel = STEER_GAIN * steer
    return torch.atan(REAR_WB / (FRONT_WB + REAR_WB) * torch.tan(wheel))


def _poly(feats: torch.Tensor, coeffs) -> torch.Tensor:
    """feats [..., K] . coeffs [K] in f32, as the JAX package's `@`."""
    return feats @ torch.tensor(coeffs, dtype=feats.dtype, device=feats.device)


def bicycle_step(pos, heading, speed, action, dt: float = 0.1):
    """One full-response step of (pos [..., 2], heading, speed) under
    action [..., 3] (throttle, steer, brake). Returns (pos', heading',
    speed')."""
    throttle = action[..., 0]
    brake = action[..., 2] >= 0.5
    slip = _slip(action[..., 1])
    dx = speed * torch.cos(heading + slip) * dt
    dy = speed * torch.sin(heading + slip) * dt
    new_heading = heading + (speed / REAR_WB) * torch.sin(slip) * dt
    new_pos = pos + torch.stack([dx, dy], dim=-1)

    v = speed * 3.6
    v_brake = _poly(torch.stack([v ** i for i in range(1, 8)], dim=-1), BRAKE_POLY)
    t = throttle
    feats = torch.stack(
        [v, v * v, t, t * t, v * t, v * t * t, v * v * t, v * v * t * t], dim=-1
    )
    v_throttle = _poly(feats, THROTTLE_POLY)
    throttling = ~brake & (throttle >= THROTTLE_MIN_EFFECT)
    v_next = torch.where(brake, v_brake, v)
    v_next = torch.where(throttling, v_throttle, v_next)
    return new_pos, new_heading, torch.clamp(v_next / 3.6, min=0.0)


def bicycle_forecast_step(pos, heading, speed, action, dt: float = 0.1):
    """One constant-accel forecast step for other vehicles."""
    throttle = action[..., 0]
    brake = action[..., 2] >= 0.5
    slip = _slip(action[..., 1])
    dx = speed * torch.cos(heading + slip) * dt
    dy = speed * torch.sin(heading + slip) * dt
    new_heading = heading + speed / REAR_WB * torch.sin(slip) * dt
    new_pos = pos + torch.stack([dx, dy], dim=-1)
    accel = torch.where(brake, FORECAST_BRAKE_ACCEL, throttle * FORECAST_THROTTLE_ACCEL)
    return new_pos, new_heading, torch.clamp(speed + dt * accel, min=0.0)
