"""The world tick's autopilot target (port of rift_tpu/sim/world.py:
`autopilot_steady_speed` only, the teacher's target speed; the tick
itself comes with the next slice)."""

from __future__ import annotations

import torch

from ..map.tensor_map import TensorMap
from .autopilot import IDM_BRAKE, IDM_MIN_GAP, TM_SPEED_FACTOR, find_leaders, yield_target_speed
from .state import SimState
from .stop_signs import stop_target_speed
from .traffic_lights import red_ahead


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
    must_stop, _ = red_ahead(tmap, state.lane, state.pos, state.tick)
    v_target = torch.where(must_stop, 0.0, v_target)
    v_target = yield_target_speed(tmap, state, v_target)
    return stop_target_speed(tmap, state.lane, state.pos, state.stopped_at_stop, v_target)
