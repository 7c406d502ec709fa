"""Rule-based ego: privileged route following with IDM speed control (port
of rift_tpu/ego/rule_ego.py).

The IDM target speed from the leader gap, red lights, the junction yield
and stop signs, turned into local waypoints along the scenario route for
the world tick's trajectory tracker.
"""

from __future__ import annotations

import torch

from ..sim.autopilot import find_leaders, idm_target_speed, path_follow_waypoints
from ..sim.autopilot import yield_target_speed
from ..sim.state import ScenarioSpec, SimState
from ..sim.stop_signs import stop_target_speed
from ..sim.traffic_lights import red_ahead

EGO_SPEED_DEFAULT = 8.0  # m/s cruise if the spec has none


def rule_ego_waypoints(spec: ScenarioSpec, state: SimState, dt: float = 0.1,
                       num_points: int = 30, tmap=None) -> torch.Tensor:
    """[S, N, 2] local-frame waypoints for agent slot 0 of each scenario."""
    gap, leader_speed = find_leaders(
        state.pos, state.heading, state.speed, state.shape, state.alive
    )
    v0 = torch.where(spec.ego_target_speed > 0, spec.ego_target_speed, EGO_SPEED_DEFAULT)
    v_target = idm_target_speed(state.speed[:, 0], v0, (gap[:, 0], leader_speed[:, 0]), dt)
    if tmap is not None:
        must_stop, _ = red_ahead(tmap, state.lane[:, :1], state.pos[:, :1], state.tick)
        v_target = torch.where(must_stop[:, 0], 0.0, v_target)
        # junction negotiation: the TrafficManager-style yield of slot 0
        v_all = v_target[:, None].expand(state.speed.shape)
        v_target = yield_target_speed(tmap, state, v_all)[:, 0]
        v_target = stop_target_speed(
            tmap, state.lane[:, 0], state.pos[:, 0], state.stopped_at_stop[:, 0], v_target
        )
    spacing = torch.clamp(v_target * dt, min=1e-3)
    return path_follow_waypoints(
        spec.ego_route, spec.ego_route_len, state.pos[:, 0], state.heading[:, 0],
        spacing, num_points,
    )
