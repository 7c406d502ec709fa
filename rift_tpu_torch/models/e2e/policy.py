"""E2E ego policy glue: SimState -> cameras -> model -> ego_traj waypoints
(port of rift_tpu/models/e2e/policy.py). The env's shared tracker runs
the PID on the waypoints, fed through env_step's `ego_traj` like PlanT's.
"""

from __future__ import annotations

import torch

from ...ego.sensors import render_cameras
from ...sim.pid import densify_local_waypoints
from ...sim.state import ScenarioSpec, SimState

TARGET_POINT_AHEAD = 30.0  # meters along the route (the PlanT convention)


def e2e_inputs(spec: ScenarioSpec, state: SimState, tmap):
    """(cameras [S, CAM, H, W, C], target [S, 2] in the ego frame, speed [S])."""
    imgs = render_cameras(tmap, spec, state)
    cursor = torch.minimum(state.ego_route_cursor.to(torch.int32) + int(TARGET_POINT_AHEAD),
                           spec.ego_route_len - 1).long()
    tp_world = torch.gather(spec.ego_route[..., :2], 1,
                            cursor[:, None, None].expand(-1, 1, 2))[:, 0]
    rel = tp_world - state.pos[:, 0]
    h = state.heading[:, 0]
    c, s = torch.cos(-h), torch.sin(-h)
    target = torch.stack([rel[..., 0] * c - rel[..., 1] * s, rel[..., 0] * s + rel[..., 1] * c],
                         -1)
    return imgs, target, state.speed[:, 0]


@torch.no_grad()
def e2e_ego_waypoints(model, tmap, spec: ScenarioSpec, state: SimState) -> torch.Tensor:
    """[S, N, 2] ego-frame waypoints for env_step's `ego_traj`: the model's
    0.5 s predictions densified to the tracker's 0.1 s grid (no gradient:
    the serving path)."""
    imgs, target, speed = e2e_inputs(spec, state, tmap)
    return densify_local_waypoints(model(imgs, target, speed)["pred_wp"], wp_dt=0.5)
