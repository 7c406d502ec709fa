"""Traffic-light state machine (port of rift_tpu/sim/traffic_lights.py).

Each junction approach (TensorMap.light_group) alternates green / yellow /
red with the opposing axis; the phase is a pure function of the tick.
"""

from __future__ import annotations

import torch

from ..map.tensor_map import TensorMap

GREEN, YELLOW, RED = 0, 1, 2
GREEN_TICKS = 100  # 10 s @ 10 fps
YELLOW_TICKS = 20  # 2 s
AXIS_CYCLE = GREEN_TICKS + YELLOW_TICKS  # one axis holds right-of-way
FULL_CYCLE = 2 * AXIS_CYCLE
STOP_DISTANCE = 15.0  # start braking for a red this far from the stop line


def group_state(group: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    """Light state of light-group ids (any shape) at `tick` (broadcast);
    axis 0 (even groups) holds green during the first half cycle."""
    phase = tick % FULL_CYCLE
    local = torch.where(group % 2 == 0, phase, (phase + AXIS_CYCLE) % FULL_CYCLE)
    state = torch.where(
        local < GREEN_TICKS,
        GREEN,
        torch.where(local < AXIS_CYCLE, YELLOW, RED),
    )
    return torch.where(group < 0, GREEN, state)


def lane_light_state(tmap: TensorMap, tick: torch.Tensor) -> torch.Tensor:
    """[..., L] light state of every lane at tick [...] (GREEN if
    unsignalised)."""
    return group_state(tmap.light_group, tick[..., None])


def red_ahead(tmap: TensorMap, lane, pos, tick):
    """(must_stop [S, A], dist_to_stop_line [S, A]) for lane [S, A], pos
    [S, A, 2], tick [S]: stop when every signalised successor shows red or
    yellow and the lane end is within STOP_DISTANCE; agents inside a
    signalised connector never stop (they clear the junction)."""
    succ = tmap.successors[lane]  # [S, A, K]
    succ_group = torch.where(succ >= 0, tmap.light_group[torch.clamp(succ, min=0)], -1)
    succ_state = group_state(succ_group, tick[:, None, None])
    signalised = succ_group >= 0
    blocked = signalised & (succ_state != GREEN)
    all_blocked = signalised.any(-1) & (blocked | ~signalised).all(-1)
    dist = torch.linalg.norm(tmap.centerline[lane, -1] - pos, dim=-1)
    on_connector = tmap.light_group[lane] >= 0
    return all_blocked & (dist < STOP_DISTANCE) & ~on_connector, dist


def ego_red_light_entry(tmap: TensorMap, prev_lane, new_lane, tick):
    """[S] bool: the ego (lanes [S] before and after the step) just entered
    a signalised connector on red (the RunningRedLightTest event)."""
    group = tmap.light_group[new_lane]
    entered = (new_lane != prev_lane) & (group >= 0)
    return entered & (group_state(group, tick) == RED)
