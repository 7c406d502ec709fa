"""Stop-sign zones and stop-once-then-proceed behaviour (port of
rift_tpu/sim/stop_signs.py).

`TensorMap.stop_lane` marks lanes whose end is a stop line. An agent is
"approaching" within STOP_BRAKE_DISTANCE of the line and "in the zone"
within STOP_ZONE, where it must halt once (`SimState.stopped_at_stop`).
"""

from __future__ import annotations

import torch

from ..map.tensor_map import TensorMap

STOP_BRAKE_DISTANCE = 15.0  # start braking this far from the stop line
STOP_ZONE = 6.0  # must have halted within this distance of the line
SPEED_STOPPED = 0.1  # m/s (RunningStopTest.SPEED_THRESHOLD)
CRAWL_SPEED = 2.0  # m/s approach creep toward the stop line


def stop_zone_info(tmap: TensorMap, lane, pos):
    """(approaching, in_zone, dist) for agents bound to `lane` (...,) at
    `pos` (..., 2)."""
    is_stop = tmap.stop_lane[lane]
    dist = torch.linalg.norm(tmap.centerline[lane, -1] - pos, dim=-1)
    return is_stop & (dist < STOP_BRAKE_DISTANCE), is_stop & (dist < STOP_ZONE), dist


def stop_target_speed(tmap: TensorMap, lane, pos, stopped_latch, v_target):
    """Clamp `v_target` for stop-sign compliance: crawl while approaching
    the line, halt inside the zone until the latch sets, then resume."""
    approaching, in_zone, _ = stop_zone_info(tmap, lane, pos)
    need = ~stopped_latch
    v = torch.where(approaching & need, torch.clamp(v_target, max=CRAWL_SPEED), v_target)
    return torch.where(in_zone & need, 0.0, v)


def update_stop_memory(in_zone_prev, stopped_prev, in_zone_now, speed_now):
    """New (in_stop_zone, stopped_at_stop) [S, A]: the halt latch resets on
    zone entry and persists after exit, where the criterion reads it.
    `speed_now` is the world tick's new speed, whose subnormals the tick
    has already flushed to zero."""
    enter = in_zone_now & ~in_zone_prev
    stopped = (stopped_prev & ~enter) | (in_zone_now & (speed_now < SPEED_STOPPED))
    return in_zone_now, stopped
