"""PID tracker state (port of rift_tpu/sim/pid.py, state containers only;
the tracking step comes with the world tick)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.tensors import TensorDataclass

PID_WINDOW = 20


@dataclass
class PIDState(TensorDataclass):
    """Ring buffer of recent errors; all fields share leading batch shape."""

    buf: torch.Tensor  # [..., PID_WINDOW]
    ptr: torch.Tensor  # [...]
    count: torch.Tensor  # [...]


@dataclass
class TrackerState(TensorDataclass):
    """Per-vehicle trajectory tracker (speed PID + turn PID)."""

    speed: PIDState
    turn: PIDState
