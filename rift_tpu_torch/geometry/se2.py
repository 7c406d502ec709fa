"""SE(2) primitives (port of rift_tpu/geometry/se2.py: what the map and
the planner's features use)."""

from __future__ import annotations

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi] as atan2(sin, cos)."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))
