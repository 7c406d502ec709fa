"""SE(2) primitives (port of rift_tpu/geometry/se2.py: what the map, the
planner's features and the evaluator use)."""

from __future__ import annotations

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi] as atan2(sin, cos)."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def rotate(points: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 2) points by angle(s) theta, broadcasting."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x * c - y * s, x * s + y * c], dim=-1)
