"""SE(2) rigid-transform primitives (port of rift_tpu/geometry/se2.py).

Everything broadcasts over leading batch dims; poses are (..., 3) tensors
[x, y, heading].
"""

from __future__ import annotations

import torch


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to (-pi, pi] as atan2(sin, cos)."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def rotation_matrix(theta: torch.Tensor) -> torch.Tensor:
    """(...,) angles -> (..., 2, 2) matrices R such that R @ v rotates a
    column vector by +theta."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def rotate(points: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 2) points by angle(s) theta, broadcasting."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x * c - y * s, x * s + y * c], dim=-1)


def global_to_local(points, origin, heading) -> torch.Tensor:
    """Global (..., 2) points in the frame at `origin` with `heading`."""
    return rotate(points - origin, -heading)


def local_to_global(points, origin, heading) -> torch.Tensor:
    """Inverse of `global_to_local`."""
    return rotate(points, heading) + origin


def se2_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b of (..., 3) poses: b applied in a's frame."""
    xy = a[..., :2] + rotate(b[..., :2], a[..., 2])
    th = wrap_angle(a[..., 2] + b[..., 2])
    return torch.cat([xy, th[..., None]], dim=-1)


def se2_inverse(a: torch.Tensor) -> torch.Tensor:
    """The pose whose composition with `a` is the identity."""
    return torch.cat([rotate(-a[..., :2], -a[..., 2]), -a[..., 2:3]], dim=-1)
