"""Oriented bounding boxes: corners and the separating-axis overlap test
(port of rift_tpu/geometry/obb.py).

Box shapes are [width, length]. Two rectangles overlap iff their
projections overlap on all four face normals; the closed form needs no
corner tensors, so all-pairs collision matrices stay elementwise.
"""

from __future__ import annotations

import torch


def box_corners(center, heading, shape) -> torch.Tensor:
    """(..., 4, 2) corners of oriented rectangles, ordered front-left,
    rear-left, rear-right, front-right."""
    half_w = 0.5 * shape[..., 0]
    half_l = 0.5 * shape[..., 1]
    dx = torch.stack([half_l, -half_l, -half_l, half_l], dim=-1)
    dy = torch.stack([half_w, half_w, -half_w, -half_w], dim=-1)
    c = torch.cos(heading)[..., None]
    s = torch.sin(heading)[..., None]
    return torch.stack([dx * c - dy * s, dx * s + dy * c], dim=-1) + center[..., None, :]


def _axes_from_heading(heading) -> torch.Tensor:
    """(...,) -> (..., 2, 2): the two face normals of a box with given yaw."""
    c, s = torch.cos(heading), torch.sin(heading)
    return torch.stack(
        [torch.stack([c, s], dim=-1), torch.stack([-s, c], dim=-1)], dim=-2
    )


def obb_overlap(center_a, heading_a, shape_a, center_b, heading_b, shape_b):
    """Elementwise SAT overlap of box pairs; all args broadcast. Boxes are
    separated along axis u iff |(c_b - c_a).u| > h_a(u) + h_b(u), with a
    box's half-extent h(u) = (l/2)|f.u| + (w/2)|s.u|. Returns bool (...,)."""
    ca, sa = torch.cos(heading_a), torch.sin(heading_a)
    cb, sb = torch.cos(heading_b), torch.sin(heading_b)
    hw_a, hl_a = 0.5 * shape_a[..., 0], 0.5 * shape_a[..., 1]
    hw_b, hl_b = 0.5 * shape_b[..., 0], 0.5 * shape_b[..., 1]
    tx = center_b[..., 0] - center_a[..., 0]
    ty = center_b[..., 1] - center_a[..., 1]

    def half_extent(ux, uy, c, s, hl, hw):
        return hl * torch.abs(ux * c + uy * s) + hw * torch.abs(-ux * s + uy * c)

    sep = None
    for ux, uy in ((ca, sa), (-sa, ca), (cb, sb), (-sb, cb)):
        dist = torch.abs(tx * ux + ty * uy)
        s_k = dist > half_extent(ux, uy, ca, sa, hl_a, hw_a) + half_extent(
            ux, uy, cb, sb, hl_b, hw_b
        )
        sep = s_k if sep is None else sep | s_k
    return ~sep


def obb_overlap_matrix(center_a, heading_a, shape_a, center_b, heading_b, shape_b):
    """All pairs: boxes a (G, ...) against boxes b (N, ...) -> (G, N) bool."""
    return obb_overlap(center_a[:, None], heading_a[:, None], shape_a[:, None],
                       center_b[None, :], heading_b[None, :], shape_b[None, :])


def point_in_obb(points, center, heading, shape) -> torch.Tensor:
    """Point-in-rectangle test, broadcasting; shape = [width, length]."""
    d = points - center
    c, s = torch.cos(heading), torch.sin(heading)
    lon = d[..., 0] * c + d[..., 1] * s
    lat = -d[..., 0] * s + d[..., 1] * c
    return (torch.abs(lon) <= 0.5 * shape[..., 1]) & (torch.abs(lat) <= 0.5 * shape[..., 0])
