"""Polyline projection (port of rift_tpu/geometry/polyline.py: what the
map uses). Fixed-size and mask-friendly."""

from __future__ import annotations

import torch

from .se2 import wrap_angle


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along the last dim for per-row indices idx (...,)."""
    x = x.expand(idx.shape + x.shape[-1:])
    return torch.gather(x, -1, idx[..., None])[..., 0]


def project_point_to_polyline(polyline, query):
    """Project (..., 2) points onto (..., P, 2) segment-wise polylines.

    Returns (arclength, signed_lateral, heading_at_projection), each (...,);
    the lateral offset is positive to the right of the tangent."""
    a = polyline[..., :-1, :]
    b = polyline[..., 1:, :]
    ab = b - a
    ab_len2 = torch.clamp((ab * ab).sum(-1), min=1e-12)
    t = ((query[..., None, :] - a) * ab).sum(-1) / ab_len2
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    d2 = ((query[..., None, :] - proj) ** 2).sum(-1)
    idx = torch.argmin(d2, dim=-1)

    seg_len = torch.linalg.norm(ab, dim=-1)
    cum = torch.cat(
        [torch.zeros_like(seg_len[..., :1]), torch.cumsum(seg_len, dim=-1)],
        dim=-1,
    )
    t_best = _take(t, idx)
    s0 = _take(cum[..., :-1], idx)
    l0 = _take(seg_len, idx)
    arclength = s0 + t_best * l0

    lead = idx.shape
    gi = idx[..., None, None].expand(lead + (1, 2))
    tangent = torch.gather(ab.expand(lead + ab.shape[-2:]), -2, gi)[..., 0, :]
    heading = torch.atan2(tangent[..., 1], tangent[..., 0])
    proj_best = torch.gather(proj.expand(lead + proj.shape[-2:]), -2, gi)[
        ..., 0, :
    ]
    rel = query - proj_best
    tdir = torch.stack([torch.cos(heading), torch.sin(heading)], dim=-1)
    signed_lat = -(rel[..., 0] * tdir[..., 1] - rel[..., 1] * tdir[..., 0])
    return arclength, signed_lat, wrap_angle(heading)
