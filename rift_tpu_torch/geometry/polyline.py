"""Polylines: arclength, resampling, headings, nearest vertex and
projection (port of rift_tpu/geometry/polyline.py). Fixed-size and
mask-friendly."""

from __future__ import annotations

import torch

from .se2 import wrap_angle


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] along the last dim for per-row indices idx (...,)."""
    x = x.expand(idx.shape + x.shape[-1:])
    return torch.gather(x, -1, idx[..., None])[..., 0]


def polyline_arclength(points: torch.Tensor) -> torch.Tensor:
    """Cumulative arclength (..., P, 2) -> (..., P), starting at 0."""
    seg = torch.linalg.norm(torch.diff(points, dim=-2), dim=-1)
    return torch.cat([torch.zeros_like(seg[..., :1]), torch.cumsum(seg, dim=-1)], dim=-1)


def _interp(x, xp, fp):
    """jnp.interp's formula: linear between the bracketing knots, a knot
    gap of at most one ulp of eps taking the left value, constant outside."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps * torch.finfo(xp.dtype).eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + ((x - xp[i - 1]) / torch.where(dx0, 1.0, dx)) * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def resample_polyline(points: torch.Tensor, num_samples: int) -> torch.Tensor:
    """A (P, 2) polyline at `num_samples` points equally spaced by
    arclength (endpoints kept; a zero-length one repeats its first point)."""
    s = polyline_arclength(points)
    total = torch.clamp(s[-1], min=1e-9)
    # jnp.linspace(0, 1, n): i / (n - 1), the last exactly 1 (n = 1: 0)
    frac = torch.arange(num_samples, dtype=points.dtype, device=points.device)
    if num_samples > 1:
        frac = torch.cat([frac[:-1] / (num_samples - 1), frac.new_ones(1)])
    targets = frac * total
    return torch.stack([_interp(targets, s, points[:, 0]), _interp(targets, s, points[:, 1])],
                       dim=-1)


def polyline_headings(points: torch.Tensor) -> torch.Tensor:
    """Per-point tangent heading (..., P, 2) -> (..., P) by forward
    differences; the last point repeats the previous heading."""
    vec = torch.diff(points, dim=-2)
    h = torch.atan2(vec[..., 1], vec[..., 0])
    return torch.cat([h, h[..., -1:]], dim=-1)


def nearest_point_index(polyline, query, valid_mask=None) -> torch.Tensor:
    """Index of the polyline vertex (..., P, 2) nearest to each query
    (..., 2), ignoring vertices where `valid_mask` (..., P) is False ->
    (...,) int32; the first of equal minima."""
    d2 = ((polyline - query[..., None, :]) ** 2).sum(-1)
    if valid_mask is not None:
        d2 = torch.where(valid_mask, d2, torch.inf)
    return torch.argmin(d2, dim=-1).to(torch.int32)


def project_point_to_polyline(polyline, query, valid_mask=None):
    """Project (..., 2) points onto (..., P, 2) segment-wise polylines; a
    segment counts where both its vertices are valid (`valid_mask`
    (..., P), all by default).

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
    if valid_mask is not None:
        d2 = torch.where(valid_mask[..., :-1] & valid_mask[..., 1:], d2, torch.inf)
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
