"""Criticality metrics RTTC, ACT and EI (port of
rift_tpu/scenario/metrics.py).

RTTC sweeps each vehicle's corners along the relative velocity against the
other's box edges; ACT = shortest corner-to-corner distance / closing
speed; EI = safety in-depth / RTTC. Over neighbours: min RTTC and ACT, max
EI. NaN means undefined (not approaching, no neighbours).
"""

from __future__ import annotations

import torch

from ..geometry.obb import box_corners

D_SAFE = 0.0
NAN = float("nan")


def _nan_reduce(x, dims, largest: bool):
    """nanmin / nanmax over `dims`: NaN only where every element is NaN."""
    nan = torch.isnan(x)
    y = torch.where(nan, -torch.inf if largest else torch.inf, x)
    y = y.amax(dim=dims) if largest else y.amin(dim=dims)
    return torch.where((~nan).sum(dim=dims) == 0, NAN, y)


def _nanmin(x, dims):
    return _nan_reduce(x, dims, largest=False)


def _nanmax(x, dims):
    return _nan_reduce(x, dims, largest=True)


def _ray_segment_t(origin, direction, seg_a, seg_b):
    """Distance along the normalized `direction` from `origin` to the
    segment [a, b]; NaN if no hit (parallel rays never hit)."""
    v1 = origin - seg_a
    v2 = seg_b - seg_a
    d = direction / torch.clamp(torch.linalg.norm(direction, dim=-1, keepdim=True), min=1e-12)
    v3 = torch.stack([-d[..., 1], d[..., 0]], dim=-1)
    dot = (v2 * v3).sum(-1)
    dot = torch.where(torch.abs(dot) < 1e-10, NAN, dot)
    t1 = (v2[..., 0] * v1[..., 1] - v2[..., 1] * v1[..., 0]) / dot
    t2 = (v1 * v3).sum(-1) / dot
    return torch.where((t2 >= 0.0) & (t2 <= 1.0), t1, NAN)


def _corner_box_dtc(corners_from, direction, corners_to):
    """Min positive hit distance from 4 corners along `direction` to the 4
    edges of the other box; 0 where a corner sees hits on both sides."""
    a = corners_to
    b = torch.roll(corners_to, -1, dims=-2)
    t = _ray_segment_t(
        corners_from[..., :, None, :], direction[..., None, None, :],
        a[..., None, :, :], b[..., None, :, :],
    )  # (..., 4 corners, 4 edges)
    through = (t > 0).any(-1) & (t < 0).any(-1)
    dtc = _nanmin(torch.where(t > 0, t, NAN), (-2, -1))
    return torch.where(through.any(-1), 0.0, dtc)


def pairwise_criticality(pos_a, heading_a, speed_a, shape_a,
                         pos_b, heading_b, speed_b, shape_b):
    """RTTC / ACT / EI of vehicle pairs (shape = [width, length]); a dict
    of (...,) tensors, NaN where undefined."""
    unit_dir = lambda h: torch.stack([torch.cos(h), torch.sin(h)], dim=-1)
    v_a = speed_a[..., None] * unit_dir(heading_a)
    v_b = speed_b[..., None] * unit_dir(heading_b)
    v_rel = v_a - v_b
    v_rel_norm = torch.linalg.norm(v_rel, dim=-1)

    # closing speed along the centre line
    delta = pos_b - pos_a
    delta_norm = torch.linalg.norm(delta, dim=-1)
    unit = delta / torch.clamp(delta_norm, min=1e-12)[..., None]
    v_br = -(unit * (v_b - v_a)).sum(-1)
    v_br = torch.where(delta_norm > 0, v_br, 0.0)

    ca = box_corners(pos_a, heading_a, shape_a)
    cb = box_corners(pos_b, heading_b, shape_b)
    dtc = _nanmin(
        torch.stack([_corner_box_dtc(ca, v_rel, cb), _corner_box_dtc(cb, -v_rel, ca)], -1), -1
    )
    rttc = dtc / torch.clamp(v_rel_norm, min=1e-12)
    rttc = torch.where((v_br >= 0) & (v_rel_norm > 1e-12) & (rttc >= 0), rttc, NAN)

    # TDM / MFD
    dv = v_b - v_a
    theta = dv / torch.clamp(torch.linalg.norm(dv, dim=-1), min=1e-12)[..., None]
    aa = ca - pos_a[..., None, :]
    bb = cb - pos_b[..., None, :]
    th = theta[..., None, :]
    proj = lambda c: torch.linalg.norm(c - (c * th).sum(-1, keepdim=True) * th, dim=-1)
    d_t1 = torch.linalg.norm(delta - (delta * theta).sum(-1, keepdim=True) * theta, dim=-1)
    mfd = d_t1 - (proj(aa).amax(-1) + proj(bb).amax(-1))
    in_depth = D_SAFE - mfd

    diff = bb[..., None, :, :] + delta[..., None, None, :] - aa[..., :, None, :]
    dis_shortest = torch.linalg.norm(diff, dim=-1).flatten(-2).amin(-1)

    approaching = v_br > 0
    act = dis_shortest / torch.clamp(v_br, min=1e-12)
    defined = approaching & ~torch.isnan(rttc)
    act = torch.where(defined & (act >= 0), act, NAN)
    ei = in_depth / torch.where(rttc == 0, NAN, rttc)
    ei = torch.where(defined, ei, NAN)
    return {"RTTC": rttc, "ACT": act, "EI": ei}


def ego_criticality(ego_pos, ego_heading, ego_speed, ego_shape,
                    nbr_pos, nbr_heading, nbr_speed, nbr_shape, nbr_valid):
    """Over neighbours [S, N]: min RTTC and ACT, max EI (NaN if none)."""
    m = pairwise_criticality(
        ego_pos[:, None], ego_heading[:, None], ego_speed[:, None], ego_shape[:, None],
        nbr_pos, nbr_heading, nbr_speed, nbr_shape,
    )
    masked = {k: torch.where(nbr_valid, v, NAN) for k, v in m.items()}
    return {
        "RTTC": _nanmin(masked["RTTC"], -1),
        "ACT": _nanmin(masked["ACT"], -1),
        "EI": _nanmax(masked["EI"], -1),
    }
