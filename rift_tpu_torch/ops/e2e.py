"""The vendored detection and sampling ops of the E2E camera stacks (port of
rift_tpu/ops/e2e.py).

The reference's UniAD / VAD / SparseDrive compile CUDA ops of mmcv and
SparseDrive (ms_deform_attn, nms_rotated, box_iou_rotated,
roi_align(_rotated), deformable_aggregation, voxelization, knn,
furthest_point_sample, iou3d). The JAX package wrote each as an XLA
composite, none as a Pallas kernel; here each is the same composite in
eager torch: gathers for the bilinear samples, sums for the weighted
reductions, masked Sutherland-Hodgman for rotated-box clipping, and one
Python loop over the boxes for the greedy NMS and furthest-point loops,
run for every batch row at once.

Every function takes optional leading batch dimensions where the JAX one
is written for one sample and vmapped by its callers.

Semantics:
  * ms_deform_attn: multi_scale_deformable_attn_pytorch (grid_sample,
    align_corners=False, zero padding).
  * box_iou_rotated / nms_rotated: mmcv box_iou_rotated ((cx, cy, w, h,
    angle_rad) boxes, exact polygon clipping).
  * roi_align / roi_align_rotated: mmcv aligned=True (-0.5 pixel shift),
    average pooling.
  * deformable_aggregation: SparseDrive's deformable_aggregation_ext
    forward.
"""

from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# bilinear sampling (grid_sample semantics, align_corners=False, zeros pad)
# ---------------------------------------------------------------------------
def _bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C]; x, y [B, ...] pixel coordinates (centre-of-pixel
    convention) -> [B, ..., C]. Out-of-bounds reads contribute zero."""
    B, H, W, C = img.shape
    flat = img.reshape(B, H * W, C)
    lead = x.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    outs = 0.0
    for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
        for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
            xi = x0.to(torch.int32) + dx
            yi = y0.to(torch.int32) + dy
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = (torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)).long()
            v = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
            outs = outs + v.reshape(lead + (C,)) * (wx * wy * inb)[..., None]
    return outs


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights):
    """Multi-scale deformable attention -> [bs, Q, num_heads * head_dim].

    value [bs, num_keys, num_heads, head_dim]; spatial_shapes [(H, W), ...]
    (a Python list); sampling_locations [bs, Q, heads, L, P, 2] in [0, 1]
    (x, y); attention_weights [bs, Q, heads, L, P]. Locations are
    normalized: pixel = loc * size - 0.5 (grid_sample, align_corners=False).
    """
    bs, _, nh, hd = value.shape
    Q = sampling_locations.shape[1]
    P = sampling_locations.shape[4]
    out = 0.0
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].reshape(bs, h, w, nh, hd)
        start += h * w
        # heads join the batch: [bs * nh, h, w, hd]
        v = v.permute(0, 3, 1, 2, 4).reshape(bs * nh, h, w, hd)
        loc = sampling_locations[:, :, :, lvl]  # [bs, Q, nh, P, 2]
        px = (loc[..., 0] * w - 0.5).permute(0, 2, 1, 3).reshape(bs * nh, Q, P)
        py = (loc[..., 1] * h - 0.5).permute(0, 2, 1, 3).reshape(bs * nh, Q, P)
        sampled = _bilinear_sample(v, px, py).reshape(bs, nh, Q, P, hd).permute(0, 2, 1, 3, 4)
        out = out + torch.sum(sampled * attention_weights[:, :, :, lvl][..., None], dim=3)
    return out.reshape(bs, Q, nh * hd)


# ---------------------------------------------------------------------------
# rotated boxes
# ---------------------------------------------------------------------------
def _box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (cx, cy, w, h, angle) -> [..., 4, 2] corners (ccw)."""
    cx, cy, w, h, a = boxes.unbind(-1)
    c, s = torch.cos(a), torch.sin(a)
    dx = torch.stack([w, w, -w, -w], -1) * 0.5
    dy = torch.stack([-h, h, h, -h], -1) * 0.5
    x = cx[..., None] + dx * c[..., None] - dy * s[..., None]
    y = cy[..., None] + dx * s[..., None] + dy * c[..., None]
    return torch.stack([x, y], -1)


_MAX_V = 8  # intersection of two convex quads has <= 8 vertices


def _clip_poly(pts, valid, a, b):
    """Clip polygon (pts [..., V, 2], valid [..., V], a contiguous prefix)
    against the half-plane left of edge a->b (a, b [..., 2]). Fixed-size
    output [..., _MAX_V]."""
    V = pts.shape[-2]
    nxt = torch.cat([pts[..., 1:, :], pts[..., :1, :]], dim=-2)
    # each vertex's successor is the next VALID vertex: the last valid one
    # wraps to vertex 0
    n = valid.sum(-1, keepdim=True)
    is_last = torch.arange(V, device=pts.device) == (n - 1)
    nxt = torch.where(is_last[..., None], pts[..., :1, :], nxt)

    e = b - a

    def side(p):
        d = p - a[..., None, :]
        return e[..., None, 0] * d[..., 1] - e[..., None, 1] * d[..., 0]

    s_cur = side(pts)
    s_nxt = side(nxt)
    cur_in = s_cur >= 0
    nxt_in = s_nxt >= 0
    den = s_cur - s_nxt
    t = s_cur / torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    inter = pts + (nxt - pts) * torch.clamp(t, 0.0, 1.0)[..., None]

    # each input edge emits up to 2 points: (cur if cur_in), (inter if the
    # edge crosses), laid out as [..., V, 2 slots] and compacted
    emit1 = cur_in & valid
    emit2 = (cur_in ^ nxt_in) & valid
    out_pts = torch.stack([pts, inter], dim=-2).reshape(pts.shape[:-2] + (2 * V, 2))
    out_ok = torch.stack([emit1, emit2], dim=-1).reshape(valid.shape[:-1] + (2 * V,))
    order = torch.argsort((~out_ok).to(torch.uint8), dim=-1, stable=True)[..., :_MAX_V]
    pts_c = torch.gather(out_pts, -2, order[..., None].expand(order.shape + (2,)))
    ok_c = torch.gather(out_ok, -1, order)
    return pts_c, ok_c


def _poly_area(pts, valid):
    """Shoelace area of a contiguous-prefix polygon [..., V, 2]."""
    V = pts.shape[-2]
    n = valid.sum(-1, keepdim=True)
    idx = torch.arange(V, device=pts.device)
    nxt_idx = torch.where(idx == (n - 1), 0, torch.clamp(idx + 1, max=V - 1))
    nxt_idx = nxt_idx.expand(pts.shape[:-1])
    nxt = torch.gather(pts, -2, nxt_idx[..., None].expand(pts.shape))
    cross = pts[..., 0] * nxt[..., 1] - pts[..., 1] * nxt[..., 0]
    return 0.5 * torch.abs(torch.sum(torch.where(valid, cross, 0.0), dim=-1))


def rotated_box_intersection(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Intersection area of rotated boxes b1, b2 [..., 5] -> [...]."""
    b1, b2 = torch.broadcast_tensors(b1, b2)
    poly = _box_corners(b1)  # [..., 4, 2]
    lead = poly.shape[:-2]
    pts = torch.cat([poly, poly.new_zeros(lead + (_MAX_V - 4, 2))], dim=-2)
    valid = torch.cat([torch.ones(lead + (4,), dtype=torch.bool, device=poly.device),
                       torch.zeros(lead + (_MAX_V - 4,), dtype=torch.bool, device=poly.device)],
                      dim=-1)
    clip = _box_corners(b2)
    for i in range(4):
        pts, valid = _clip_poly(pts, valid, clip[..., i, :], clip[..., (i + 1) % 4, :])
    return _poly_area(pts, valid)


def box_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[..., N, 5] x [..., M, 5] -> [..., N, M] IoU (mmcv box_iou_rotated,
    mode 'iou')."""
    inter = rotated_box_intersection(boxes1[..., :, None, :], boxes2[..., None, :, :])
    a1 = (boxes1[..., 2] * boxes1[..., 3])[..., :, None]
    a2 = (boxes2[..., 2] * boxes2[..., 3])[..., None, :]
    return inter / torch.clamp(a1 + a2 - inter, min=1e-9)


def _greedy_nms(iou: torch.Tensor, threshold: float) -> torch.Tensor:
    """Keep mask [..., N] of boxes in descending-score order, from their
    pairwise IoU [..., N, N]: box i is kept unless a kept box before it
    overlaps it by more than `threshold`. One step per box, all rows at
    once."""
    N = iou.shape[-1]
    over = iou > threshold
    kept = torch.zeros(iou.shape[:-1], dtype=torch.bool, device=iou.device)
    for i in range(N):
        kept[..., i] = ~(over[..., i, :i] & kept[..., :i]).any(-1)
    return kept


def _sort_desc(scores: torch.Tensor) -> torch.Tensor:
    """jnp.argsort(-scores): a stable sort, ties in index order."""
    return torch.argsort(-scores, dim=-1, stable=True)


def _unsort(kept: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(kept).scatter(-1, order, kept)


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy rotated NMS: boxes [..., N, 5], scores [..., N] -> keep mask
    [..., N] in the original order (mmcv nms_rotated: by descending score,
    suppress a box with IoU > threshold against an already-kept box)."""
    order = _sort_desc(scores)
    srt = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    return _unsort(_greedy_nms(box_iou_rotated(srt, srt), iou_threshold), order)


# ---------------------------------------------------------------------------
# RoIAlign
# ---------------------------------------------------------------------------
def _pool(features, gx, gy):
    """Average of bilinear samples: features [B, H, W, C] or [H, W, C],
    grids [B, R, out, out, sr, sr] or [R, out, out, sr, sr] -> [(B,) R,
    out, out, C]."""
    unbatched = features.dim() == 3
    if unbatched:
        features = features[None]
    if gx.dim() == 5:  # one set of rois for every image
        gx, gy = gx[None], gy[None]
    B = features.shape[0]
    gx, gy = (g.expand((B,) + g.shape[1:]) for g in (gx, gy))
    v = _bilinear_sample(features, gx, gy).mean(dim=(-3, -2))
    return v[0] if unbatched else v


def roi_align(features, rois, out_size: int = 7, sampling_ratio: int = 2,
              spatial_scale: float = 1.0):
    """mmcv RoIAlign (aligned=True): features [(B,) H, W, C], rois
    [(B,) R, 4] (x1, y1, x2, y2) -> [(B,) R, out, out, C], the average of
    sampling_ratio^2 bilinear samples per output bin (-0.5 pixel shift)."""
    r = rois * spatial_scale
    x1, y1, x2, y2 = r.unbind(-1)
    bw = torch.clamp((x2 - x1) / out_size, min=1e-6)
    bh = torch.clamp((y2 - y1) / out_size, min=1e-6)
    dev = rois.device
    gi = (torch.arange(sampling_ratio, device=dev) + 0.5) / sampling_ratio
    ox = torch.arange(out_size, device=dev)
    grid = ox[:, None] + gi[None, :]  # [out, sr]
    xs = x1[..., None, None] + grid * bw[..., None, None] - 0.5  # [..., R, out, sr]
    ys = y1[..., None, None] + grid * bh[..., None, None] - 0.5
    n, sr = out_size, sampling_ratio
    gx = xs[..., None, :, None, :].expand(xs.shape[:-2] + (n, n, sr, sr))
    gy = ys[..., :, None, :, None].expand(ys.shape[:-2] + (n, n, sr, sr))
    return _pool(features, gx, gy)


def roi_align_rotated(features, rois, out_size: int = 7, sampling_ratio: int = 2,
                      spatial_scale: float = 1.0):
    """mmcv RoIAlignRotated (aligned=True, clockwise=False): features
    [(B,) H, W, C], rois [(B,) R, 5] (cx, cy, w, h, angle) -> [(B,) R, out,
    out, C]: an axis-aligned grid in the box frame, rotated into the image."""
    cx, cy, w, h, ang = rois.unbind(-1)
    cx, cy, w, h = (x * spatial_scale for x in (cx, cy, w, h))
    dev = rois.device
    gi = (torch.arange(sampling_ratio, device=dev) + 0.5) / sampling_ratio
    ox = torch.arange(out_size, device=dev)
    u = (ox[:, None] + gi[None, :]) / out_size - 0.5  # [out, sr], box units
    n, sr = out_size, sampling_ratio
    e = lambda x: x[..., None, None, None, None]  # noqa: E731
    lx = u[None, :, None, :] * e(w)  # [..., R, out(y), out(x), sr(y), sr(x)]
    ly = u[:, None, :, None] * e(h)
    lx, ly = (t.expand(rois.shape[:-1] + (n, n, sr, sr)) for t in (lx, ly))
    c, s = torch.cos(ang), torch.sin(ang)
    gx = e(cx) + lx * e(c) - ly * e(s) - 0.5
    gy = e(cy) + lx * e(s) + ly * e(c) - 0.5
    return _pool(features, gx, gy)


# ---------------------------------------------------------------------------
# SparseDrive deformable aggregation
# ---------------------------------------------------------------------------
def deformable_aggregation(mc_ms_feat, spatial_shapes, sampling_location, weights):
    """SparseDrive's deformable_aggregation_ext forward: bilinear-sample
    each (camera, scale) feature map at the projected anchor points and
    reduce with the predicted weights -> [bs, pts, C].

    mc_ms_feat [bs, num_keys, C] (camera-major stacked maps);
    spatial_shapes [[(h, w) per scale] per camera]; sampling_location
    [bs, pts, cam, scale, 2] in [0, 1]; weights [bs, pts, cam, scale]."""
    bs, _, C = mc_ms_feat.shape
    out = 0.0
    start = 0
    for ci, cam_shapes in enumerate(spatial_shapes):
        for si, (h, w) in enumerate(cam_shapes):
            fmap = mc_ms_feat[:, start:start + h * w].reshape(bs, h, w, C)
            start += h * w
            loc = sampling_location[:, :, ci, si]  # [bs, pts, 2]
            v = _bilinear_sample(fmap, loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5)
            out = out + v * weights[:, :, ci, si][..., None]
    return out


# ---------------------------------------------------------------------------
# point-cloud ops (mmcv/ops/csrc: voxelization, knn, furthest_point_sample,
# iou3d): ragged voxel lists become padded [max_voxels, max_points] tensors
# with validity masks, scatters become a sort and segment ranks
# ---------------------------------------------------------------------------
def voxelize(points, valid, voxel_size: tuple, pc_range: tuple, max_voxels: int = 256,
             max_points: int = 16):
    """Hard voxelization (mmcv Voxelization.forward) of points [..., N, C>=3]
    (x, y, z, feats...) where valid [..., N] -> (voxels [..., V, P, C],
    coords [..., V, 3] int32 (ix, iy, iz), num_points [..., V] int32,
    voxel_valid [..., V]). Points beyond `max_points` in a voxel and voxels
    beyond `max_voxels` are dropped, as the CUDA op drops them."""
    lead = points.shape[:-2]
    N, C = points.shape[-2:]
    points = points.reshape((-1, N, C))
    valid = valid.reshape((-1, N))
    B = points.shape[0]
    dev = points.device
    x0, y0, z0, x1, y1, z1 = pc_range
    vx, vy, vz = voxel_size
    nx = max(int(round((x1 - x0) / vx)), 1)
    ny = max(int(round((y1 - y0) / vy)), 1)
    nz = max(int(round((z1 - z0) / vz)), 1)

    ix = torch.floor((points[..., 0] - x0) / vx).to(torch.int32)
    iy = torch.floor((points[..., 1] - y0) / vy).to(torch.int32)
    iz = torch.floor((points[..., 2] - z0) / vz).to(torch.int32)
    in_range = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz)
    ok = valid & in_range
    lin = torch.where(ok, (iz.long() * ny + iy) * nx + ix, INT32_MAX)

    # a stable sort by voxel id keeps the CUDA op's first-come point order
    order = torch.argsort(lin, dim=-1, stable=True)
    slin = torch.gather(lin, 1, order)
    ar = torch.arange(N, device=dev).expand(B, N)
    same = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                      slin[:, 1:] == slin[:, :-1]], dim=1)
    seg_start = torch.where(~same, ar, 0)
    rank = ar - torch.cummax(seg_start, dim=1).values  # rank within the voxel
    new_voxel = ~same & (slin != INT32_MAX)
    vidx = torch.cumsum(new_voxel, dim=1) - 1  # sorted-order voxel slot

    keep = (slin != INT32_MAX) & (rank < max_points) & (vidx < max_voxels)
    dst_v = torch.where(keep, vidx, max_voxels)  # the overflow row, dropped below
    dst_p = torch.where(keep, rank, 0)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, N)

    sorted_pts = torch.gather(points, 1, order[..., None].expand(B, N, C))
    voxels = points.new_zeros((B, max_voxels + 1, max_points, C))
    voxels = voxels.index_put((bidx, dst_v, dst_p), sorted_pts)[:, :max_voxels]
    num = torch.zeros((B, max_voxels + 1), dtype=torch.int32, device=dev)
    num = num.scatter_add(1, dst_v, keep.to(torch.int32))[:, :max_voxels]
    slin_clip = torch.clamp(slin, min=0)
    cz = slin_clip // (nx * ny)
    cy = (slin_clip - cz * nx * ny) // nx
    cx = slin_clip - cz * nx * ny - cy * nx
    coords = torch.zeros((B, max_voxels + 1, 3), dtype=torch.int32, device=dev)
    coords = coords.index_put((bidx, dst_v),
                              torch.stack([cx, cy, cz], -1).to(torch.int32))[:, :max_voxels]
    out = (voxels, coords, num, num > 0)
    return tuple(x.reshape(lead + x.shape[1:]) for x in out)


def dynamic_scatter_mean(feats: torch.Tensor, voxel_id: torch.Tensor, num_voxels: int):
    """mmcv DynamicScatter(mode='mean'): the mean of point features feats
    [..., N, C] per voxel slot voxel_id [N] (shared by every batch row; -1
    drops the point) -> [..., num_voxels, C] (zero where empty). The sums
    are a product with the [num_voxels, N] slot-membership matrix: on the
    card a scatter-add's atomics would sum in a different order each call,
    and the closed loop must be reproducible."""
    member = (voxel_id[None, :] == torch.arange(num_voxels, device=feats.device)[:, None])
    n = member.sum(-1, dtype=torch.int32)
    s = torch.matmul(member.to(feats.dtype), torch.where((voxel_id >= 0)[:, None], feats, 0.0))
    return s / torch.clamp(n[:, None], min=1)


def knn(query: torch.Tensor, points: torch.Tensor, k: int, valid=None):
    """mmcv knn: indices [..., Q, k] of the k nearest `points` [..., N, D]
    to each query [..., Q, D] (invalid points excluded; ties go to the
    lower index, as `lax.top_k`)."""
    d = torch.sum((query[..., :, None, :] - points[..., None, :, :]) ** 2, -1)
    if valid is not None:
        d = torch.where(valid[..., None, :], d, torch.inf)
    return torch.argsort(d, dim=-1, stable=True)[..., :k]


def furthest_point_sample(points: torch.Tensor, num_samples: int, valid=None):
    """mmcv furthest_point_sample: greedy max-min selection from index 0 ->
    indices [..., num_samples] (int32) of points [..., N, D]; all rows at
    once."""
    N = points.shape[-2]
    lead = points.shape[:-2]
    if valid is not None:
        big = torch.where(valid, 0.0, -torch.inf)
    else:
        big = points.new_zeros(lead + (N,))
    mind = torch.full(lead + (N,), torch.inf, device=points.device)
    last = torch.zeros(lead + (1,), dtype=torch.long, device=points.device)
    idx = [last]
    for _ in range(num_samples - 1):
        p = torch.gather(points, -2, last[..., None].expand(lead + (1, points.shape[-1])))
        mind = torch.minimum(mind, torch.sum((points - p) ** 2, -1))
        last = torch.argmax(mind + big, dim=-1, keepdim=True)
        idx.append(last)
    return torch.cat(idx, -1).to(torch.int32)


def boxes_iou3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """mmcv iou3d boxes_iou3d_gpu: [..., N, 7] x [..., M, 7] (x, y, z, dx,
    dy, dz, yaw; z the box centre) -> IoU [..., N, M]: the exact rotated BEV
    intersection times the z-extent overlap."""
    bev = [0, 1, 3, 4, 6]
    inter_bev = rotated_box_intersection(boxes1[..., bev][..., :, None, :],
                                         boxes2[..., bev][..., None, :, :])
    z1lo = boxes1[..., 2] - boxes1[..., 5] * 0.5
    z1hi = boxes1[..., 2] + boxes1[..., 5] * 0.5
    z2lo = boxes2[..., 2] - boxes2[..., 5] * 0.5
    z2hi = boxes2[..., 2] + boxes2[..., 5] * 0.5
    zo = torch.clamp(torch.minimum(z1hi[..., :, None], z2hi[..., None, :])
                     - torch.maximum(z1lo[..., :, None], z2lo[..., None, :]), min=0.0)
    inter = inter_bev * zo
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    return inter / torch.clamp(v1[..., :, None] + v2[..., None, :] - inter, min=1e-8)


def nms3d(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.3):
    """mmcv iou3d nms_gpu: greedy NMS on 3D IoU, boxes [..., N, 7], scores
    [..., N] -> keep mask [..., N]."""
    order = _sort_desc(scores)
    srt = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    return _unsort(_greedy_nms(boxes_iou3d(srt, srt), iou_threshold), order)
