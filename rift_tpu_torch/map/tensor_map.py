"""TensorMap: the precompiled on-device vector map (port of
rift_tpu/map/tensor_map.py).

Lane layout: each lane is resampled to ``P + 1 = 21`` centerline vertices
plus left/right edge polylines; topology is successor indices plus
left/right adjacency. "Lane connectors" are lanes with ``is_junction``.
The numpy constructors are copies of the JAX package's, so both packages build
bit-identical arrays from the same lane dicts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..geometry.polyline import project_point_to_polyline
from ..utils.device import resolve_device
from ..utils.tensors import TensorDataclass

# sampled segments per lane (21 vertices)
LANE_POINTS = 21

# spatial hash grid: each cell stores the GRID_K nearest distinct lanes
GRID_K = 16
GRID_CELL = 2.0  # meters


@dataclass
class TensorMap(TensorDataclass):
    """Per-town static map as tensors. Lane arrays have leading dim L
    (padded); invalid slots have ``valid == False`` and index fields -1.
    Integer fields are int64."""

    centerline: torch.Tensor  # [L, LANE_POINTS, 2] float32
    left_edge: torch.Tensor  # [L, LANE_POINTS, 2]
    right_edge: torch.Tensor  # [L, LANE_POINTS, 2]
    headings: torch.Tensor  # [L, LANE_POINTS]
    width: torch.Tensor  # [L]
    length: torch.Tensor  # [L] centerline arclength
    road_id: torch.Tensor  # [L]
    lane_id: torch.Tensor  # [L] signed, CARLA convention
    is_junction: torch.Tensor  # [L] bool
    speed_limit: torch.Tensor  # [L] m/s
    successors: torch.Tensor  # [L, K_SUC], -1 padded
    predecessors: torch.Tensor  # [L, K_SUC], -1 padded
    left_adj: torch.Tensor  # [L], -1 if none
    right_adj: torch.Tensor  # [L], -1 if none
    valid: torch.Tensor  # [L] bool
    light_group: torch.Tensor  # [L], -1 = unsignalised
    stop_lane: torch.Tensor  # [L] bool
    crosswalk_edges: torch.Tensor  # [C, 3, Pc, 2]
    crosswalk_valid: torch.Tensor  # [C] bool
    grid_lanes: torch.Tensor  # [GY, GX, GRID_K]
    grid_origin: torch.Tensor  # [2]
    grid_inv_cell: torch.Tensor  # []
    drivable_grid: torch.Tensor  # [RY, RX] bool
    drivable_inv_cell: torch.Tensor  # []
    drivable_clearance: torch.Tensor  # [RY, RX] float32

    @property
    def num_lanes(self) -> int:
        return self.centerline.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centerline.device

    @property
    def lane_mid(self) -> torch.Tensor:
        """[L, 2] centerline midpoints (a cheap query key)."""
        return self.centerline[:, LANE_POINTS // 2]

    def lane_point_dist2(self, point: torch.Tensor) -> torch.Tensor:
        """Squared distance from `point` (..., 2) to each lane's nearest
        centerline vertex -> (..., L); invalid lanes +inf. Same expansion
        |p|^2 + |v|^2 - 2 p.v as the JAX package, so rankings agree."""
        L, P, _ = self.centerline.shape
        verts = self.centerline.reshape(L * P, 2)
        cross = point @ verts.T
        d2 = (
            (point * point).sum(-1, keepdim=True)
            + (verts * verts).sum(-1)
            - 2.0 * cross
        )
        d2 = torch.clamp(d2.reshape(point.shape[:-1] + (L, P)).amin(-1), min=0.0)
        return torch.where(self.valid, d2, torch.inf)

    def grid_candidates(self, point: torch.Tensor) -> torch.Tensor:
        """(..., 2) -> (..., GRID_K): the nearest lanes to the point's cell."""
        gy, gx = self.grid_lanes.shape[:2]
        cell = (point - self.grid_origin) * self.grid_inv_cell
        cx = torch.clamp(cell[..., 0].to(torch.int32), 0, gx - 1).long()
        cy = torch.clamp(cell[..., 1].to(torch.int32), 0, gy - 1).long()
        return self.grid_lanes[cy, cx]

    def _candidate_dist2(self, cand, point):
        """Exact min-vertex distance to each candidate lane (..., K), plus
        the lane heading at that nearest vertex."""
        idx = torch.clamp(cand, min=0)
        pts = self.centerline[idx]
        diff = pts - point[..., None, None, :]
        d2v = (diff * diff).sum(-1)
        vi = torch.argmin(d2v, dim=-1)
        d2 = torch.gather(d2v, -1, vi[..., None])[..., 0]
        hdg = torch.gather(self.headings[idx], -1, vi[..., None])[..., 0]
        return torch.where(cand >= 0, d2, torch.inf), hdg

    HEADING_TIEBREAK_W = 4.0

    def nearest_lane(self, point, heading=None):
        """Index of the nearest valid lane to (..., 2) points, re-ranked
        over the cell's GRID_K candidates; with `heading`, overlapping
        lanes resolve to the direction-aligned one."""
        cand = self.grid_candidates(point)
        d2, lane_hdg = self._candidate_dist2(cand, point)
        if heading is not None:
            mis = 1.0 - torch.cos(lane_hdg - heading[..., None])
            d2 = d2 + self.HEADING_TIEBREAK_W * mis
        best = torch.argmin(d2, dim=-1)
        return torch.gather(cand, -1, best[..., None])[..., 0]

    def nearest_lane_full(self, point):
        """Exact O(L) nearest lane."""
        return torch.argmin(self.lane_point_dist2(point), dim=-1)

    def nearest_lanes(self, point, k: int):
        """Top-k nearest lanes by centerline-vertex distance: (indices
        (..., k), dist2 (..., k)). A stable sort keeps the lowest index
        first among equal distances, as jax.lax.top_k does."""
        d2 = self.lane_point_dist2(point)
        kk = min(k, self.num_lanes)
        d2s, idx = torch.sort(d2, dim=-1, stable=True)
        idx, d2s = idx[..., :kk], d2s[..., :kk]
        if kk < k:
            pad = idx.shape[:-1] + (k - kk,)
            idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
            d2s = torch.cat([d2s, d2s.new_full(pad, torch.inf)], dim=-1)
        return idx, d2s

    def query_proximal(self, point, radius: float, max_objects: int):
        """Lanes within `radius` of `point`, distance-sorted, padded to
        `max_objects`: (lane_idx with -1 pad, valid)."""
        idx, d2 = self.nearest_lanes(point, max_objects)
        within = d2 <= radius * radius
        return torch.where(within, idx, -1), within

    def project(self, lane_idx, point):
        """Project (..., 2) points onto lanes (...,): (arclength,
        signed_lateral, heading)."""
        return project_point_to_polyline(self.centerline[lane_idx], point)

    def road_clearance(self, point: torch.Tensor) -> torch.Tensor:
        """Bilinear-sampled signed road clearance (m) of (..., 2) points:
        >= 0 inside a lane, < 0 outside."""
        ry, rx = self.drivable_clearance.shape
        cell = (point - self.grid_origin) * self.drivable_inv_cell - 0.5
        cx = torch.clamp(cell[..., 0], 0.0, rx - 1.001)
        cy = torch.clamp(cell[..., 1], 0.0, ry - 1.001)
        x0 = cx.to(torch.int32).long()
        y0 = cy.to(torch.int32).long()
        fx, fy = cx - x0, cy - y0
        g = self.drivable_clearance
        top = g[y0, x0] + (g[y0, x0 + 1] - g[y0, x0]) * fx
        bot = g[y0 + 1, x0] + (g[y0 + 1, x0 + 1] - g[y0 + 1, x0]) * fx
        return top + (bot - top) * fy

    def on_road(self, point: torch.Tensor, margin: float = 0.3) -> torch.Tensor:
        """Drivable-area test of (..., 2) points on the clearance raster
        (the world tick's off-road flag)."""
        return self.road_clearance(point) >= -margin

    def on_road_raster(self, point: torch.Tensor) -> torch.Tensor:
        """Raster drivable-area test of (..., 2) points: one gather per
        point (the evaluator's bulk off-road query)."""
        ry, rx = self.drivable_grid.shape
        cell = (point - self.grid_origin) * self.drivable_inv_cell
        cx = torch.clamp(cell[..., 0].to(torch.int32), 0, rx - 1).long()
        cy = torch.clamp(cell[..., 1].to(torch.int32), 0, ry - 1).long()
        return self.drivable_grid[cy, cx]

    def on_route_mask(self, route_road_ids, route_lane_ids):
        """[..., L] bool: lane lies on the route (same road id, same lane-id
        sign). `route_*_ids` [..., RIDS], road id -1 pads."""
        rr = route_road_ids[..., None, :]
        rl = route_lane_ids[..., None, :]
        same_road = self.road_id[:, None] == rr
        same_sign = (self.lane_id[:, None] * rl) > 0
        pad = rr < 0
        return (same_road & same_sign & ~pad).any(-1) & self.valid

    def lane_frame_speed_limit(self, lane_idx: torch.Tensor) -> torch.Tensor:
        """The speed limit (m/s) of each lane in `lane_idx`."""
        return self.speed_limit[lane_idx]


def build_tensor_map(
    lanes: list[dict[str, Any]],
    crosswalks: list[np.ndarray] | None = None,
    pad_lanes_to: int | None = None,
    max_successors: int = 4,
    grid_shape: tuple[int, int] | None = None,
    raster_shape: tuple[int, int] | None = None,
    device=None,
) -> TensorMap:
    """Host-side constructor from a list of lane dicts (see the JAX
    package's build_tensor_map for the lane dict schema); the map lands on
    `device` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    import numpy as onp

    L = len(lanes)
    Lp = pad_lanes_to or L
    assert Lp >= L

    def _resample(poly: onp.ndarray) -> onp.ndarray:
        poly = onp.asarray(poly, dtype=onp.float64)
        if len(poly) < 2:
            poly = onp.repeat(poly[:1], 2, axis=0) if len(poly) else onp.zeros((2, 2))
        seg = onp.linalg.norm(onp.diff(poly, axis=0), axis=1)
        s = onp.concatenate([[0.0], onp.cumsum(seg)])
        total = max(s[-1], 1e-9)
        t = onp.linspace(0, total, LANE_POINTS)
        return onp.stack(
            [onp.interp(t, s, poly[:, 0]), onp.interp(t, s, poly[:, 1])], axis=-1
        )

    centerline = onp.zeros((Lp, LANE_POINTS, 2), onp.float32)
    left_edge = onp.zeros_like(centerline)
    right_edge = onp.zeros_like(centerline)
    width = onp.zeros(Lp, onp.float32)
    length = onp.zeros(Lp, onp.float32)
    road_id = onp.full(Lp, -1, onp.int32)
    lane_id = onp.zeros(Lp, onp.int32)
    is_junction = onp.zeros(Lp, bool)
    speed_limit = onp.zeros(Lp, onp.float32)
    valid = onp.zeros(Lp, bool)
    light_group = onp.full(Lp, -1, onp.int32)
    stop_lane = onp.zeros(Lp, bool)

    key_to_idx: dict[tuple[int, int], int] = {}
    for i, ln in enumerate(lanes):
        key_to_idx[(int(ln["road_id"]), int(ln["lane_id"]))] = i

    for i, ln in enumerate(lanes):
        c = _resample(ln["centerline"])
        centerline[i] = c
        w = float(ln.get("width", 3.5))
        if ln.get("left") is not None and len(ln["left"]) >= 2:
            left_edge[i] = _resample(ln["left"])
        else:
            left_edge[i] = _offset_polyline(c, +w / 2)
        if ln.get("right") is not None and len(ln["right"]) >= 2:
            right_edge[i] = _resample(ln["right"])
        else:
            right_edge[i] = _offset_polyline(c, -w / 2)
        width[i] = w
        length[i] = float(
            onp.linalg.norm(onp.diff(c, axis=0), axis=1).sum()
        )
        road_id[i] = int(ln["road_id"])
        lane_id[i] = int(ln["lane_id"])
        is_junction[i] = bool(ln.get("is_junction", False))
        speed_limit[i] = float(ln.get("speed_limit", 14.0))
        valid[i] = True
        light_group[i] = int(ln.get("light_group", -1))
        stop_lane[i] = bool(ln.get("stop", False))

    successors = onp.full((Lp, max_successors), -1, onp.int32)
    predecessors = onp.full((Lp, max_successors), -1, onp.int32)
    left_adj = onp.full(Lp, -1, onp.int32)
    right_adj = onp.full(Lp, -1, onp.int32)
    pred_count = onp.zeros(Lp, onp.int32)

    for i, ln in enumerate(lanes):
        succ = [
            key_to_idx[tuple(map(int, s))]
            for s in ln.get("successors", [])
            if tuple(map(int, s)) in key_to_idx
        ]
        for k, j in enumerate(succ[:max_successors]):
            successors[i, k] = j
            if pred_count[j] < max_successors:
                predecessors[j, pred_count[j]] = i
                pred_count[j] += 1
        la = ln.get("left_adj")
        if la is not None and tuple(map(int, la)) in key_to_idx:
            left_adj[i] = key_to_idx[tuple(map(int, la))]
        ra = ln.get("right_adj")
        if ra is not None and tuple(map(int, ra)) in key_to_idx:
            right_adj[i] = key_to_idx[tuple(map(int, ra))]

    vec = onp.diff(centerline, axis=1)
    headings = onp.arctan2(vec[..., 1], vec[..., 0])
    headings = onp.concatenate([headings, headings[:, -1:]], axis=1).astype(onp.float32)

    cw = crosswalks or []
    Pc = LANE_POINTS
    C = max(len(cw), 1)
    crosswalk_edges = onp.zeros((C, 3, Pc, 2), onp.float32)
    crosswalk_valid = onp.zeros(C, bool)
    for i, poly in enumerate(cw):
        crosswalk_edges[i] = _crosswalk_edges(onp.asarray(poly), Pc)
        crosswalk_valid[i] = True

    grid_lanes, grid_origin, grid_inv_cell = _build_spatial_grid(
        centerline, valid, fixed_shape=grid_shape
    )
    drivable_grid, _, drivable_inv_cell = _build_drivable_raster(
        centerline, width, valid, grid_origin, fixed_shape=raster_shape
    )
    drivable_clearance = _build_clearance_raster(
        centerline, width, valid, grid_lanes, grid_origin, grid_inv_cell,
        drivable_grid.shape, drivable_inv_cell,
    )

    host = dict(
        centerline=centerline,
        left_edge=left_edge,
        right_edge=right_edge,
        headings=headings,
        width=width,
        length=length,
        road_id=road_id,
        lane_id=lane_id,
        is_junction=is_junction,
        speed_limit=speed_limit,
        successors=successors,
        predecessors=predecessors,
        left_adj=left_adj,
        right_adj=right_adj,
        valid=valid,
        light_group=light_group,
        stop_lane=stop_lane,
        crosswalk_edges=crosswalk_edges,
        crosswalk_valid=crosswalk_valid,
        grid_lanes=grid_lanes,
        grid_origin=grid_origin,
        grid_inv_cell=np.float32(grid_inv_cell),
        drivable_grid=drivable_grid,
        drivable_inv_cell=np.float32(drivable_inv_cell),
        drivable_clearance=drivable_clearance,
    )
    return TensorMap(**host).to(device)


RASTER_CELL = 1.0  # m — matches the reference's raster granularity
MAX_RASTER_CELLS = 4_000_000  # coarsen beyond this (multi-km route maps)
# clearance raster saturation (m): beyond this distance from a lane edge the
# sign can never flip, so the field clamps — keeps bilinear interpolation
# well-behaved across the near/far prefilter boundary (cutoff slack is 6 m)
CLEARANCE_CLAMP = 6.0
MAX_GRID_CELLS = 1_500_000  # same cap for the lane hash grid


def _pad_grid_edge(arr, fixed_shape):
    """Edge-replicate-pad the leading two (cell) dims to `fixed_shape`.

    Replication preserves the clip-to-edge lookup semantics EXACTLY: a
    query clamped into the padded region reads a copy of the nearest real
    edge cell — the same value the unpadded grid's clamp would return. A
    fixed shape keeps every downstream jitted program's signature constant
    across maps (per-episode route maps must not recompile)."""
    import numpy as onp

    gy, gx = arr.shape[:2]
    fy, fx = fixed_shape
    assert gy <= fy and gx <= fx, (arr.shape, fixed_shape)
    pad = [(0, fy - gy), (0, fx - gx)] + [(0, 0)] * (arr.ndim - 2)
    return onp.pad(arr, pad, mode="edge")


def _fit_cell(lo, hi, nominal_cell, fixed_shape):
    """Smallest cell >= nominal such that ceil(extent/cell)+1 <= shape."""
    ey = float(hi[1] - lo[1])
    ex = float(hi[0] - lo[0])
    fy, fx = fixed_shape
    return max(nominal_cell, ey / (fy - 1.01), ex / (fx - 1.01))


def _unique_pairs(cand):
    """(row, lane) index arrays of each row's distinct lanes >= 0 of `cand`
    [n, k] (candidate slots repeat lanes; a lane's distance or clearance
    is the same in every slot it holds, so each is computed once)."""
    import numpy as onp

    s = onp.sort(cand, axis=1)
    first = onp.ones_like(s, dtype=bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    rows, cols = onp.nonzero(first & (s >= 0))
    return rows, s[rows, cols]


def _build_drivable_raster(
    centerline: np.ndarray,  # [L, P, 2]
    width: np.ndarray,  # [L]
    valid: np.ndarray,  # [L]
    origin: np.ndarray,  # [2] (shared with the lane grid)
    cell: float = RASTER_CELL,
    margin: float = 0.3,
    k: int = 8,
    fixed_shape: tuple[int, int] | None = None,
):
    """[RY, RX] bool: cell center within half-width(+margin) of a lane
    centerline. Host-side, exact point-to-segment distances over the k
    nearest candidate lanes per cell. (The float clearance field lives in
    `_build_clearance_raster`, which mirrors on_road_exact's grid-hash
    candidate semantics.)"""
    import numpy as onp
    from scipy.spatial import cKDTree

    lane_ids_valid = onp.flatnonzero(valid)
    if len(lane_ids_valid) == 0:
        out = onp.zeros(fixed_shape or (1, 1), bool)
        return out, None, onp.float32(1.0 / cell)
    verts = centerline[lane_ids_valid].reshape(-1, 2)
    vert_lane = onp.repeat(lane_ids_valid, centerline.shape[1])
    hi = verts.max(0) + 12.0
    if fixed_shape is not None:
        cell = _fit_cell(origin, hi, cell, fixed_shape)
    # adaptive resolution: real-town routes span kilometers — cap the raster
    # at ~MAX_RASTER_CELLS by coarsening (accuracy loss documented; the
    # evaluator treats off-road at raster granularity either way)
    area = float(hi[0] - origin[0]) * float(hi[1] - origin[1])
    if area / (cell * cell) > MAX_RASTER_CELLS:
        cell = float(onp.sqrt(area / MAX_RASTER_CELLS))
    rx = int(onp.ceil((hi[0] - origin[0]) / cell)) + 1
    ry = int(onp.ceil((hi[1] - origin[1]) / cell)) + 1
    xs = origin[0] + (onp.arange(rx) + 0.5) * cell
    ys = origin[1] + (onp.arange(ry) + 0.5) * cell
    centers = onp.stack(
        [onp.repeat(xs[None], ry, 0), onp.repeat(ys[:, None], rx, 1)], axis=-1
    ).reshape(-1, 2)

    tree = cKDTree(verts)
    # cheap pre-filter: cells farther than any plausible half-width from the
    # nearest vertex can never be drivable — skip the expensive k-query
    # (route-union maps are mostly empty AABB)
    d1, _ = tree.query(centers, k=1, workers=-1)
    cutoff = float(width[lane_ids_valid].max()) * 0.5 + margin + 6.0
    near = onp.flatnonzero(d1 <= cutoff)

    out = onp.zeros(centers.shape[0], bool)
    q = min(8 * k, len(verts))
    chunk = 65536
    for lo in range(0, len(near), chunk):
        sel = near[lo : lo + chunk]
        pts = centers[sel]  # [n, 2]
        _, vidx = tree.query(pts, k=q, workers=-1)
        lanes = vert_lane[onp.atleast_2d(vidx)]  # [n, q] (dupes fine)
        lanes = lanes[:, :: max(q // k, 1)][:, :k]  # subsample to k candidates
        pi, lanes = _unique_pairs(lanes)
        cl = centerline[lanes]  # [m, P, 2]
        a, b = cl[:, :-1], cl[:, 1:]  # segments
        ab = b - a
        ap = pts[pi][:, None] - a
        t = onp.clip(
            (ap * ab).sum(-1) / onp.maximum((ab * ab).sum(-1), 1e-9), 0.0, 1.0
        )
        proj = a + t[..., None] * ab
        d = onp.linalg.norm(pts[pi][:, None] - proj, axis=-1).min(-1)  # [m]
        half_w = width[lanes] * 0.5 + margin
        out[sel] = onp.bincount(pi, d <= half_w, minlength=len(sel)) > 0
    out = out.reshape(ry, rx)
    if fixed_shape is not None:
        out = _pad_grid_edge(out, fixed_shape)
    return out, None, onp.float32(1.0 / cell)


def _build_clearance_raster(
    centerline: np.ndarray,  # [L, P, 2]
    width: np.ndarray,  # [L]
    valid: np.ndarray,  # [L]
    grid_lanes: np.ndarray,  # [GY, GX, GRID_K] the lane hash grid
    origin: np.ndarray,  # [2]
    grid_inv_cell: np.ndarray,  # []
    raster_shape: tuple[int, int],
    raster_inv_cell: np.ndarray,  # []
) -> np.ndarray:
    """[RY, RX] float32 signed clearance at raster cell centers, computed
    with EXACTLY `on_road_exact`'s semantics: candidates from the spatial
    hash grid, clearance = max over candidates of
    (half_width - |clamped-segment perpendicular lateral|), clamped to
    +-CLEARANCE_CLAMP. Bilinear sampling of this field (`on_road`)
    then reproduces the exact test up to interpolation error (~cm on
    straight boundaries, <~0.2 m at sharp junction corners)."""
    import numpy as onp

    from scipy.spatial import cKDTree

    ry, rx = raster_shape
    cell = 1.0 / float(raster_inv_cell)
    xs = origin[0] + (onp.arange(rx) + 0.5) * cell
    ys = origin[1] + (onp.arange(ry) + 0.5) * cell
    out = onp.full((ry, rx), -CLEARANCE_CLAMP, onp.float32)
    if not valid.any():
        return out

    # prefilter: only cells that could have clearance > -CLAMP need the
    # exact projection (route-union maps are mostly empty AABB). Vertex
    # spacing bounds the vertex-vs-segment distance gap by max_seg/2.
    verts_all = centerline[valid].reshape(-1, 2)
    seg_len = onp.linalg.norm(onp.diff(centerline[valid], axis=1), axis=-1)
    cutoff = (
        CLEARANCE_CLAMP
        + float(width[valid].max()) * 0.5
        + float(seg_len.max()) * 0.5
        + cell
    )
    tree = cKDTree(verts_all)

    gy, gx = grid_lanes.shape[:2]
    chunk_rows = max(1, 262_144 // max(rx, 1))
    for r0 in range(0, ry, chunk_rows):
        yy = ys[r0 : r0 + chunk_rows]
        grid_pts = onp.stack(
            [
                onp.repeat(xs[None], len(yy), 0),
                onp.repeat(yy[:, None], rx, 1),
            ],
            axis=-1,
        ).reshape(-1, 2)
        d1, _ = tree.query(grid_pts, k=1, workers=-1)
        nearsel = onp.flatnonzero(d1 <= cutoff)
        if len(nearsel) == 0:
            continue
        pts = grid_pts[nearsel]  # [n, 2]
        cellf = (pts - origin[None]) * float(grid_inv_cell)
        cx = onp.clip(cellf[:, 0].astype(onp.int64), 0, gx - 1)
        cy = onp.clip(cellf[:, 1].astype(onp.int64), 0, gy - 1)
        cand = grid_lanes[cy, cx]  # [n, K]
        cand = onp.where(valid[onp.maximum(cand, 0)], cand, -1)
        pi, li = _unique_pairs(cand)
        p = pts[pi]  # [m, 2]
        cl = centerline[li]  # [m, P, 2]
        a, b = cl[:, :-1], cl[:, 1:]
        ab = b - a
        ap = p[:, None] - a
        t = onp.clip(
            (ap * ab).sum(-1) / onp.maximum((ab * ab).sum(-1), 1e-12),
            0.0, 1.0,
        )
        proj = a + t[..., None] * ab
        d2 = onp.sum((p[:, None] - proj) ** 2, axis=-1)  # [m, P-1]
        seg = onp.argmin(d2, axis=-1)
        pair = onp.arange(len(li))
        pb = proj[pair, seg]
        tb = ab[pair, seg]
        tb /= onp.maximum(onp.linalg.norm(tb, axis=-1, keepdims=True), 1e-12)
        rel = p - pb
        lat = onp.abs(rel[..., 0] * tb[..., 1] - rel[..., 1] * tb[..., 0])
        clr = onp.full(len(pts), -onp.inf)
        onp.maximum.at(clr, pi, width[li] * 0.5 - lat)  # the best lane of each point
        block = out[r0 : r0 + chunk_rows].reshape(-1)
        block[nearsel] = onp.clip(clr, -CLEARANCE_CLAMP, CLEARANCE_CLAMP)
        out[r0 : r0 + chunk_rows] = block.reshape(len(yy), rx)
    return out


def _build_spatial_grid(
    centerline: np.ndarray,  # [L, P, 2]
    valid: np.ndarray,  # [L]
    cell: float = GRID_CELL,
    k: int = GRID_K,
    margin: float = 12.0,
    fixed_shape: tuple[int, int] | None = None,
):
    """[GY, GX, k] int32 table of the k nearest distinct lanes per cell center
    (host, cKDTree over all valid centerline vertices)."""
    import numpy as onp
    from scipy.spatial import cKDTree

    lane_ids_valid = onp.flatnonzero(valid)
    if len(lane_ids_valid) == 0:
        return (
            onp.full(
                (fixed_shape or (1, 1)) + (k,), -1, onp.int32
            ),
            onp.zeros(2, onp.float32),
            onp.float32(1.0 / cell),
        )
    verts = centerline[lane_ids_valid].reshape(-1, 2)
    vert_lane = onp.repeat(lane_ids_valid, centerline.shape[1])
    lo = verts.min(0) - margin
    hi = verts.max(0) + margin
    if fixed_shape is not None:
        cell = _fit_cell(lo, hi, cell, fixed_shape)
    # adaptive cell on multi-km maps (exactness kept by the K-candidate
    # re-rank as long as the cell's K nearest lanes cover the local overlap)
    area = float(hi[0] - lo[0]) * float(hi[1] - lo[1])
    if area / (cell * cell) > MAX_GRID_CELLS:
        cell = float(onp.sqrt(area / MAX_GRID_CELLS))
    gx = int(onp.ceil((hi[0] - lo[0]) / cell)) + 1
    gy = int(onp.ceil((hi[1] - lo[1]) / cell)) + 1
    xs = lo[0] + (onp.arange(gx) + 0.5) * cell
    ys = lo[1] + (onp.arange(gy) + 0.5) * cell
    centers = onp.stack(
        [onp.repeat(xs[None], gy, 0), onp.repeat(ys[:, None], gx, 1)], axis=-1
    ).reshape(-1, 2)

    tree = cKDTree(verts)
    n_cells = centers.shape[0]
    # pre-filter: distant cells only ever need their single nearest lane
    # (queries there are lane binding for stray agents, not overlap logic)
    d1, i1 = tree.query(centers, k=1, workers=-1)
    near = onp.flatnonzero(d1 <= 40.0)
    chosen = onp.repeat(vert_lane[i1][:, None], k, axis=1).astype(onp.int64)

    # query enough vertices to find k distinct lanes (vertices cluster by lane)
    q = min(max(8 * k, 32), len(verts))
    if len(near):
        _, idx = tree.query(centers[near], k=q, workers=-1)
        lanes = vert_lane[onp.atleast_2d(idx)]  # [Nn, q]
        sub = onp.full((len(near), k), -1, onp.int64)
        count = onp.zeros(len(near), onp.int64)
        rows = onp.arange(len(near))
        for j in range(lanes.shape[1]):
            lane_j = lanes[:, j]
            is_new = (sub != lane_j[:, None]).all(1) & (count < k)
            sub[rows[is_new], count[is_new]] = lane_j[is_new]
            count[is_new] += 1
            if (count >= k).all():
                break
        # pad unfilled slots with the cell's nearest lane (never -1 when any
        # lane exists) so gathers stay in-bounds / at worst redundant
        sub = onp.where(sub < 0, sub[:, :1], sub)
        chosen[near] = sub
    chosen = chosen.reshape(gy, gx, k).astype(onp.int32)
    if fixed_shape is not None:
        chosen = _pad_grid_edge(chosen, fixed_shape)
    return (
        chosen,
        lo.astype(onp.float32),
        onp.float32(1.0 / cell),
    )


def _offset_polyline(poly: np.ndarray, offset: float) -> np.ndarray:
    """Offset a polyline along its left normal by `offset` (host-side)."""
    import numpy as onp

    vec = onp.diff(poly, axis=0)
    vec = onp.concatenate([vec, vec[-1:]], axis=0)
    norm = onp.linalg.norm(vec, axis=1, keepdims=True)
    norm = onp.maximum(norm, 1e-9)
    normal = onp.stack([-vec[:, 1], vec[:, 0]], axis=-1) / norm
    return (poly + offset * normal).astype(onp.float32)


def _crosswalk_edges(polygon: np.ndarray, n: int) -> np.ndarray:
    """Center/left/right edge polylines of a crosswalk polygon's oriented
    bbox, following nuplan_map_utils.py:_get_crosswalk_edges (without shapely:
    we use the PCA-aligned box of the polygon vertices)."""
    import numpy as onp

    pts = onp.asarray(polygon, dtype=onp.float64)
    c = pts.mean(axis=0)
    x = pts - c
    cov = x.T @ x
    evals, evecs = onp.linalg.eigh(cov)
    major = evecs[:, onp.argmax(evals)]
    minor = evecs[:, onp.argmin(evals)]
    lon = x @ major
    lat = x @ minor
    lo, hi = lon.min(), lon.max()
    la, lb = lat.min(), lat.max()
    t = onp.linspace(lo, hi, n)
    center = c + t[:, None] * major
    left = center + lb * minor
    right = center + la * minor
    return onp.stack([center, left, right], axis=0).astype(onp.float32)
