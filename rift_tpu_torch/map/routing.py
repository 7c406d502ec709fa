"""Global route planning over the lane graph (port of
rift_tpu/map/routing.py: the same host-side numpy code over the map's
host copies).

Replaces the reference's networkx-A* GlobalRoutePlanner
(rift/scenario/tools/global_route_planner.py:20-111): we run BFS/Dijkstra on
the host over the TensorMap's successor/adjacency arrays at scenario reset
(routes are episode-static), producing dense route tensors the device consumes.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..utils.tensors import to_numpy
from .tensor_map import TensorMap

LANE_CHANGE_COST = 15.0  # discourage but allow lane changes, like the
# reference's topology graph which includes adjacent-lane edges

# lane-change blend window as fractions of the lane extent: the blended
# route keeps the source lane up to LC_KEEP_FRAC, crosses laterally, and
# lands on the target lane at LC_END_FRAC. Shared by route_waypoints
# (geometry) and route_distance_field (arclength bookkeeping) — adjacent
# lanes span the SAME physical extent, so a path stepping through an
# adjacency edge must not double-count it.
LC_KEEP_FRAC = 0.35
LC_END_FRAC = 0.85


_HOST_CACHE: dict[int, dict] = {}


_HOST_FIELDS = (
    "successors", "left_adj", "right_adj", "length", "valid",
    "centerline", "headings", "road_id", "lane_id",
)


def host_map(tmap: TensorMap) -> dict:
    """Host (numpy) copies of map arrays, cached per map: each copy of a
    device tensor is a device->host transfer. The cache entry holds the
    centerline tensor it was keyed on, so a recycled id never hits."""
    key = id(tmap.centerline)
    hit = _HOST_CACHE.get(key)
    if hit is None or hit["_key"] is not tmap.centerline:
        hit = {k: to_numpy(getattr(tmap, k)) for k in _HOST_FIELDS}
        hit["_key"] = tmap.centerline
        _HOST_CACHE[key] = hit
    return hit


def _host_arrays(tmap: TensorMap):
    h = host_map(tmap)
    return (
        h["successors"],
        h["left_adj"],
        h["right_adj"],
        h["length"],
        h["valid"],
    )


def trace_route(tmap: TensorMap, start_lane: int, goal_lane: int):
    """Dijkstra over the lane graph. Returns (lane_indices list, total_dist)
    or (None, inf) if unreachable. Host-side (reset-time only)."""
    succ, left, right, length, valid = _host_arrays(tmap)
    L = len(length)
    dist = np.full(L, np.inf)
    prev = np.full(L, -1, np.int64)
    dist[start_lane] = 0.0
    pq = [(0.0, int(start_lane))]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        if u == goal_lane:
            break
        edges = [(int(v), float(length[u])) for v in succ[u] if v >= 0]
        for v in (left[u], right[u]):
            if v >= 0:
                edges.append((int(v), LANE_CHANGE_COST))
        for v, w in edges:
            if not valid[v]:
                continue
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                prev[v] = u
                heapq.heappush(pq, (nd, v))
    if not np.isfinite(dist[goal_lane]):
        return None, np.inf
    path = [int(goal_lane)]
    while path[-1] != start_lane:
        path.append(int(prev[path[-1]]))
    return path[::-1], float(dist[goal_lane])


def route_distance_field(tmap: TensorMap, lane_path: list[int], max_dist: float = 400.0):
    """Per-lane driving distance to the ego route (host, reset-time).

    Returns (D [L] float32, J [L] float32): D[l] = driving distance from the
    START of lane l to where the lane graph first joins the route;
    J[l] = route arclength (m) at that join point. Path lanes seed D=0 with
    J = their cumulative arclength. Unreachable lanes get D=inf.

    A candidate at arclength s on lane l is then, for any route point at
    arclength w: `route_dist = (D[l] - s) + (w - J[l])`, valid when
    w >= J[l] — the per-candidate A* of the reference's interaction
    matching (base_cbv.py:66-192) collapsed into one reset-time field.
    """
    succ, left, right, length, valid = _host_arrays(tmap)
    L = len(length)
    # reversed adjacency: reaching lane u's start means we can relax every
    # predecessor p with weight length[p]
    preds: list[list[int]] = [[] for _ in range(L)]
    for u in range(L):
        if not valid[u]:
            continue
        for v in succ[u]:
            if v >= 0 and valid[v]:
                preds[int(v)].append(u)

    D = np.full(L, np.inf, np.float64)
    J = np.full(L, np.inf, np.float64)
    pq = []
    s_cum = 0.0
    prev = None
    for li in lane_path:
        if prev is not None and li in (int(left[prev]), int(right[prev])):
            # lane-change edge: the blended route consumed only
            # ~LC_END_FRAC of `prev` and lands on `li` at lane-arclength
            # ~LC_END_FRAC * length[li] (route_waypoints geometry) — the
            # two lanes overlap physically, so rewind the double count
            s_cum -= (1.0 - LC_END_FRAC) * float(length[prev])
            join_s = LC_END_FRAC * float(length[li])
            if not np.isfinite(J[li]):
                D[li] = join_s
                J[li] = s_cum
                heapq.heappush(pq, (join_s, int(li)))
            s_cum += (1.0 - LC_END_FRAC) * float(length[li])
        else:
            if not np.isfinite(J[li]):
                D[li] = 0.0
                J[li] = s_cum
                heapq.heappush(pq, (0.0, int(li)))
            s_cum += float(length[li])
        prev = li
    while pq:
        d, u = heapq.heappop(pq)
        if d > D[u] or d > max_dist:
            continue
        for p in preds[u]:
            nd = d + float(length[p])
            if nd < D[p]:
                D[p] = nd
                J[p] = J[u]
                heapq.heappush(pq, (nd, p))
        # lane-change edges: a vehicle on a lane ADJACENT to u can merge
        # into u (the reference's interaction matching runs A* over a
        # topology graph that includes adjacent-lane edges,
        # global_route_planner.py:159+ / base_cbv.py:66-192 — without
        # these, candidates on the parallel lane are never route-reachable)
        for a in (int(left[u]), int(right[u])):
            if a >= 0 and valid[a]:
                nd = d + LANE_CHANGE_COST
                if nd < D[a]:
                    D[a] = nd
                    J[a] = J[u]
                    heapq.heappush(pq, (nd, a))
    return D.astype(np.float32), J.astype(np.float32)


def route_waypoints(tmap: TensorMap, lane_path: list[int], spacing: float = 1.0):
    """Densify a lane path into ~`spacing`-meter waypoints [N, 3] (x, y, hdg).

    Equivalent to interpolate_trajectory (route_manipulation.py:137-164).
    Successor edges append the next lane's centerline; ADJACENCY edges
    (the path stepping to left_adj/right_adj — a lane change) become a
    smooth lateral blend along the shared road extent instead of a
    double-back to the adjacent lane's start (the reference's route plan
    likewise stays monotone along the road through CHANGELANELEFT/RIGHT
    options, global_route_planner.py:113-157).
    """
    hm = host_map(tmap)
    cl, hd = hm["centerline"], hm["headings"]
    left, right = hm["left_adj"], hm["right_adj"]
    P = cl.shape[1]
    a_cut = max(int(LC_KEEP_FRAC * P), 1)
    b_cut = min(int(LC_END_FRAC * P), P - 1)

    pts, hdg = [], []
    start_idx = 0  # first centerline vertex of the current lane to emit
    for k, li in enumerate(lane_path):
        p, ph = cl[li], hd[li]
        nxt = lane_path[k + 1] if k + 1 < len(lane_path) else None
        if nxt is not None and nxt in (int(left[li]), int(right[li])):
            a = min(max(a_cut, start_idx + 1), P - 2)
            b = min(max(b_cut, a + 2), P)
            keep = p[start_idx:a]
            t = np.linspace(0.0, 1.0, b - a + 1)[1:, None]
            blend = p[a:b] * (1.0 - t) + cl[nxt][a:b] * t
            seg = np.concatenate([keep, blend])
            d = np.diff(seg, axis=0)
            sh = np.arctan2(d[:, 1], d[:, 0])
            pts.append(seg)
            hdg.append(np.concatenate([sh, sh[-1:]]))
            start_idx = b  # the next (adjacent) lane resumes past the blend
            continue
        pts.append(p[start_idx:] if start_idx else p)
        hdg.append(ph[start_idx:] if start_idx else ph)
        start_idx = 1  # successor lanes share the boundary vertex
    pts = np.concatenate(pts)
    hdg = np.concatenate(hdg)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    t = np.arange(0.0, max(total, spacing), spacing)
    x = np.interp(t, s, pts[:, 0])
    y = np.interp(t, s, pts[:, 1])
    c = np.interp(t, s, np.cos(hdg))
    sn = np.interp(t, s, np.sin(hdg))
    return np.stack([x, y, np.arctan2(sn, c)], axis=-1)


def nearest_lane_host(tmap: TensorMap, point) -> int:
    h = host_map(tmap)
    cl, valid = h["centerline"], h["valid"]
    d2 = ((cl - np.asarray(point)[None, None, :]) ** 2).sum(-1).min(-1)
    d2[~valid] = np.inf
    return int(np.argmin(d2))


def route_road_lane_ids(tmap: TensorMap, lane_path: list[int], pad_to: int = 64):
    """Fixed-size (road_ids, lane_ids) arrays for on_route_mask, padded -1."""
    h = host_map(tmap)
    rid = h["road_id"][lane_path]
    lid = h["lane_id"][lane_path]
    out_r = np.full(pad_to, -1, np.int32)
    out_l = np.zeros(pad_to, np.int32)
    n = min(len(rid), pad_to)
    out_r[:n] = rid[:n]
    out_l[:n] = lid[:n]
    return out_r, out_l
