"""Junction-bearing maps derived from Bench2Drive routes (port of
rift_tpu/map/from_route.py: the numpy builders are copied unchanged, so
both packages build the same lanes in the same order; the map lands on
`device`, CUDA unless the caller names another).

The reference repo ships Bench2Drive route XMLs but not the CARLA HD-map npz
artifacts, so route keypoint polylines are compiled into a
drivable TensorMap town: the route corridor (route lane + parallel lanes)
plus, at every detected corner, a REAL junction — the corridor is cut
`JUNCTION_RADIUS` short on both sides and re-joined with signalised bezier
connectors, and a perpendicular two-way cross road with straight-through
connectors (opposing light phase) crosses there. Routes therefore traverse
junctions with working traffic lights and crossing traffic, so red-light
infractions and crossing-hazard behavior are exercised on the route
files. `map_from_routes` merges a whole batch of routes into ONE map
(distinct road-id ranges per route) so the data loader's non-overlapping
batches co-simulate in one batched state. When
real `TownXX_HD_map.npz` files are present, `compiler.compile_town`
supersedes this.
"""

from __future__ import annotations

import numpy as np

from .tensor_map import TensorMap, build_tensor_map

SEGMENT_LEN = 100.0
LANE_WIDTH = 3.5
ROAD_ID_STRIDE = 10000  # road-id block per route in a merged map
# Route tiling: routes arrive at native town coordinates (km apart across
# towns), which would union into a giant, mostly-empty AABB — a multi-MB
# spatial grid whose SHAPE changes with every sampled batch. Scenarios
# never interact across the [S] axis, so each route is translated into a
# compact vertical tile instead; with the fixed GRID_SHAPE/RASTER_SHAPE
# below, every route map in a run has identical array shapes (the same
# buffers episode after episode) and near-nominal grid resolution.
TILE_PAD = 90.0  # clearance per tile: cross arms (60) + lanes + grid margin
TILE_GAP = 40.0  # extra separation between consecutive tiles
GRID_SHAPE = (1792, 256)  # [GY, GX] lane hash cells (2 m nominal)
RASTER_SHAPE = (3584, 512)  # [RY, RX] drivable raster cells (1 m nominal)
JUNCTION_RADIUS = 14.0  # corridor cut-back around a corner
CROSS_ARM_LEN = 60.0  # cross-road length each side of the junction
CORNER_ANGLE = 0.35  # rad of heading change that makes a corner (~20 deg)
CORNER_WINDOW = 4  # resample steps (x2 m) over which the change is measured
MIN_CORNER_GAP = 50.0  # m between distinct corners
RESAMPLE_M = 2.0


def _resample(keypoints: np.ndarray) -> np.ndarray:
    pts = np.asarray(keypoints, dtype=np.float64)[:, :2]
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = max(s[-1], 4.0)
    t = np.arange(0.0, total, RESAMPLE_M)
    return np.stack(
        [np.interp(t, s, pts[:, 0]), np.interp(t, s, pts[:, 1])], axis=-1
    )


def _headings(pts: np.ndarray) -> np.ndarray:
    vec = np.gradient(pts, axis=0)
    return np.arctan2(vec[:, 1], vec[:, 0])


def _find_corners(pts: np.ndarray) -> list[int]:
    """Indices of junction-worthy corners: local maxima of windowed heading
    change above CORNER_ANGLE, at least MIN_CORNER_GAP apart and clear of
    the route ends."""
    h = _headings(pts)
    w = CORNER_WINDOW
    n = len(pts)
    if n < 4 * w:
        return []
    delta = np.abs(
        np.angle(np.exp(1j * (h[2 * w :] - h[: -2 * w])))
    )  # [n-2w]
    corners: list[int] = []
    margin = int((JUNCTION_RADIUS + 6.0) / RESAMPLE_M)
    i = margin
    lim = len(delta) - margin
    gap = int(MIN_CORNER_GAP / RESAMPLE_M)
    while i < lim:
        if delta[i] > CORNER_ANGLE:
            # take the local peak of this corner event
            j = i
            while j + 1 < lim and delta[j + 1] >= delta[j]:
                j += 1
            corners.append(j + w)  # center of the window
            i = j + gap
        else:
            i += 1
    return corners


def _corridor_lanes(
    pts: np.ndarray,
    road_base: int,
    num_lanes: int,
    lane_width: float,
    speed_limit: float,
    lanes: list[dict],
    keys_out: list[tuple],
    base_off: float = 0.0,
):
    """Append corridor lane dicts for one uninterrupted route section.
    Returns (first_keys, last_keys) per lane offset for junction stitching:
    lists of the section's first and last (road_id, lane_id) per lane.
    `base_off` shifts the whole lane group right of the polyline — the
    reverse carriageway passes its reversed polyline with base_off =
    lane_width so its lanes sit left of the forward group."""
    vec = np.gradient(pts, axis=0)
    norm = np.maximum(np.linalg.norm(vec, axis=1, keepdims=True), 1e-9)
    d = vec / norm
    right = np.stack([d[:, 1], -d[:, 0]], axis=-1)
    total = RESAMPLE_M * (len(pts) - 1)
    n_seg = max(int(np.ceil(total / SEGMENT_LEN)), 1)
    pts_per_seg = max(len(pts) // n_seg, 2)

    first_keys = [None] * num_lanes
    last_keys = [None] * num_lanes
    for li in range(num_lanes):
        off = base_off + li * lane_width
        lane_pts = pts + right * off
        lane_id = -(li + 1)
        for si in range(n_seg):
            lo = si * pts_per_seg
            hi = min((si + 1) * pts_per_seg + 1, len(pts))
            if hi - lo < 2:
                continue
            road = road_base + si + 1
            succ = [(road + 1, lane_id)] if si + 1 < n_seg else []
            lanes.append(
                dict(
                    centerline=lane_pts[lo:hi],
                    width=lane_width,
                    road_id=road,
                    lane_id=lane_id,
                    is_junction=False,
                    successors=succ,
                    left_adj=(road, lane_id + 1) if li > 0 else None,
                    right_adj=(road, lane_id - 1) if li + 1 < num_lanes else None,
                    speed_limit=speed_limit,
                )
            )
            if first_keys[li] is None:
                first_keys[li] = (road, lane_id)
            last_keys[li] = (road, lane_id)
            if li == 0:
                keys_out.append((road, lane_id))
    return first_keys, last_keys


def _bezier(p0, d0, p1, d1, n=15):
    dist = max(np.linalg.norm(p1 - p0), 1e-6)
    c0 = p0 + d0 * dist * 0.4
    c1 = p1 - d1 * dist * 0.4
    t = np.linspace(0, 1, n)[:, None]
    return (
        (1 - t) ** 3 * p0
        + 3 * (1 - t) ** 2 * t * c0
        + 3 * (1 - t) * t**2 * c1
        + t**3 * p1
    )


UTURN_SPEED = 5.0  # m/s limit on turnaround connectors (tight radius)


def _uturn(p0, d, p1, depth, n=21):
    """Teardrop turnaround: depart `p0` along `d`, loop around, arrive at
    `p1` heading `-d`. Both bezier control points sit `depth` m out along
    `d`, which bulges the curve past the endpoints so the turn radius stays
    driveable even when p0/p1 are one lane width apart."""
    c0 = p0 + d * depth
    c1 = p1 + d * depth
    t = np.linspace(0, 1, n)[:, None]
    return (
        (1 - t) ** 3 * p0
        + 3 * (1 - t) ** 2 * t * c0
        + 3 * (1 - t) * t**2 * c1
        + t**3 * p1
    )


def _route_lanes(
    keypoints: np.ndarray,
    road_base: int,
    num_lanes: int,
    lane_width: float,
    speed_limit: float,
    light_group_base: int,
    cross_roads: bool = True,
    stop_ratio: float = 0.0,
    extra_corners: list[tuple] | None = None,
    pts_resampled: np.ndarray | None = None,
):
    """Lane dicts for one route: corridor sections + signalised junctions
    with cross roads at corners. Returns (lanes, primary_keys, n_junctions).

    `stop_ratio` > 0 converts that fraction of junctions (deterministically,
    every round(1/ratio)-th, matching map/synthetic.py) to all-way-stop:
    connectors lose the light phase and every approach lane — the route's
    own and the cross road's — gets a stop line at its end
    (`TensorMap.stop_lane`; CARLA's `traffic.stop` trigger volumes,
    atomic_criteria.py:1806).

    `extra_corners` = [(resample_idx, light_group, arms)] injects junctions
    at route-route crossings (shared_map_from_routes): the connector takes
    the GIVEN light group (the other route holds the opposing phase) and
    `arms=False` skips the synthetic perpendicular cross road — the other
    route IS the cross traffic."""
    pts = _resample(keypoints) if pts_resampled is None else pts_resampled
    own = _find_corners(pts)
    cut = int(JUNCTION_RADIUS / RESAMPLE_M)
    gap = int(MIN_CORNER_GAP / RESAMPLE_M)
    if not own and len(pts) > 2 * (cut + 8):
        # straight route (the Bench2Drive dev routes are short, nearly
        # straight scenario segments): synthesize through-junctions at
        # interior points so the route still crosses signalised/stop
        # intersections with cross traffic, like the real towns it came
        # from (Town13/Town15 routes pass intersections the corridor
        # abstraction would otherwise erase)
        n3 = len(pts) // 3
        own = [n3, 2 * n3] if len(pts) * RESAMPLE_M > 180 else [len(pts) // 2]
    # corner spec: (idx, group_override or None, arms)
    specs = [(c, None, cross_roads) for c in own]
    margin = cut + 3
    for idx, grp, arms in extra_corners or []:
        idx = int(np.clip(idx, margin, len(pts) - 1 - margin))
        # a shared crossing WINS over a nearby auto corner — the junction
        # is at the crossing and its light phase is shared with the other
        # route; two shared crossings too close keep the first
        specs = [
            (c, g, a)
            for c, g, a in specs
            if g is not None or abs(idx - c) >= gap
        ]
        if any(abs(idx - c) < gap for c, _, _ in specs):
            continue
        specs.append((idx, grp, arms))
    specs.sort(key=lambda t: t[0])
    corners = [c for c, _, _ in specs]

    lanes: list[dict] = []
    primary: list[tuple] = []
    by_key = lambda: {(l["road_id"], l["lane_id"]): l for l in lanes}

    # section boundaries (in resample indices)
    bounds = [0]
    for c in corners:
        bounds += [max(c - cut, bounds[-1] + 2), c + cut]
    bounds.append(len(pts) - 1)

    section_ends = []  # (first_keys, last_keys) per section
    rid = road_base
    for k in range(0, len(bounds) - 1, 2):
        lo, hi = bounds[k], bounds[k + 1]
        sec = pts[lo : hi + 1]
        if len(sec) < 2:
            sec = pts[lo : lo + 2]
        fk, lk = _corridor_lanes(
            sec, rid, num_lanes, lane_width, speed_limit, lanes, primary
        )
        section_ends.append((fk, lk))
        rid += 200

    # reverse carriageway: same sections driven the other way, lanes offset
    # one width to the left of the forward group. Together with the
    # turnaround connectors below this closes the lane graph — CARLA towns
    # are connected road networks, so BV flow circulates and CBV lane
    # chains never dead-end (nuplan_map_utils.py:46-66 topology; without
    # this every vehicle eventually parks at the corridor end and the
    # whole scenario congeals)
    rev_ends = []
    _sink: list[tuple] = []
    for k in range(0, len(bounds) - 1, 2):
        lo, hi = bounds[k], bounds[k + 1]
        sec = pts[lo : hi + 1]
        if len(sec) < 2:
            sec = pts[lo : lo + 2]
        fk, lk = _corridor_lanes(
            sec[::-1], rid, num_lanes, lane_width, speed_limit, lanes,
            _sink, base_off=lane_width,
        )
        rev_ends.append((fk, lk))
        rid += 200

    # junctions between consecutive sections
    stop_every = int(round(1.0 / stop_ratio)) if stop_ratio > 0 else 0
    table = by_key()
    n_auto = 0
    for j, (c, grp_override, arms) in enumerate(specs):
        # shared-crossing junctions keep their assigned (shared) phase and
        # are never stop junctions; only auto corners consume local groups
        if grp_override is None:
            is_stop_junction = stop_every > 0 and n_auto % stop_every == 0
            group = -1 if is_stop_junction else light_group_base + 2 * n_auto
            n_auto += 1
        else:
            is_stop_junction = False
            group = grp_override
        _, prev_last = section_ends[j]
        next_first, _ = section_ends[j + 1]
        h_in = _headings(pts)[max(c - cut, 0)]
        h_out = _headings(pts)[min(c + cut, len(pts) - 1)]
        d_in = np.array([np.cos(h_in), np.sin(h_in)])
        d_out = np.array([np.cos(h_out), np.sin(h_out)])
        for li in range(num_lanes):
            a, b = prev_last[li], next_first[li]
            if a is None or b is None:
                continue
            p0 = np.asarray(table[a]["centerline"])[-1]
            p1 = np.asarray(table[b]["centerline"])[0]
            conn_rid = rid
            rid += 1
            lane_id = -(li + 1)
            lanes.append(
                dict(
                    centerline=_bezier(p0, d_in, p1, d_out),
                    width=lane_width,
                    road_id=conn_rid,
                    lane_id=lane_id,
                    is_junction=True,
                    successors=[b],
                    left_adj=None,
                    right_adj=None,
                    speed_limit=speed_limit,
                    light_group=group,
                )
            )
            table[a].setdefault("successors", []).append((conn_rid, lane_id))
            if is_stop_junction:
                table[a]["stop"] = True
            table[(conn_rid, lane_id)] = lanes[-1]
            if li == 0:
                # splice the connector into the primary driving order,
                # right after its approach segment
                primary.insert(primary.index(a) + 1, (conn_rid, lane_id))

        # reverse-carriageway connector through the same junction (opposing
        # direction shares the forward phase, as opposing straight flows do)
        for li in range(num_lanes):
            a, b = rev_ends[j + 1][1][li], rev_ends[j][0][li]
            if a is None or b is None:
                continue
            p0 = np.asarray(table[a]["centerline"])[-1]
            p1 = np.asarray(table[b]["centerline"])[0]
            conn_rid = rid
            rid += 1
            lane_id = -(li + 1)
            lanes.append(
                dict(
                    centerline=_bezier(p0, -d_out, p1, -d_in),
                    width=lane_width,
                    road_id=conn_rid,
                    lane_id=lane_id,
                    is_junction=True,
                    successors=[b],
                    left_adj=None,
                    right_adj=None,
                    speed_limit=speed_limit,
                    light_group=group,
                )
            )
            table[a].setdefault("successors", []).append((conn_rid, lane_id))
            if is_stop_junction:
                table[a]["stop"] = True
            table[(conn_rid, lane_id)] = lanes[-1]

        if not arms:
            continue
        # perpendicular two-way cross road through the corner
        center = pts[c]
        bis = d_in + d_out
        bis = bis / max(np.linalg.norm(bis), 1e-9)
        perp = np.array([-bis[1], bis[0]])
        arm_tips = {0: {}, 1: {}}  # side -> li -> (in_key, out_key, a0, b1, dirv)
        for side in (0, 1):  # two directions of the cross road
            dirv = perp if side == 0 else -perp
            rightv = np.array([dirv[1], -dirv[0]])
            for li in range(num_lanes):
                off = (li + 0.5) * lane_width
                lane_id = -(li + 1)
                # incoming arm: far -> junction edge
                a0 = center - dirv * CROSS_ARM_LEN + rightv * off
                a1 = center - dirv * JUNCTION_RADIUS + rightv * off
                # outgoing arm: junction edge -> far
                b0 = center + dirv * JUNCTION_RADIUS + rightv * off
                b1 = center + dirv * CROSS_ARM_LEN + rightv * off
                rid_in, rid_conn, rid_out = rid, rid + 1, rid + 2
                rid += 3
                lanes.append(
                    dict(
                        centerline=np.stack(
                            [a0 + (a1 - a0) * t for t in np.linspace(0, 1, 15)]
                        ),
                        width=lane_width,
                        road_id=rid_in,
                        lane_id=lane_id,
                        is_junction=False,
                        successors=[(rid_conn, lane_id)],
                        left_adj=(rid_in, lane_id + 1) if li > 0 else None,
                        right_adj=(rid_in, lane_id - 1)
                        if li + 1 < num_lanes
                        else None,
                        speed_limit=speed_limit,
                        stop=is_stop_junction,
                    )
                )
                lanes.append(
                    dict(
                        centerline=np.stack(
                            [a1 + (b0 - a1) * t for t in np.linspace(0, 1, 15)]
                        ),
                        width=lane_width,
                        road_id=rid_conn,
                        lane_id=lane_id,
                        is_junction=True,
                        successors=[(rid_out, lane_id)],
                        left_adj=None,
                        right_adj=None,
                        speed_limit=speed_limit,
                        # opposing phase to the route; -1 = all-way stop
                        light_group=-1 if is_stop_junction else group + 1,
                    )
                )
                lanes.append(
                    dict(
                        centerline=np.stack(
                            [b0 + (b1 - b0) * t for t in np.linspace(0, 1, 15)]
                        ),
                        width=lane_width,
                        road_id=rid_out,
                        lane_id=lane_id,
                        is_junction=False,
                        successors=[],
                        left_adj=(rid_out, lane_id + 1) if li > 0 else None,
                        right_adj=(rid_out, lane_id - 1)
                        if li + 1 < num_lanes
                        else None,
                        speed_limit=speed_limit,
                    )
                )
                arm_tips[side][li] = (
                    (rid_in, lane_id), (rid_out, lane_id), a0, b1, dirv
                )
        # close the cross road: each out-arm turns around at its tip into
        # the opposite side's in-arm, so cross traffic circulates through
        # the junction instead of parking at the arm end
        table = by_key()
        for side in (0, 1):
            for li in range(num_lanes):
                _, out_key, _, b1, dirv = arm_tips[side][li]
                in_key, _, a0_other, _, _ = arm_tips[1 - side][li]
                lane_id = -(li + 1)
                rid_u = rid
                rid += 1
                lanes.append(
                    dict(
                        centerline=_uturn(
                            b1, dirv, a0_other, 8.0 + 3.0 * li
                        ),
                        width=lane_width,
                        road_id=rid_u,
                        lane_id=lane_id,
                        is_junction=True,
                        successors=[in_key],
                        left_adj=None,
                        right_adj=None,
                        speed_limit=UTURN_SPEED,
                    )
                )
                table[out_key].setdefault("successors", []).append(
                    (rid_u, lane_id)
                )
                table[(rid_u, lane_id)] = lanes[-1]
        table = by_key()

    # turnaround loops at both route ends: forward end -> reverse
    # carriageway -> forward start. With the junction connectors above this
    # makes the whole tile strongly connected (every lane's chain continues
    # forever), replacing the reference towns' connected road mesh.
    h_all = _headings(pts)
    d_end = np.array([np.cos(h_all[-1]), np.sin(h_all[-1])])
    d_start = np.array([np.cos(h_all[0]), np.sin(h_all[0])])
    table = by_key()
    for li in range(num_lanes):
        lane_id = -(li + 1)
        links = [
            # (approach key, depart dir, arrive key)
            (section_ends[-1][1][li], d_end, rev_ends[-1][0][li]),
            (rev_ends[0][1][li], -d_start, section_ends[0][0][li]),
        ]
        for a, d, b in links:
            if a is None or b is None:
                continue
            p0 = np.asarray(table[a]["centerline"])[-1]
            p1 = np.asarray(table[b]["centerline"])[0]
            rid_u = rid
            rid += 1
            lanes.append(
                dict(
                    centerline=_uturn(p0, d, p1, 9.0 + 3.0 * li),
                    width=lane_width,
                    road_id=rid_u,
                    lane_id=lane_id,
                    is_junction=True,
                    successors=[b],
                    left_adj=None,
                    right_adj=None,
                    speed_limit=UTURN_SPEED,
                )
            )
            table[a].setdefault("successors", []).append((rid_u, lane_id))
            table[(rid_u, lane_id)] = lanes[-1]

    return lanes, primary, n_auto


def map_from_routes(
    keypoints_list: list[np.ndarray],
    num_lanes: int = 2,
    lane_width: float = LANE_WIDTH,
    speed_limit: float = 14.0,
    pad_lanes_to: int | None = None,
    cross_roads: bool = True,
    stop_ratio: float = 0.0,
    device=None,
):
    """One TensorMap covering every route in the batch, on `device`.

    Returns (tmap, lane_paths) with lane_paths[i] = the lane indices of route
    i's primary path (corridor segments + junction connectors), in driving
    order (feeds TrafficEnv.reset).
    """
    all_lanes: list[dict] = []
    all_keys: list[list[tuple]] = []
    lg_base = 0
    y_cursor = TILE_PAD
    for ri, kp in enumerate(keypoints_list):
        kp = np.asarray(kp, dtype=np.float64)
        xy = kp[:, :2]
        lo = xy.min(0)
        kp = kp.copy()
        kp[:, 0] = xy[:, 0] - lo[0] + TILE_PAD
        kp[:, 1] = xy[:, 1] - lo[1] + y_cursor
        y_cursor += (xy[:, 1].max() - lo[1]) + 2 * TILE_PAD + TILE_GAP
        lanes, keys, n_junc = _route_lanes(
            kp, ri * ROAD_ID_STRIDE, num_lanes, lane_width, speed_limit,
            light_group_base=lg_base, cross_roads=cross_roads,
            stop_ratio=stop_ratio,
        )
        lg_base += 2 * n_junc
        all_lanes.extend(lanes)
        all_keys.append(keys)

    if pad_lanes_to is not None and len(all_lanes) > pad_lanes_to:
        # a junction-heavy batch can exceed the caller's fixed pad: grow to
        # the next 128 multiple instead of asserting (callers that want
        # stable shapes should carry the grown pad forward)
        pad_lanes_to = -(-len(all_lanes) // 128) * 128
    tmap = build_tensor_map(
        all_lanes, pad_lanes_to=pad_lanes_to,
        grid_shape=GRID_SHAPE, raster_shape=RASTER_SHAPE, device=device,
    )
    # host-side (road_id, lane_id) -> lane index; all_lanes order IS the
    # tensor-map lane order, so no device read-back is needed
    key_to_idx = {
        (int(l["road_id"]), int(l["lane_id"])): i
        for i, l in enumerate(all_lanes)
    }
    lane_paths = [
        [key_to_idx[k] for k in keys if k in key_to_idx] for keys in all_keys
    ]
    return tmap, lane_paths


CROSS_EPS = 4.0  # proximity (m) that clusters routes into one shared tile
CROSS_ANGLE = 0.44  # min transversal angle (rad, mod pi) for a crossing


def _route_crossings(polys: list[np.ndarray]):
    """Transversal crossings between resampled route polylines:
    [(i, idx_i, j, idx_j)] with i < j. Proximal-but-parallel stretches
    (merges, shared straights) are NOT crossings — only events whose local
    headings differ by more than CROSS_ANGLE (mod pi) qualify for a shared
    junction."""
    out = []
    gap = int(MIN_CORNER_GAP / RESAMPLE_M)
    for i in range(len(polys)):
        for j in range(i + 1, len(polys)):
            P, Q = polys[i], polys[j]
            d = np.linalg.norm(P[:, None] - Q[None], axis=-1)
            close = d < CROSS_EPS
            if not close.any():
                continue
            rows = np.flatnonzero(close.any(1))
            groups = np.split(
                rows, np.flatnonzero(np.diff(rows) > gap) + 1
            )
            hP, hQ = _headings(P), _headings(Q)
            for g in groups:
                sub = d[g]
                r, c = np.unravel_index(int(sub.argmin()), sub.shape)
                ii, jj = int(g[r]), int(c)
                ang = abs(np.angle(np.exp(1j * (hP[ii] - hQ[jj]))))
                ang = min(ang, np.pi - ang)
                if ang < CROSS_ANGLE:
                    continue  # parallel overlap: shared road, no junction
                out.append((i, ii, j, jj))
    return out


def _proximity_clusters(polys: list[np.ndarray]) -> list[list[int]]:
    """Union-find clusters of routes whose polylines come within
    CROSS_EPS of each other (checked on coarse point proximity)."""
    n = len(polys)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n):
        for j in range(i + 1, n):
            # coarse AABB rejection first
            lo_i, hi_i = polys[i].min(0), polys[i].max(0)
            lo_j, hi_j = polys[j].min(0), polys[j].max(0)
            if (lo_i - CROSS_EPS > hi_j).any() or (lo_j - CROSS_EPS > hi_i).any():
                continue
            d = np.linalg.norm(polys[i][:, None] - polys[j][None], axis=-1)
            if d.min() < CROSS_EPS:
                parent[find(i)] = find(j)
    clusters: dict[int, list[int]] = {}
    for i in range(n):
        clusters.setdefault(find(i), []).append(i)
    return list(clusters.values())


def shared_map_from_routes(
    keypoints_list: list[np.ndarray],
    num_lanes: int = 2,
    lane_width: float = LANE_WIDTH,
    speed_limit: float = 14.0,
    pad_lanes_to: int | None = None,
    stop_ratio: float = 0.0,
    device=None,
):
    """ONE persistent town shared by every route of a run (the reference's
    analogue is one `CarlaMap` per town reused for
    all routes, nuplan_map_utils.py:46-66).

    Unlike `map_from_routes` — which isolates each sampled batch's routes
    into disjoint tiles and rebuilds the map every episode — this compiles
    ALL of a run's routes into one TensorMap up front. Routes whose
    polylines come within CROSS_EPS of each other keep their TRUE relative
    town geometry inside a shared tile, so overlapping corridors genuinely
    share road space, and wherever two routes cross transversally a SHARED
    signalised junction is injected into both: route A's connector holds
    light phase g (even, green first), route B's holds g+1 (opposing) —
    each route is the other's cross traffic, so no synthetic perpendicular
    arms are added there (`arms=False`). Isolated routes tile compactly as
    before. Parallel overlaps currently duplicate lane geometry in place
    (both corridors rasterize to the same drivable space) rather than
    unifying lane records.

    Returns (tmap, lane_paths): lane_paths[i] = route i's primary lane
    path, reused across every episode of the run (run.py --shared_town).
    """
    polys = [
        _resample(np.asarray(kp, np.float64)[:, :2]) for kp in keypoints_list
    ]
    clusters = _proximity_clusters(polys)

    # ---- tile packing: one tile per CLUSTER, members keep relative pose
    shifted: list[np.ndarray | None] = [None] * len(polys)
    y_cursor = TILE_PAD
    for members in clusters:
        lo = np.min([polys[m].min(0) for m in members], axis=0)
        hi = np.max([polys[m].max(0) for m in members], axis=0)
        for m in members:
            p = polys[m].copy()
            p[:, 0] += TILE_PAD - lo[0]
            p[:, 1] += y_cursor - lo[1]
            shifted[m] = p
        y_cursor += (hi[1] - lo[1]) + 2 * TILE_PAD + TILE_GAP

    # ---- shared junctions at route-route crossings (per cluster)
    crossings = []
    for members in clusters:
        if len(members) < 2:
            continue
        sub = _route_crossings([shifted[m] for m in members])
        crossings += [
            (members[i], ii, members[j], jj) for i, ii, j, jj in sub
        ]
    # drop crossings too close to a route end for a junction cut
    margin = int(JUNCTION_RADIUS / RESAMPLE_M) + 4
    crossings = [
        (i, ii, j, jj)
        for i, ii, j, jj in crossings
        if margin < ii < len(shifted[i]) - 1 - margin
        and margin < jj < len(shifted[j]) - 1 - margin
    ]
    extra: dict[int, list[tuple]] = {}
    for k, (i, ii, j, jj) in enumerate(crossings):
        extra.setdefault(i, []).append((ii, 2 * k, False))
        extra.setdefault(j, []).append((jj, 2 * k + 1, False))

    all_lanes: list[dict] = []
    all_keys: list[list[tuple]] = []
    lg_base = 2 * len(crossings)  # shared groups allocated first
    for ri, pts in enumerate(shifted):
        lanes, keys, n_junc = _route_lanes(
            np.zeros((2, 2)), ri * ROAD_ID_STRIDE, num_lanes, lane_width,
            speed_limit, light_group_base=lg_base, cross_roads=True,
            stop_ratio=stop_ratio, extra_corners=extra.get(ri),
            pts_resampled=pts,
        )
        lg_base += 2 * n_junc
        all_lanes.extend(lanes)
        all_keys.append(keys)

    if pad_lanes_to is None:
        pad_lanes_to = max(256, -(-len(all_lanes) // 128) * 128)
    tmap = build_tensor_map(all_lanes, pad_lanes_to=pad_lanes_to, device=device)
    # host-side (road_id, lane_id) -> lane index; all_lanes order IS the
    # tensor-map lane order, so no device read-back is needed
    key_to_idx = {
        (int(l["road_id"]), int(l["lane_id"])): i
        for i, l in enumerate(all_lanes)
    }
    lane_paths = [
        [key_to_idx[k] for k in keys if k in key_to_idx] for keys in all_keys
    ]
    return tmap, lane_paths


def map_from_route(
    keypoints: np.ndarray,
    num_lanes: int = 2,
    lane_width: float = LANE_WIDTH,
    speed_limit: float = 14.0,
    pad_lanes_to: int | None = None,
    device=None,
) -> TensorMap:
    """Single-route map (back-compat convenience)."""
    tmap, _ = map_from_routes(
        [keypoints], num_lanes, lane_width, speed_limit, pad_lanes_to,
        device=device,
    )
    return tmap
