"""Procedural town generator (port of rift_tpu/map/synthetic.py; the
lane-graph constructors are copies, so both packages build identical maps).

The reference repo documents but does not ship its `TownXX_HD_map.npz`
artifacts (data/map_data/anno/HD-Map-Anno.md), so tests and benchmarks build
towns procedurally in the same TensorMap format. Towns are lane graphs with
straight multi-lane roads and arc junction connectors, equivalent in structure
to what data/gen_hdmap.py extracts from CARLA OpenDRIVE.
"""

from __future__ import annotations

import numpy as np

from .tensor_map import TensorMap, build_tensor_map

LANE_WIDTH = 3.5
SPEED_LIMIT = 14.0  # m/s, reference default (nuplan_map_utils.py:51)


def _straight(p0, p1, n=25):
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    t = np.linspace(0, 1, n)[:, None]
    return p0 + t * (p1 - p0)


def _arc(center, radius, a0, a1, n=25):
    t = np.linspace(a0, a1, n)
    return np.stack(
        [center[0] + radius * np.cos(t), center[1] + radius * np.sin(t)], axis=-1
    )


def make_straight_town(
    length: float = 500.0,
    num_lanes: int = 2,
    lane_width: float = LANE_WIDTH,
    pad_lanes_to: int | None = None,
    stop_segment: int | None = None,
    device=None,
) -> TensorMap:
    """A straight multi-lane road along +x, split into 100 m segments so
    topology traversal is exercised. Lane i is offset -i*w (to the right).
    `stop_segment` marks that segment's end as a stop line on every lane."""
    seg_len = 100.0
    n_seg = max(int(np.ceil(length / seg_len)), 1)
    lanes = []
    for li in range(num_lanes):
        y = -li * lane_width
        for si in range(n_seg):
            x0, x1 = si * seg_len, min((si + 1) * seg_len, length)
            road = si + 1
            lane_id = -(li + 1)  # CARLA right-hand negative lane ids
            succ = [(road + 1, lane_id)] if si + 1 < n_seg else []
            lanes.append(
                dict(
                    centerline=_straight((x0, y), (x1, y)),
                    width=lane_width,
                    road_id=road,
                    lane_id=lane_id,
                    is_junction=False,
                    successors=succ,
                    left_adj=(road, lane_id + 1) if li > 0 else None,
                    right_adj=(road, lane_id - 1) if li + 1 < num_lanes else None,
                    speed_limit=SPEED_LIMIT,
                    stop=(si == stop_segment),
                )
            )
    return build_tensor_map(lanes, pad_lanes_to=pad_lanes_to, device=device)


def make_grid_town(
    blocks: int = 3,
    block_size: float = 120.0,
    num_lanes: int = 2,
    lane_width: float = LANE_WIDTH,
    pad_lanes_to: int | None = None,
    stop_ratio: float = 0.0,
    device=None,
) -> TensorMap:
    """Manhattan grid town compiled to a TensorMap (see grid_town_lanes),
    on `device` (CUDA unless the caller names another)."""
    lanes = grid_town_lanes(
        blocks=blocks, block_size=block_size, num_lanes=num_lanes,
        lane_width=lane_width, stop_ratio=stop_ratio,
    )
    return build_tensor_map(lanes, pad_lanes_to=pad_lanes_to, device=device)


def grid_town_lanes(
    blocks: int = 3,
    block_size: float = 120.0,
    num_lanes: int = 2,
    lane_width: float = LANE_WIDTH,
    stop_ratio: float = 0.0,
) -> list[dict]:
    """Manhattan grid: (blocks+1)^2 intersections joined by two-way roads,
    each direction `num_lanes` wide, with arc connectors (right turn, left
    turn) and straight connectors through every junction. Returns the lane
    dicts (build_tensor_map input) so they can also be exported to the
    reference's npz schema (map/npz_fixture.py).

    `stop_ratio` > 0 converts that fraction of junctions (deterministically,
    every round(1/ratio)-th) from signalised to all-way-stop: their
    connectors lose the light group and every approach lane gets a stop
    line at its end (`TensorMap.stop_lane`).

    Road id layout:
      horizontal segment (i,j)->(i+1,j): rid = 1000 + (j*blocks + i)*2 + dir
      vertical   segment (i,j)->(i,j+1): rid = 3000 + (i*blocks + j)*2 + dir
      junction connectors:               rid = 5000 + running index
    Lane ids are -1..-num_lanes (right-hand traffic).
    """
    jr = 12.0  # junction radius: roads stop this far from intersection centers
    lanes: list[dict] = []
    conn_rid = [5000]

    def node(i, j):
        return np.array([i * block_size, j * block_size], float)

    # directed road segments between adjacent intersections
    # direction vectors: E, W, N, S
    def add_road(rid, p0, p1):
        """Directed road p0->p1, num_lanes lanes offset to the right."""
        d = (p1 - p0) / np.linalg.norm(p1 - p0)
        right = np.array([d[1], -d[0]])
        for li in range(num_lanes):
            off = (li + 0.5) * lane_width
            lane_id = -(li + 1)
            lanes.append(
                dict(
                    centerline=_straight(p0 + right * off, p1 + right * off),
                    width=lane_width,
                    road_id=rid,
                    lane_id=lane_id,
                    is_junction=False,
                    successors=[],
                    left_adj=(rid, lane_id + 1) if li > 0 else None,
                    right_adj=(rid, lane_id - 1) if li + 1 < num_lanes else None,
                    speed_limit=SPEED_LIMIT,
                )
            )

    n = blocks + 1
    # horizontal + vertical directed segments, trimmed by jr at each end
    seg_ids: dict[tuple, int] = {}

    def seg_key(a, b):
        return (a[0], a[1], b[0], b[1])

    rid_counter = [1000]
    for j in range(n):
        for i in range(blocks):
            a, b = (i, j), (i + 1, j)
            for (s, e) in [(a, b), (b, a)]:
                p0, p1 = node(*s), node(*e)
                d = (p1 - p0) / np.linalg.norm(p1 - p0)
                rid = rid_counter[0]
                rid_counter[0] += 1
                seg_ids[seg_key(s, e)] = rid
                add_road(rid, p0 + d * jr, p1 - d * jr)
    for i in range(n):
        for j in range(blocks):
            a, b = (i, j), (i, j + 1)
            for (s, e) in [(a, b), (b, a)]:
                p0, p1 = node(*s), node(*e)
                d = (p1 - p0) / np.linalg.norm(p1 - p0)
                rid = rid_counter[0]
                rid_counter[0] += 1
                seg_ids[seg_key(s, e)] = rid
                add_road(rid, p0 + d * jr, p1 - d * jr)

    # junction connectors: for each intersection, connect every incoming
    # directed segment's lane ends to every outgoing segment's lane starts
    # (straight, right turn, left turn — no U-turns).
    lane_end: dict[tuple, np.ndarray] = {}
    lane_start: dict[tuple, np.ndarray] = {}
    by_rid_lane = {}
    for ln in lanes:
        key = (ln["road_id"], ln["lane_id"])
        by_rid_lane[key] = ln
        lane_start[key] = ln["centerline"][0]
        lane_end[key] = ln["centerline"][-1]

    def neighbors(i, j):
        out = []
        for di, dj in [(1, 0), (-1, 0), (0, 1), (0, -1)]:
            ii, jj = i + di, j + dj
            if 0 <= ii < n and 0 <= jj < n:
                out.append((ii, jj))
        return out

    stop_every = int(round(1.0 / stop_ratio)) if stop_ratio > 0 else 0

    for i in range(n):
        for j in range(n):
            junction_idx = i * n + j
            is_stop_junction = stop_every > 0 and junction_idx % stop_every == 0
            for src in neighbors(i, j):
                if seg_key(src, (i, j)) not in seg_ids:
                    continue
                rid_in = seg_ids[seg_key(src, (i, j))]
                # approach axis: 0 = horizontal (east/west), 1 = vertical
                axis = 0 if src[1] == j else 1
                light_group = -1 if is_stop_junction else junction_idx * 2 + axis
                if is_stop_junction:
                    for li in range(num_lanes):
                        by_rid_lane[(rid_in, -(li + 1))]["stop"] = True
                for dst in neighbors(i, j):
                    if dst == src:
                        continue  # no U-turn
                    if seg_key((i, j), dst) not in seg_ids:
                        continue
                    rid_out = seg_ids[seg_key((i, j), dst)]
                    for li in range(num_lanes):
                        lane_id = -(li + 1)
                        p_in = lane_end[(rid_in, lane_id)]
                        p_out = lane_start[(rid_out, lane_id)]
                        d_in = _lane_dir(by_rid_lane[(rid_in, lane_id)], -1)
                        d_out = _lane_dir(by_rid_lane[(rid_out, lane_id)], 0)
                        ctrl = _bezier(p_in, d_in, p_out, d_out)
                        rid = conn_rid[0]
                        conn_rid[0] += 1
                        lanes.append(
                            dict(
                                centerline=ctrl,
                                width=lane_width,
                                road_id=rid,
                                lane_id=lane_id,
                                is_junction=True,
                                successors=[(rid_out, lane_id)],
                                left_adj=None,
                                right_adj=None,
                                speed_limit=SPEED_LIMIT,
                                light_group=light_group,
                            )
                        )
                        by_rid_lane[(rid_in, lane_id)].setdefault(
                            "successors", []
                        ).append((rid, lane_id))

    return lanes


def _lane_dir(lane: dict, idx: int) -> np.ndarray:
    c = lane["centerline"]
    if idx == 0:
        v = c[1] - c[0]
    else:
        v = c[-1] - c[-2]
    return v / max(np.linalg.norm(v), 1e-9)


def _bezier(p0, d0, p1, d1, n=25):
    """Cubic Bezier with tangent control points — smooth junction connector."""
    dist = np.linalg.norm(p1 - p0)
    c0 = p0 + d0 * dist * 0.4
    c1 = p1 - d1 * dist * 0.4
    t = np.linspace(0, 1, n)[:, None]
    return (
        (1 - t) ** 3 * p0
        + 3 * (1 - t) ** 2 * t * c0
        + 3 * (1 - t) * t**2 * c1
        + t**3 * p1
    )
