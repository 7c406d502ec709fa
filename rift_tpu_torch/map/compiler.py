"""Offline HD-map compiler: CARLA npz dump -> TensorMap (port of
rift_tpu/map/compiler.py; the numpy is the JAX package's, the map lands on
`device`, CUDA unless the caller names another).

Consumes the reference's HD-map artifact format (documented in the
reference's data/map_data/anno/HD-Map-Anno.md, produced by
data/gen_hdmap.py): a per-town dict of road_id -> lane_id -> LaneMark
Left/Center/Right point lists with topology, plus crosswalk polygons.

Equivalent in role to CarlaMap._load_hd_map/_preprocess_data
(nuplan_map_utils.py:68-290), but emits dense tensors instead of
GeoDataFrames.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .tensor_map import TensorMap, build_tensor_map

JUNCTION_TYPES = {"Junction", "EnterJunction", "PassJunction", "StartJunctionMultiChange"}


def load_npz(path: str) -> dict[Any, Any]:
    data = np.load(path, allow_pickle=True)
    return dict(data["arr"])


def compile_town(
    map_data: dict[Any, Any],
    speed_limit_mps: float = 14.0,
    pad_lanes_to: int | None = None,
    device=None,
) -> TensorMap:
    """Compile the raw HD-map dict into a TensorMap on `device`.

    Trigger_Volumes become signalisation: a StopSign volume marks the
    nearest same-road lane end as a stop line (`TensorMap.stop_lane`); a
    TrafficLight volume assigns a light group to the junction connectors
    downstream of its approach lane, with volumes clustered into junctions
    (<= 2 * CLUSTER_RADIUS apart) and phased by approach axis — the
    `gen_hdmap.py` TriggerVolumeGettor data consumed the way
    CarlaDataProvider consumes live traffic lights.
    """
    lanes: list[dict] = []
    crosswalks: list[np.ndarray] = []
    trigger_volumes: list[dict] = []  # {road_id, type, center}

    for road_id, road_data in map_data.items():
        if road_id == "Crosswalks":
            for cw in road_data:
                poly = cw.get("Polygon")
                if poly is None:
                    continue
                coords = getattr(poly, "exterior", None)
                if coords is not None:
                    pts = np.stack(coords.coords.xy, axis=-1)
                else:
                    pts = np.asarray(poly, dtype=np.float64)
                if len(pts) >= 3:
                    crosswalks.append(pts)
            continue
        for lane_id, lane_data in road_data.items():
            if lane_id == "Trigger_Volumes":
                for tv in lane_data:
                    pts = np.asarray(
                        [(p[0], p[1]) for p in tv["Points"]], np.float64
                    )
                    trigger_volumes.append(
                        dict(
                            road_id=int(road_id),
                            type=tv.get("Type", ""),
                            center=pts.mean(axis=0),
                        )
                    )
                continue
            marks = dict(lane_data.get("LaneMark", {}))
            # merge multi-part marks per side (nuplan_map_utils.py:167-178)
            sides = {}
            for side in ("Left", "Center", "Right"):
                parts = marks.get(side, [])
                if not parts:
                    sides[side] = None
                    continue
                merged = dict(parts[0])
                merged["Points"] = list(parts[0]["Points"])
                if "Topology" in merged:
                    merged["Topology"] = list(parts[0].get("Topology", []))
                for p in parts[1:]:
                    merged["Points"].extend(p["Points"])
                    if "Topology" in merged:
                        merged["Topology"].extend(p.get("Topology", []))
                sides[side] = merged

            center = sides["Center"]
            if center is None or len(center["Points"]) < 3:
                continue

            def _coords(mark):
                if mark is None:
                    return None
                return np.array(
                    [[p[0][0], p[0][1]] for p in mark["Points"]], dtype=np.float64
                )

            topo_type = center.get("TopologyType", "Normal")
            lanes.append(
                dict(
                    centerline=_coords(center),
                    left=_coords(sides["Left"]),
                    right=_coords(sides["Right"]),
                    width=float(lane_data.get("LaneWidth", 3.5)),
                    road_id=int(road_id),
                    lane_id=int(lane_id),
                    is_junction=topo_type in JUNCTION_TYPES,
                    successors=[tuple(map(int, t)) for t in center.get("Topology", [])],
                    left_adj=tuple(map(int, center["Left"]))
                    if center.get("Left") is not None
                    else None,
                    right_adj=tuple(map(int, center["Right"]))
                    if center.get("Right") is not None
                    else None,
                    speed_limit=speed_limit_mps,
                )
            )

    _apply_trigger_volumes(lanes, trigger_volumes)
    return build_tensor_map(lanes, crosswalks=crosswalks, pad_lanes_to=pad_lanes_to,
                            device=device)


CLUSTER_RADIUS = 25.0  # lights within 2x this of each other share a junction


def _apply_trigger_volumes(lanes: list[dict], volumes: list[dict]) -> None:
    """Mutate lane dicts: stop lines + junction light groups from volumes."""
    if not volumes:
        return
    by_key = {(int(l["road_id"]), int(l["lane_id"])): l for l in lanes}
    by_road: dict[int, list[dict]] = {}
    for ln in lanes:
        by_road.setdefault(int(ln["road_id"]), []).append(ln)

    def approach_lane(v):
        """Nearest same-road lane END to the volume center."""
        cands = by_road.get(v["road_id"], [])
        if not cands:
            return None
        ends = np.asarray([np.asarray(l["centerline"])[-1] for l in cands])
        d = np.linalg.norm(ends - v["center"][None], axis=-1)
        return cands[int(np.argmin(d))]

    # ---- stop signs
    for v in volumes:
        if v["type"] == "StopSign":
            ln = approach_lane(v)
            if ln is not None:
                ln["stop"] = True

    # ---- traffic lights: cluster into junctions, phase by approach axis
    lights = [v for v in volumes if v["type"] == "TrafficLight"]
    if not lights:
        return
    centers = np.asarray([v["center"] for v in lights])
    cluster = np.full(len(lights), -1, np.int64)
    n_clusters = 0
    for i in range(len(lights)):
        if cluster[i] >= 0:
            continue
        cluster[i] = n_clusters
        # greedy flood: anything within 2*CLUSTER_RADIUS of a member joins
        changed = True
        while changed:
            member = cluster == n_clusters
            d = np.linalg.norm(
                centers[:, None] - centers[None, member], axis=-1
            ).min(-1)
            grow = (cluster < 0) & (d < 2 * CLUSTER_RADIUS)
            changed = bool(grow.any())
            cluster[grow] = n_clusters
        n_clusters += 1

    for v, cl in zip(lights, cluster):
        ln = approach_lane(v)
        if ln is None:
            continue
        c = np.asarray(ln["centerline"], np.float64)
        vec = c[-1] - c[-2]
        yaw = np.arctan2(vec[1], vec[0])
        axis = int(round(yaw / (np.pi / 2))) % 2  # 0 = E/W, 1 = N/S
        group = int(cl) * 2 + axis
        # the light lives on the connectors downstream of the approach
        for s in ln.get("successors", []):
            nxt = by_key.get(tuple(map(int, s)))
            if nxt is not None and nxt.get("is_junction"):
                nxt["light_group"] = group


def compile_town_from_npz(path: str, **kw) -> TensorMap:
    """`compile_town` of a `save_npz` file (`device=` among the keywords)."""
    return compile_town(load_npz(path), **kw)
