"""Export lane dicts to the reference's `TownXX_HD_map.npz` schema (port
of rift_tpu/map/npz_fixture.py, numpy only, copied unchanged).

The reference documents (data/map_data/anno/HD-Map-Anno.md) but does not
ship its per-town npz artifacts, so this writer produces schema-exact
fixtures from synthetic towns: road_id -> lane_id -> {LaneType, LaneWidth,
LaneMark{Left/Center/Right}} with Points ((x,y,z),(roll,pitch,yaw),
is_junction), Center Topology/TopologyType/Left/Right, per-road
Trigger_Volumes (TrafficLight / StopSign) and top-level Crosswalks — the
exact structure data/gen_hdmap.py dumps from CARLA OpenDRIVE. Used to
validate map/compiler.py end to end.
"""

from __future__ import annotations

import numpy as np


def _points(centerline: np.ndarray, is_junction: bool) -> list:
    """Location-rotation array: ((x, y, z), (roll, pitch, yaw), is_junction)."""
    c = np.asarray(centerline, np.float64)
    vec = np.diff(c, axis=0)
    vec = np.concatenate([vec, vec[-1:]], axis=0)
    yaw = np.arctan2(vec[:, 1], vec[:, 0])
    return [
        ((float(p[0]), float(p[1]), 0.0), (0.0, 0.0, float(y)), bool(is_junction))
        for p, y in zip(c, yaw)
    ]


def _offset(centerline: np.ndarray, off: float) -> np.ndarray:
    c = np.asarray(centerline, np.float64)
    vec = np.diff(c, axis=0)
    vec = np.concatenate([vec, vec[-1:]], axis=0)
    n = np.linalg.norm(vec, axis=1, keepdims=True)
    normal = np.stack([-vec[:, 1], vec[:, 0]], axis=-1) / np.maximum(n, 1e-9)
    return c + off * normal


def lanes_to_map_data(lanes: list[dict], crosswalks: list[np.ndarray] | None = None) -> dict:
    """Lane dicts (build_tensor_map input) -> HD-Map-Anno.md dict."""
    map_data: dict = {}
    light_volumes: dict[int, list] = {}  # light_group -> approach lanes
    for ln in lanes:
        rid, lid = int(ln["road_id"]), int(ln["lane_id"])
        w = float(ln.get("width", 3.5))
        c = np.asarray(ln["centerline"], np.float64)
        junc = bool(ln.get("is_junction", False))
        center_mark = {
            "Points": _points(c, junc),
            "Type": "Center",
            "Color": "White",
            "Topology": [
                (int(a), int(b)) for a, b in ln.get("successors", [])
            ],
            "TopologyType": "Junction" if junc else "Normal",
            "Left": tuple(map(int, ln["left_adj"])) if ln.get("left_adj") else None,
            "Right": tuple(map(int, ln["right_adj"])) if ln.get("right_adj") else None,
        }
        left_mark = {
            "Points": _points(_offset(c, +w / 2), junc),
            "Type": "Broken",
            "Color": "White",
            "Topology": [],
        }
        right_mark = {
            "Points": _points(_offset(c, -w / 2), junc),
            "Type": "Solid",
            "Color": "White",
            "Topology": [],
        }
        map_data.setdefault(rid, {})[lid] = {
            "LaneType": "Driving",
            "LaneWidth": w,
            "LaneMark": {
                "Left": [left_mark],
                "Center": [center_mark],
                "Right": [right_mark],
            },
        }

    # Trigger volumes: every signalised junction connector contributes a
    # TrafficLight volume on its PREDECESSOR road (where CARLA's light
    # trigger sits); stop lanes get a StopSign volume at their end.
    by_key = {(int(l["road_id"]), int(l["lane_id"])): l for l in lanes}
    succ_of: dict[tuple, list] = {}
    for ln in lanes:
        for s in ln.get("successors", []):
            succ_of.setdefault(tuple(map(int, s)), []).append(ln)

    def _volume(point: np.ndarray, vtype: str) -> dict:
        p = np.asarray(point, np.float64)
        box = [
            (float(p[0] + dx), float(p[1] + dy), 0.0)
            for dx, dy in ((-2, -2), (2, -2), (2, 2), (-2, 2))
        ]
        return {
            "Points": box,
            "Type": vtype,
            "ParentActor_Location": (float(p[0]), float(p[1]), 2.0),
        }

    seen_approach = set()
    for ln in lanes:
        lg = int(ln.get("light_group", -1))
        if lg >= 0 and ln.get("is_junction"):
            for pred in succ_of.get((int(ln["road_id"]), int(ln["lane_id"])), []):
                pk = (int(pred["road_id"]), int(pred["lane_id"]))
                if pk in seen_approach or pred.get("is_junction"):
                    continue
                seen_approach.add(pk)
                end = np.asarray(pred["centerline"], np.float64)[-1]
                map_data[pk[0]].setdefault("Trigger_Volumes", []).append(
                    _volume(end, "TrafficLight")
                )
        if ln.get("stop"):
            rid = int(ln["road_id"])
            end = np.asarray(ln["centerline"], np.float64)[-1]
            map_data[rid].setdefault("Trigger_Volumes", []).append(
                _volume(end, "StopSign")
            )

    cws = []
    for poly in crosswalks or []:
        pts = np.asarray(poly, np.float64)
        try:
            from shapely.geometry import Polygon

            shape = Polygon(pts)
        except Exception:  # shapely optional in the fixture
            shape = pts
        cws.append(
            {"Polygon": shape, "Location": tuple(pts.mean(0)) + (0.0,)}
        )
    map_data["Crosswalks"] = cws
    return map_data


def save_npz(path: str, map_data: dict) -> str:
    """Write in the reference's container format (np.savez, object dict)."""
    np.savez_compressed(path, arr=np.array(list(map_data.items()), dtype=object))
    return path
