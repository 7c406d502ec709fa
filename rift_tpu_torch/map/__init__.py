from .compiler import compile_town, compile_town_from_npz, load_npz
from .npz_fixture import lanes_to_map_data, save_npz
from .reference_lines import build_lane_chains, reference_lines_from_chains
from .routing import (
    nearest_lane_host,
    route_road_lane_ids,
    route_waypoints,
    trace_route,
)
from .synthetic import grid_town_lanes, make_grid_town, make_straight_town
from .tensor_map import LANE_POINTS, TensorMap, build_tensor_map

__all__ = [
    "LANE_POINTS",
    "TensorMap",
    "build_tensor_map",
    "compile_town",
    "compile_town_from_npz",
    "load_npz",
    "build_lane_chains",
    "reference_lines_from_chains",
    "trace_route",
    "route_waypoints",
    "nearest_lane_host",
    "route_road_lane_ids",
    "make_grid_town",
    "make_straight_town",
    "grid_town_lanes",
    "lanes_to_map_data",
    "save_npz",
]
