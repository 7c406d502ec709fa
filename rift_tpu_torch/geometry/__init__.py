from .obb import box_corners, obb_overlap, obb_overlap_matrix, point_in_obb
from .polyline import (
    nearest_point_index,
    polyline_arclength,
    polyline_headings,
    project_point_to_polyline,
    resample_polyline,
)
from .se2 import (
    global_to_local,
    local_to_global,
    rotate,
    rotation_matrix,
    se2_compose,
    se2_inverse,
    wrap_angle,
)

__all__ = [
    "wrap_angle",
    "rotate",
    "rotation_matrix",
    "global_to_local",
    "local_to_global",
    "se2_compose",
    "se2_inverse",
    "box_corners",
    "obb_overlap",
    "obb_overlap_matrix",
    "point_in_obb",
    "polyline_arclength",
    "resample_polyline",
    "project_point_to_polyline",
    "nearest_point_index",
    "polyline_headings",
]
