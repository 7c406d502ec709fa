from .obb import box_corners, obb_overlap
from .polyline import project_point_to_polyline
from .se2 import rotate, wrap_angle

__all__ = [
    "wrap_angle", "rotate", "project_point_to_polyline", "box_corners", "obb_overlap",
]
