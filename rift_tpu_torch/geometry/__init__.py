from .polyline import project_point_to_polyline
from .se2 import wrap_angle

__all__ = ["wrap_angle", "project_point_to_polyline"]
