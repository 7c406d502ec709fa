from .model import PlanTModel, init_plant_weights
from .policy import build_plant_tokens, plant_ego_waypoints

__all__ = ["PlanTModel", "build_plant_tokens", "init_plant_weights", "plant_ego_waypoints"]
