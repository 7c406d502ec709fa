from .rule_ego import rule_ego_waypoints

__all__ = ["rule_ego_waypoints"]
