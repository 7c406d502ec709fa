from .env import (
    TrafficEnv,
    make_scenario_spec,
    sample_route,
    spawn_agents,
    wake_all_bvs,
)
from .recognition import cbv_slot_assignment

__all__ = [
    "TrafficEnv",
    "make_scenario_spec",
    "sample_route",
    "spawn_agents",
    "wake_all_bvs",
    "cbv_slot_assignment",
]
