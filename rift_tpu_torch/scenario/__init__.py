from .criteria import (
    CriteriaState,
    driving_score,
    init_criteria,
    route_completion_percent,
    update_criteria,
)
from .env import (
    TrafficEnv,
    env_step,
    make_scenario_spec,
    sample_route,
    spawn_agents,
    wake_all_bvs,
)
from .recognition import attn_recognize_cbvs, cbv_slot_assignment, recognize_cbvs

__all__ = [
    "CriteriaState",
    "init_criteria",
    "update_criteria",
    "route_completion_percent",
    "driving_score",
    "TrafficEnv",
    "env_step",
    "make_scenario_spec",
    "sample_route",
    "spawn_agents",
    "wake_all_bvs",
    "attn_recognize_cbvs",
    "cbv_slot_assignment",
    "recognize_cbvs",
]
