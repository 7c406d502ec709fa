from .dynamics import bicycle_forecast_step, bicycle_step
from .pid import (
    PID_WINDOW,
    PIDState,
    TrackerState,
    densify_local_waypoints,
    extend_path,
    pid_step,
    track_step,
)
from .state import HISTORY_STEPS, ScenarioSpec, SimState, init_sim_state, init_sim_state_host
from .world import cbv_reached_goal, step

__all__ = [
    "PID_WINDOW",
    "PIDState",
    "TrackerState",
    "pid_step",
    "track_step",
    "densify_local_waypoints",
    "extend_path",
    "step",
    "cbv_reached_goal",
    "bicycle_step",
    "bicycle_forecast_step",
    "HISTORY_STEPS",
    "ScenarioSpec",
    "SimState",
    "init_sim_state",
    "init_sim_state_host",
]
