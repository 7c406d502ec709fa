from .dynamics import bicycle_forecast_step, bicycle_step
from .pid import PID_WINDOW, PIDState, TrackerState, pid_step, track_step
from .state import HISTORY_STEPS, ScenarioSpec, SimState, init_sim_state_host

__all__ = [
    "PID_WINDOW",
    "PIDState",
    "TrackerState",
    "pid_step",
    "track_step",
    "bicycle_step",
    "bicycle_forecast_step",
    "HISTORY_STEPS",
    "ScenarioSpec",
    "SimState",
    "init_sim_state_host",
]
