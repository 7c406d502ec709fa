from .pid import PID_WINDOW, PIDState, TrackerState
from .state import HISTORY_STEPS, ScenarioSpec, SimState, init_sim_state_host

__all__ = [
    "PID_WINDOW",
    "PIDState",
    "TrackerState",
    "HISTORY_STEPS",
    "ScenarioSpec",
    "SimState",
    "init_sim_state_host",
]
