from .model import PRED_LEN, E2EModel, init_e2e_weights
from .policy import e2e_ego_waypoints, e2e_inputs
from .train import bc_train

__all__ = [
    "E2EModel",
    "PRED_LEN",
    "bc_train",
    "e2e_ego_waypoints",
    "e2e_inputs",
    "init_e2e_weights",
]
