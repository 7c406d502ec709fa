from .features import build_cbv_features, build_features_for_agent
from .model import PlutoModel
from .policy import canonical_map_tokens, pluto_cbv_act, select_trajectory

__all__ = [
    "PlutoModel",
    "build_cbv_features",
    "build_features_for_agent",
    "canonical_map_tokens",
    "pluto_cbv_act",
    "select_trajectory",
]
