from .features import build_cbv_features
from .model import PlutoModel
from .policy import canonical_map_tokens, pluto_cbv_act, select_trajectory

__all__ = [
    "PlutoModel",
    "build_cbv_features",
    "canonical_map_tokens",
    "pluto_cbv_act",
    "select_trajectory",
]
