"""PlanT's serving half of rift_tpu/models/plant/train.py: the attention
scores the CBV recognizer ranks by, and the weights' npz format.

The behaviour-cloning fit (`plant_bc_dataset`, `fit_plant`, the script's
`main`) reads `collect_data`'s HDF5 buffer and is not ported yet.
"""

from __future__ import annotations

import torch

from ...sim.state import ScenarioSpec, SimState
from ...utils.params_io import flatten_params, load_jax_params, load_params_npz
from ...utils.params_io import save_params_npz as save_plant_params  # noqa: F401
from .model import PlanTModel
from .policy import MAX_VEHICLE_TOKENS, build_plant_tokens


@torch.no_grad()
def plant_attn_scores(model: PlanTModel, spec: ScenarioSpec, state: SimState) -> torch.Tensor:
    """[S, A] per-agent relevance: the PlanT CLS attention over the vehicle
    tokens, scattered back to the agents' slots (-inf for agents without a
    token). The JAX package's `.at[].max` into -inf is a scatter-reduce
    "amax" that keeps the initial -inf."""
    S, A = state.alive.shape
    tokens, target, light, veh_idx = build_plant_tokens(spec, state, return_vehicle_index=True)
    att = model(tokens, target, light)["attn_scores"][:, :MAX_VEHICLE_TOKENS]
    scores = torch.full((S, A), -torch.inf, device=att.device)
    return scores.scatter_reduce(
        1, torch.clamp(veh_idx, min=0), torch.where(veh_idx >= 0, att, -torch.inf),
        "amax", include_self=True,
    )


def make_attn_scores_fn(model: PlanTModel, spec: ScenarioSpec):
    """`attn_scores_fn(state) -> [S, A]` for attn_recognize_cbvs (the model
    holds its weights, where the JAX package passes params)."""
    return lambda state: plant_attn_scores(model, spec, state)


def load_plant_params(path: str) -> dict:
    """A PlanT npz in the JAX package's flat-key format (either package's
    `save_params_npz`) as nested numpy params."""
    return load_params_npz(path)


def load_plant_weights(model: PlanTModel, path: str) -> PlanTModel:
    """Fill `model` from a PlanT npz, strictly: every key used, every shape
    matching (the npz's dims must be the model's)."""
    load_jax_params(model, flatten_params(load_plant_params(path)))
    return model
