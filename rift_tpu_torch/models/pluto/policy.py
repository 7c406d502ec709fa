"""Pluto CBV policy, eval step (port of rift_tpu/models/pluto/policy.py:
`select_trajectory`, `canonical_map_tokens` and the eval branch of
`pluto_cbv_act`; the train branch comes with the train path).

One call plans every CBV of every scenario: canonical features, the
PlutoModel forward, candidate selection, and the chosen local waypoints
scattered into the [S, A] agent layout.
"""

from __future__ import annotations

import torch

from ...map.tensor_map import TensorMap
from ...scenario.recognition import cbv_slot_assignment
from ...sim.state import ScenarioSpec, SimState
from .features import build_cbv_features, canonical_map_features

TOPK = 10
REF_FREE_SCORE = 0.25
BC_FRAMES = 80


def select_trajectory(out: dict, topk: int = TOPK):
    """Executed trajectory per batch element: softmax over the top-k
    flattened R*M probabilities; the ref-free trajectory wins when the best
    candidate's share is below REF_FREE_SCORE.

    Returns (traj [B, T, 3] local frame, chosen_flat_idx [B], use_ref_free
    [B]). A stable descending sort keeps the lowest index first among equal
    scores, as jax.lax.top_k does (invalid lines all sit at -1e6)."""
    prob = out["probability"]
    B, R, M = prob.shape
    flat = prob.reshape(B, R * M)
    k = min(topk, R * M)
    top_vals, top_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    use_ref_free = torch.softmax(top_vals, dim=-1)[:, 0] < REF_FREE_SCORE
    cand = out["candidate_trajectories"].reshape(B, R * M, -1, 3)
    best_idx = top_idx[:, 0]
    best_cand = cand[torch.arange(B, device=prob.device), best_idx]
    if "output_ref_free_trajectory" in out:
        traj = torch.where(
            use_ref_free[:, None, None], out["output_ref_free_trajectory"], best_cand
        )
    else:
        traj = best_cand
        use_ref_free = torch.zeros_like(use_ref_free)
    return traj, best_idx, use_ref_free


def _check_device(model, tmap):
    dev = next(model.parameters()).device
    if dev.type != tmap.device.type:
        raise ValueError(f"model on {dev}, map on {tmap.device}")


@torch.inference_mode()
def canonical_map_tokens(model, tmap: TensorMap) -> torch.Tensor:
    """Canonical per-lane map tokens [L, D]: a pure function of the model's
    weights and the map, valid while both stay frozen. Passing the result
    as `map_tok` to pluto_cbv_act removes the map PointsEncoder from the
    per-tick forward."""
    _check_device(model, tmap)
    sh = canonical_map_features(tmap)
    data = {
        "shared": {
            "map_feat": sh["feat"],
            "map_type": sh["type"],
            "map_speed": sh["speed"],
        },
        "map_tokens_only": True,
    }
    return model(data)


@torch.inference_mode()
def pluto_cbv_act(
    model,
    tmap: TensorMap,
    spec: ScenarioSpec,
    state: SimState,
    max_cbvs: int = 3,
    topk: int = TOPK,
    map_tok: torch.Tensor | None = None,
):
    """Plan all CBVs of all scenarios (eval mode, canonical tokens: the
    JAX package's canonical=True, the only mode ported so far).

    The JAX function takes (model, params, ...); here the weights live in
    the torch model. Returns dict:
      traj [S, A, T, 2]  local waypoints scattered into agent slots
      mask [S, A]        which agents are CBV-controlled this tick
      features           the [S, C]-leading feature dict
      cbv_slots [S, C], chosen_idx [S, C]
      and the train-mode fields as zeros, as the JAX eval branch returns.
    """
    _check_device(model, tmap)
    S, A = state.alive.shape
    cbv_slots = cbv_slot_assignment(state.is_cbv, max_cbvs)
    C = cbv_slots.shape[1]
    feats, slot_valid, shared = build_cbv_features(tmap, state, cbv_slots, spec)
    model_in = {
        g: {k: v.reshape((S * C,) + v.shape[2:]) for k, v in d.items()}
        if isinstance(d, dict) else d.reshape((S * C,) + d.shape[2:])
        for g, d in feats.items()
    }
    dev = state.pos.device
    model_in["shared"] = {
        **shared, "scen_idx": torch.arange(S, device=dev).repeat_interleave(C)
    }
    if map_tok is not None:
        model_in["shared"]["map_tok"] = map_tok
    model_in["no_aux"] = True
    out = model(model_in)

    traj3, chosen_idx, _ = select_trajectory(out, topk)
    T = traj3.shape[-2]
    wp = traj3[..., :2].reshape(S, C, T, 2)

    # scatter into the [S, A] agent layout; padded CBV positions (slot -1)
    # write nothing
    slot = torch.clamp(cbv_slots, min=0)
    scen = torch.arange(S, device=dev)[:, None].expand(S, C)
    traj = torch.zeros((S, A, T, 2), dtype=torch.float32, device=dev)
    traj[scen[slot_valid], slot[slot_valid]] = wp[slot_valid]
    mask = torch.zeros((S, A), dtype=torch.bool, device=dev)
    mask[scen[slot_valid], slot[slot_valid]] = True
    mask[:, 0] = False  # slot 0 is the ego

    R, M = out["probability"].shape[1:3]
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return {
        "traj": traj,
        "mask": mask,
        "features": feats,
        "cbv_slots": cbv_slots,
        "chosen_idx": chosen_idx.reshape(S, C),
        "old_logits": zeros(S, C, R, M),
        "advantage": zeros(S, C, R, M),
        "adv_valid": torch.zeros((S, C, R, M), dtype=torch.bool, device=dev),
        "rollout_return": zeros(S, C, R, M),
        "value": zeros(S, C),
        "teacher_speed": zeros(S, C),
        "teacher_pos": zeros(S, C, 2),
        "teacher_traj": zeros(S, C, BC_FRAMES, 2),
        "exec_speed": zeros(S, C),
    }
