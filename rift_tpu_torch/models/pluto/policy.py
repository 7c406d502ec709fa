"""Pluto CBV policy (port of rift_tpu/models/pluto/policy.py:
`select_trajectory`, `_neighbor_states`, `canonical_map_tokens` and both
branches of `pluto_cbv_act`, with the BC pretrain's `execute_teacher`).

One call plans every CBV of every scenario: legacy (per-CBV) or canonical
features, the PlutoModel forward, candidate selection, and the chosen local waypoints
scattered into the [S, A] agent layout. In train mode it also scores every
candidate with the GRPO evaluator (rl/evaluator.py, through the retrack
and refline kernels on the card) and returns the training signals.
"""

from __future__ import annotations

import torch

from ...map.tensor_map import TensorMap
from ...rl.evaluator import grpo_advantage_batched
from ...scenario.recognition import cbv_slot_assignment
from ...sim.autopilot import IDM_BRAKE, IDM_MAX_ACCEL, lane_follow_waypoints
from ...sim.state import ScenarioSpec, SimState
from ...sim.world import autopilot_steady_speed
from .features import build_cbv_features, canonical_map_features

TOPK = 10
REF_FREE_SCORE = 0.25
NUM_NEIGHBORS = 8  # forecast neighbours per CBV in train mode
TEACHER_NUM_FRAMES = 80  # full candidate horizon (8 s at 10 fps)
TEACHER_HORIZON_STEP = 39  # frame 40 = 4 s (waypoint i is frame i+1)
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


def _neighbor_states(state: SimState, scen, slot, n_nbr: int = NUM_NEIGHBORS):
    """The nearest alive agents of each CBV (scen, slot [...]): (pos, heading,
    speed, control, shape, valid), each [..., n_nbr, ...]. A stable sort
    keeps the lowest slot first among equal distances, as jax.lax.top_k
    does."""
    pos = state.pos[scen]  # [..., A, 2]
    A = pos.shape[-2]
    me = torch.gather(pos, -2, slot[..., None, None].expand(slot.shape + (1, 2)))
    d = torch.linalg.norm(pos - me, dim=-1)
    others = torch.arange(A, device=pos.device) != slot[..., None]
    d = torch.where(state.alive[scen] & others, d, torch.inf)
    k = min(n_nbr, A)
    d_sorted, idx = torch.sort(d, dim=-1, stable=True)
    idx, valid = idx[..., :k], torch.isfinite(d_sorted[..., :k])
    if k < n_nbr:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (n_nbr - k,))], -1)
        valid = torch.cat([valid, valid.new_zeros(valid.shape[:-1] + (n_nbr - k,))], -1)
    sc = scen[..., None]
    return (
        state.pos[sc, idx], state.heading[sc, idx], state.speed[sc, idx],
        state.control[sc, idx], state.shape[sc, idx], valid,
    )


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


def pluto_cbv_act(
    model,
    tmap: TensorMap,
    spec: ScenarioSpec,
    state: SimState,
    max_cbvs: int = 3,
    train: bool = False,
    topk: int = TOPK,
    canonical: bool = False,
    map_tok: torch.Tensor | None = None,
    adv_debug: bool = False,
    execute_teacher: bool = False,
):
    """Plan all CBVs of all scenarios, on legacy per-CBV tokens (the JAX
    package's default) or, with `canonical`, on frame-invariant tokens
    with the per-lane map tokens `map_tok` precomputed (or computed in the
    call when None). `map_tok` is read only with `canonical`.

    The JAX function takes (model, params, ...); here the weights live in
    the torch model. Returns dict:
      traj [S, A, T, 2]  local waypoints scattered into agent slots
      mask [S, A]        which agents are CBV-controlled this tick
      features           the [S, C]-leading feature dict (for the buffer)
      cbv_slots [S, C], chosen_idx [S, C]
      old_logits, advantage, adv_valid, rollout_return [S, C, R, M],
      value, teacher_speed, exec_speed [S, C], teacher_pos [S, C, 2],
      teacher_traj [S, C, 80, 2]: the train-mode signals, zeros in eval.
    With `execute_teacher` (train mode, the BC pretrain's expert rollouts)
    the CBVs execute the privileged teacher's path: `traj` holds it and
    `exec_speed` is taken from it. With `adv_debug` (train mode) the
    evaluator's per-candidate reward attribution is added, each [S, C, R,
    M]: the `dbg_*` fields of `grpo_advantage_batched(debug=True)`. The
    eval branch runs under inference_mode; the train branch under no_grad,
    so its features can feed a later fit.
    """
    _check_device(model, tmap)
    mode = torch.no_grad() if train else torch.inference_mode()
    with mode:
        return _act(model, tmap, spec, state, max_cbvs, train, topk, canonical, map_tok,
                    adv_debug, execute_teacher)


def _act(model, tmap, spec, state, max_cbvs, train, topk, canonical, map_tok,
         adv_debug, execute_teacher):
    S, A = state.alive.shape
    cbv_slots = cbv_slot_assignment(state.is_cbv, max_cbvs)
    C = cbv_slots.shape[1]
    dev = state.pos.device
    feats, slot_valid, *rest = build_cbv_features(
        tmap, state, cbv_slots, spec, canonical=canonical, with_sample_feats=train
    )
    model_in = {
        g: {k: v.reshape((S * C,) + v.shape[2:]) for k, v in d.items()}
        if isinstance(d, dict) else d.reshape((S * C,) + d.shape[2:])
        for g, d in feats.items()
    }
    if canonical:
        (shared,) = rest
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

    result = {
        "traj": traj,
        "mask": mask,
        "features": feats,
        "cbv_slots": cbv_slots,
        "chosen_idx": chosen_idx.reshape(S, C),
    }
    R, M = out["probability"].shape[1:3]
    if train:
        result.update(_train_signals(tmap, state, feats, out, wp, scen, slot, slot_valid,
                                     adv_debug))
        if execute_teacher:
            # expert rollouts: the CBVs execute the teacher path, so cloning
            # sees the expert's state visitation
            teacher = result["teacher_traj"]
            traj = torch.zeros((S, A) + teacher.shape[2:], dtype=torch.float32, device=dev)
            traj[scen[slot_valid], slot[slot_valid]] = teacher[slot_valid]
            result["traj"] = traj
            result["exec_speed"] = _implied_speed(teacher)
        return result
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    result.update({
        "old_logits": zeros(S, C, R, M),
        "advantage": zeros(S, C, R, M),
        "adv_valid": torch.zeros((S, C, R, M), dtype=torch.bool, device=dev),
        "rollout_return": zeros(S, C, R, M),
        "value": zeros(S, C),
        "teacher_speed": zeros(S, C),
        "teacher_pos": zeros(S, C, 2),
        "teacher_traj": zeros(S, C, BC_FRAMES, 2),
        "exec_speed": zeros(S, C),
    })
    return result


def _implied_speed(wp):
    """The tracker's desired speed implied by [S, C, T, 2] executed
    waypoints: their mean spacing over the first second / dt."""
    step_d = torch.linalg.norm(torch.diff(wp[:, :, :10], dim=2), dim=-1)
    return step_d.mean(-1) / 0.1


def _train_signals(tmap, state, feats, out, wp, scen, slot, slot_valid, adv_debug):
    """The train branch's executed-transition signals and the GRPO
    advantage of every candidate (with `adv_debug`, its `dbg_*` fields)."""
    S, C = slot.shape
    R, M = out["probability"].shape[1:3]
    dev = slot.device
    res = {
        "value": out["value"].reshape(S, C) if "value" in out
        else torch.zeros((S, C), device=dev),
    }
    # privileged teacher trajectory: lane-chain follow with a feasible
    # speed profile from the CBV's current speed toward the steady target
    v_steady = torch.gather(autopilot_steady_speed(tmap, state), 1, slot)
    v0 = state.speed[scen, slot]
    t_k = 0.1 * (1.0 + torch.arange(TEACHER_NUM_FRAMES, dtype=torch.float32, device=dev))
    v_k = torch.minimum(
        torch.maximum(v_steady[..., None], torch.clamp(v0[..., None] - IDM_BRAKE * t_k, min=0.0)),
        v0[..., None] + IDM_MAX_ACCEL * t_k,
    )  # [S, C, 80] frame speeds
    teacher_wp = lane_follow_waypoints(
        tmap, state.lane[scen, slot], state.pos[scen, slot], state.heading[scen, slot],
        state.bv_branch_bits[scen, slot], torch.clamp(v_k * 0.1, min=1e-3),
        num_points=TEACHER_NUM_FRAMES, n_chain=8,
    )  # [S, C, 80, 2] local frame, point i = frame i+1
    res["teacher_speed"] = v_k[..., :10].mean(-1)
    res["teacher_pos"] = teacher_wp[..., TEACHER_HORIZON_STEP, :]
    res["teacher_traj"] = teacher_wp
    res["exec_speed"] = _implied_speed(wp)

    # GRPO advantage, batched over all S*C CBVs: one retrack launch over
    # every candidate, one refline launch over every (CBV, line) pair
    nbr = _neighbor_states(state, scen, slot)
    B = S * C
    fb = lambda x: x.reshape((B,) + x.shape[2:])
    rl = feats["reference_line"]
    adv = grpo_advantage_batched(
        tmap,
        out["trajectory"].reshape(B, R, M, -1, 6),
        fb(rl["valid_mask"]).any(-1),
        fb(rl["position"]),
        fb(rl["orientation"]),
        fb(rl["valid_mask"]),
        fb(state.pos[scen, slot]),
        fb(state.heading[scen, slot]),
        fb(state.speed[scen, slot]),
        fb(state.shape[scen, slot]),
        *[fb(x) for x in nbr],
        debug=adv_debug,
    )
    adv = {k: v.reshape((S, C) + v.shape[1:]) for k, v in adv.items()}
    res["old_logits"] = out["probability"].reshape(S, C, R, M)
    res["advantage"] = adv["advantage"]
    res["adv_valid"] = adv["valid_mask"] & slot_valid[..., None, None]
    res["rollout_return"] = adv["rollout_return"]
    res.update({k: v for k, v in adv.items() if k.startswith("dbg_")})
    return res
