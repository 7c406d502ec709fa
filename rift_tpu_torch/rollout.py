"""K closed-loop ticks of policy act + env step (port of rift_tpu/rollout.py).

The JAX package scans the K ticks inside one jitted program; here they are
a Python loop of eager calls. The tick is kept on the host (ticks advance
in lockstep), so the loop reads nothing back from the device.

Train mode also assembles, per tick, the signals the fine-tune variants
need: the executed transition's env reward (the dense reward model on the
real step), the teacher reward -|v_teacher - v_exec|, per-slot done flags
(churn or scenario end) and, after the loop, truncated-chunk discounted
returns (gamma 0.98) and GAE(lambda) with a value bootstrap. The last
tick has no bootstrap value, so its GAE sample is marked invalid.
"""

from __future__ import annotations

import torch

from .ego.pdm_ego import pdm_ego_waypoints
from .map.tensor_map import TensorMap
from .models.e2e.policy import e2e_ego_waypoints
from .models.plant.policy import plant_ego_waypoints
from .models.pluto.policy import pluto_cbv_act
from .rl.buffer import ring_append, ring_init
from .rl.evaluator import GAMMA, executed_cbv_reward
from .scenario.criteria import CriteriaState
from .scenario.env import env_step
from .sim.state import ScenarioSpec, SimState
from .utils.tensors import tree_map

GAE_LAMBDA = 0.95
TEACHER_LAMBDA = 0.2  # reward_lambda of the reference's shaped return
# the extras a fine-tune buffer keeps, beside the features
SAMPLE_KEYS = (
    "old_logits", "advantage", "valid", "rollout_return", "chosen_idx",
    "teacher_speed", "teacher_pos", "teacher_traj", "value", "reward",
    "ret", "ret_shaped", "gae", "gae_valid",
)


def _chunk_returns(rewards, dones, values):
    """[K, B] truncated discounted returns with a last-value bootstrap, and
    GAE(lambda). Returns (ret, gae, gae_valid)."""
    K = rewards.shape[0]
    not_done = 1.0 - dones.float()
    # discounted return, segmented by dones, bootstrapped at the chunk end
    ret = torch.empty_like(rewards)
    carry = values[-1] * not_done[-1]
    for k in range(K - 1, -1, -1):
        carry = rewards[k] + GAMMA * not_done[k] * carry
        ret[k] = carry
    # GAE with a one-step bootstrap; the last tick has no V_{t+1}
    v_next = torch.cat([values[1:], values[-1:]], dim=0)
    delta = rewards + GAMMA * not_done * v_next - values
    gae = torch.empty_like(rewards)
    carry = torch.zeros_like(delta[-1])
    for k in range(K - 1, -1, -1):
        carry = delta[k] + GAMMA * GAE_LAMBDA * not_done[k] * carry
        gae[k] = carry
    gae_valid = torch.ones(rewards.shape, dtype=torch.bool, device=rewards.device)
    gae_valid[-1] = False
    return ret, gae, gae_valid


def tick_extras(tmap: TensorMap, cbv_out: dict, state_after: SimState,
                crit_after: CriteriaState) -> dict:
    """One tick's fine-tune samples, flattened to [S*C], from a train-mode
    policy act and the state after the env step."""
    slots = cbv_out["cbv_slots"]
    S, C = slots.shape
    flat = lambda x: x.reshape((S * C,) + x.shape[2:])
    reward = executed_cbv_reward(tmap, state_after, slots)
    teacher_reward = -torch.abs(cbv_out["teacher_speed"] - cbv_out["exec_speed"])
    scen = torch.arange(S, device=slots.device)[:, None]
    still_cbv = state_after.is_cbv[scen, torch.clamp(slots, min=0)] & (slots >= 0)
    done = ~still_cbv | crit_after.done[:, None]
    out = {"features": tree_map(flat, cbv_out["features"])}
    out.update({k: flat(cbv_out[src]) for k, src in (
        ("old_logits", "old_logits"), ("advantage", "advantage"), ("valid", "adv_valid"),
        ("rollout_return", "rollout_return"), ("chosen_idx", "chosen_idx"),
        ("teacher_speed", "teacher_speed"), ("teacher_pos", "teacher_pos"),
        ("teacher_traj", "teacher_traj"), ("value", "value"),
    )})
    out["reward"] = flat(reward)
    out["reward_shaped"] = flat(reward + TEACHER_LAMBDA * teacher_reward)
    out["done"] = flat(done)
    out["sample_valid"] = flat(slots >= 0) & out["valid"].flatten(1).any(-1)
    return out


def _stack(pending: list) -> dict:
    """[B]-leading per-tick samples -> [K, B] (features nested)."""
    return {
        k: tree_map(lambda *xs: torch.stack(xs), *[p[k] for p in pending])
        for k in pending[0]
    }


def _with_returns(extras: dict) -> dict:
    ret, gae, gae_valid = _chunk_returns(extras["reward"], extras["done"], extras["value"])
    ret_shaped, _, _ = _chunk_returns(extras["reward_shaped"], extras["done"], extras["value"])
    extras.update(ret=ret, ret_shaped=ret_shaped, gae=gae,
                  gae_valid=gae_valid & extras["sample_valid"])
    return extras


def store_chunk(buffer, extras: dict, capacity: int):
    """Append [K, B, ...] chunk extras' valid samples to a ring buffer,
    made on the first call (`buffer` None) with `capacity`. Returns it."""
    merge = lambda x: x.reshape((-1,) + x.shape[2:])
    samples = {"features": tree_map(merge, extras["features"])}
    samples.update({k: merge(extras[k]) for k in SAMPLE_KEYS if k in extras})
    if buffer is None:
        buffer = ring_init(tree_map(lambda x: x[0], samples), capacity=capacity)
    ring_append(buffer, samples, merge(extras["sample_valid"]))
    return buffer


def flush_pending(store_fn, pending: list):
    """Stack per-tick samples into [K, B] extras with returns and GAE, hand
    them to `store_fn` and clear the list."""
    if pending:
        store_fn(_with_returns(_stack(pending)))
        pending.clear()


EGO_KINDS = ("rule", "pdm", "expert", "plant", "e2e")


def ego_waypoints(ego: str, tmap: TensorMap, spec: ScenarioSpec, state: SimState,
                  ego_model=None):
    """The ego's waypoints of this tick for `rollout_chunk`'s ego kind:
    the PDM-Lite ego ("pdm"), the same with privileged lane changes
    ("expert"), the PlanT transformer `ego_model` ("plant"), an E2E camera
    stack `ego_model` ("e2e": vad, uniad or sparsedrive), or None, which
    leaves env_step to the rule ego ("rule")."""
    if ego == "rule":
        return None
    if ego not in EGO_KINDS:
        raise ValueError(f"ego kind {ego!r} is not ported (ported: {', '.join(EGO_KINDS)})")
    if ego in ("plant", "e2e") and ego_model is None:
        raise ValueError(f"the {ego} ego needs its model (ego_model)")
    if ego == "plant":
        return plant_ego_waypoints(ego_model, spec, state)
    if ego == "e2e":
        return e2e_ego_waypoints(ego_model, tmap, spec, state)
    return pdm_ego_waypoints(spec, state, tmap, lane_change=ego == "expert")


def rollout_chunk(model, tmap: TensorMap, spec: ScenarioSpec, state: SimState,
                  crit: CriteriaState, max_cbvs: int = 3, num_steps: int = 10,
                  train: bool = False, with_policy: bool = True, ego: str = "rule",
                  canonical: bool = False, map_tok: torch.Tensor | None = None,
                  execute_teacher: bool = False, ego_model=None, recog_model=None,
                  *, tick: int):
    """Advance all scenarios `num_steps` ticks: each tick the ego's
    waypoints (`ego`: "rule", "pdm", "expert", or "plant" or "e2e" with its
    PlanTModel or E2EModel `ego_model`, computed in the loop, as the JAX
    package computes them in its scan), the Pluto CBVs' act (legacy
    per-CBV tokens, or with `canonical` frame-invariant ones, `map_tok`
    precomputed), then the env step; `with_policy=False` runs the world
    alone. `execute_teacher` (train mode) makes the CBVs execute the
    teacher's path, as the BC pretrain collects. `recog_model` (a PlanT
    scorer) makes env_step's recognition the attention one. `tick` is the
    state's tick, kept on the host (`TrafficEnv.advance`).

    Returns (state, crit, extras). In train mode, extras stacks the per-tick
    buffer samples with leading dims [num_steps, S*C]: features, old_logits,
    advantage, valid, sample_valid, chosen_idx, teacher_speed, reward, ret,
    ret_shaped, gae, gae_valid, value, ...; else None.
    """
    pending = []
    for k in range(num_steps):
        ego_traj = ego_waypoints(ego, tmap, spec, state, ego_model)
        if with_policy:
            res = pluto_cbv_act(
                model, tmap, spec, state, max_cbvs=max_cbvs, train=train,
                canonical=canonical, map_tok=map_tok, execute_teacher=execute_teacher,
            )
            state, crit = env_step(
                tmap, spec, state, crit, cbv_traj=res["traj"], cbv_traj_mask=res["mask"],
                ego_traj=ego_traj, max_cbvs=max_cbvs, recog_model=recog_model,
                tick=tick + k,
            )
            if train:
                pending.append(tick_extras(tmap, res, state, crit))
        else:
            state, crit = env_step(tmap, spec, state, crit, ego_traj=ego_traj,
                                   max_cbvs=max_cbvs, recog_model=recog_model, tick=tick + k)
    return state, crit, _with_returns(_stack(pending)) if pending else None
