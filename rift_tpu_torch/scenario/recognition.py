"""CBV recognition: promote background vehicles to adversaries (port of
rift_tpu/scenario/recognition.py: the rule path, the PlanT attention
recognizer `attn_recognize_cbvs` and `cbv_slot_assignment`).

Candidates are alive background vehicles 10-60 m from the ego, on-road,
whose driving distance to some upcoming ego-route waypoint is comparable to
the ego's own route distance to it (interaction-point matching). The
reset-time route-distance field (ScenarioSpec.lane_route_dist/join) turns
each candidate's graph distance into two gathers:
`d_cand(w) = (D[lane] - s_on_lane) + (w_s - J[lane])`. The closest
matching candidates become CBVs, each with a goal ~GOAL_AHEAD m along its
own lane chain (the fork taken from its branch bits).
"""

from __future__ import annotations

import torch

from ..map.tensor_map import TensorMap
from ..sim.state import ScenarioSpec, SimState

MIN_EGO_DIST = 10.0
MAX_EGO_DIST = 60.0  # search radius
# |d_cbv - d_ego| acceptance threshold: 60 m in train mode, 20 m in eval
INTERACTION_TOLERANCE = 60.0
INTERACTION_TOLERANCE_EVAL = 20.0
MAX_EGO_ROUTE_AHEAD = 80.0  # route waypoints (1 m apart) matched ahead
GOAL_AHEAD = 400.0  # CBV goal distance along its own chain
MIN_GOAL_DIST = 20.0  # no promotion when the chain ends at the agent's feet
RECOG_WARMUP_TICKS = 25  # no recognition before tick 25
RECOG_INTERVAL = 2  # then every 2 ticks


def recognize_cbvs(tmap: TensorMap, spec: ScenarioSpec, state: SimState, max_cbvs: int = 3):
    """Returns (is_cbv [S, A], goal [S, A, 2], goal_valid [S, A],
    interaction_idx [S, A] route-waypoint index or -1, promote [S, A]).
    Existing CBVs keep their status and goal; only free slots are filled.
    The spec must carry the lane chains and the route-distance field, as
    `make_scenario_spec` builds them."""
    dev = state.pos.device
    ego_pos = state.pos[:, 0]
    W = spec.ego_route.shape[1]
    # only MAX_EGO_ROUTE_AHEAD m past the ego's cursor can match: a window
    W_WIN = int(MAX_EGO_ROUTE_AHEAD) + 16
    base = torch.clamp(state.ego_route_cursor.to(torch.int32), 0, W - 1).long()
    w_abs = torch.clamp(base[:, None] + torch.arange(W_WIN, device=dev), max=W - 1)
    w_f = w_abs.float()
    d_ego = w_f - state.ego_route_cursor[:, None]  # [S, W']
    ahead = (d_ego >= 0) & (d_ego <= MAX_EGO_ROUTE_AHEAD) & (w_abs < spec.ego_route_len[:, None])

    lane = torch.clamp(state.lane, min=0)
    s_on, _, _ = tmap.project(lane, state.pos)  # [S, A]
    D = torch.gather(spec.lane_route_dist, 1, lane)
    J = torch.gather(spec.lane_route_join, 1, lane)
    d_cbv = (D - s_on)[..., None] + (w_f[:, None] - J[..., None])  # [S, A, W']
    reachable = (
        (D < 1e8)[..., None] & (w_f[:, None] >= J[..., None] - 1.0) & (d_cbv > -2.0)
    )
    d_cbv = torch.where(reachable, torch.clamp(d_cbv, min=0.0), torch.inf)
    mismatch = torch.abs(d_cbv - d_ego[:, None])
    mismatch = torch.where(ahead[:, None] & torch.isfinite(d_cbv), mismatch, torch.inf)
    best_mismatch, best_w_win = mismatch.min(-1)  # first index among ties
    best_w = torch.gather(w_abs, 1, best_w_win)

    goal_pos = _chain_goal(tmap, spec, state, GOAL_AHEAD)
    # a goal at the candidate's feet would be reached at once: churn
    goal_far = torch.linalg.norm(goal_pos - state.pos, dim=-1) > MIN_GOAL_DIST

    dist_ego = torch.linalg.norm(state.pos - ego_pos[:, None], dim=-1)
    # only background vehicles are promotable; the ego never
    is_bv = state.alive & ~state.is_cbv & (state.agent_class == 0)
    is_bv[:, 0] = False
    candidate = (
        is_bv & (dist_ego > MIN_EGO_DIST) & (dist_ego < MAX_EGO_DIST) & ~state.offroad
        & (best_mismatch < INTERACTION_TOLERANCE) & goal_far
    )
    # fill the free CBV slots with the closest candidates; stable sorts, as
    # jnp.argsort, over scores full of inf ties
    free = torch.clamp(max_cbvs - state.is_cbv.sum(-1), min=0)
    score = torch.where(candidate, dist_ego, torch.inf)
    order = torch.argsort(score, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    promote = candidate & (rank < free[:, None])
    return (
        state.is_cbv | promote,
        torch.where(promote[..., None], goal_pos, state.goal),
        state.goal_valid | promote,
        torch.where(promote, best_w, -1),
        promote,
    )


def _chain_goal(tmap, spec, state, ahead: float) -> torch.Tensor:
    """[S, A, 2] goal `ahead` meters along each agent's lane chain (or the
    chain end when shorter)."""
    S = state.pos.shape[0]
    lane = torch.clamp(state.lane, min=0)
    branch = state.bv_branch_bits & 1
    scen = torch.arange(S, device=lane.device)[:, None]
    chains = spec.lane_chains[scen, lane, branch]  # [S, A, MC]
    ch = torch.clamp(chains, min=0)
    lens = tmap.length[ch] * (chains >= 0)
    s_on, _, _ = tmap.project(lane, state.pos)
    # distance from the agent to the END of each chain lane
    cum = torch.cumsum(lens, dim=-1) - s_on[..., None]
    hit = cum >= ahead
    idx = torch.where(
        hit.any(-1), torch.argmax(hit.to(torch.uint8), dim=-1), (chains >= 0).sum(-1) - 1
    )
    idx = torch.clamp(idx, min=0)
    goal_lane = torch.gather(ch, -1, idx[..., None])[..., 0]
    # distance to the START of the goal lane (lane 0 starts s_on behind)
    cum_start = torch.cat([-s_on[..., None], cum], dim=-1)
    to_start = torch.gather(cum_start, -1, idx[..., None])[..., 0]
    remaining = torch.clamp(ahead - to_start, min=0.0)
    frac = torch.clamp(remaining / torch.clamp(tmap.length[goal_lane], min=1e-3), 0.0, 1.0)
    P = tmap.centerline.shape[1]
    fi = frac * (P - 1)
    i0 = torch.clamp(fi.to(torch.int32), 0, P - 2).long()
    w = (fi - i0)[..., None]
    return tmap.centerline[goal_lane, i0] * (1 - w) + tmap.centerline[goal_lane, i0 + 1] * w


def attn_recognize_cbvs(tmap: TensorMap, spec: ScenarioSpec, state: SimState,
                        attn_scores_fn, max_cbvs: int = 3):
    """Attention recognition: the rule-passing candidates ranked by a
    PlanT scorer's attention (`attn_scores_fn(state) -> [S, A]`, higher is
    more relevant; models/plant/train.py:plant_attn_scores), the top ones
    promoted into the free CBV slots. Returns `recognize_cbvs`'s tuple.

    The ranks are the JAX package's two stable argsorts; a candidate whose
    score is -inf (no vehicle token) is never promoted, and tied scores
    rank by slot."""
    is_cbv, goal, goal_valid, interaction, promote_rule = recognize_cbvs(
        tmap, spec, state, max_cbvs
    )
    scores = attn_scores_fn(state)
    candidate = promote_rule | (is_cbv & ~state.is_cbv)
    free = torch.clamp(max_cbvs - state.is_cbv.sum(-1), min=0)
    score = torch.where(candidate, scores, -torch.inf)
    order = torch.argsort(-score, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    promote = candidate & (rank < free[:, None]) & torch.isfinite(score)
    return (
        state.is_cbv | promote,
        torch.where(promote[..., None], goal, state.goal),
        torch.where(promote, goal_valid, state.goal_valid),
        torch.where(promote, interaction, -1),
        promote,
    )


def cbv_slot_assignment(is_cbv: torch.Tensor, max_cbvs: int) -> torch.Tensor:
    """[S, A] mask -> [S, C] agent indices (-1 padded), CBVs first in slot
    order (a stable sort, as jnp.argsort is)."""
    order = torch.argsort((~is_cbv).to(torch.uint8), dim=-1, stable=True)
    slots = order[:, :max_cbvs]
    valid = torch.gather(is_cbv, 1, slots)
    return torch.where(valid, slots, -1)
