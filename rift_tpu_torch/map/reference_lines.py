"""Reference-line extraction from precomputed lane chains (port of
rift_tpu/map/reference_lines.py).

`build_lane_chains` walks the lane topology once per episode: for every
(scenario, start lane, branch) the greedy successor chain preferring
on-route successors. Per tick a reference line is then gathers and a lerp.
The JAX package's `lax.scan` becomes a Python loop over MAX_CHAIN steps and
its `vmap`s become batch dimensions written out.
"""

from __future__ import annotations

import torch

from .tensor_map import LANE_POINTS, TensorMap

MAX_CHAIN = 16
NUM_BRANCHES = 2  # primary chain + alternate branch at the first fork


def _segment_table(tmap: TensorMap) -> torch.Tensor:
    """[L, P-1, 8] per segment (x0, y0, cos h0, sin h0, x1, y1, cos h1,
    sin h1)."""
    vt = torch.cat(
        [
            tmap.centerline,
            torch.cos(tmap.headings)[..., None],
            torch.sin(tmap.headings)[..., None],
        ],
        dim=-1,
    )
    return torch.cat([vt[:, :-1], vt[:, 1:]], dim=-1)


def build_lane_chains(tmap: TensorMap, route_lane_mask: torch.Tensor):
    """[S, L] on-route mask -> [S, L, NUM_BRANCHES, MAX_CHAIN] lane chains.

    Chain step preference: the first on-route successor, else the first
    valid successor. Branch 1 takes the second choice at the first fork."""
    succ = tmap.successors  # [L, K]
    S = route_lane_mask.shape[0]
    L, K = succ.shape
    ok = succ >= 0
    on_route = ok & route_lane_mask[:, succ.clamp(min=0)]  # [S, L, K]
    key = torch.where(on_route, 0, torch.where(ok, 1, 2))
    order = torch.argsort(key, dim=-1, stable=True)
    succ_sorted = torch.gather(succ.expand(S, L, K), -1, order)
    n_pref = on_route.sum(-1)
    n_valid = ok.sum(-1).expand(S, L)
    n_choice = torch.where(n_pref > 0, n_pref, n_valid)
    next_primary = torch.where(n_valid > 0, succ_sorted[..., 0], -1)
    alt_ix = torch.clamp(n_choice - 1, min=0).clamp(max=1)
    next_alt = torch.where(
        n_valid > 0, torch.gather(succ_sorted, -1, alt_ix[..., None])[..., 0], -1
    )
    is_fork = n_choice > 1  # [S, L]

    lane0 = torch.arange(L, device=succ.device).expand(S, L)
    branches = []
    for use_alt in (False, True):
        lane = lane0
        pending = torch.full((S, L), use_alt, dtype=torch.bool, device=succ.device)
        links = [lane0]
        for _ in range(MAX_CHAIN - 1):
            li = lane.clamp(min=0)
            fork = torch.gather(is_fork, 1, li)
            nxt = torch.where(
                pending & fork,
                torch.gather(next_alt, 1, li),
                torch.gather(next_primary, 1, li),
            )
            nxt = torch.where(lane < 0, -1, nxt)
            pending = pending & ~fork
            lane = nxt
            links.append(lane)
        branches.append(torch.stack(links, dim=-1))  # [S, L, MC]
    return torch.stack(branches, dim=2)


def reference_lines_from_chains(
    tmap: TensorMap,
    lane_chains: torch.Tensor,  # [S, L, NUM_BRANCHES, MAX_CHAIN]
    scenario: torch.Tensor,  # [B] scenario of each vehicle
    cur_lane: torch.Tensor,  # [B] the vehicle's current lane
    position: torch.Tensor,  # [B, 2]
    num_refs: int = 4,
    num_points: int = 120,
    max_length: float = 120.0,
):
    """Reference lines for B vehicles: current lane, left/right adjacent
    lanes (primary branch) and the current lane's alternate branch.

    The JAX function takes one vehicle and its scenario's chain table; here
    the vehicles are a batch dimension and `scenario` picks each one's
    table. Returns position [B, R, N, 2] / vector / orientation /
    valid_mask at ~1 m spacing from the vehicle's projection."""
    left = tmap.left_adj[cur_lane]
    right = tmap.right_adj[cur_lane]
    starts = torch.stack([cur_lane, left, right, cur_lane], dim=-1)[:, :num_refs]
    branch = (torch.arange(num_refs, device=starts.device) == num_refs - 1).long()
    P = LANE_POINTS
    MC = lane_chains.shape[-1]

    ok = starts >= 0  # [B, R]
    st = starts.clamp(min=0)
    chain = lane_chains[scenario[:, None], st, branch[None, :]]  # [B, R, MC]
    lane_ok = chain >= 0
    ch = chain.clamp(min=0)
    lens = tmap.length[ch] * lane_ok
    cum = torch.cat([torch.zeros_like(lens[..., :1]), torch.cumsum(lens, -1)], -1)
    total = cum[..., -1]

    # arclength of the vehicle's projection onto the START lane
    s0, _, _ = tmap.project(st, position[:, None, :])  # [B, R]
    step = torch.arange(num_points, dtype=torch.float32, device=starts.device)
    targets = s0[..., None] + step * (max_length / num_points)  # [B, R, N]

    # which chain link holds each target: j = #{cum[1:] <= t}
    j = (targets[..., None] >= cum[..., None, 1:]).sum(-1)
    j = j.clamp(0, MC - 1)
    lane_j = torch.gather(ch, -1, j)
    u = targets - torch.gather(cum, -1, j)
    frac = torch.clamp(
        u / torch.clamp(tmap.length[lane_j], min=1e-3), 0.0, 1.0
    ) * (P - 1)
    i0 = torch.clamp(frac.to(torch.int32), 0, P - 2).long()
    w = (frac - i0)[..., None]
    seg = _segment_table(tmap)[lane_j, i0]  # [B, R, N, 8]
    blended = seg[..., :4] * (1.0 - w) + seg[..., 4:] * w
    pos_r = blended[..., :2]
    ori_r = torch.atan2(blended[..., 3], blended[..., 2])
    valid_r = (
        (targets <= total[..., None] + 1e-3)
        & torch.gather(lane_ok, -1, j)
        & ok[..., None]
    )

    # dedupe: drop a line whose points all lie within 0.5 m of an earlier
    # line
    def dup_against(i, k):
        both = valid_r[:, i] & valid_r[:, k]
        diff = (pos_r[:, i] - pos_r[:, k]).abs().sum(-1)
        close = torch.where(both, diff, 0.0)
        return (close.amax(-1) < 0.5) & both.any(-1)

    dup = [torch.zeros_like(ok[:, 0])]
    for k in range(1, num_refs):
        is_dup = torch.zeros_like(ok[:, 0])
        for i in range(k):
            is_dup = is_dup | (dup_against(i, k) & ~dup[i])
        dup.append(is_dup)
    valid_r = valid_r & ~torch.stack(dup, dim=1)[..., None]

    vector = torch.diff(pos_r, dim=-2, append=pos_r[..., -1:, :])
    return {
        "position": pos_r,
        "vector": vector,
        "orientation": ori_r,
        "valid_mask": valid_r,
        "current_lane": cur_lane,
    }
