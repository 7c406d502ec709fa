"""Pluto feature construction (port of rift_tpu/models/pluto/features.py).

Features are built on the device from the SimState and the TensorMap, in
each center CBV's frame. The JAX package `vmap`s one function over
(scenario, CBV); here the S*C center agents are one batch dimension written
out. The legacy (per-CBV, the JAX default) features carry every
neighbour's whole history and every lane polygon's points in the CBV's
frame, for the model to encode per CBV. Canonical mode encodes each map
lane and each world agent's history once (`canonical_map_features`,
`shared_history_features`); its per-CBV features are gather indices plus
current poses.
"""

from __future__ import annotations

import torch

from ...geometry.se2 import wrap_angle
from ...map.reference_lines import reference_lines_from_chains
from ...map.tensor_map import LANE_POINTS, TensorMap
from ...sim.state import ScenarioSpec, SimState

PT_LANE, PT_LANE_CONNECTOR, PT_CROSSWALK = 0, 1, 2
TL_GREEN, TL_UNKNOWN = 0, 3
CAT_EGO, CAT_VEHICLE, CAT_PEDESTRIAN, CAT_BICYCLE = 0, 1, 2, 3


def _rotate(v, c, s):
    """Rotate (..., 2) vectors by the angle whose cos/sin are c, s (shaped
    to broadcast against v[..., 0])."""
    return torch.stack(
        [v[..., 0] * c - v[..., 1] * s, v[..., 0] * s + v[..., 1] * c], dim=-1
    )


def build_features_for_agents(
    tmap: TensorMap,
    state: SimState,
    scenario: torch.Tensor,  # [B]
    agent: torch.Tensor,  # [B] center agent slots
    spec: ScenarioSpec,
    max_agents: int = 32,
    max_polygons: int = 64,
    num_refs: int = 4,
    radius: float = 120.0,
    canonical: bool = False,
):
    """Feature dict for B center agents, each in its own frame (the JAX
    package's build_features_for_agent over a batch). With `canonical` the
    per-CBV history and polygon-point arrays are replaced by gather
    indices (`agent.order`, `map.lane_idx`) and current poses."""
    dev = state.pos.device
    B = scenario.shape[0]
    pos = state.pos[scenario]  # [B, A, 2]
    alive = state.alive[scenario]
    A = pos.shape[1]
    c_pos = state.pos[scenario, agent]  # [B, 2]
    c_heading = state.heading[scenario, agent]  # [B]
    c = torch.cos(-c_heading)
    s = torch.sin(-c_heading)

    def to_local(p):  # [B, ..., 2]
        extra = p.dim() - 2
        shp = (B,) + (1,) * extra
        rel = p - c_pos.reshape(shp + (2,))
        return _rotate(rel, c.reshape(shp), s.reshape(shp))

    def rot_local(v):
        extra = v.dim() - 2
        shp = (B,) + (1,) * extra
        return _rotate(v, c.reshape(shp), s.reshape(shp))

    # ---------------------------------------------------------------- agents
    d = torch.sqrt(((pos - c_pos[:, None]) ** 2).sum(-1))
    others = torch.arange(A, device=dev)[None] != agent[:, None]
    d = torch.where(alive & others, d, torch.inf)
    d = torch.where(d <= radius, d, torch.inf)
    # nearest neighbours (stable: lowest slot first among ties, as top_k)
    k = min(max_agents - 1, A)
    d_sorted, nbr_idx = torch.sort(d, dim=-1, stable=True)
    nbr_idx, nbr_valid = nbr_idx[:, :k], torch.isfinite(d_sorted[:, :k])
    padn = max_agents - 1 - k
    if padn:
        nbr_idx = torch.cat([nbr_idx, nbr_idx.new_zeros(B, padn)], dim=1)
        nbr_valid = torch.cat([nbr_valid, nbr_valid.new_zeros(B, padn)], dim=1)
    order = torch.cat([agent[:, None], nbr_idx], dim=1)  # [B, N]
    slot_valid = torch.cat([torch.ones_like(nbr_valid[:, :1]), nbr_valid], dim=1)
    sc = scenario[:, None]
    a_valid = state.hist_valid[sc, order] & slot_valid[..., None]
    if canonical:
        agent_dict = {
            "order": order,
            "cur_pos": to_local(state.pos[sc, order]),
            "cur_heading": wrap_angle(state.heading[sc, order] - c_heading[:, None]),
        }
    else:
        H = a_valid.shape[-1]
        agent_dict = {
            "position": to_local(state.hist_pos[sc, order]),  # [B, N, H, 2]
            "heading": wrap_angle(state.hist_heading[sc, order] - c_heading[:, None, None]),
            "velocity": rot_local(state.hist_vel[sc, order]),
            "shape": state.shape[sc, order][:, :, None].expand(B, max_agents, H, 2),
        }
    cls = state.agent_class[sc, order]
    category = torch.where(cls == 1, CAT_PEDESTRIAN, CAT_VEHICLE)
    category[:, 0] = CAT_EGO

    # current state: x, y, heading = 0 in own frame; v, a, steer, yaw rate
    cur = torch.zeros((B, 7), dtype=torch.float32, device=dev)
    cur[:, 3] = state.speed[scenario, agent]
    cur[:, 4] = state.accel[scenario, agent]
    cur[:, 5] = state.control[scenario, agent, 1] * 0.37
    cur[:, 6] = state.yaw_rate[scenario, agent]

    # ---------------------------------------------------------------- map
    lane_idx, lane_in = tmap.query_proximal(c_pos, radius, max_polygons)
    li = torch.clamp(lane_idx, min=0)  # [B, M]
    P = LANE_POINTS - 1
    mid = P // 2
    if canonical:
        # only the polygon-centre pose depends on the frame; the point
        # features come from the frame-invariant shared tokens
        seg = tmap.centerline[li, mid + 1] - tmap.centerline[li, mid]
        ori = torch.atan2(seg[..., 1], seg[..., 0]) - c_heading[:, None]
        polygon_center = torch.cat(
            [to_local(tmap.centerline[li, mid]), wrap_angle(ori)[..., None]], dim=-1
        )
        map_dict = {"lane_idx": li}
    else:
        centerline = to_local(tmap.centerline[li])  # [B, M, P+1, 2]
        edges = torch.stack(
            [centerline, to_local(tmap.left_edge[li]), to_local(tmap.right_edge[li])], dim=2
        )  # [B, M, 3, P+1, 2]
        point_vector = edges[..., 1:, :] - edges[..., :-1, :]
        point_orientation = torch.atan2(point_vector[..., 1], point_vector[..., 0])
        polygon_center = torch.cat(
            [centerline[:, :, mid], point_orientation[:, :, 0, mid, None]], dim=-1
        )
        map_dict = {
            "point_position": edges[..., :-1, :],
            "point_vector": point_vector,
            "point_orientation": point_orientation,
        }
    polygon_type = torch.where(tmap.is_junction[li], PT_LANE_CONNECTOR, PT_LANE)
    cur_lane = state.lane[scenario, agent]
    own_chain = spec.lane_chains[scenario, torch.clamp(cur_lane, min=0), 0]
    on_own_route = (li[:, :, None] == own_chain[:, None, :]).any(-1)
    polygon_on_route = (spec.route_lane_mask[sc, li] | on_own_route) & lane_in
    map_dict.update(
        polygon_center=polygon_center,
        polygon_type=polygon_type,
        polygon_on_route=polygon_on_route,
        polygon_tl_status=torch.full_like(li, TL_GREEN),
        polygon_speed_limit=tmap.speed_limit[li],
        valid_mask=lane_in[..., None].expand(B, max_polygons, P).contiguous(),
    )
    if not canonical:
        map_dict["polygon_has_speed_limit"] = lane_in

    # ---------------------------------------------------------------- refs
    refs = reference_lines_from_chains(
        tmap, spec.lane_chains, scenario, cur_lane, c_pos,
        num_refs=num_refs, num_points=int(radius), max_length=radius,
    )
    ref_dict = {
        "position": to_local(refs["position"]),
        "vector": rot_local(refs["vector"]),
        "orientation": wrap_angle(refs["orientation"] - c_heading[:, None, None]),
        "valid_mask": refs["valid_mask"],
    }

    # ---------------------------------------------------------------- statics
    f32 = dict(dtype=torch.float32, device=dev)
    statics = {
        "position": torch.zeros((B, 1, 2), **f32),
        "heading": torch.zeros((B, 1), **f32),
        "shape": torch.zeros((B, 1, 2), **f32),
        "category": torch.zeros((B, 1), dtype=torch.long, device=dev),
        "valid_mask": torch.zeros((B, 1), dtype=torch.bool, device=dev),
    }
    agent_dict.update(category=category, valid_mask=a_valid)
    return {
        "agent": agent_dict,
        "map": map_dict,
        "reference_line": ref_dict,
        "static_objects": statics,
        "current_state": cur,
    }


def build_features_for_agent(
    tmap: TensorMap,
    state: SimState,
    scenario,  # scalar int
    agent,  # scalar int: the center agent's slot
    route_mask: torch.Tensor,  # [L] the scenario's ego-route lanes
    chains_s: torch.Tensor,  # [L, 2, MAX_CHAIN] the scenario's lane chains
    max_agents: int = 32,
    max_polygons: int = 64,
    num_refs: int = 4,
    radius: float = 120.0,
    canonical: bool = False,
):
    """The feature dict (no batch dim) of one center agent, in its frame:
    `build_features_for_agents` over a batch of one, with the scenario's
    route mask and lane chains standing for its spec's rows."""
    dev = state.pos.device
    S = state.pos.shape[0]
    spec_rows = ScenarioSpec(
        ego_route=None, ego_route_len=None, route_road_ids=None, route_lane_ids=None,
        ego_target_speed=None, timeout_ticks=None,
        route_lane_mask=route_mask[None].expand((S,) + route_mask.shape),
        lane_chains=chains_s[None].expand((S,) + chains_s.shape),
    )
    as_index = lambda i: torch.as_tensor(i, device=dev).long().reshape(1)
    feats = build_features_for_agents(
        tmap, state, as_index(scenario), as_index(agent), spec_rows, max_agents=max_agents,
        max_polygons=max_polygons, num_refs=num_refs, radius=radius, canonical=canonical,
    )
    return {g: {k: v[0] for k, v in d.items()} if isinstance(d, dict) else d[0]
            for g, d in feats.items()}


def canonical_map_features(tmap: TensorMap):
    """Per-lane polygon features in each lane's own frame: {"feat"
    [L, P, 10], "type" [L], "speed" [L]} (the channel layout MapEncoder
    feeds its PointsEncoder)."""
    edges = torch.stack([tmap.centerline, tmap.left_edge, tmap.right_edge], dim=1)
    point_position = edges[:, :, :-1]
    point_vector = edges[:, :, 1:] - edges[:, :, :-1]
    point_orientation = torch.atan2(point_vector[..., 1], point_vector[..., 0])
    mid = (LANE_POINTS - 1) // 2
    center_pos = tmap.centerline[:, mid]
    center_ori = point_orientation[:, 0, mid]
    c = torch.cos(-center_ori)[:, None]
    s = torch.sin(-center_ori)[:, None]
    rel_ori = point_orientation[:, 0] - center_ori[:, None]
    feat = torch.cat(
        [
            _rotate(point_position[:, 0] - center_pos[:, None, :], c, s),
            _rotate(point_vector[:, 0], c, s),
            torch.stack([torch.cos(rel_ori), torch.sin(rel_ori)], dim=-1),
            _rotate(point_position[:, 1] - point_position[:, 0], c, s),
            _rotate(point_position[:, 2] - point_position[:, 0], c, s),
        ],
        dim=-1,
    )
    ptype = torch.where(tmap.is_junction, PT_LANE_CONNECTOR, PT_LANE)
    return {"feat": feat, "type": ptype, "speed": tmap.speed_limit}


def shared_history_features(state: SimState):
    """Per-world-agent history-difference features in each agent's own
    current frame: [S, A, H-1, 9] (the layout AgentEncoder feeds its
    HistoryEncoder). CBV-independent by construction."""
    c = torch.cos(-state.heading)[..., None]
    s = torch.sin(-state.heading)[..., None]
    hv = state.hist_valid
    vec_mask = hv[..., :-1] & hv[..., 1:]

    def to_vec(f):
        d = f[..., 1:, :] - f[..., :-1, :]
        return torch.where(vec_mask[..., None], _rotate(d, c, s), 0.0)

    dh = state.hist_heading[..., 1:] - state.hist_heading[..., :-1]
    dh = torch.where(vec_mask, dh, 0.0)
    S, A, H = hv.shape
    shape_b = state.shape[:, :, None, :].expand(S, A, H - 1, 2)
    return torch.cat(
        [
            to_vec(state.hist_pos),
            to_vec(state.hist_vel),
            torch.stack([torch.cos(dh), torch.sin(dh)], dim=-1),
            shape_b,
            vec_mask[..., None].float(),
        ],
        dim=-1,
    )


def build_cbv_features(
    tmap: TensorMap,
    state: SimState,
    cbv_slots: torch.Tensor,  # [S, C] agent slot per CBV position (-1 pad)
    spec: ScenarioSpec,
    max_agents: int = 32,
    max_polygons: int = 64,
    num_refs: int = 4,
    radius: float = 120.0,
    canonical: bool = False,
    with_sample_feats: bool = False,
):
    """Features for all CBVs of all scenarios, leading dims [S, C].
    Returns (features, valid [S, C]), and with `canonical` a third
    element, `shared`: the frame-invariant blocks {"map_feat"/"map_type"/
    "map_speed" [L, ...], "hist_feat" [S, A, H-1, 9]}.

    `with_sample_feats` (train mode, canonical tokens; legacy features are
    per sample already) also gathers the per-sample canonical inputs "agent.hist_feat" [S, C, N, H-1, 9] and "map.canonical_feat"
    [S, C, M, P, 10], so buffered samples stay self-contained for the fit
    forward; the model computes the same tokens from either form."""
    S, C = cbv_slots.shape
    scen = torch.arange(S, device=cbv_slots.device).repeat_interleave(C)
    feats = build_features_for_agents(
        tmap, state, scen, torch.clamp(cbv_slots, min=0).reshape(-1), spec,
        max_agents=max_agents, max_polygons=max_polygons,
        num_refs=num_refs, radius=radius, canonical=canonical,
    )
    feats = {
        g: {k: v.reshape((S, C) + v.shape[1:]) for k, v in d.items()}
        if isinstance(d, dict) else d.reshape((S, C) + d.shape[1:])
        for g, d in feats.items()
    }
    if not canonical:
        return feats, cbv_slots >= 0
    shared = {f"map_{k}": v for k, v in canonical_map_features(tmap).items()}
    shared["hist_feat"] = shared_history_features(state)
    if with_sample_feats:
        order = feats["agent"]["order"]  # [S, C, N]
        scen = torch.arange(S, device=order.device)[:, None, None]
        feats["agent"]["hist_feat"] = shared["hist_feat"][scen, order]
        feats["map"]["canonical_feat"] = shared["map_feat"][feats["map"]["lane_idx"]]
    return feats, cbv_slots >= 0, shared
