"""Pluto planner in PyTorch (port of rift_tpu/models/pluto/model.py).

dim 128, 21 history steps, 80 future steps, encoder and decoder depth 4
by default, 12 modes, a reference-line x mode query decoder. The encoders
branch on the features' keys, as the JAX package's do, over one parameter
tree: the legacy (per-CBV, the JAX default) branches encode every
neighbour's history and every lane polygon in the CBV's frame; the
canonical (frame-invariant token) branches take agent tokens from the
shared per-world-agent history features, map tokens from the shared
per-lane features or the precomputed `map_tok` (the rollout), or both from
the per-sample canonical features of a buffered batch (the fine-tune
forward).

Submodule names are the flax ones, so `load_jax_params` maps a flax param
path onto the module tree directly.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from ...utils.device import resolve_device
from .layers import (
    Attention,
    Dense,
    Embed,
    FourierEmbedding,
    HistoryEncoder,
    LayerNorm,
    MLPLayer,
    PointsEncoder,
    StateAttentionEncoder,
    TransformerEncoderLayer,
)


def _wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


class AgentEncoder(nn.Module):
    """Agent tokens: the HistoryEncoder over history differences, either
    each neighbour's in the CBV's frame (legacy) or each world agent's in
    its own frame, once per world agent and gathered per CBV slot
    (canonical); slot 0 is the ego token from the current-state
    channels."""

    def __init__(self, dim=128, state_channel=6, hist_steps=21, dtype=None):
        super().__init__()
        self.dim, self.state_channel, self.hist_steps = dim, state_channel, hist_steps
        self.HistoryEncoder_0 = HistoryEncoder(9, dim // 4, dtype=dtype)
        self.StateAttentionEncoder_0 = StateAttentionEncoder(state_channel, dim, dtype)
        self.Embed_0 = Embed(4, dim, dtype)

    def forward(self, data):
        valid_mask = data["agent"]["valid_mask"][:, :, : self.hist_steps]
        shared = data.get("shared", {})
        if "hist_feat" in shared:
            hf = shared["hist_feat"]  # [S, A_w, T-1, 9]
            S, A_w, Tm1, C = hf.shape
            tok = self.HistoryEncoder_0(hf.reshape(S * A_w, Tm1, C))
            tok = tok.reshape(S, A_w, self.dim)
            x = tok[shared["scen_idx"][:, None], data["agent"]["order"]]
        else:
            # per sample: canonical features of buffered fit samples, or
            # legacy ones differenced here; [B, A, T-1, 9]
            feat = data["agent"].get("hist_feat")
            if feat is None:
                feat = _history_differences(data["agent"], valid_mask, self.hist_steps)
            B, A, Tm1, C = feat.shape
            x = self.HistoryEncoder_0(feat.reshape(B * A, Tm1, C)).reshape(B, A, self.dim)
        x = torch.where(valid_mask.any(-1)[..., None], x, 0.0)
        ego = self.StateAttentionEncoder_0(
            data["current_state"][:, : self.state_channel]
        )
        x = torch.cat([ego[:, None].to(x.dtype), x[:, 1:]], dim=1)
        return x + self.Embed_0(data["agent"]["category"])


def _history_differences(agent, valid_mask, T):
    """The legacy branch's [B, A, T-1, 9] HistoryEncoder input: position
    and velocity differences, the heading difference's cos and sin, the
    shape, and the difference mask; differences where either step is
    invalid are 0."""
    vec_mask = valid_mask[..., :-1] & valid_mask[..., 1:]

    def to_vec(f):
        f = f[:, :, :T]
        d = f[:, :, 1:] - f[:, :, :-1]
        return torch.where(vec_mask if d.dim() == vec_mask.dim() else vec_mask[..., None],
                           d, 0.0)

    dh = to_vec(agent["heading"])
    return torch.cat(
        [
            to_vec(agent["position"]),
            to_vec(agent["velocity"]),
            torch.stack([torch.cos(dh), torch.sin(dh)], dim=-1),
            agent["shape"][:, :, 1:T],
            vec_mask[..., None].float(),
        ],
        dim=-1,
    )


def _polygon_points(m):
    """The legacy branch's [B, M, P, 10] PointsEncoder input: centreline
    points about the polygon centre, their vectors and orientation (cos,
    sin), and the left and right edge points about the centreline's."""
    pos, ori = m["point_position"], m["point_orientation"]
    return torch.cat(
        [
            pos[:, :, 0] - m["polygon_center"][..., None, :2],
            m["point_vector"][:, :, 0],
            torch.stack([torch.cos(ori[:, :, 0]), torch.sin(ori[:, :, 0])], dim=-1),
            pos[:, :, 1] - pos[:, :, 0],
            pos[:, :, 2] - pos[:, :, 0],
        ],
        dim=-1,
    )


class MapEncoder(nn.Module):
    """Polygon tokens: each CBV's lane polygons through the PointsEncoder
    under their point masks (legacy), or one frame-invariant token per map
    lane gathered per CBV polygon slot (canonical); plus type, on-route,
    light and speed-limit embeddings."""

    def __init__(self, dim=128, dtype=None, points_norm="ln"):
        super().__init__()
        self.dt = dtype or torch.float32
        self.PointsEncoder_0 = PointsEncoder(10, dim, dtype, points_norm)
        self.type_emb = Embed(3, dim, dtype)
        self.speed_emb = FourierEmbedding(1, dim, 64, dtype)
        self.unknown_speed_emb = nn.Parameter(0.02 * torch.randn(dim))
        self.on_route_emb = Embed(2, dim, dtype)
        self.tl_emb = Embed(4, dim, dtype)

    def forward(self, data):
        sh = data.get("shared", {})
        if "map_feat" not in sh:
            m = data["map"]
            if "canonical_feat" not in m:
                return self._per_cbv(m)
            # per-sample path (buffered fit samples)
            feat = m["canonical_feat"]  # [B, M, P, 10]
            x = self.PointsEncoder_0(feat, torch.ones(feat.shape[:-1], dtype=torch.bool,
                                                      device=feat.device))
            x = x + self.type_emb(m["polygon_type"])
            x = x + self.speed_emb(m["polygon_speed_limit"][..., None])
            return x + self.on_route_emb(m["polygon_on_route"]) + self.tl_emb(
                m["polygon_tl_status"]
            )
        if "map_tok" in sh:
            tok = sh["map_tok"].to(self.dt)
        else:
            mf = sh["map_feat"]  # [L, P, 10]
            L, P, _ = mf.shape
            ones = torch.ones((1, L, P), dtype=torch.bool, device=mf.device)
            tok = self.PointsEncoder_0(mf[None], ones)[0]
            tok = tok + self.type_emb(sh["map_type"])
            tok = tok + self.speed_emb(sh["map_speed"][..., None])
        if "map_tokens_only" in data:
            return tok
        m = data["map"]
        x = tok[m["lane_idx"]]
        x = x + self.on_route_emb(m["polygon_on_route"])
        return x + self.tl_emb(m["polygon_tl_status"])

    def _per_cbv(self, m):
        """Per-CBV polygons under their real masks (an all-masked polygon
        gives 0), the embeddings added in the JAX package's order: type,
        on-route, light, then the speed limit's or the unknown-speed
        embedding. The latter is an f32 parameter, so with bf16 compute the
        sum, as the JAX package's, comes out in f32."""
        x = self.PointsEncoder_0(_polygon_points(m), m["valid_mask"])
        x = x + self.type_emb(m["polygon_type"])
        x = x + self.on_route_emb(m["polygon_on_route"])
        x = x + self.tl_emb(m["polygon_tl_status"])
        speed = self.speed_emb(m["polygon_speed_limit"][..., None])
        return x + torch.where(m["polygon_has_speed_limit"][..., None], speed,
                               self.unknown_speed_emb)


class StaticObjectsEncoder(nn.Module):
    def __init__(self, dim=128, dtype=None):
        super().__init__()
        self.FourierEmbedding_0 = FourierEmbedding(2, dim, 64, dtype)
        self.Embed_0 = Embed(4, dim, dtype)

    def forward(self, data):
        so = data["static_objects"]
        emb = self.FourierEmbedding_0(so["shape"]) + self.Embed_0(so["category"])
        valid = so["valid_mask"]
        emb = torch.where(valid[..., None], emb, 0.0)
        obj_pos = torch.cat([so["position"], _wrap(so["heading"])[..., None]], -1)
        return emb, obj_pos, ~valid


class AgentPredictor(nn.Module):
    """Auxiliary agent-prediction head (training losses only)."""

    def __init__(self, dim=128, future_steps=80, dtype=None):
        super().__init__()
        self.T = future_steps
        for i in range(3):
            setattr(self, f"MLPLayer_{i}", MLPLayer(dim, 2 * dim, 2 * future_steps, dtype))

    def forward(self, x):
        B, N, _ = x.shape
        return torch.cat(
            [getattr(self, f"MLPLayer_{i}")(x).reshape(B, N, self.T, 2) for i in range(3)],
            dim=-1,
        )


class DecoderLayer(nn.Module):
    """R2R self-attention, M2M self-attention, cross-attention, FFN."""

    def __init__(self, dim, num_heads, mlp_ratio, dtype=None):
        super().__init__()
        for i in range(4):
            setattr(self, f"LayerNorm_{i}", LayerNorm(dim, dtype))
        self.r2r = Attention(dim, num_heads, dtype)
        self.m2m = Attention(dim, num_heads, dtype)
        self.cross = Attention(dim, num_heads, dtype)
        self.Dense_0 = Dense(dim, dim * mlp_ratio, dtype)
        self.Dense_1 = Dense(dim * mlp_ratio, dim, dtype)

    def forward(self, tgt, memory, r_key_padding, memory_key_padding, m_pos):
        B, R, M, D = tgt.shape
        # r2r: attend across reference lines (batched over modes)
        h = self.LayerNorm_0(tgt).transpose(1, 2).reshape(B * M, R, D)
        pad = torch.repeat_interleave(r_key_padding, M, dim=0)
        h = self.r2r(h, key_padding_mask=pad)
        tgt = tgt + h.reshape(B, M, R, D).transpose(1, 2)

        # m2m: attend across modes (batched over reference lines)
        h = self.LayerNorm_1(tgt).reshape(B * R, M, D)
        hq = h + m_pos
        h = self.m2m(hq, hq, h, merge="qk").reshape(B, R, M, D)
        h = torch.where(r_key_padding[:, :, None, None], 0.0, h)
        tgt = tgt + h

        # cross-attention to the scene encoding
        h = self.LayerNorm_2(tgt).reshape(B, R * M, D)
        h = self.cross(h, memory, memory, key_padding_mask=memory_key_padding)
        tgt = tgt + h.reshape(B, R, M, D)

        h = self.Dense_1(torch.relu(self.Dense_0(self.LayerNorm_3(tgt))))
        return tgt + h


class PlanningDecoder(nn.Module):
    def __init__(self, num_modes=12, depth=4, dim=128, num_heads=4, mlp_ratio=4,
                 future_steps=80, dtype=None, points_norm="ln"):
        super().__init__()
        self.M, self.depth, self.dim, self.T = num_modes, depth, dim, future_steps
        self.r_encoder = PointsEncoder(6, dim, dtype, points_norm)
        self.r_pos_emb = FourierEmbedding(3, dim, 64, dtype)
        self.m_emb = nn.Parameter(0.01 * torch.randn(1, 1, num_modes, dim))
        self.m_pos = nn.Parameter(0.01 * torch.randn(1, num_modes, dim))
        self.q_proj = Dense(2 * dim, dim, dtype)
        for i in range(depth):
            setattr(self, f"layer{i}", DecoderLayer(dim, num_heads, mlp_ratio, dtype))
        self.cat_x_proj = Dense(2 * dim, dim, dtype)
        self.loc_head = MLPLayer(dim, 2 * dim, future_steps * 2, dtype)
        self.yaw_head = MLPLayer(dim, 2 * dim, future_steps * 2, dtype)
        self.vel_head = MLPLayer(dim, 2 * dim, future_steps * 2, dtype)
        self.pi_head = MLPLayer(dim, dim, 1, dtype)

    def forward(self, data, enc_emb, enc_key_padding):
        r = data["reference_line"]
        r_pos, r_vec, r_ori, r_valid = (
            r["position"], r["vector"], r["orientation"], r["valid_mask"],
        )
        r_key_padding = ~r_valid.any(-1)
        feat = torch.cat(
            [
                r_pos - r_pos[..., 0:1, :],
                r_vec,
                torch.stack([torch.cos(r_ori), torch.sin(r_ori)], dim=-1),
            ],
            dim=-1,
        )
        r_emb = self.r_encoder(feat, r_valid)
        r_pos_feat = torch.cat([r_pos[:, :, 0], r_ori[:, :, 0, None]], dim=-1)
        r_emb = r_emb + self.r_pos_emb(r_pos_feat)

        B, R, _ = r_emb.shape
        M, D = self.M, self.dim
        q = torch.cat(
            [r_emb[:, :, None].expand(B, R, M, D), self.m_emb.expand(B, R, M, D)],
            dim=-1,
        )
        q = self.q_proj(q)
        for i in range(self.depth):
            q = getattr(self, f"layer{i}")(
                q, enc_emb, r_key_padding, enc_key_padding, self.m_pos
            )
        x0 = enc_emb[:, 0][:, None, None].expand(B, R, M, D).to(q.dtype)
        q = self.cat_x_proj(torch.cat([q, x0], dim=-1))

        T = self.T
        traj = torch.cat(
            [
                self.loc_head(q).reshape(B, R, M, T, 2),
                self.yaw_head(q).reshape(B, R, M, T, 2),
                self.vel_head(q).reshape(B, R, M, T, 2),
            ],
            dim=-1,
        )
        pi = self.pi_head(q)[..., 0]
        return traj.float(), pi.float()


class PlutoModel(nn.Module):
    """The full planner. `dtype` is the compute type (bf16 by default);
    params and outputs stay f32. `value_head` adds the critic MLP on the
    centre-agent token (ppo_pluto's). The model is built on `device` (CUDA
    unless the caller names another) from the global torch seed."""

    def __init__(
        self,
        dim: int = 128,
        state_channel: int = 6,
        history_steps: int = 21,
        future_steps: int = 80,
        encoder_depth: int = 4,
        decoder_depth: int = 4,
        num_heads: int = 4,
        num_modes: int = 12,
        use_hidden_proj: bool = True,
        ref_free_traj: bool = True,
        value_head: bool = False,
        dtype: torch.dtype | None = torch.bfloat16,
        points_norm: str = "ln",
        device=None,
    ):
        super().__init__()
        self.dim, self.history_steps, self.future_steps = dim, history_steps, future_steps
        self.encoder_depth = encoder_depth
        self.use_hidden_proj, self.ref_free_traj = use_hidden_proj, ref_free_traj
        self.AgentEncoder_0 = AgentEncoder(dim, state_channel, history_steps, dtype)
        self.MapEncoder_0 = MapEncoder(dim, dtype, points_norm)
        self.StaticObjectsEncoder_0 = StaticObjectsEncoder(dim, dtype)
        self.pos_emb = FourierEmbedding(3, dim, 64, dtype)
        for i in range(encoder_depth):
            setattr(self, f"enc{i}", TransformerEncoderLayer(dim, num_heads, dtype=dtype))
        self.enc_norm = LayerNorm(dim, dtype)
        self.agent_predictor = AgentPredictor(dim, future_steps, dtype)
        self.planning_decoder = PlanningDecoder(
            num_modes, decoder_depth, dim, num_heads, 4, future_steps, dtype,
            points_norm,
        )
        if use_hidden_proj:
            self.hidden_proj_fc1 = Dense(dim, dim, dtype)
            self.hidden_proj_fc2 = Dense(dim, dim, dtype)
        if ref_free_traj:
            self.ref_free_decoder = MLPLayer(dim, 2 * dim, future_steps * 4, dtype)
        self.has_value_head = value_head
        if value_head:
            self.value_head = MLPLayer(dim, dim, 1, dtype)
        self.to(resolve_device(device))

    def forward(self, data: Dict[str, Any]):
        if "map_tokens_only" in data:
            return self.MapEncoder_0(data)
        agent = data["agent"]
        if "cur_pos" in agent:  # canonical tokens
            agent_pos, agent_heading = agent["cur_pos"], agent["cur_heading"]
        else:
            agent_pos = agent["position"][:, :, self.history_steps - 1]
            agent_heading = agent["heading"][:, :, self.history_steps - 1]
        agent_mask = agent["valid_mask"][:, :, : self.history_steps]
        polygon_center = data["map"]["polygon_center"]
        polygon_mask = data["map"]["valid_mask"]
        B, A = agent_pos.shape[:2]

        position = torch.cat([agent_pos, polygon_center[..., :2]], dim=1)
        angle = torch.cat([agent_heading, polygon_center[..., 2]], dim=1)
        pos = torch.cat([position, _wrap(angle)[..., None]], dim=-1)

        x_agent = self.AgentEncoder_0(data)
        x_polygon = self.MapEncoder_0(data)
        x_static, static_pos, static_key_padding = self.StaticObjectsEncoder_0(data)

        x = torch.cat([x_agent, x_polygon, x_static], dim=1)
        pos = torch.cat([pos, static_pos], dim=1)
        key_padding_mask = torch.cat(
            [~agent_mask.any(-1), ~polygon_mask.any(-1), static_key_padding], dim=-1
        )
        x = x + self.pos_emb(pos)
        for i in range(self.encoder_depth):
            x = getattr(self, f"enc{i}")(x, key_padding_mask=key_padding_mask)
        x = self.enc_norm(x)

        no_aux = "no_aux" in data
        if not no_aux:
            prediction = self.agent_predictor(x[:, 1:A]).float()

        trajectory, probability = self.planning_decoder(data, x, key_padding_mask)
        out = {"trajectory": trajectory, "probability": probability}
        if not no_aux:
            out["prediction"] = prediction
        if self.has_value_head:
            out["value"] = self.value_head(x[:, 0])[..., 0].float()
        if self.use_hidden_proj:
            h = torch.relu(self.hidden_proj_fc1(x[:, 0]))
            out["hidden"] = self.hidden_proj_fc2(h).float()
        if self.ref_free_traj:
            rf = self.ref_free_decoder(x[:, 0]).reshape(B, self.future_steps, 4).float()
            out["ref_free_trajectory"] = rf
            out["output_ref_free_trajectory"] = torch.cat(
                [rf[..., :2], torch.atan2(rf[..., 3], rf[..., 2])[..., None]], dim=-1
            )
        if not no_aux:
            out["output_prediction"] = torch.cat(
                [
                    prediction[..., :2] + agent_pos[:, 1:A, None],
                    (
                        torch.atan2(prediction[..., 3], prediction[..., 2])
                        + agent_heading[:, 1:A, None]
                    )[..., None],
                    prediction[..., 4:6],
                ],
                dim=-1,
            )

        # mask invalid reference lines, emit the best trajectory
        r_padding = ~data["reference_line"]["valid_mask"].any(-1)
        probability = torch.where(r_padding[:, :, None], -1e6, probability)
        out["probability"] = probability
        angle = torch.atan2(trajectory[..., 3], trajectory[..., 2])
        out_traj = torch.cat([trajectory[..., :2], angle[..., None]], dim=-1)
        R, M = out_traj.shape[1:3]
        # first index among equal maxima (invalid lines all sit at -1e6)
        best = torch.sort(
            probability.reshape(B, R * M), dim=-1, descending=True, stable=True
        ).indices[:, 0]
        out["output_trajectory"] = out_traj.reshape(B, R * M, self.future_steps, 3)[
            torch.arange(B, device=best.device), best
        ]
        out["candidate_trajectories"] = out_traj
        return out
