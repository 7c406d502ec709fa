"""PlanT object-token ego planner (port of rift_tpu/models/plant/model.py).

Object tokens (vehicles and route segments, 6 attributes each) go through a
pre-LN transformer encoder whose attention runs through the planner's
`Attention` (ops/attention.py: the CUDA kernel on the card); a CLS token
feeds a GRU that decodes waypoints one step at a time, conditioned on the
target point and a traffic-light flag; optional forecast heads classify
discretised attributes. The CLS token's similarity to every token after the
encoder (`attn_scores`) drives the attention CBV recognizer.

Submodules carry the flax names (`tok_emb`, `layer3`, `wp_decoder/hn`, ...)
so that `utils.params_io.load_jax_params` loads a JAX PlanT npz strictly.
Everything computes in f32, as the JAX package does; its layer norms keep
flax's default epsilon, 1e-6.

"PlanT_medium": dim 512, 8 layers, 8 heads (head dim 64).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..pluto.layers import Dense, Embed, LayerNorm, TransformerEncoderLayer

NUM_ATTRIBUTES = 6  # x, y, yaw, speed-or-id, extent_x, extent_y
TYPE_PAD, TYPE_VEHICLE, TYPE_ROUTE = 0, 1, 2
LIDAR_OFFSET_X = 1.3  # vehicle -> lidar frame shift used by the reference
LN_EPS = 1e-6  # flax nn.LayerNorm's default
WP_HIDDEN = 65  # the GRU's state: wp_head's 64 features and the light flag


class GRUCell(nn.Module):
    """flax nn.GRUCell as plain ops under its parameter names: input
    projections `ir`, `iz`, `in` with biases, recurrent `hr`, `hz` without
    and `hn` with one (torch.nn.GRUCell lays its biases out otherwise).

        r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h))
        n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n + z * h
    """

    def __init__(self, in_dim, features):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(in_dim, features))
        self.hr = nn.Linear(features, features, bias=False)
        self.hz = nn.Linear(features, features, bias=False)
        self.hn = Dense(features, features)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class PlanTModel(nn.Module):
    def __init__(self, dim=512, num_layers=8, num_heads=8, pred_len=4,
                 forecast_heads=False, attribute_vocab=16, device=None):
        super().__init__()
        self.dim, self.num_layers, self.pred_len = dim, num_layers, pred_len
        self.forecast_heads = forecast_heads
        self.tok_emb = Dense(NUM_ATTRIBUTES, dim)
        self.type_emb = Embed(3, dim)
        self.cls_emb = nn.Parameter(0.02 * torch.randn(1, 1, dim))
        for i in range(num_layers):
            setattr(self, f"layer{i}", TransformerEncoderLayer(dim, num_heads, eps=LN_EPS))
        self.final_norm = LayerNorm(dim, eps=LN_EPS)
        self.wp_head = Dense(dim, WP_HIDDEN - 1)
        self.wp_decoder = GRUCell(4, WP_HIDDEN)
        self.wp_output = Dense(WP_HIDDEN, 2)
        if forecast_heads:
            for i in range(NUM_ATTRIBUTES):
                setattr(self, f"forecast_head{i}", Dense(dim, attribute_vocab))
        if device is not None:
            self.to(device)

    def forward(self, tokens, target_point, light_hazard):
        """tokens [B, O, 1 + NUM_ATTRIBUTES] (type, attributes), target_point
        [B, 2], light_hazard [B, 1] -> {pred_wp [B, pred_len, 2],
        attn_scores [B, O] (-1e9 on pad tokens), cls [B, dim] and, with
        forecast heads, forecast_logits [B, O, NUM_ATTRIBUTES, vocab]}."""
        B = tokens.shape[0]
        token_type = tokens[..., 0].to(torch.int32)
        emb = self.tok_emb(tokens[..., 1:]) + self.type_emb(torch.clamp(token_type, 0, 2))
        x = torch.cat([self.cls_emb.expand(B, 1, self.dim), emb], dim=1)
        pad = torch.cat([torch.zeros_like(token_type[:, :1], dtype=torch.bool),
                         token_type == TYPE_PAD], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, key_padding_mask=pad)
        x = self.final_norm(x)

        # the recognizer's CLS-attention proxy: each token's similarity to
        # the CLS embedding after the encoder
        cls_vec = x[:, 0]
        attn_scores = torch.einsum("bd,bod->bo", cls_vec, x[:, 1:]) / math.sqrt(self.dim)
        attn_scores = torch.where(token_type == TYPE_PAD, -1e9, attn_scores)

        # the waypoint GRU
        z = torch.cat([self.wp_head(cls_vec), light_hazard.float()], dim=-1)
        wp = torch.zeros((B, 2), device=tokens.device)
        outputs = []
        for _ in range(self.pred_len):
            z = self.wp_decoder(z, torch.cat([wp, target_point], dim=-1))
            wp = wp + self.wp_output(z)
            outputs.append(wp)
        pred_wp = torch.stack(outputs, dim=1)
        pred_wp = torch.cat([pred_wp[..., :1] - LIDAR_OFFSET_X, pred_wp[..., 1:]], dim=-1)

        out = {"pred_wp": pred_wp, "attn_scores": attn_scores, "cls": cls_vec}
        if self.forecast_heads:
            out["forecast_logits"] = torch.stack(
                [getattr(self, f"forecast_head{i}")(x[:, 1:]) for i in range(NUM_ATTRIBUTES)],
                dim=-2,
            )
        return out


@torch.no_grad()
def init_plant_weights(model: PlanTModel, gen: torch.Generator) -> PlanTModel:
    """Fresh weights drawn from `gen` (a CPU generator, so a seed gives the
    same weights on every device), at flax's default scales: projections
    and embeddings normal with std 1/sqrt(fan in), the CLS embedding with
    std 0.02, biases 0 and layer norms 1 and 0."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "cls_emb":
            scale = 0.02
        elif leaf == "weight" and p.dim() == 2:
            scale = 1.0 / math.sqrt(p.shape[1])  # Linear [out, in]; Embedding [n, dim]
        else:
            p.fill_(1.0 if leaf == "weight" else 0.0)  # biases, layer norms
            continue
        p.copy_(scale * torch.randn(p.shape, generator=gen))
    return model
