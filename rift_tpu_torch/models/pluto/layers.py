"""Building blocks of the Pluto planner (port of
rift_tpu/models/pluto/layers.py).

Submodules carry the flax module names (`Dense_0`, `LayerNorm_1`, `q`,
`out`, ...) so that `utils.params_io.load_jax_params` maps a flax param
path straight onto a torch attribute path. Params stay float32; each block
computes in its `dtype` (bf16 on the planner's main path), with layer norms
and softmax in f32, as the JAX package does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import NEG_INF, fused_attention
from ...ops.history import encoder_forward, encoder_shapes, history_encoder, local_stage
from ...ops.points import points_encoder


def _lecun(*shape, fan_in):
    return nn.Parameter(torch.randn(*shape) / math.sqrt(fan_in))


class Dense(nn.Linear):
    """flax nn.Dense: computes in `dtype` (f32 when None)."""

    def __init__(self, in_dim, out_dim, dtype=None):
        super().__init__(in_dim, out_dim)
        self.dt = dtype or torch.float32
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_dim))
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dt
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm (eps 1e-5, as the planner sets it; flax's own
    default, which PlanT keeps, is 1e-6): computed in f32, output in
    `dtype`."""

    def __init__(self, dim, dtype=None, eps=1e-5):
        super().__init__(dim, eps=eps)
        self.dt = dtype or torch.float32

    def forward(self, x):
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )
        return y.to(self.dt)


class Embed(nn.Embedding):
    """flax nn.Embed: lookup cast to `dtype`."""

    def __init__(self, num, dim, dtype=None):
        super().__init__(num, dim)
        self.dt = dtype or torch.float32

    def forward(self, idx):
        return super().forward(idx.long()).to(self.dt)


class MLPLayer(nn.Module):
    """Linear -> LayerNorm -> ReLU -> Linear."""

    def __init__(self, in_dim, hidden, out, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden, dtype)
        self.LayerNorm_0 = LayerNorm(hidden, dtype)
        self.Dense_1 = Dense(hidden, out, dtype)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.LayerNorm_0(self.Dense_0(x))))


class FourierEmbedding(nn.Module):
    """Learned Fourier features per input channel, summed; per-channel MLPs
    as channel-stacked einsums."""

    def __init__(self, channels, dim, num_freq_bands=64, dtype=None):
        super().__init__()
        C, Fq, D = channels, num_freq_bands, dim
        self.dt = dtype or torch.float32
        self.freqs = nn.Parameter(torch.randn(C, Fq))
        self.w1 = _lecun(C, 2 * Fq + 1, D, fan_in=2 * Fq + 1)
        self.b1 = nn.Parameter(torch.zeros(C, D))
        self.ln_scale = nn.Parameter(torch.ones(C, D))
        self.ln_bias = nn.Parameter(torch.zeros(C, D))
        self.w2 = _lecun(C, D, D, fan_in=D)
        self.b2 = nn.Parameter(torch.zeros(C, D))
        self.out_ln = LayerNorm(D, dtype)
        self.out_fc = Dense(D, D, dtype)

    def forward(self, x):
        dt = self.dt
        phased = x[..., None] * self.freqs * 2 * math.pi
        feats = torch.cat(
            [torch.cos(phased), torch.sin(phased), x[..., None]], dim=-1
        ).to(dt)
        h = torch.einsum("...cf,cfd->...cd", feats, self.w1.to(dt)) + self.b1.to(dt)
        h = F.layer_norm(h.float(), h.shape[-1:], None, None, 1e-5).to(dt)
        h = h * self.ln_scale.to(dt) + self.ln_bias.to(dt)
        h = torch.relu(h)
        out = torch.einsum("...cd,cde->...e", h, self.w2.to(dt)) + self.b2.sum(0).to(dt)
        return self.out_fc(torch.relu(self.out_ln(out)))


class _Lin(nn.Module):
    """Dense params in flax layout (kernel [in, out]), read by the kernel."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.kernel = _lecun(in_dim, out_dim, fan_in=in_dim)
        self.bias = nn.Parameter(torch.zeros(out_dim))


class _LNP(nn.Module):
    """LayerNorm params in flax layout (scale, bias)."""

    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class PointsEncoder(nn.Module):
    """Masked PointNet over (..., P, C) points, through ops/points.py (the
    CUDA kernel on the card). norm="none" is the BN-folded variant."""

    def __init__(self, in_dim, out_dim, dtype=None, norm="ln"):
        super().__init__()
        self.out_dim = out_dim
        self.dt = dtype
        self.has_ln = norm == "ln"
        self.Dense_0 = _Lin(in_dim, 128)
        self.Dense_1 = _Lin(128, 256)
        self.Dense_2 = _Lin(512, 256)
        self.Dense_3 = _Lin(256, out_dim)
        if self.has_ln:
            self.LayerNorm_0 = _LNP(128)
            self.LayerNorm_1 = _LNP(256)

    def weights(self):
        if self.has_ln:
            ln1 = (self.LayerNorm_0.scale, self.LayerNorm_0.bias)
            ln2 = (self.LayerNorm_1.scale, self.LayerNorm_1.bias)
        else:
            dev = self.Dense_0.kernel.device
            ln1 = (torch.ones(128, device=dev), torch.zeros(128, device=dev))
            ln2 = (torch.ones(256, device=dev), torch.zeros(256, device=dev))
        return (
            self.Dense_0.kernel, self.Dense_0.bias, *ln1,
            self.Dense_1.kernel, self.Dense_1.bias,
            self.Dense_2.kernel, self.Dense_2.bias, *ln2,
            self.Dense_3.kernel, self.Dense_3.bias,
        )

    def forward(self, x, mask):
        batch = x.shape[:-2]
        out = points_encoder(
            x.reshape((-1,) + x.shape[-2:]).float().contiguous(),
            mask.reshape((-1,) + mask.shape[-1:]).contiguous(),
            self.weights(), self.out_dim, has_ln=self.has_ln,
        )
        return out.reshape(batch + (self.out_dim,)).to(self.dt or x.dtype)


class Attention(nn.Module):
    """Multi-head attention with optional key-padding and additive bias;
    the core runs through ops/attention.py (the CUDA kernel on the card).

    `merge` picks how projections sharing an input are fused into one
    matmul: "qkv" (self-attention, the default when k and v are omitted),
    "qk" (q and k share an input, v differs) or "none". The JAX package
    infers it from object identity (`q is k`); here the caller says so."""

    def __init__(self, dim, num_heads, dtype=None, rel_pos_window=0):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dt = dtype or torch.float32
        self.q = Dense(dim, dim, dtype)
        self.k = Dense(dim, dim, dtype)
        self.v = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)
        self.window = rel_pos_window
        if rel_pos_window > 0:
            self.rpb = nn.Parameter(torch.zeros(num_heads, 2 * rel_pos_window - 1))

    def forward(self, q, k=None, v=None, key_padding_mask=None,
                attn_bias=None, merge=None):
        if merge is None:
            merge = "qkv" if k is None and v is None else "none"
        k = q if k is None else k
        v = k if v is None else v
        H, D, dt = self.num_heads, self.dim, self.dt
        Tq, Tk = q.shape[-2], k.shape[-2]
        lead = q.shape[:-2]

        def fused(x, mods):
            w = torch.cat([m.weight for m in mods], 0).to(dt)
            b = torch.cat([m.bias for m in mods], 0).to(dt)
            return F.linear(x.to(dt), w, b)

        if merge == "qkv":
            qkv = fused(q, (self.q, self.k, self.v))
            qp, kp, vp = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        elif merge == "qk":
            qk = fused(q, (self.q, self.k))
            qp, kp = qk[..., :D], qk[..., D:]
            vp = self.v(v)
        else:
            qp, kp, vp = self.q(q), self.k(k), self.v(v)

        dev = qp.device
        bias = torch.zeros((H, Tq, Tk), dtype=torch.float32, device=dev)
        if self.window > 0:
            w = self.window
            i = torch.arange(Tq, device=dev)
            rel = torch.clamp(i[None, :] - i[:, None] + (w - 1), 0, 2 * w - 2)
            bias = bias + self.rpb[:, rel]
        if attn_bias is not None:
            bias = bias + attn_bias.float().expand(H, Tq, Tk)
        if key_padding_mask is not None:
            kpad = torch.where(key_padding_mask, NEG_INF, 0.0).float()
            kpad = kpad.expand(lead + (Tk,))
        else:
            kpad = torch.zeros(lead + (Tk,), dtype=torch.float32, device=dev)

        B = math.prod(lead)
        out = fused_attention(
            qp.reshape(B, Tq, D), kp.reshape(B, Tk, D), vp.reshape(B, Tk, D),
            bias.contiguous(), kpad.reshape(B, Tk).contiguous(), H,
        )
        return self.out(out.reshape(lead + (Tq, D)))


class TransformerEncoderLayer(nn.Module):
    """Pre-LN encoder block (attention, then a GELU MLP); `eps` of its
    layer norms."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, dtype=None, eps=1e-5):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype, eps)
        self.Attention_0 = Attention(dim, num_heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype, eps)
        self.Dense_0 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.Dense_1 = Dense(int(dim * mlp_ratio), dim, dtype)

    def forward(self, x, key_padding_mask=None):
        h = self.Attention_0(self.LayerNorm_0(x), key_padding_mask=key_padding_mask)
        x = x + h
        h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh"))
        return x + h


# ---------------------------------------------------------------- history
def history_forward(W, x, dtype=None):
    """HistoryEncoder forward over the flat param dict `W` (port of
    rift_tpu/models/pluto/layers.py:history_forward_jnp, eval mode), x
    [N, 20, 9] -> [N, 128] in `dtype`.

    The JAX package's live path is `history_forward_jnp` in the compute
    dtype: bf16 convolutions and matmuls with LayerNorm statistics in f32
    (its whole-encoder kernel route is off, layers.py:651, and its stage
    branch is gated off, layers.py:461-470). The port deliberately runs
    the encoder in f32 whatever `dtype` and rounds the result once: at
    bf16 that is JAX's f32 encoder within one bf16 rounding, and a bf16
    encoder would come no closer to JAX's bf16 one, since bf16
    intermediates rounded in another order scatter as far (the gaps are
    measured in tests/test_torch_history_encoder.py); f32 also keeps one
    arithmetic for the kernels and their plain versions. When no gradient
    has to flow through it (grad mode off, or neither x nor any weight
    requires grad), the whole encoder runs in one launch of
    ops/history.py:history_encoder (the CUDA kernel on the card) in f32.
    Otherwise (the fits that train the encoder, `bc_pluto`) each level's
    two LocalBlocks go through the differentiable fused stage
    (ops/history.py:local_stage) in f32 and the convolutions, norms and
    FPN compute in `dtype`: at bf16 a mix that neither JAX path runs."""
    dt = dtype or torch.float32
    if torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in W.values())
    ):
        return encoder_forward(W, x, local_stage, dt)
    return history_encoder(x, W).to(dt)


class HistoryEncoder(nn.Module):
    """Temporal encoder for per-agent history vectors. Params are the JAX
    package's flat names (rift_tpu/ops/history.py:weight_order plus
    blk{i}_rpb), registered directly on the module."""

    def __init__(self, in_dim=9, embed_dim=32, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.dtype = dtype
        shapes = encoder_shapes(embed_dim, in_dim)
        for name, s in shapes.items():
            if name.endswith(("_b", "_bias")) or "rpb" in name:
                p = torch.zeros(s)
            elif name.endswith("_scale"):
                p = torch.ones(s)
            else:
                p = torch.randn(s) / math.sqrt(math.prod(s[:-1]))
            self.register_parameter(name, nn.Parameter(p))

    def forward(self, x):
        W = dict(self.named_parameters())
        return history_forward(W, x, self.dtype)


class StateAttentionEncoder(nn.Module):
    """Ego current-state encoder: per-channel tokens pooled by attention
    from a learned query (eval mode: no channel dropout)."""

    def __init__(self, state_channel, dim, dtype=None):
        super().__init__()
        C = state_channel
        self.dt = dtype or torch.float32
        self.proj_w = nn.Parameter(torch.randn(C, 1, dim))
        self.proj_b = nn.Parameter(torch.zeros(C, dim))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, C, dim))
        self.query = nn.Parameter(0.02 * torch.randn(1, 1, dim))
        self.Attention_0 = Attention(dim, 4, dtype)

    def forward(self, x):
        dt = self.dt
        h = x[..., None].to(dt) * self.proj_w[:, 0].to(dt) + self.proj_b.to(dt)
        h = h + self.pos_embed
        q = self.query.expand(h.shape[:-2] + (1, h.shape[-1]))
        return self.Attention_0(q, h, h)[..., 0, :]
