"""Building blocks of the Pluto planner (port of
rift_tpu/models/pluto/layers.py).

Submodules carry the flax module names (`Dense_0`, `LayerNorm_1`, `q`,
`out`, ...) so that `utils.params_io.load_jax_params` maps a flax param
path straight onto a torch attribute path. Params stay float32; each block
computes in its `dtype` (bf16 on the planner's main path), with layer norms
and softmax in f32, as the JAX package does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import NEG_INF, fused_attention
from ...ops.history import STAGE_WNAMES, local_stage
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
    """flax nn.LayerNorm (eps 1e-5): computed in f32, output in `dtype`."""

    def __init__(self, dim, dtype=None):
        super().__init__(dim, eps=1e-5)
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


def ln_f32(x, scale, bias, dt):
    """The JAX package's hand-written LN: stats in f32, affine in dt."""
    y = F.layer_norm(x.float(), x.shape[-1:], None, None, 1e-5)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


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
    """Pre-LN encoder block (attention, then a GELU MLP)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, dtype=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.Attention_0 = Attention(dim, num_heads, dtype)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, int(dim * mlp_ratio), dtype)
        self.Dense_1 = Dense(int(dim * mlp_ratio), dim, dtype)

    def forward(self, x, key_padding_mask=None):
        h = self.Attention_0(self.LayerNorm_0(x), key_padding_mask=key_padding_mask)
        x = x + h
        h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh"))
        return x + h


# ---------------------------------------------------------------- history
DEPTHS = (2, 2, 2)  # LocalBlocks per level: one fused stage each
HEADS = (2, 4, 8)
WINDOWS = (3, 3, 5)


def block_dims(embed_dim: int):
    """Width of each LocalBlock: embed_dim, doubled at every level."""
    return [embed_dim * 2 ** lv for lv, depth in enumerate(DEPTHS) for _ in range(depth)]


@functools.lru_cache(maxsize=None)
def _band_index(n: int, window: int, device: torch.device):
    """The clamped neighborhood band (0 / -1e9) [n, n] and the relative
    offset index [n, n] into a [H, 2w-1] RPB, on `device`, made once."""
    w = min(window, n)
    i = np.arange(n)
    start = np.clip(i - (w - 1) // 2, 0, n - w)
    j = np.arange(n)
    near = (j[None, :] >= start[:, None]) & (j[None, :] < start[:, None] + w)
    band = torch.from_numpy(np.where(near, 0.0, -1e9).astype(np.float32))
    rel = np.clip(i[None, :] - i[:, None] + (window - 1), 0, 2 * window - 2)
    return band.to(device), torch.from_numpy(rel).to(device)


def band_rpb_bias(rpb: torch.Tensor, n: int, window: int) -> torch.Tensor:
    """[H, n, n] additive bias: clamped neighborhood band (0 / -1e9) plus
    the natten relative-position bias (rift_tpu/ops/history.py)."""
    band, rel = _band_index(n, window, rpb.device)
    return band[None] + rpb[:, rel]


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] linear-resize operator: half-pixel-center triangle
    interpolation with edge clamping, jax.image.resize(method='linear')
    semantics for upscaling (copy of rift_tpu/ops/history.py)."""
    scale = src / dst
    out = np.zeros((dst, src), np.float32)
    for d in range(dst):
        pos = (d + 0.5) * scale - 0.5
        lo = int(np.floor(pos))
        w = pos - lo
        for idx, wt in ((lo, 1.0 - w), (lo + 1, w)):
            out[d, min(max(idx, 0), src - 1)] += wt
    return out


def conv3(x, w, b, stride=1, dt=torch.float32):
    """k=3 convolution over [N, T, C] with XLA "SAME" padding: total pad
    max((out-1)*stride + 3 - T, 0), the odd one at the END (so stride 2
    at even T pads (0, 1), unlike torch's padding=1). w is [3, in, out]."""
    T = x.shape[-2]
    out_len = -(-T // stride)
    total = max((out_len - 1) * stride + 3 - T, 0)
    xt = F.pad(x.to(dt).transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(xt, w.to(dt).permute(2, 1, 0), stride=stride)
    return y.transpose(1, 2) + b.to(dt)


def history_forward(W, x, embed_dim=32, num_heads=HEADS, windows=WINDOWS,
                    dtype=None):
    """HistoryEncoder forward over the flat param dict `W` (port of
    rift_tpu/models/pluto/layers.py:history_forward_jnp, eval mode, with
    its stage branch): conv tokenizer; each level's two LocalBlocks as one
    fused stage through ops/history.py (the CUDA kernel on the card), in
    f32 whatever `dtype`, as the JAX package's stage branch casts; stride-2
    downsampling, FPN fusion, last-token readout. x [N, T, C] -> [N, 4*32]."""
    dt = dtype or torch.float32
    x = conv3(x, W["conv0_w"], W["conv0_b"], dt=dt)
    outs = []
    levels = len(DEPTHS)
    for lv in range(levels):
        n = x.shape[-2]
        blocks = (2 * lv, 2 * lv + 1)
        sw = [W[f"blk{b}_{nm}"] for b in blocks for nm in STAGE_WNAMES]
        b0, b1 = (band_rpb_bias(W[f"blk{b}_rpb"].float(), n, windows[lv]) for b in blocks)
        x = local_stage(x.float().contiguous(), sw, b0, b1, num_heads[lv]).to(dt)
        outs.append(ln_f32(x, W[f"level{lv}_ln_scale"], W[f"level{lv}_ln_bias"], dt))
        if lv < levels - 1:
            x = conv3(x, W[f"down{lv}_w"], W[f"down{lv}_b"], stride=2, dt=dt)
            x = ln_f32(x, W[f"down{lv}_ln_scale"], W[f"down{lv}_ln_bias"], dt)

    lat = [
        conv3(outs[lv], W[f"lat{lv}_w"], W[f"lat{lv}_b"], dt=dt)
        for lv in range(levels)
    ]
    for i in range(len(lat) - 1, 0, -1):
        R = torch.from_numpy(resize_matrix(lat[i].shape[-2], lat[i - 1].shape[-2]))
        up = torch.einsum("ts,nsc->ntc", R.to(lat[i]), lat[i])
        lat[i - 1] = lat[i - 1] + up
    out = conv3(lat[0], W["fpn_w"], W["fpn_b"], dt=dt)
    return out[..., -1, :]


class HistoryEncoder(nn.Module):
    """Temporal encoder for per-agent history vectors. Params are the JAX
    package's flat names (rift_tpu/ops/history.py:weight_order plus
    blk{i}_rpb), registered directly on the module."""

    def __init__(self, in_dim=9, embed_dim=32, num_heads=HEADS, windows=WINDOWS,
                 dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads, self.windows, self.dtype = num_heads, windows, dtype
        dims = block_dims(embed_dim)
        levels = len(DEPTHS)
        ends = [dims[sum(DEPTHS[: lv + 1]) - 1] for lv in range(levels)]
        shapes = {"conv0_w": (3, in_dim, embed_dim), "conv0_b": (embed_dim,)}
        for i, d in enumerate(dims):
            shapes.update({
                f"blk{i}_ln1_scale": (d,), f"blk{i}_ln1_bias": (d,),
                f"blk{i}_qkv_w": (d, 3 * d), f"blk{i}_qkv_b": (3 * d,),
                f"blk{i}_out_w": (d, d), f"blk{i}_out_b": (d,),
                f"blk{i}_ln2_scale": (d,), f"blk{i}_ln2_bias": (d,),
                f"blk{i}_mlp1_w": (d, 3 * d), f"blk{i}_mlp1_b": (3 * d,),
                f"blk{i}_mlp2_w": (3 * d, d), f"blk{i}_mlp2_b": (d,),
            })
        for lv, d in enumerate(ends):
            shapes[f"level{lv}_ln_scale"] = shapes[f"level{lv}_ln_bias"] = (d,)
            if lv < levels - 1:
                shapes[f"down{lv}_w"] = (3, d, 2 * d)
                shapes[f"down{lv}_b"] = (2 * d,)
                shapes[f"down{lv}_ln_scale"] = shapes[f"down{lv}_ln_bias"] = (2 * d,)
            shapes[f"lat{lv}_w"] = (3, d, dims[-1])
            shapes[f"lat{lv}_b"] = (dims[-1],)
        shapes["fpn_w"] = (3, dims[-1], dims[-1])
        shapes["fpn_b"] = (dims[-1],)
        for i in range(len(dims)):
            lv = i // 2
            shapes[f"blk{i}_rpb"] = (num_heads[lv], 2 * windows[lv] - 1)
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
        return history_forward(
            W, x, self.embed_dim, self.num_heads, self.windows, self.dtype
        )


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
