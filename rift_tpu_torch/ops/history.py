"""The HistoryEncoder's two TPU kernels (port of rift_tpu/ops/history.py):
one level fused, two LocalBlocks (`local_stage_pallas`, body
`_stage_kernel`), and the whole encoder fused (`history_encoder_pallas`,
body `_history_kernel`).

`local_stage` runs the hand-written CUDA kernel `csrc/history_stage.cu` on
CUDA tensors and its plain PyTorch version `local_stage_ref` on CPU
tensors; `history_encoder` likewise runs `csrc/history_encoder.cu` or
`history_encoder_ref`. There is no fallback from one to the other. The
HistoryEncoder (models/pluto/layers.py) takes the whole-encoder kernel
for every forward that no gradient flows through (the act steps, and the
fit of every policy that trains no encoder weight): x [S*A, 20, 9] ->
[S*A, 128], N = 1536 on the planner's main path. When a gradient has to
flow through the encoder (the full-model BC pretrain), each of its three
levels goes through the stage kernel instead: [N, 20, 32], [N, 10, 64],
[N, 5, 128].

The stage is differentiable: as for the other kernels, its backward saves
only the inputs and recomputes through the plain version, on either
device. The whole-encoder kernel is forward only.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# per-block weight names in kernel-operand order (rift_tpu/ops/history.py
# _STAGE_WNAMES); a stage takes them for block 0, then block 1
STAGE_WNAMES = (
    "ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "out_w", "out_b",
    "ln2_scale", "ln2_bias", "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b",
)
# the stage kernel's shapes (csrc/history_common.cuh): T <= MAX_T logits
# in registers, head dim HEAD_DIM, D / 4 lanes a LayerNorm row (D one of
# STAGE_WIDTHS)
MAX_T = 20
HEAD_DIM = 16
STAGE_WIDTHS = (16, 32, 64, 128)

DEPTHS = (2, 2, 2)  # LocalBlocks per level: one fused stage each
HEADS = (2, 4, 8)
WINDOWS = (3, 3, 5)
ENCODER_T, ENCODER_CIN, ENCODER_EMBED = 20, 9, 32  # the encoder kernel's shapes
# the FPN rows the last token depends on, per lateral level: lat0 rows
# 18-19 (the final conv's taps), lat1 rows 8-9, lat2 rows 3-4
LATERAL_ROWS = ((18, 19), (8, 9), (3, 4))

# kernel launches since the counters were last set to 0: `launches` of
# the stage kernel, `encoder_launches` of the whole-encoder kernel
launches = 0
encoder_launches = 0


def weight_order(embed_dim: int = 32):
    """The encoder's flat parameter names in kernel-operand order (copy of
    rift_tpu/ops/history.py:weight_order)."""
    names = ["conv0_w", "conv0_b"]
    for i in range(sum(DEPTHS)):
        names += [f"blk{i}_{nm}" for nm in STAGE_WNAMES]
    names += [f"level{lv}_ln_{k}" for lv in range(len(DEPTHS)) for k in ("scale", "bias")]
    for lv in range(len(DEPTHS) - 1):
        names += [f"down{lv}_w", f"down{lv}_b", f"down{lv}_ln_scale", f"down{lv}_ln_bias"]
    names += [f"lat{lv}_{k}" for lv in range(len(DEPTHS)) for k in ("w", "b")]
    return names + ["fpn_w", "fpn_b"]


def rpb_names():
    """The blocks' relative-position tables blk{i}_rpb [H, 2w-1]."""
    return [f"blk{i}_rpb" for i in range(sum(DEPTHS))]


@functools.lru_cache(maxsize=None)
def _band_index(n: int, window: int, device: torch.device):
    """The clamped neighborhood band (0 / -1e9) [n, n] and the relative
    offset index [n, n] into a [H, 2w-1] RPB, on `device`, made once. Made
    outside inference mode whatever the caller's mode, so that a later
    forward that autograd records (a fit that trains the encoder) may save
    them."""
    w = min(window, n)
    i = np.arange(n)
    start = np.clip(i - (w - 1) // 2, 0, n - w)
    j = np.arange(n)
    near = (j[None, :] >= start[:, None]) & (j[None, :] < start[:, None] + w)
    rel = np.clip(i[None, :] - i[:, None] + (window - 1), 0, 2 * window - 2)
    with torch.inference_mode(False):
        band = torch.from_numpy(np.where(near, 0.0, -1e9).astype(np.float32))
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


def layer_norm(x, scale, bias, dt):
    """The JAX package's hand-written LN: stats in f32, affine in dt."""
    y = F.layer_norm(x.float(), x.shape[-1:], None, None, 1e-5)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def encoder_forward(W, x, stage, dt=torch.float32):
    """The HistoryEncoder step by step over the flat param dict `W`
    (rift_tpu/models/pluto/layers.py:history_forward_jnp, eval mode, laid
    out as its stage branch, which the JAX package gates off): the conv
    tokenizer; each level's two LocalBlocks through `stage` (local_stage
    or local_stage_ref) in f32; a level LN, then a stride-2 conv and an LN
    between levels; the lateral convs, the FPN top-down fusion through
    `resize_matrix`, the final conv; the last token. The rest computes in
    `dt`: f32 for the whole-encoder kernel's plain version; the compute
    dtype on the route of the fits that train the encoder (`bc_pluto`),
    where at bf16 the f32 stages sit between bf16 convolutions, a mix that
    neither of the JAX package's paths runs (its live path,
    history_forward_jnp, computes everything in the compute dtype).
    x [N, T, C] -> [N, 4*embed]."""
    x = conv3(x, W["conv0_w"], W["conv0_b"], dt=dt)
    outs = []
    levels = len(DEPTHS)
    for lv in range(levels):
        n = x.shape[-2]
        blocks = (2 * lv, 2 * lv + 1)
        sw = [W[f"blk{b}_{nm}"] for b in blocks for nm in STAGE_WNAMES]
        b0, b1 = (band_rpb_bias(W[f"blk{b}_rpb"].float(), n, WINDOWS[lv]) for b in blocks)
        x = stage(x.float().contiguous(), sw, b0, b1, HEADS[lv]).to(dt)
        outs.append(layer_norm(x, W[f"level{lv}_ln_scale"], W[f"level{lv}_ln_bias"], dt))
        if lv < levels - 1:
            x = conv3(x, W[f"down{lv}_w"], W[f"down{lv}_b"], stride=2, dt=dt)
            x = layer_norm(x, W[f"down{lv}_ln_scale"], W[f"down{lv}_ln_bias"], dt)
    lat = [conv3(outs[lv], W[f"lat{lv}_w"], W[f"lat{lv}_b"], dt=dt) for lv in range(levels)]
    for i in range(levels - 1, 0, -1):
        R = torch.from_numpy(resize_matrix(lat[i].shape[-2], lat[i - 1].shape[-2]))
        lat[i - 1] = lat[i - 1] + torch.einsum("ts,nsc->ntc", R.to(lat[i]), lat[i])
    out = conv3(lat[0], W["fpn_w"], W["fpn_b"], dt=dt)
    return out[..., -1, :]


def history_encoder_ref(x, W):
    """Plain PyTorch version of the whole-encoder kernel, step for step, in
    f32: x [N, T, C], W the flat param dict (weight_order + rpb_names) ->
    [N, 4*embed] f32, the last token."""
    return encoder_forward({k: v.float() for k, v in W.items()}, x.float(), local_stage_ref)


def history_encoder(x, W):
    """[N, 20, 9] -> [N, 128] f32, the HistoryEncoder's last token, forward
    only: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors. Raises when a gradient would have to flow through it."""
    if torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in W.values())
    ):
        raise ValueError("history_encoder is forward only: take local_stage for gradients")
    if x.device.type == "cpu":
        return history_encoder_ref(x, W)
    if x.device.type != "cuda":
        raise ValueError(f"history_encoder: unsupported device {x.device}")
    return _encoder_forward(x, W)


def weight_shapes(D: int):
    """The shapes of one block's 12 weights at width D."""
    return (
        (D,), (D,), (D, 3 * D), (3 * D,), (D, D), (D,),
        (D,), (D,), (D, 3 * D), (3 * D,), (3 * D, D), (D,),
    )


def local_stage_ref(x, weights, bias0, bias1, num_heads):
    """Plain PyTorch version of the kernel, step for step, in f32: x
    [N, T, D], weights the 24 arrays of STAGE_WNAMES for block 0 then 1,
    bias0/bias1 [H, T, T] additive. The softmax is written out (max, exp,
    sum), as the TPU kernel's."""
    x = x.float()
    N, T, D = x.shape
    H = num_heads
    Dh = D // H
    for blk, bias in enumerate((bias0, bias1)):
        W = dict(zip(STAGE_WNAMES, (w.float() for w in weights[12 * blk:12 * blk + 12])))
        h = F.layer_norm(x, (D,), W["ln1_scale"], W["ln1_bias"], 1e-5)
        qkv = (h @ W["qkv_w"] + W["qkv_b"]).reshape(N, T, 3, H, Dh)
        q, k, v = qkv.unbind(2)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(Dh)
        logits = logits + bias.float()[None]
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        wgt = e / e.sum(-1, keepdim=True)
        o = torch.einsum("nhqk,nkhd->nqhd", wgt, v).reshape(N, T, D)
        x = x + (o @ W["out_w"] + W["out_b"])
        h = F.layer_norm(x, (D,), W["ln2_scale"], W["ln2_bias"], 1e-5)
        h = F.gelu(h @ W["mlp1_w"] + W["mlp1_b"], approximate="tanh")
        x = x + (h @ W["mlp2_w"] + W["mlp2_b"])
    return x


def local_stage(x, weights, bias0, bias1, num_heads):
    """[N, T, D] f32 through two LocalBlocks -> [N, T, D] f32. The CUDA
    kernel on CUDA tensors, the plain version on CPU tensors; gradients
    through the plain version."""
    return _LocalStage.apply(x, bias0, bias1, num_heads, *weights)


class _LocalStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias0, bias1, num_heads, *weights):
        ctx.save_for_backward(x, bias0, bias1, *weights)
        ctx.num_heads = num_heads
        return _forward(x, weights, bias0, bias1, num_heads)

    @staticmethod
    def backward(ctx, g):
        x, bias0, bias1, *weights = ctx.saved_tensors
        inputs = (x, bias0, bias1, *weights)
        need = ctx.needs_input_grad[:3] + ctx.needs_input_grad[4:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
            out = local_stage_ref(xs[0], xs[3:], xs[1], xs[2], ctx.num_heads)
            wrt = [t for t, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        dx, db0, db1, *dw = (next(grads) if n else None for n in need)
        return (dx, db0, db1, None, *dw)


def _forward(x, weights, bias0, bias1, num_heads):
    if x.device.type == "cpu":
        return local_stage_ref(x, weights, bias0, bias1, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"local_stage: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"local_stage: x {tuple(x.shape)}, [N, T, D] expected")
    N, T, D = x.shape
    H = num_heads
    if not (1 <= T <= MAX_T and D in STAGE_WIDTHS and D == HEAD_DIM * H):
        raise ValueError(
            f"local_stage: T={T}, D={D}, H={H} outside the kernel's range "
            f"(1 <= T <= {MAX_T}, D one of {STAGE_WIDTHS}, head dim D/H = {HEAD_DIM})"
        )
    if len(weights) != 24:
        raise ValueError(f"local_stage: {len(weights)} weights, 24 expected")
    for i, (w, s) in enumerate(zip(weights, weight_shapes(D) * 2)):
        if tuple(w.shape) != s:
            raise ValueError(f"local_stage: weight {i} is {tuple(w.shape)}, not {s}")
    for name, b in (("bias0", bias0), ("bias1", bias1)):
        if tuple(b.shape) != (H, T, T):
            raise ValueError(f"local_stage: {name} {tuple(b.shape)}, not {(H, T, T)}")
    tensors = [x, *weights, bias0, bias1]
    for t in tensors:
        if t.device != x.device or not t.is_contiguous() or t.dtype != torch.float32:
            raise ValueError("local_stage: inputs must be contiguous f32 on one device")
    lib = _lib()
    G = stage_chunk(T, D)
    out = torch.empty_like(x)
    params = (ctypes.c_void_p * 26)(*[t.data_ptr() for t in tensors[1:]])
    err = lib.rift_history_stage_fwd(
        x.data_ptr(), out.data_ptr(), params, N, T, D, H, G,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"history stage kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def stage_chunk(T: int, D: int) -> int:
    """Sequences per chunk of the stage kernel at [T, D]: the most whose
    rows fit the kernel's chunk (12 at each of the model's levels; fewer
    ran slower, PERF.md §6)."""
    return _lib().rift_history_stage_chunk_rows(D) // T


def encoder_shapes(embed_dim=ENCODER_EMBED, in_dim=ENCODER_CIN):
    """{name: shape} of the encoder's flat params: weight_order, then
    rpb_names."""
    dims = [embed_dim * 2 ** lv for lv in range(len(DEPTHS))]
    out_dim = dims[-1]
    shapes = {"conv0_w": (3, in_dim, embed_dim), "conv0_b": (embed_dim,)}
    for i in range(sum(DEPTHS)):
        shapes.update({f"blk{i}_{nm}": s for nm, s in zip(STAGE_WNAMES, weight_shapes(dims[i // 2]))})
    for lv, d in enumerate(dims):
        shapes[f"level{lv}_ln_scale"] = shapes[f"level{lv}_ln_bias"] = (d,)
        if lv < len(dims) - 1:
            shapes[f"down{lv}_w"] = (3, d, 2 * d)
            shapes[f"down{lv}_b"] = (2 * d,)
            shapes[f"down{lv}_ln_scale"] = shapes[f"down{lv}_ln_bias"] = (2 * d,)
        shapes[f"lat{lv}_w"] = (3, d, out_dim)
        shapes[f"lat{lv}_b"] = (out_dim,)
    shapes["fpn_w"] = (3, out_dim, out_dim)
    shapes["fpn_b"] = (out_dim,)
    for i in range(sum(DEPTHS)):
        shapes[f"blk{i}_rpb"] = (HEADS[i // 2], 2 * WINDOWS[i // 2] - 1)
    return shapes


@functools.lru_cache(maxsize=None)
def fpn_weights() -> tuple:
    """The 8 resize weights the kept FPN rows read (up[lv][i][s]: lateral
    lv's kept row i from lateral lv+1's kept row s), after checking that
    those rows read no other row."""
    lens = [ENCODER_T >> lv for lv in range(len(DEPTHS))]
    up = []
    for lv in range(len(DEPTHS) - 1):
        R = resize_matrix(lens[lv + 1], lens[lv])
        rows, cols = LATERAL_ROWS[lv], LATERAL_ROWS[lv + 1]
        if np.count_nonzero(np.delete(R[list(rows)], cols, axis=1)):
            raise AssertionError("FPN rows read beyond the kept lateral rows")
        up += R[np.ix_(rows, cols)].ravel().tolist()
    return tuple(up)


def _encoder_forward(x, W):
    if x.dim() != 3 or tuple(x.shape[1:]) != (ENCODER_T, ENCODER_CIN):
        raise ValueError(f"history_encoder: x {tuple(x.shape)}, [N, {ENCODER_T}, "
                         f"{ENCODER_CIN}] expected")
    names = weight_order(ENCODER_EMBED) + rpb_names()
    shapes = encoder_shapes()
    if set(W) != set(names):
        raise ValueError(f"history_encoder: params {sorted(set(W) ^ set(names))} differ")
    x = x.float().contiguous()
    for n in names:
        w = W[n]
        if tuple(w.shape) != shapes[n]:
            raise ValueError(f"history_encoder: {n} is {tuple(w.shape)}, not {shapes[n]}")
        if w.device != x.device or not w.is_contiguous() or w.dtype != torch.float32:
            raise ValueError("history_encoder: weights must be contiguous f32 on x's device")
    lib = _lib_encoder()
    N = x.shape[0]
    out = torch.empty((N, ENCODER_EMBED * 2 ** (len(DEPTHS) - 1)), device=x.device)
    params = (ctypes.c_void_p * len(names))(*[W[n].data_ptr() for n in names])
    up = (ctypes.c_float * 8)(*fpn_weights())
    err = lib.rift_history_encoder_fwd(
        x.data_ptr(), out.data_ptr(), params, up, N,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"history encoder kernel launch failed: CUDA error {err}")
    global encoder_launches
    encoder_launches += 1
    return out


def _lib_encoder():
    from .build import load

    lib = load("history_encoder")
    fn = lib.rift_history_encoder_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, ctypes.POINTER(ctypes.c_float), I, P]
        fn.restype = ctypes.c_int
    return lib


def _lib():
    from .build import load

    lib = load("history_stage")
    fn = lib.rift_history_stage_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        lib.rift_history_stage_chunk_rows.argtypes = [I]
        lib.rift_history_stage_chunk_rows.restype = I
    return lib
