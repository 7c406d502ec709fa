"""Fused masked PointNet (PointsEncoder) forward (port of
rift_tpu/ops/points.py).

`points_encoder` runs the hand-written CUDA kernel (`csrc/points.cu`, the
port of the TPU kernel `points_encoder_pallas`) on CUDA tensors and its
plain PyTorch version `points_forward_ref` on CPU tensors; there is no
fallback from one to the other. It encodes the per-tick reference lines
([S*C*R, 120, 6]) and the canonical map tokens once per episode
([L, 20, 10]), and the per-sample map rows of a fine-tune batch.

It is differentiable: as the JAX package's `custom_vjp`, the backward
saves only the inputs and recomputes through the plain version, on either
device; the mask gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

NEG = -1e9
# the kernel packs the valid points of whole rows into tiles of 128 points
MAX_POINTS = 128
MAX_CHANNELS = 32

# kernel launches since the counter was last set to 0
launches = 0


def points_forward_ref(x, mask, weights, has_ln: bool = True):
    """Plain PyTorch version of the kernel, step for step, in f32:
    x [..., P, C], mask [..., P] bool, weights (w1, b1, ln1s, ln1b, w2, b2,
    w3, b3, ln2s, ln2b, w4, b4) with [in, out] matrices -> [..., out]."""
    w1, b1, ln1s, ln1b, w2, b2, w3, b3, ln2s, ln2b, w4, b4 = [
        w.float() for w in weights
    ]
    x = x.float()
    m = mask[..., None]

    def ln(h, s, b):
        mu = h.mean(-1, keepdim=True)
        var = h.var(-1, keepdim=True, unbiased=False)
        return (h - mu) * torch.rsqrt(var + 1e-5) * s + b

    h = x @ w1 + b1
    if has_ln:
        h = ln(h, ln1s, ln1b)
    h = torch.relu(h)
    h = h @ w2 + b2
    h = torch.where(m, h, NEG)
    pooled = h.amax(-2, keepdim=True)
    h = h @ w3[:256] + pooled @ w3[256:] + b3
    if has_ln:
        h = ln(h, ln2s, ln2b)
    h = torch.relu(h)
    h = h @ w4 + b4
    h = torch.where(m, h, NEG)
    out = h.amax(-2)
    return torch.where(mask.any(-1)[..., None], out, 0.0)


def points_encoder(x, mask, weights, out_dim: int, has_ln: bool = True):
    """[N, P, C] masked PointNet -> [N, out_dim] f32. The CUDA kernel on
    CUDA tensors, the plain version on CPU tensors; gradients through the
    plain version."""
    return _PointsEncoder.apply(x, mask, out_dim, has_ln, *weights)


class _PointsEncoder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, out_dim, has_ln, *weights):
        ctx.save_for_backward(x, mask, *weights)
        ctx.has_ln = has_ln
        return _forward(x, mask, weights, out_dim, has_ln)

    @staticmethod
    def backward(ctx, g):
        x, mask, *weights = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], *ctx.needs_input_grad[4:])
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip((x, *weights), need)]
            out = points_forward_ref(xs[0], mask, xs[1:], ctx.has_ln)
            wrt = [t for t, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        dx, *dw = (next(grads) if n else None for n in need)
        return (dx, None, None, None, *dw)


def _forward(x, mask, weights, out_dim, has_ln):
    if x.device.type == "cpu":
        # only the rows with a valid point: a row masked whole encodes to 0
        P, C = x.shape[-2:]
        xf, mf = x.reshape(-1, P, C), mask.reshape(-1, P)
        keep = mf.any(-1).nonzero()[:, 0]
        out = torch.zeros((xf.shape[0], out_dim), dtype=torch.float32)
        if len(keep):
            out[keep] = points_forward_ref(xf[keep], mf[keep], weights, has_ln)
        return out.reshape(x.shape[:-2] + (out_dim,))
    if x.device.type != "cuda":
        raise ValueError(f"points_encoder: unsupported device {x.device}")
    if x.dim() != 3 or mask.shape != x.shape[:2] or mask.dtype != torch.bool:
        raise ValueError(f"points_encoder: x {x.shape}, mask {mask.shape} {mask.dtype}")
    N, P, C = x.shape
    shapes = (
        (C, 128), (128,), (128,), (128,), (128, 256), (256,),
        (512, 256), (256,), (256,), (256,), (256, out_dim), (out_dim,),
    )
    for i, (w, s) in enumerate(zip(weights, shapes)):
        if tuple(w.shape) != s:
            raise ValueError(f"points_encoder: weight {i} is {tuple(w.shape)}, not {s}")
    if not 1 <= out_dim <= 256:
        raise ValueError(f"points_encoder: out_dim {out_dim} > 256")
    if not (1 <= P <= MAX_POINTS and 1 <= C <= MAX_CHANNELS):
        raise ValueError(
            f"points_encoder: P={P}, C={C} outside the kernel's range "
            f"(P <= {MAX_POINTS}, C <= {MAX_CHANNELS})"
        )
    lib = _lib()
    tensors = [x, mask, *weights]
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("points_encoder: inputs must be contiguous on one device")
        if t is not mask and t.dtype != torch.float32:
            raise TypeError(f"points_encoder: {t.dtype} input, f32 expected")
    out = torch.empty((N, out_dim), dtype=torch.float32, device=x.device)
    err = lib.rift_points_fwd(
        *[t.data_ptr() for t in tensors], out.data_ptr(),
        N, P, C, out_dim, int(has_ln),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"points kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def _lib():
    from .build import load

    lib = load("points")
    if lib.rift_points_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.rift_points_fwd.argtypes = [P] * 15 + [I] * 5 + [P]
        lib.rift_points_fwd.restype = ctypes.c_int
    return lib
