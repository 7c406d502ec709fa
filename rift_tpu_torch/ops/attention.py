"""Fused multi-head attention for short sequences (port of
rift_tpu/ops/attention.py).

`fused_attention` runs the hand-written CUDA kernel
(`csrc/attention.cu`, the port of the TPU kernel `fused_attention_pallas`)
on CUDA tensors and its plain PyTorch version `fused_attention_ref` on CPU
tensors; there is no fallback from one to the other. The planner's
attentions all come through here (T = 1..97 tokens, head dim 16 or 32),
and PlanT's (19 tokens, head dim 64 for the ego, 32 for the recognizer).

It is differentiable: as the JAX package's `custom_vjp`, the backward
saves only the inputs and recomputes through the plain version
(rematerialisation), on either device.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e9
MAX_TK = 128  # keys per row the kernel stages in shared memory
MAX_HEAD_DIM = 64

# kernel launches since the counter was last set to 0
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_ref(q, k, v, bias, kpad_add, num_heads):
    """Plain PyTorch version of the kernel, step for step: q [B, Tq, D],
    k/v [B, Tk, D], bias [H, Tq, Tk] and kpad_add [B, Tk] additive f32.
    Logits and softmax in f32; the weights are rounded to the input dtype
    before the AV product, which accumulates in f32."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    Dh = D // H
    qh = q.reshape(B, Tq, H, Dh).float()
    kh = k.reshape(B, Tk, H, Dh).float()
    vh = v.reshape(B, Tk, H, Dh).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(Dh)
    logits = logits + bias[None] + kpad_add[:, None, None, :]
    w = torch.softmax(logits, dim=-1).to(q.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", w, vh).to(q.dtype)
    return out.reshape(B, Tq, D)


def _row_stride(x: torch.Tensor, name: str) -> int:
    """Row stride of a [B, T, D] tensor whose rows may be spaced out (a
    slice of a packed qkv projection), but whose features are contiguous
    and whose batch rows follow each other."""
    B, T, _ = x.shape
    if x.stride(2) != 1 or (B > 1 and x.stride(0) != T * x.stride(1)):
        raise ValueError(f"fused_attention: {name} layout {x.stride()} unsupported")
    return x.stride(1)


def fused_attention(q, k, v, bias, kpad_add, num_heads):
    """[B, Tq, D] x [B, Tk, D]^2 (+ bias [H, Tq, Tk], kpad_add [B, Tk]) ->
    [B, Tq, D] in q's dtype. The CUDA kernel on CUDA tensors, the plain
    version on CPU tensors; gradients through the plain version."""
    return _FusedAttention.apply(q, k, v, bias, kpad_add, num_heads)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, kpad_add, num_heads):
        ctx.save_for_backward(q, k, v, bias, kpad_add)
        ctx.num_heads = num_heads
        return _forward(q, k, v, bias, kpad_add, num_heads)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, need)]
            out = fused_attention_ref(*xs, ctx.num_heads)
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if n else None for n in need), None)


def _forward(q, k, v, bias, kpad_add, num_heads):
    if q.device.type == "cpu":
        return fused_attention_ref(q, k, v, bias, kpad_add, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if D % H or D // H > MAX_HEAD_DIM or not 1 <= Tk <= MAX_TK:
        raise ValueError(
            f"fused_attention: D={D}, H={H}, Tk={Tk} outside the kernel's "
            f"range (D % H == 0, D/H <= {MAX_HEAD_DIM}, Tk <= {MAX_TK})"
        )
    if k.shape != (B, Tk, D) or v.shape != (B, Tk, D):
        raise ValueError(f"fused_attention: k {k.shape}, v {v.shape}")
    if bias.shape != (H, Tq, Tk) or kpad_add.shape != (B, Tk):
        raise ValueError(f"fused_attention: bias {bias.shape}, kpad {kpad_add.shape}")
    for name, t in (("bias", bias), ("kpad_add", kpad_add)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_attention: {name} must be contiguous f32")
    for t in (k, v, bias, kpad_add):
        if t.device != q.device:
            raise ValueError("fused_attention: tensors on different devices")
    sq, sk, sv = (_row_stride(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    out = torch.empty((B, Tq, D), dtype=q.dtype, device=q.device)
    err = _lib().rift_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), kpad_add.data_ptr(), out.data_ptr(),
        B, Tq, Tk, D, H, sq, sk, sv,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def _lib():
    from .build import load

    lib = load("attention")
    fn = lib.rift_attention_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, L, L, L, P]
        fn.restype = ctypes.c_int
    return lib
