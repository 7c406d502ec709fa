"""One HistoryEncoder level fused: two LocalBlocks (port of
rift_tpu/ops/history.py: `local_stage_pallas` and its body `_stage_kernel`).

`local_stage` runs the hand-written CUDA kernel (`csrc/history_stage.cu`)
on CUDA tensors and its plain PyTorch version `local_stage_ref` on CPU
tensors; there is no fallback from one to the other. The HistoryEncoder
(models/pluto/layers.py) sends each of its three depth-2 levels through it:
[S*A, T, D] = [1536, 20, 32], [1536, 10, 64] and [1536, 5, 128] on the
planner's main path, and the batch's history rows in a fine-tune step.

It is differentiable: as for the other kernels, the backward saves only the
inputs and recomputes through the plain version, on either device.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

# per-block weight names in kernel-operand order (rift_tpu/ops/history.py
# _STAGE_WNAMES); a stage takes them for block 0, then block 1
STAGE_WNAMES = (
    "ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "out_w", "out_b",
    "ln2_scale", "ln2_bias", "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b",
)
SEQS_PER_BLOCK = 4  # sequences one CUDA block holds in shared memory
MAX_T = 20
ROWS_PER_THREAD = 5  # the kernel's product tile: T must be a multiple
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use

# kernel launches since the counter was last set to 0
launches = 0


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
    if not (1 <= T <= MAX_T and T % ROWS_PER_THREAD == 0) or D % 32 or D % H:
        raise ValueError(
            f"local_stage: T={T}, D={D}, H={H} outside the kernel's range "
            f"(T <= {MAX_T} and a multiple of {ROWS_PER_THREAD}, D a multiple "
            f"of 32 and of H)"
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
    G = SEQS_PER_BLOCK
    smem = lib.rift_history_stage_smem_bytes(T, D, G)
    if smem > SMEM_LIMIT:
        raise ValueError(f"local_stage: T={T}, D={D} needs {smem} B of shared memory")
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


def _lib():
    from .build import load

    lib = load("history_stage")
    fn = lib.rift_history_stage_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        lib.rift_history_stage_smem_bytes.argtypes = [I, I, I]
        lib.rift_history_stage_smem_bytes.restype = ctypes.c_longlong
    return lib
