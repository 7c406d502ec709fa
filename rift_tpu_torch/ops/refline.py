"""Candidate-vs-reference-line matrices of the GRPO evaluator (port of
rift_tpu/ops/refline.py).

`refline_matrices` runs the hand-written CUDA kernel (`csrc/refline.cu`,
the port of the TPU kernel `refline_matrices_pallas`) on CUDA tensors and
its plain PyTorch version `refline_matrices_ref` on CPU tensors; there is
no fallback from one to the other. The plain version is the JAX package's
`ref_line_matrices` (rl/evaluator.py:329) over a leading batch of
(CBV, reference line) pairs, with its |c|^2 + |r|^2 - 2 c.r distance
expansion; the kernel takes direct differences, so a point almost equally
far from two line points may pick the other one.
"""

from __future__ import annotations

import ctypes

import torch

from ..geometry.se2 import wrap_angle

# kernel launches since the counter was last set to 0
launches = 0


def refline_matrices_ref(cand_pos, cand_heading, ref_pos, ref_heading, ref_valid,
                         return_index: bool = False):
    """Plain PyTorch version: cand_pos [BR, MT, 2], cand_heading [BR, MT],
    ref_pos [BR, Nr, 2], ref_heading [BR, Nr], ref_valid [BR, Nr] bool ->
    (signed lateral offset, wrapped heading error) each [BR, MT], and the
    nearest ref point's index with `return_index`."""
    cross2 = torch.einsum("bmx,bnx->bmn", cand_pos, ref_pos)
    d2 = (
        (cand_pos * cand_pos).sum(-1)[..., None]
        + (ref_pos * ref_pos).sum(-1)[:, None]
        - 2.0 * cross2
    )
    d2 = torch.where(ref_valid[:, None], d2, torch.inf)
    idx = torch.argmin(d2, dim=-1)  # first index among equal minima
    closest_angle = torch.gather(ref_heading, 1, idx)
    closest_pos = torch.gather(ref_pos, 1, idx[..., None].expand(idx.shape + (2,)))
    delta_angle = wrap_angle(cand_heading - closest_angle)
    rel = cand_pos - closest_pos
    cross = rel[..., 0] * torch.sin(closest_angle) - rel[..., 1] * torch.cos(closest_angle)
    if return_index:
        return -cross, delta_angle, idx
    return -cross, delta_angle


def refline_matrices(cand_pos, cand_heading, ref_pos, ref_heading, ref_valid,
                     return_index: bool = False):
    """[BR, MT, 2], [BR, MT], [BR, Nr, 2], [BR, Nr], [BR, Nr] bool ->
    (delta_dis, delta_angle) [BR, MT] (and the index [BR, MT] with
    `return_index`). The CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if cand_pos.device.type == "cpu":
        return refline_matrices_ref(
            cand_pos, cand_heading, ref_pos, ref_heading, ref_valid, return_index
        )
    if cand_pos.device.type != "cuda":
        raise ValueError(f"refline_matrices: unsupported device {cand_pos.device}")
    BR, MT = cand_heading.shape
    Nr = ref_heading.shape[1]
    shapes = {
        "cand_pos": (cand_pos, (BR, MT, 2)), "ref_pos": (ref_pos, (BR, Nr, 2)),
        "ref_heading": (ref_heading, (BR, Nr)), "ref_valid": (ref_valid, (BR, Nr)),
    }
    for name, (t, s) in shapes.items():
        if tuple(t.shape) != s:
            raise ValueError(f"refline_matrices: {name} {tuple(t.shape)}, expected {s}")
    for t in (cand_pos, cand_heading, ref_pos, ref_heading, ref_valid):
        if t.device != cand_pos.device or not t.is_contiguous():
            raise ValueError("refline_matrices: inputs must be contiguous on one device")
        if t is not ref_valid and t.dtype != torch.float32:
            raise TypeError(f"refline_matrices: {t.dtype} input, f32 expected")
    if ref_valid.dtype != torch.bool:
        raise TypeError(f"refline_matrices: ref_valid {ref_valid.dtype}, bool expected")
    dev = cand_pos.device
    dis = torch.empty((BR, MT), dtype=torch.float32, device=dev)
    ang = torch.empty((BR, MT), dtype=torch.float32, device=dev)
    idx = torch.empty((BR, MT), dtype=torch.int32, device=dev) if return_index else None
    err = _lib().rift_refline_fwd(
        cand_pos.data_ptr(), cand_heading.data_ptr(), ref_pos.data_ptr(),
        ref_heading.data_ptr(), ref_valid.data_ptr(), dis.data_ptr(),
        ang.data_ptr(), None if idx is None else idx.data_ptr(), BR, MT, Nr,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"refline kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return (dis, ang, idx.long()) if return_index else (dis, ang)


def _lib():
    from .build import load

    lib = load("refline")
    fn = lib.rift_refline_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I, I, I, P]
        fn.restype = ctypes.c_int
    return lib
