"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import neither jax nor rift_tpu (the card's machine has
neither), so they run there without the JAX test configuration:

    python -m pytest tests/test_torch_kernels.py -m cuda -q --noconftest

Without a CUDA device every test here skips. Tolerances: f32 attention
1e-5, summation order only; PointNet atol 2e-4 as the JAX package's own
kernel test (a 512-deep f32 product chain; without the layer norms the
outputs reach ~10^3, hence also rtol 1e-5); bf16 attention 2e-2 (the
weights are rounded to bf16 before the AV product).
"""

import numpy as np
import pytest
import torch

from rift_tpu_torch.ops.attention import fused_attention, fused_attention_ref
from rift_tpu_torch.ops.points import points_encoder, points_forward_ref
from torch_parity import ATTN_CASES, attn_inputs, points_weights


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_kernel_matches_plain(cuda_device, case, dtype):
    B, Tq, Tk, D, H = ATTN_CASES[case]
    q, k, v, bias, kpad = (
        torch.from_numpy(a).to(cuda_device) for a in attn_inputs(B, Tq, Tk, D, H)
    )
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = fused_attention(q, k, v, bias, kpad, H)
    torch.cuda.synchronize()
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        got.float(), fused_attention_ref(q, k, v, bias, kpad, H).float(),
        atol=atol, rtol=0,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("has_ln", [True, False])
def test_points_kernel_matches_plain(cuda_device, has_ln):
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.normal(0, 2.0, (300, 120, 6)).astype(np.float32))
    mask = torch.from_numpy(r.random((300, 120)) < 0.7)
    mask[5] = False
    w = [torch.from_numpy(a).to(cuda_device) for a in points_weights(2, 6, 128)]
    x, mask = x.to(cuda_device), mask.to(cuda_device)
    got = points_encoder(x, mask, w, 128, has_ln)
    torch.cuda.synchronize()
    ref = points_forward_ref(x, mask, w, has_ln)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=1e-5)
