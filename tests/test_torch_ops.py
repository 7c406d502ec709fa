"""The plain PyTorch versions of the port's two kernels against rift_tpu's
Pallas kernels (interpret mode) and XLA references, on the same
numpy-seeded inputs, in f32: the attention cases here and in
test_torch_ops_attention.py, the PointNet's in test_torch_ops_points.py
and test_torch_ops_points_map.py (files of at most three tests, which the
tier-1 run's loadfile scheduler hands out after its long pole).

Tolerances: attention 1e-5 (f32 softmax over <= 97 keys, summation order
only); PointNet 2e-4, as the JAX package's own kernel test uses (a
512-deep f32 product chain with two layer norms).

The CUDA kernels themselves only run on a card: tests/test_torch_kernels.py
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ops.attention import fused_attention_pallas, fused_attention_xla
from rift_tpu.ops.points import points_encoder_pallas, points_forward_xla
from rift_tpu_torch.ops.attention import fused_attention_ref
from rift_tpu_torch.ops.points import points_forward_ref
from torch_parity import ATTN_CASES, attn_inputs, one_torch_thread, points_weights


ATTN_SPLIT = 3  # the first three cases here, the rest in test_torch_ops_attention.py


def attention_matches_jax(case):
    B, Tq, Tk, D, H = ATTN_CASES[case]
    arrs = attn_inputs(B, Tq, Tk, D, H)
    got = fused_attention_ref(*map(torch.from_numpy, arrs), H).numpy()
    assert np.isfinite(got).all()
    ref = fused_attention_xla(*map(jnp.asarray, arrs), H)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
    pallas = fused_attention_pallas(*map(jnp.asarray, arrs), H, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)


def points_matches_jax(has_ln, shape):
    N, P, C = shape
    r = np.random.default_rng(1)
    x = r.normal(0, 2.0, (N, P, C)).astype(np.float32)
    mask = r.random((N, P)) < 0.7
    mask[5] = False  # an all-masked row must come out zero
    w = points_weights(2, C, 128)
    got = points_forward_ref(
        torch.from_numpy(x), torch.from_numpy(mask),
        [torch.from_numpy(a) for a in w], has_ln,
    ).numpy()
    assert (got[5] == 0.0).all()
    jw = tuple(map(jnp.asarray, w))
    ref = points_forward_xla(jnp.asarray(x), jnp.asarray(mask), jw, has_ln)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4)
    pallas = points_encoder_pallas(
        jnp.asarray(x), jnp.asarray(mask), jw, 128, has_ln=has_ln, interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-4)



@pytest.mark.parametrize("case", sorted(ATTN_CASES)[:ATTN_SPLIT])
def test_attention_ref_matches_jax(case):
    attention_matches_jax(case)
