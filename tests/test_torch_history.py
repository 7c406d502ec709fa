"""The port's HistoryEncoder stage (ops/history.py) and forward against the
JAX package's, on the CPU: `local_stage_ref`, the plain version of the CUDA
stage kernel, against the TPU kernel `local_stage_pallas` run in interpret
mode at the three main-path (T, D, H, window) shapes; the port's
`history_forward` against `history_forward_jnp` is in
test_torch_history_forward.py (files of at most three tests, which the
tier-1 run's loadfile scheduler hands out after its long pole). Inputs
and weights are made from numpy seeds.

Tolerances: the stage 1e-4 (atol and rtol: two LocalBlocks, products up
to 3D = 384 deep, summed in another order than XLA's); the band-plus-RPB
biases exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.ops.history import _STAGE_WNAMES, local_stage_pallas
from rift_tpu.ops.history import band_rpb_bias as jax_band_rpb_bias
from rift_tpu_torch.ops.history import STAGE_WNAMES, band_rpb_bias, local_stage
from torch_parity import STAGE_LEVELS, one_torch_thread, stage_inputs

N = 6  # history rows


@pytest.mark.parametrize("level", sorted(STAGE_LEVELS))
def test_local_stage_matches_pallas(level):
    assert tuple(STAGE_WNAMES) == tuple(_STAGE_WNAMES)
    T, D, H, window = STAGE_LEVELS[level]
    x, ws, rpb = stage_inputs(T, N, T, D, H, window)
    jb = [jax_band_rpb_bias(jnp.asarray(p), T, window) for p in rpb]
    tb = [band_rpb_bias(torch.from_numpy(p), T, window) for p in rpb]
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = local_stage_pallas(
        jnp.asarray(x), tuple(jnp.asarray(w) for w in ws), jb[0], jb[1], H, interpret=True
    )
    got = local_stage(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], *tb, H)
    assert got.dtype == torch.float32 and got.shape == (N, T, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
