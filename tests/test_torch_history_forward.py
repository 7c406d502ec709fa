"""The port's HistoryEncoder forward against the JAX package's, on the
CPU: `history_forward` against `history_forward_jnp` (block by block) on
one seeded flat param dict. With no gradient required the port takes the
whole-encoder route, whose plain version runs every level through
`local_stage_ref` (the stage route with gradients:
tests/test_torch_history_encoder.py; the stage alone:
tests/test_torch_history.py).

Tolerance 1e-4, atol and rtol (three stages, two downsampling
convolutions, the FPN and a last convolution).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rift_tpu.models.pluto.layers import history_forward_jnp
from rift_tpu.ops.history import rpb_names, weight_order
from rift_tpu_torch.models.pluto.layers import HistoryEncoder, history_forward
from test_torch_history import N
from torch_parity import one_torch_thread  # noqa: F401


def test_history_forward_matches_jnp():
    """The port's forward (the whole-encoder route, whose plain version runs
    all three levels through the stage's) against the JAX package's
    block-by-block reference, on one seeded flat param dict."""
    mod = HistoryEncoder(9, 32)
    r = np.random.default_rng(11)
    W = {}
    for name, p in mod.named_parameters():
        s = tuple(p.shape)
        if name.endswith("scale"):
            a = 1.0 + 0.1 * r.normal(size=s)
        elif len(s) == 1 or "rpb" in name:
            a = 0.1 * r.normal(size=s)
        else:
            a = r.normal(size=s) / np.sqrt(np.prod(s[:-1]))
        W[name] = a.astype(np.float32)
    assert set(W) == set(weight_order(32)) | set(rpb_names())
    x = r.normal(size=(N, 20, 9)).astype(np.float32)
    ref = jax.jit(history_forward_jnp)({k: jnp.asarray(v) for k, v in W.items()}, jnp.asarray(x))
    got = history_forward({k: torch.from_numpy(v) for k, v in W.items()}, torch.from_numpy(x))
    assert got.shape == (N, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
