"""The port's whole-encoder HistoryEncoder route against the JAX package's,
on the CPU: `history_encoder_ref`, the plain version of the CUDA
whole-encoder kernel, against the TPU kernel `history_encoder_pallas` run
in interpret mode and against `history_forward_jnp`; and both routes of
the port's `history_forward`: with no gradient required (the encoder
route) and with one (the per-level stage route), values and gradients
against `history_forward_jnp` and `jax.grad` of it. Inputs and weights
(the RPB tables perturbed, so the band-plus-RPB bias matters) are made
from numpy seeds.

Tolerances: 1e-4 (atol and rtol) for values and gradients: six f32
LocalBlocks, three convolutions and the FPN, summed in another order
than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.models.pluto.layers import history_forward_jnp
from rift_tpu.ops.history import history_encoder_pallas
from rift_tpu.ops.history import rpb_names as jax_rpb_names
from rift_tpu.ops.history import weight_order as jax_weight_order
from rift_tpu_torch.models.pluto.layers import HistoryEncoder, history_forward
from rift_tpu_torch.ops import history
from torch_parity import one_torch_thread

N = 6  # history rows: interpret mode pads them to 128


@pytest.fixture(scope="module")
def inputs():
    """Seeded flat params (weight_order + rpb_names) and x [N, 20, 9]."""
    r = np.random.default_rng(7)
    W = {}
    for name, p in HistoryEncoder(9, 32).named_parameters():
        s = tuple(p.shape)
        if name.endswith("scale"):
            a = 1.0 + 0.1 * r.normal(size=s)
        elif "rpb" in name:
            a = 0.5 * r.normal(size=s)
        elif len(s) == 1:
            a = 0.1 * r.normal(size=s)
        else:
            a = r.normal(size=s) / np.sqrt(np.prod(s[:-1]))
        W[name] = a.astype(np.float32)
    x = r.normal(size=(N, 20, 9)).astype(np.float32)
    return W, x


@pytest.fixture(scope="module")
def jnp_ref(inputs):
    """history_forward_jnp's values and the gradients of a seeded weighted
    sum of them (w.r.t. every weight and x), in one compile: (g, values,
    (dW, dx))."""
    W, x = inputs
    g = np.random.default_rng(8).normal(size=(N, 128)).astype(np.float32)

    @jax.jit
    def value_and_vjp(Wd, xs):
        out, vjp = jax.vjp(history_forward_jnp, Wd, xs)
        return out, vjp(jnp.asarray(g))

    return (g, *value_and_vjp({k: jnp.asarray(v) for k, v in W.items()}, jnp.asarray(x)))


def test_history_encoder_ref_matches_pallas_and_jnp(inputs, jnp_ref):
    W, x = inputs
    assert history.weight_order(32) == jax_weight_order(32)
    assert history.rpb_names() == jax_rpb_names()
    jW = {k: jnp.asarray(v) for k, v in W.items()}
    pallas = history_encoder_pallas(jW, jnp.asarray(x), 32, interpret=True)
    jnp_ref = jnp_ref[1]
    got = history.history_encoder_ref(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in W.items()}
    )
    assert got.dtype == torch.float32 and got.shape == (N, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp_ref), atol=1e-4, rtol=1e-4)


def test_history_forward_routes_match_jnp(inputs, jnp_ref):
    """No gradient required: the encoder route, equal to the plain version
    (and the forward-only wrapper refuses inputs that require grad). With
    gradients: the stage route, whose values and gradients (of a weighted
    sum, w.r.t. x and every weight) match jax.grad of the reference."""
    W, x = inputs
    tW = {k: torch.from_numpy(v) for k, v in W.items()}
    tx = torch.from_numpy(x)
    launches = history.encoder_launches
    plain = history_forward(tW, tx)
    np.testing.assert_array_equal(plain.numpy(), history.history_encoder_ref(tx, tW).numpy())
    assert history.encoder_launches == launches  # CPU tensors launch nothing

    g, ref_val, (ref_gw, ref_gx) = jnp_ref
    gW = {k: v.clone().requires_grad_(True) for k, v in tW.items()}
    gx = tx.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        history.history_encoder(gx, gW)
    out = history_forward(gW, gx)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_val), atol=1e-4, rtol=1e-4)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(gx.grad.numpy(), np.asarray(ref_gx), atol=1e-4, rtol=1e-4)
    for k in W:
        np.testing.assert_allclose(gW[k].grad.numpy(), np.asarray(ref_gw[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
