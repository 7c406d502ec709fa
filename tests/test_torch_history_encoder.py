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
than XLA's. At the compute dtype bf16 the port's encoder runs in f32 and
rounds once (models/pluto/layers.py:history_forward), where the JAX
package's live path computes in bf16: that gap is pinned at 64 rows
(test_bf16_encoder_against_jax_f32_and_bf16).
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
N_BF16 = 64  # history rows of the bf16 comparison


@pytest.fixture(scope="module")
def inputs():
    """Seeded flat params (weight_order + rpb_names), x [N, 20, 9] and the
    same draw at N_BF16 rows (its first N rows are x)."""
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
    x = r.normal(size=(N_BF16, 20, 9)).astype(np.float32)
    return W, x[:N], x


@pytest.fixture(scope="module")
def jnp_ref(inputs):
    """history_forward_jnp's values and the gradients of a seeded weighted
    sum of them (w.r.t. every weight and x), in one compile: (g, values,
    (dW, dx))."""
    W, x, _ = inputs
    g = np.random.default_rng(8).normal(size=(N, 128)).astype(np.float32)

    @jax.jit
    def value_and_vjp(Wd, xs):
        out, vjp = jax.vjp(history_forward_jnp, Wd, xs)
        return out, vjp(jnp.asarray(g))

    return (g, *value_and_vjp({k: jnp.asarray(v) for k, v in W.items()}, jnp.asarray(x)))


def test_history_encoder_ref_matches_pallas_and_jnp(inputs, jnp_ref):
    W, x, _ = inputs
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
    W, x, _ = inputs
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


def test_bf16_encoder_against_jax_f32_and_bf16(inputs):
    """The port's encoder at the compute dtype bf16 (f32 inside, one
    rounding at the end) against history_forward_jnp in f32 and in bf16,
    at N_BF16 rows (max |y| = 5.9). Measured on the CPU with these
    weights, history_forward_jnp jitted as here: the port vs JAX f32
    0.0145 max abs (the final rounding alone), the port vs JAX bf16 0.066,
    and JAX bf16 vs JAX f32 itself 0.067 (mean 0.013; op by op, JAX's
    bf16 path reads 0.078 against the port and 0.074 against its f32):
    bf16 intermediates rounded in another order scatter as far as that,
    so a bf16 encoder would come no closer to JAX's. Bounds: 0.02 against JAX f32 (about one bf16 rounding at this
    scale: half an ulp at |y| in [4, 8) is 0.016), 0.1 against JAX bf16."""
    W, _, x = inputs
    tW = {k: torch.from_numpy(v) for k, v in W.items()}
    with torch.no_grad():
        got = history_forward(tW, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (N_BF16, 128)
    got = got.float().numpy()
    jW = {k: jnp.asarray(v) for k, v in W.items()}
    for dt, tol in ((jnp.float32, 0.02), (jnp.bfloat16, 0.1)):
        ref = jax.jit(lambda W_, x_: history_forward_jnp(W_, x_, dtype=dt))(jW, jnp.asarray(x))
        err = np.abs(got - np.asarray(ref, np.float32)).max()
        assert err <= tol, (dt, err)
