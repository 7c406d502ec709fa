"""The RIFT loss and the gradients of the two PR-1 kernel wrappers
against the JAX package's, on the CPU (numpy-seeded inputs; split from
test_torch_train.py, so that each file holds at most three tests).

Tolerances: rift_loss 1e-6 (a handful of f32 exp/log per element); the
wrapper gradients against jax.grad of the XLA versions: attention 1e-5,
PointNet 1e-4 with rtol 1e-4 (a 512-deep product chain).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rift_tpu.ops.attention import fused_attention_xla
from rift_tpu.ops.points import points_forward_xla
from rift_tpu.rl.losses import rift_loss as jax_rift_loss
from rift_tpu_torch.ops.attention import fused_attention
from rift_tpu_torch.ops.points import points_encoder
from rift_tpu_torch.rl import rift_loss
from torch_parity import attn_inputs, one_torch_thread, points_weights  # noqa: F401

T = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def test_rift_loss_matches_jax():
    r = np.random.default_rng(4)
    bs, R, M = 5, 4, 12
    prob = r.normal(0, 2, (bs, R, M)).astype(np.float32)
    old = (prob + r.normal(0, 0.3, prob.shape)).astype(np.float32)
    adv = r.normal(0, 1, (bs, R, M)).astype(np.float32)
    pad = r.random((bs, R)) < 0.3
    valid = (r.random((bs, R, M)) < 0.8) & ~pad[..., None]
    args = (prob, pad, old, adv, valid)
    ref = float(jax_rift_loss(*map(jnp.asarray, args)))
    np.testing.assert_allclose(float(rift_loss(*map(T, args))), ref, atol=1e-6)


def test_attention_gradient_matches_jax():
    B, Tq, Tk, D, H = 3, 5, 7, 64, 4
    q, k, v, bias, kpad = attn_inputs(B, Tq, Tk, D, H, seed=2)
    kpad[0] = 0.0  # keep every row's keys reachable
    w = np.random.default_rng(3).normal(0, 1, (B, Tq, D)).astype(np.float32)
    loss = lambda *a: jnp.sum(fused_attention_xla(*a, H) * w)
    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias, kpad)))
    xs = [T(x).requires_grad_(True) for x in (q, k, v, bias)]
    out = fused_attention(*xs, T(kpad), H)
    assert out.grad_fn is not None
    (out * T(w)).sum().backward()
    for x, r in zip(xs, ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), atol=1e-5)


def test_points_gradient_matches_jax():
    r = np.random.default_rng(8)
    x = r.normal(0, 2.0, (6, 20, 10)).astype(np.float32)
    mask = r.random((6, 20)) < 0.7
    mask[2] = False
    wts = points_weights(9, 10, 64)
    g = r.normal(0, 1, (6, 64)).astype(np.float32)
    loss = lambda xx, ww: jnp.sum(points_forward_xla(xx, jnp.asarray(mask), ww, True) * g)
    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), tuple(map(jnp.asarray, wts)))
    tx = T(x).requires_grad_(True)
    tw = [T(a).requires_grad_(True) for a in wts]
    out = points_encoder(tx, T(mask), tw, 64)
    assert out.grad_fn is not None
    (out * T(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), atol=1e-4, rtol=1e-4)
    for a, b in zip(tw, dw):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
