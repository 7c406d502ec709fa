"""The port's `gae` and `smooth_l1` (rl/losses.py) against the JAX
package's on numpy-seeded inputs: values and `gae`'s gradient w.r.t. the
values within 1e-5, `smooth_l1` within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rift_tpu.rl import losses as jl
from rift_tpu_torch.rl import losses as tl
from torch_parity import one_torch_thread  # noqa: F401


def test_gae_and_smooth_l1_match_jax():
    r = np.random.default_rng(3)
    rewards = r.normal(size=12).astype(np.float32)
    values = r.normal(size=13).astype(np.float32)
    dones = r.random(12) < 0.2
    adv, ret = jax.jit(jl.gae)(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones))
    tv = torch.from_numpy(values).requires_grad_(True)
    got_adv, got_ret = tl.gae(torch.from_numpy(rewards), tv, torch.from_numpy(dones))
    np.testing.assert_allclose(got_adv.detach().numpy(), np.asarray(adv), atol=1e-5)
    np.testing.assert_allclose(got_ret.detach().numpy(), np.asarray(ret), atol=1e-5)
    ref_g = jax.jit(jax.grad(
        lambda v: jnp.sum(jl.gae(jnp.asarray(rewards), v, jnp.asarray(dones))[0])))(
        jnp.asarray(values))
    got_adv.sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(ref_g), atol=1e-5)

    pred, target = r.normal(size=20).astype(np.float32), r.normal(size=20).astype(np.float32)
    np.testing.assert_allclose(
        tl.smooth_l1(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
        np.asarray(jl.smooth_l1(jnp.asarray(pred), jnp.asarray(target))), atol=1e-6,
    )
