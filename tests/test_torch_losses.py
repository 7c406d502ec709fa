"""The port's fine-tuning losses (rl/losses.py) against the JAX package's,
on the CPU: each loss and `gae` on the same numpy-seeded inputs, values and
gradients (w.r.t. every float input) within 1e-5. Inputs hold padded
reference lines and invalid candidates, as the buffer's samples do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu.rl import losses as jl
from rift_tpu_torch.rl import losses as tl
from torch_parity import one_torch_thread

BS, R, M = 5, 3, 4


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    r_pad = r.random((BS, R)) < 0.3
    r_pad[:, 0] = False  # every sample keeps a line
    return {
        "probability": f(BS, R, M), "old_logits": f(BS, R, M), "ref_logits": f(BS, R, M),
        "advantage": f(BS, R, M), "valid": r.random((BS, R, M)) < 0.7,
        "r_padding": r_pad, "chosen_idx": r.integers(0, M, BS).astype(np.int32),
        "returns": f(BS), "old_log_prob": -np.abs(f(BS)) - 1.0, "value_pred": f(BS),
        "reward_sum": 2.0 * f(BS), "teacher_idx": r.integers(0, M, BS).astype(np.int32),
        "teacher_valid": r.random(BS) < 0.7,
    }


# name -> (argument names, float arguments differentiated)
CASES = {
    "rift_loss": ("probability r_padding old_logits advantage valid", "probability old_logits"),
    "grpo_loss": ("probability r_padding old_logits ref_logits advantage valid",
                  "probability old_logits ref_logits"),
    "reinforce_loss": ("probability r_padding chosen_idx returns", "probability returns"),
    "ppo_candidate_loss": (
        "probability r_padding chosen_idx old_log_prob advantage value_pred reward_sum",
        "probability old_log_prob value_pred reward_sum"),
    "sft_loss": ("probability r_padding teacher_idx teacher_valid", "probability"),
    "rtr_loss": ("probability r_padding chosen_idx old_log_prob advantage value_pred "
                 "reward_sum teacher_idx", "probability value_pred"),
}


def loss_matches_jax(name):
    names, diff = (s.split() for s in CASES[name])
    data = _inputs()
    if name in ("ppo_candidate_loss", "rtr_loss"):
        data["advantage"] = data["advantage"][:, 0, 0]  # per sample
    args = [data[n] for n in names]
    pos = [names.index(n) for n in diff]

    def jfn(*xs):
        a = list(args)
        for i, x in zip(pos, xs):
            a[i] = x
        return getattr(jl, name)(*[jnp.asarray(v) for v in a])

    ref, ref_g = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(pos)))))(
        *[jnp.asarray(args[i]) for i in pos]
    )
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    for i in pos:
        targs[i].requires_grad_(True)
    got = getattr(tl, name)(*targs)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-5, rtol=1e-5)
    for i, g in zip(pos, ref_g):
        # a stopped gradient: none in torch, zeros in JAX
        grad = targs[i].grad
        grad = torch.zeros_like(targs[i]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-5,
                                   err_msg=names[i])


# three losses here, three in test_torch_losses_rl.py, `gae` in
# test_torch_losses_gae.py (files of at most three tests, which the tier-1
# run's loadfile scheduler hands out after its long pole)
@pytest.mark.parametrize("name", sorted(CASES)[:3])
def test_loss_matches_jax(name):
    loss_matches_jax(name)
