"""The port's Pluto fine-tuning zoo (policies.py) against the JAX package's,
on the CPU.

Each fine-tune key's `_loss_fn` against the JAX policy's on the same fixed
model outputs: both policies get a stub model that returns the outputs
(the JAX stub's `apply(params, features)` returns `params`), so no model
compiles, and the gradients are taken w.r.t. those outputs; values and
gradients within 1e-5 (f32 sums over a few hundred candidates).
`_teacher_label` exactly. The registries hold the ported keys and name
them when asked for another; the trainable sets and optimizer settings
are the JAX policies', and the defaults (the token convention, the
Runner's fields, the CLI's flags) the JAX package's. (The pretrain npz
round trip between the packages is in test_torch_pluto.py, on its seeded
model.) The losses of the other keys are in test_torch_policies_losses.py
and test_torch_policies_zoo.py, with `_teacher_label` and the registries;
the defaults in test_torch_policies_defaults.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rift_tpu import policies as jpolicies
from rift_tpu_torch import policies
from torch_parity import one_torch_thread

BS, R, M, F, P = 6, 3, 4, 80, 5
FINE_TUNED = ("rift_pluto", "grpo_pluto", "reinforce_pluto", "rs_pluto", "sft_pluto",
              "bc_pluto", "rtr_pluto", "ppo_pluto")
CPU_MAP = types.SimpleNamespace(device=torch.device("cpu"))  # what a policy reads
SMALL = {"encoder_depth": 1, "decoder_depth": 1}
CANONICAL_SMALL = {**SMALL, "canonical_tokens": True}


def _given(seed=0):
    """(model outputs, reference outputs, batch) as numpy, from a seed."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    valid_pts = r.random((BS, R, P)) < 0.8
    valid_pts[:, 1:][r.random((BS, R - 1)) < 0.3] = False  # padded lines
    valid_pts[:, 0, 0] = True
    r_pad = ~valid_pts.any(-1)

    def outs():
        prob = np.where(r_pad[:, :, None], -1e6, f(BS, R, M)).astype(np.float32)
        traj = np.cumsum(0.8 + 0.3 * f(BS, R, M, F, 6), axis=3).astype(np.float32)
        return {"probability": prob, "trajectory": traj,
                "output_ref_free_trajectory": np.cumsum(0.8 + 0.3 * f(BS, F, 3), 1),
                "value": f(BS)}

    out, ref = outs(), outs()
    batch = {
        "features": {"reference_line": {"valid_mask": valid_pts}},
        "old_logits": f(BS, R, M), "advantage": f(BS, R, M),
        "valid": r.random((BS, R, M)) < 0.7, "chosen_idx": r.integers(0, R * M, BS),
        "teacher_speed": 5.0 + f(BS), "teacher_pos": 30.0 + 3.0 * f(BS, 2),
        "teacher_traj": np.cumsum(0.8 + 0.3 * f(BS, F, 2), 1).astype(np.float32),
        "value": f(BS), "ret": f(BS), "ret_shaped": f(BS), "gae": f(BS),
        "gae_valid": r.random(BS) < 0.8,
    }
    return out, ref, batch


def _tree(x, fn):
    return {k: _tree(v, fn) for k, v in x.items()} if isinstance(x, dict) else fn(x)


class _JaxStub:
    def apply(self, params, features):
        return params


def loss_fn_matches_jax(key):
    out, ref, batch = _given()
    jpol = jpolicies.CBV_POLICY_LIST[key](None, {})
    jpol.model = _JaxStub()
    jpol.ref_params = _tree(ref, jnp.asarray)
    jbatch = _tree(batch, jnp.asarray)
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda o: jpol._loss_fn(o, jbatch, None)))(
        _tree(out, jnp.asarray))

    pol = policies.CBV_POLICY_LIST[key](CPU_MAP, CANONICAL_SMALL)
    touts = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in out.items()}
    pol.ref_model = lambda features: _tree(ref, torch.from_numpy)
    loss = pol._loss_fn(lambda features: dict(touts), _tree(batch, torch.from_numpy))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    for k, t in touts.items():
        g = torch.zeros_like(t) if t.grad is None else t.grad
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


# the keys' losses: three here, three in test_torch_policies_losses.py, two
# in test_torch_policies_zoo.py (files of at most three tests, which the
# tier-1 run's loadfile scheduler hands out after its long pole)
@pytest.mark.parametrize("key", FINE_TUNED[:3])
def test_loss_fn_matches_jax(key):
    loss_fn_matches_jax(key)
