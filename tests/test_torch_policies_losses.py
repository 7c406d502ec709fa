"""Three more fine-tune keys' `_loss_fn` against the JAX policies', as
test_torch_policies.py holds its three (the same stub outputs, values and
gradients within 1e-5)."""

import pytest

from test_torch_policies import FINE_TUNED, loss_fn_matches_jax
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("key", FINE_TUNED[3:6])
def test_loss_fn_matches_jax(key):
    loss_fn_matches_jax(key)
