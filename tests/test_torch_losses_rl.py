"""Three more fine-tuning losses against the JAX package's, as
test_torch_losses.py holds its three (values and gradients within 1e-5)."""

import pytest

from test_torch_losses import CASES, loss_matches_jax
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(CASES)[3:])
def test_loss_matches_jax(name):
    loss_matches_jax(name)
