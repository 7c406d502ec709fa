"""The plain PointNet against rift_tpu's Pallas kernel (interpret mode)
and XLA reference at the map polygons' shape, with and without its layer
norms (test_torch_ops.py's tolerances)."""

import pytest

from test_torch_ops import points_matches_jax
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("shape", [(33, 20, 10)], ids=["map"])
def test_points_ref_matches_jax(has_ln, shape):
    points_matches_jax(has_ln, shape)
