"""The port's bicycle step on the last two golden maneuvers, open loop at
test_torch_evaluator.py's bounds, and its box geometry against the JAX
package's: obb_overlap exactly (bools), box corners 1e-5, face normals
1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest

from rift_tpu.geometry.obb import _axes_from_heading as jax_axes
from rift_tpu.geometry.obb import box_corners as jax_box_corners
from rift_tpu.geometry.obb import obb_overlap as jax_obb_overlap
from rift_tpu_torch.geometry.obb import _axes_from_heading, box_corners, obb_overlap
from test_torch_evaluator import MANEUVERS, T, bicycle_matches_golden, traces  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", MANEUVERS[2:])
def test_bicycle_step_matches_golden_open_loop(traces, name):  # noqa: F811
    bicycle_matches_golden(traces, name)


def test_obb_overlap_matches_jax():
    r = np.random.default_rng(0)
    n = 4000
    ca = r.uniform(-6, 6, (n, 2)).astype(np.float32)
    cb = r.uniform(-6, 6, (n, 2)).astype(np.float32)
    ha, hb = (r.uniform(-np.pi, np.pi, n).astype(np.float32) for _ in range(2))
    sa, sb = (r.uniform(0.5, 5.0, (n, 2)).astype(np.float32) for _ in range(2))
    args = (ca, ha, sa, cb, hb, sb)
    ref = np.asarray(jax_obb_overlap(*map(jnp.asarray, args)))
    assert 0.1 < ref.mean() < 0.9
    np.testing.assert_array_equal(obb_overlap(*map(T, args)).numpy(), ref)
    np.testing.assert_allclose(
        box_corners(T(ca), T(ha), T(sa)).numpy(),
        np.asarray(jax_box_corners(*map(jnp.asarray, (ca, ha, sa)))), atol=1e-5,
    )
    np.testing.assert_allclose(
        _axes_from_heading(T(ha)).numpy(), np.asarray(jax_axes(jnp.asarray(ha))), atol=1e-6
    )
