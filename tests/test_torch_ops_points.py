"""The plain PointNet against rift_tpu's Pallas kernel (interpret mode)
and XLA reference at the reference lines' shape, with and without its
layer norms (test_torch_ops.py's tolerances), and the CPU wrapper taking
the plain version. The map polygons' shape: test_torch_ops_points_map.py."""

import numpy as np
import pytest
import torch

from rift_tpu_torch.ops.points import points_encoder, points_forward_ref
from test_torch_ops import points_matches_jax
from torch_parity import one_torch_thread, points_weights  # noqa: F401


@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("shape", [(40, 120, 6)], ids=["refs"])
def test_points_ref_matches_jax(has_ln, shape):
    points_matches_jax(has_ln, shape)


def test_points_cpu_wrapper_uses_plain_version():
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.normal(0, 1, (6, 9, 6)).astype(np.float32))
    mask = torch.from_numpy(r.random((6, 9)) < 0.5)
    w = [torch.from_numpy(a) for a in points_weights(5, 6, 64)]
    torch.testing.assert_close(
        points_encoder(x, mask, w, 64), points_forward_ref(x, mask, w)
    )
