"""The plain attention against rift_tpu's Pallas kernel (interpret mode)
and XLA reference: the cases after test_torch_ops.py's (its tolerances),
and the CPU wrapper taking the plain version."""

import pytest
import torch

from rift_tpu_torch.ops.attention import fused_attention, fused_attention_ref
from test_torch_ops import ATTN_SPLIT, attention_matches_jax
from torch_parity import ATTN_CASES, attn_inputs, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", sorted(ATTN_CASES)[ATTN_SPLIT:])
def test_attention_ref_matches_jax(case):
    attention_matches_jax(case)


def test_attention_cpu_wrapper_uses_plain_version():
    arrs = [torch.from_numpy(a) for a in attn_inputs(4, 5, 7, 32, 2)]
    torch.testing.assert_close(fused_attention(*arrs, 2), fused_attention_ref(*arrs, 2))
