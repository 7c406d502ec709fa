"""The port's entry points run on CUDA unless asked for the CPU."""

import pytest
import torch

from rift_tpu_torch.map import make_grid_town
from rift_tpu_torch.scenario import TrafficEnv
from torch_parity import one_torch_thread  # noqa: F401


def test_entry_points_default_to_cuda():
    """Without device="cpu" the port runs on CUDA, and raises where there
    is no card instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_grid_town(blocks=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrafficEnv(make_grid_town(blocks=1, device="cpu"), num_scenarios=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from rift_tpu_torch.models.pluto import PlutoModel

        PlutoModel(encoder_depth=1, decoder_depth=1)
