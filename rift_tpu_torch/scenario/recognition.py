"""CBV slot assignment (port of rift_tpu/scenario/recognition.py:
`cbv_slot_assignment` only; rule recognition comes with the world tick)."""

from __future__ import annotations

import torch


def cbv_slot_assignment(is_cbv: torch.Tensor, max_cbvs: int) -> torch.Tensor:
    """[S, A] mask -> [S, C] agent indices (-1 padded), CBVs first in slot
    order (a stable sort, as jnp.argsort is)."""
    order = torch.argsort((~is_cbv).to(torch.uint8), dim=-1, stable=True)
    slots = order[:, :max_cbvs]
    valid = torch.gather(is_cbv, 1, slots)
    return torch.where(valid, slots, -1)
