"""On-device ring buffer of training samples (port of rift_tpu/rl/buffer.py).

A fixed-capacity FIFO over a nested dict of tensors that lives in device
memory, so rollout -> train never leaves the card. RIFT/GRPO samples are
per-step and independent, so they append directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..utils.tensors import tree_map

DEFAULT_CAPACITY = 4096  # reference buffer cap (rift_pluto.yaml)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@dataclass
class RingBuffer:
    """Fixed-capacity FIFO: `data` holds [capacity, ...] tensors; `size`
    and `ptr` are host integers."""

    data: Any
    size: int = 0
    ptr: int = 0

    @property
    def capacity(self) -> int:
        return _leaves(self.data)[0].shape[0]

    @property
    def full(self) -> bool:
        return self.size >= self.capacity


def ring_init(sample_spec: Any, capacity: int = DEFAULT_CAPACITY) -> RingBuffer:
    """`sample_spec`: nested dict of tensors describing ONE sample (their
    shape, dtype and device)."""
    alloc = lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    return RingBuffer(data=tree_map(alloc, sample_spec))


def ring_append(buf: RingBuffer, samples: Any, valid: torch.Tensor) -> RingBuffer:
    """Append the samples (leading dim n) where `valid` [n] holds, in order,
    from `ptr` on, wrapping around; invalid ones are dropped. When one call
    brings more valid samples than the capacity, the last `capacity` of
    them stay, as a FIFO keeps the newest. Updates `buf` in place (the
    JAX package returns a new buffer) and returns it."""
    cap = buf.capacity
    idx = torch.nonzero(valid).squeeze(1)
    added = int(idx.numel())
    keep = idx[-cap:] if added > cap else idx
    slots = (buf.ptr + (added - keep.numel()) + torch.arange(keep.numel(), device=idx.device)) % cap

    def put(dst, src):
        dst[slots.to(dst.device)] = src[keep.to(src.device)]
        return dst

    tree_map(put, buf.data, samples)
    buf.size = min(buf.size + added, cap)
    buf.ptr = (buf.ptr + added) % cap
    return buf


def ring_reset(buf: RingBuffer) -> RingBuffer:
    buf.size = buf.ptr = 0
    return buf


def sample_batches(buf: RingBuffer, gen: torch.Generator, batch_size: int, num_batches: int):
    """[num_batches, batch_size] shuffled indices for one epoch over the
    filled region: a permutation when the buffer holds the whole epoch (the
    reference's shuffled dataloader), else draws with replacement. `gen`
    is a torch.Generator on the buffer's device."""
    total = num_batches * batch_size
    dev = gen.device
    if buf.size >= total:
        idx = torch.randperm(buf.size, generator=gen, device=dev)[:total]
    else:
        idx = torch.randint(0, max(buf.size, 1), (total,), generator=gen, device=dev)
    return idx.reshape(num_batches, batch_size)


def gather_batch(buf: RingBuffer, idx: torch.Tensor):
    return tree_map(lambda x: x[idx.to(x.device)], buf.data)
