"""Dataclass containers of tensors (the port's stand-in for flax.struct)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def as_tensor(x, device) -> torch.Tensor:
    """numpy/tensor -> tensor on `device`. Integers become int64: torch's
    uint32 arithmetic is incomplete and int64 indexes without casts, so
    uint32 fields (branch bits, PRNG keys) keep their values as int64."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        x = np.asarray(x)
        if x.dtype.kind in "iu":
            x = x.astype(np.int64)
        return torch.from_numpy(np.array(x, order="C")).to(device)
    t = torch.as_tensor(x)
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.long()
    return t.to(device)


def tree_map(fn, tree, *rest):
    """Apply `fn` to the tensor leaves of nested dicts (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats to zero, as XLA computes them. Braking speeds decay
    through the subnormal range; kept, they read as "moving" (> 0) and
    fall into other histogram bins than the JAX package's zeros."""
    return torch.where(torch.abs(x) < torch.finfo(x.dtype).tiny, 0.0, x)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TensorDataclass:
    """Mixin for @dataclass containers: `.to(device)` moves (or, from numpy,
    converts) every field, nested containers included; `.replace(**kw)`
    returns a copy with some fields swapped, as flax.struct's does."""

    def to(self, device):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                kw[f.name] = None
            elif isinstance(v, TensorDataclass):
                kw[f.name] = v.to(device)
            else:
                kw[f.name] = as_tensor(v, device)
        return type(self)(**kw)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
