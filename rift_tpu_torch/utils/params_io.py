"""Weights from the JAX package (port of rift_tpu/utils/params_io.py).

`load_params_npz` reads a `save_params_npz` file of the JAX package into a
nested dict of numpy arrays. `load_jax_params` fills a torch module whose
submodules carry the flax names, from the flat {path: array} form, e.g.
`params/planning_decoder/layer0/r2r/q/kernel`.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def _parts(key: str) -> list[str]:
    """Path entries, with the legacy stringified-path formats of older
    artifacts ("DictKey(key='x')", "['x']") reduced to the plain name."""
    parts = []
    for p in key.split("/"):
        m = re.match(r"DictKey\(key='(.+?)'\)", p) or re.match(r"\['(.+?)'\]", p)
        parts.append(m.group(1) if m else p)
    return parts


def load_params_npz(path: str) -> dict:
    """Rebuild the nested params dict (numpy leaves) from a
    save_params_npz file."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = _parts(key)
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = np.asarray(data[key])
    return out


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """Nested params dict -> flat {"a/b/c": array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = v
    return flat


def _target(model: nn.Module, key: str):
    """(torch param name, array transform) for one flax param path.

    The leading "params" collection and the automatic "flat" child that
    flax's PointsEncoder adds for batched input are dropped. A flax Dense
    kernel [in, out] (packed attention projections: [in, H, Dh] and
    [H, Dh, out]) becomes an nn.Linear weight [out, in]; LayerNorm `scale`
    is `weight`; Embed `embedding` is `weight`; any other leaf is a
    parameter of the same name and shape."""
    parts = [p for p in _parts(key) if p != "flat"]
    if parts and parts[0] == "params":
        parts = parts[1:]
    *mod_path, leaf = parts
    mod = model
    for p in mod_path:
        if not hasattr(mod, p) or not isinstance(getattr(mod, p), nn.Module):
            raise KeyError(f"load_jax_params: no module for {key!r}")
        mod = getattr(mod, p)
    prefix = ".".join(mod_path)
    name = lambda n: f"{prefix}.{n}" if prefix else n
    if isinstance(mod, nn.Linear) and leaf == "kernel":
        return name("weight"), lambda a: a.reshape(mod.in_features, -1).T
    if isinstance(mod, nn.Linear) and leaf == "bias":
        return name("bias"), lambda a: a.reshape(-1)
    if isinstance(mod, nn.LayerNorm) and leaf in ("scale", "bias"):
        return name("weight" if leaf == "scale" else "bias"), lambda a: a
    if isinstance(mod, nn.Embedding) and leaf == "embedding":
        return name("weight"), lambda a: a
    return name(leaf), lambda a: a


@torch.no_grad()
def load_jax_params(model: nn.Module, flat: dict) -> None:
    """Fill `model` from the JAX package's flat params. Strict: a key with
    no torch counterpart, a shape mismatch, or a torch parameter left
    unset raises."""
    params = dict(model.named_parameters())
    unset = set(params)
    for key, arr in flat.items():
        pname, fn = _target(model, key)
        if pname not in params:
            raise KeyError(f"load_jax_params: {key!r} -> {pname!r} not in the model")
        p = params[pname]
        value = torch.from_numpy(np.ascontiguousarray(fn(np.asarray(arr))))
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(
                f"load_jax_params: {key!r} {tuple(value.shape)} vs {pname!r} "
                f"{tuple(p.shape)}"
            )
        p.copy_(value.to(p.dtype))
        unset.discard(pname)
    if unset:
        raise KeyError(f"load_jax_params: parameters left unset: {sorted(unset)}")
