"""Weights in the JAX package's format (port of rift_tpu/utils/params_io.py).

`load_params_npz` reads a `save_params_npz` file of the JAX package into a
nested dict of numpy arrays. `load_jax_params` fills a torch module whose
submodules carry the flax names, from the flat {path: array} form, e.g.
`params/planning_decoder/layer0/r2r/q/kernel`; with `strict=False` it
merges instead, as the JAX package's `merge_params` (keys absent from the
file keep their values). `save_params_npz` writes a torch module in that
flat-key format, so a pretrain moves between the two packages both ways.
`load_ppo_params` fills a classic PPO actor and critic from a JAX
`ClassicPPO.params` (`PPOParams(actor, critic)`).
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
    [H, Dh, out]) becomes an nn.Linear weight [out, in]; a flax Conv
    kernel, HWIO [kh, kw, in, out], an nn.Conv2d weight, OIHW; LayerNorm
    `scale` is `weight`; Embed `embedding` is `weight`; any other leaf is
    a parameter of the same name and shape."""
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
    if isinstance(mod, nn.Conv2d) and leaf == "kernel":
        return name("weight"), lambda a: a.transpose(3, 2, 0, 1)
    if isinstance(mod, nn.LayerNorm) and leaf in ("scale", "bias"):
        return name("weight" if leaf == "scale" else "bias"), lambda a: a
    if isinstance(mod, nn.Embedding) and leaf == "embedding":
        return name("weight"), lambda a: a
    return name(leaf), lambda a: a


@torch.no_grad()
def load_jax_params(model: nn.Module, flat: dict, strict: bool = True) -> None:
    """Fill `model` from the JAX package's flat params. Strict: a key with
    no torch counterpart, a shape mismatch, or a torch parameter left
    unset raises. Not strict (`merge_params`): keys with no counterpart
    are skipped and parameters absent from `flat` keep their values, but
    a file of which no key matches raises (a wrong key format)."""
    params = dict(model.named_parameters())
    unset = set(params)
    for key, arr in flat.items():
        try:
            pname, fn = _target(model, key)
        except KeyError:
            if strict:
                raise
            continue
        if pname not in params:
            if not strict:
                continue
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
    if strict and unset:
        raise KeyError(f"load_jax_params: parameters left unset: {sorted(unset)}")
    if unset == set(params):
        raise ValueError(f"load_jax_params: no key of the file matches the model "
                         f"(file: {sorted(flat)[:4]})")


def load_ppo_params(actor: nn.Module, critic: nn.Module, params) -> None:
    """A JAX `ClassicPPO.params` (`PPOParams(actor, critic)`, or a dict with
    those keys, of flax params trees) into the port's ActorPPO and
    CriticPPO, strictly."""
    tree = params._asdict() if hasattr(params, "_asdict") else params
    load_jax_params(actor, flatten_params(tree["actor"]))
    load_jax_params(critic, flatten_params(tree["critic"]))


def jax_flat_params(model: nn.Module) -> dict:
    """The model's parameters as the JAX package's flat {path: array}: the
    inverse of `load_jax_params`. A Linear's weight [out, in] becomes the
    flax kernel [in, out] (an attention projection's: q/k/v or
    query/key/value [in, H, Dh] with bias [H, Dh], out [H, Dh, out]); a
    Conv2d's weight OIHW the flax kernel HWIO; LayerNorm weights become
    `scale`, Embedding weights `embedding`; a PointsEncoder's params sit
    under the `flat` child that flax adds for batched input. An f32
    parameter on the CPU that needs no transpose comes back as a view of
    its memory: copy the arrays to keep a snapshot across updates."""
    from ..models.e2e.model import MultiHeadDotProductAttention
    from ..models.pluto.layers import Attention, PointsEncoder

    mods = dict(model.named_modules())
    flat = {}
    for pname, p in model.named_parameters():
        *path, leaf = pname.split(".")
        mod = mods[".".join(path)]
        parent = mods[".".join(path[:-1])] if path else None
        a = p.detach().float().cpu().numpy()
        keys = []
        for i, part in enumerate(path):
            keys.append(part)
            if isinstance(mods[".".join(path[: i + 1])], PointsEncoder):
                keys.append("flat")
        if isinstance(mod, nn.Linear):
            if isinstance(parent, (Attention, MultiHeadDotProductAttention)):
                H = parent.num_heads
                if path[-1] == "out":
                    a = a.T.reshape(H, -1, a.shape[0]) if leaf == "weight" else a
                else:
                    a = a.T.reshape(a.shape[1], H, -1) if leaf == "weight" else a.reshape(H, -1)
            elif leaf == "weight":
                a = a.T
            leaf = "kernel" if leaf == "weight" else leaf
        elif isinstance(mod, nn.Conv2d) and leaf == "weight":
            a, leaf = a.transpose(2, 3, 1, 0), "kernel"
        elif isinstance(mod, nn.LayerNorm) and leaf == "weight":
            leaf = "scale"
        elif isinstance(mod, nn.Embedding) and leaf == "weight":
            leaf = "embedding"
        flat["/".join(["params", *keys, leaf])] = np.ascontiguousarray(a)
    return flat


def save_params_npz(model: nn.Module, path: str) -> None:
    """A flat npz of the model's parameters in the JAX package's format
    (rift_tpu/utils/params_io.py:save_params_npz), readable by both
    packages' `load_params_npz`."""
    np.savez(path, **jax_flat_params(model))
