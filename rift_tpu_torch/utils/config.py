"""Config loading: a JSON file per component, CLI overrides on top (port of
rift_tpu/utils/config.py).

The JAX package reads YAML; the card's machine has no YAML parser, so the
port carries JSON copies of the configs it supports under
`rift_tpu_torch/configs/`. Hydra-style dotted overrides ("train.lr=2e-4")
set nested keys.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def load_config(name_or_path: str) -> dict[str, Any]:
    """A JSON config by path, or by name from CONFIG_DIR; a name with no
    file is a policy of that name with no settings."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(CONFIG_DIR, name_or_path)
        if not path.endswith(".json"):
            path += ".json"
    if not os.path.exists(path):
        return {"policy": os.path.splitext(os.path.basename(name_or_path))[0]}
    if not path.endswith(".json"):
        raise ValueError(f"load_config: {path} is not a JSON config")
    with open(path) as f:
        return json.load(f) or {}


def _parse(value: str):
    """An override's value: JSON if it parses, else a float, else the
    string itself."""
    try:
        return json.loads(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        return value


def apply_overrides(cfg: dict[str, Any], overrides: list[str]) -> dict[str, Any]:
    """Apply "a.b.c=value" overrides (a leading "+" is dropped)."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split("=", 1)
        node = cfg
        parts = key.lstrip("+").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse(value)
    return cfg


def merge(base: dict, extra: dict) -> dict:
    """`extra` over `base`, recursively for nested dicts."""
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out
