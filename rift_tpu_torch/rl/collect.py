"""Offline dataset collection -> HDF5 (port of rift_tpu/rl/collect.py).

Per tick the buffer keeps a host copy of the SimState fields that offline
training reads, and the applied controls as normalised rl actions; `save`
writes them in the JAX package's file layout (the same dataset names,
float32, bool and int32 arrays stacked over ticks, gzip-compressed, the
tick count in `attrs["num_ticks"]`), so either package reads the other's
file. h5py is imported by `save` and `load` only: without it they raise
ImportError.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .classic import control_to_rl_action

STORED_FIELDS = ("pos", "heading", "speed", "shape", "control", "rl_action", "alive",
                 "is_cbv", "collision", "ego_route_cursor", "tick")


def _host(x) -> np.ndarray:
    """A tensor or array as the JAX package stores it: integers as int32
    (the port's index tensors are int64), floats and bools as they are."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int32) if a.dtype.kind in "iu" else a


class CollectBuffer:
    def __init__(self, out_dir: str, ego_name: str = "pdm_lite", cbv_name: str = "standard"):
        self.out_dir = out_dir
        self.name = f"{ego_name}_{cbv_name}"
        self.frames: list[dict] = []
        os.makedirs(out_dir, exist_ok=True)

    @property
    def h5_path(self) -> str:
        return os.path.join(self.out_dir, f"{self.name}.hdf5")

    def exists(self) -> bool:
        """Skip-existing resume semantics (carla_runner.py:535-553)."""
        return os.path.exists(self.h5_path)

    def store(self, state, extra: dict | None = None):
        """One frame: the state's fields (on any device) and its controls as
        rl actions, copied to the host; `extra` arrays are added the same
        way."""
        rec = {k: _host(control_to_rl_action(state.control) if k == "rl_action"
                        else getattr(state, k)) for k in STORED_FIELDS}
        if extra:
            rec.update({k: _host(v) for k, v in extra.items()})
        self.frames.append(rec)

    def set_static(self, static: dict):
        """Episode-static arrays saved once as `static_<name>` (e.g. the ego
        route, which rebuilds PlanT tokens offline: models/plant/train.py)."""
        self._static = {k: _host(v) for k, v in static.items()}

    def save(self) -> str:
        """Write the frames and the static arrays, then empty the buffer.
        An empty buffer writes no file (an exists()-based resume would
        otherwise skip this ego/cbv pair for good)."""
        import h5py

        if not self.frames:
            return self.h5_path
        with h5py.File(self.h5_path, "w") as f:
            for k in self.frames[0]:
                f.create_dataset(k, data=np.stack([fr[k] for fr in self.frames]),
                                 compression="gzip")
            for k, v in getattr(self, "_static", {}).items():
                f.create_dataset(f"static_{k}", data=v, compression="gzip")
            f.attrs["num_ticks"] = len(self.frames)
        self.frames = []
        return self.h5_path

    @staticmethod
    def load(path: str) -> dict[str, np.ndarray]:
        import h5py

        with h5py.File(path, "r") as f:
            return {k: f[k][:] for k in f.keys()}
