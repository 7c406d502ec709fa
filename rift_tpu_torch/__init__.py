"""PyTorch/CUDA port of rift_tpu for NVIDIA Hopper.

The package mirrors `rift_tpu`'s module layout and names. It imports torch
and numpy only: never jax, flax or anything of `rift_tpu`.

Geometry and simulation state stay in float32 with TF32 off everywhere:
reduced-precision products over world-frame coordinates (hundreds of
meters) move points by meters. cuDNN's flag matters too, because the
HistoryEncoder's k=3 convolutions run through cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

# subpackages loaded on first use: `rift_tpu_torch.viz` (the BEV renderer,
# which draws with matplotlib) and `rift_tpu_torch.parallel`
_LAZY = ("parallel", "viz")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
