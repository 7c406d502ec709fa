"""Builds the CUDA kernels of `rift_tpu_torch/csrc` and loads them.

Each `csrc/<name>.cu` has a plain C interface. `nvcc` compiles it for
Hopper (`sm_90a`) into a shared library that `ctypes` loads; no PyTorch
header is involved, so a build takes seconds. Libraries go to
`build/kernels/` beside the package (git-ignored), or to
`$RIFT_TORCH_KERNEL_DIR`, named by a hash of the source and the shared
headers (`csrc/*.cuh`) so an edited kernel is always rebuilt. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# per-kernel flags: the evaluator's kernels mirror elementwise tensor code,
# so no multiply-add is fused into one rounding
EXTRA_FLAGS = {"retrack": ("-fmad=false",), "refline": ("-fmad=false",)}

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    default = CSRC.parent.parent / "build" / "kernels"
    return Path(os.environ.get("RIFT_TORCH_KERNEL_DIR", default))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def start_build(name: str):
    """Start nvcc for one kernel unless its library exists. Returns the
    running process (or None); `finish_build` waits for it."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.rift_paths = (tmp, out)
    return proc


def finish_build(proc) -> str:
    """Wait for a build started by `start_build`; raise with nvcc's output
    if it failed. Returns nvcc's output (register and shared-memory use)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp, out = proc.rift_paths
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names) -> dict[str, str]:
    """Build several kernels at once, one nvcc each, all started together."""
    procs = {name: start_build(name) for name in names}
    return {name: finish_build(p) for name, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        finish_build(start_build(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
