"""Joining the process group, and global batches from per-process data (port
of rift_tpu/parallel/multihost.py).

The JAX package builds one SPMD program over every device of every host,
joined through jax.distributed's coordinator. The port runs one process per
GPU, on one host or many, joined in a `torch.distributed` process group:

    from rift_tpu_torch.parallel import global_mesh, init_distributed
    init_distributed()   # False (and nothing done) outside a launcher
    mesh = global_mesh()  # 1-D scenario mesh over every rank

Started by `torchrun --nproc_per_node=N script.py`, or with RIFT_COORDINATOR
(host:port), RIFT_NUM_PROCESSES and RIFT_PROCESS_ID set per process.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import AXIS, _comm_device, _flatten, _to_bytes, make_mesh, tree_leaves

JOIN_TIMEOUT_S = 600  # rendezvous and collectives
_device: torch.device | None = None  # this process's device, set on joining


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    backend: str | None = None,
) -> bool:
    """Join the process group. Returns True if distributed mode is on.

    Explicit arguments win; then RIFT_COORDINATOR / RIFT_NUM_PROCESSES /
    RIFT_PROCESS_ID, as the JAX package reads them; then torchrun's
    MASTER_ADDR / WORLD_SIZE / RANK. With none of these the process stays
    alone and this does nothing. The process takes the GPU
    `local_device_ids[0]` (else LOCAL_RANK, else its rank modulo the GPUs
    it sees) and NCCL; without a card, the host and gloo. `backend`
    overrides the choice (gloo on a GPU lets two ranks share one card,
    which NCCL refuses). Raises if the group cannot be joined."""
    global _device
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("RIFT_COORDINATOR")
    torchrun = all(os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    if coordinator_address is None and not torchrun:
        return False
    if num_processes is None:
        num_processes = _env_int("RIFT_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RIFT_PROCESS_ID", "RANK")
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: the number of processes and this process's "
                         "id are needed (arguments, RIFT_NUM_PROCESSES / RIFT_PROCESS_ID, "
                         "or torchrun's WORLD_SIZE / RANK)")
    if torch.cuda.is_available():
        if local_device_ids is not None:
            index = int(list(local_device_ids)[0])
        else:
            local = _env_int("LOCAL_RANK")
            index = local if local is not None else process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
        _device = torch.device("cuda", index)
    else:
        _device = torch.device("cpu")
    backend = backend or ("nccl" if _device.type == "cuda" else "gloo")
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S),
    )
    return True


def mesh_device_type() -> str:
    """The type of the device this process took on joining (CUDA where there
    is a card, when it joined some other way)."""
    if _device is not None:
        return _device.type
    return "cuda" if torch.cuda.is_available() else "cpu"


def global_mesh(axis: str = AXIS):
    """1-D mesh over every rank of every process (DP over scenarios: the
    only parallel axis this workload needs)."""
    return make_mesh(None, axis)


def host_local_batch(tree, mesh, axis: str = AXIS):
    """A global batch from each rank's LOCAL shard: the shard stays where it
    is (no rank ever holds the whole batch), once every rank has shown the
    same leading dim for each leaf (one all-gather of the dims)."""
    dims = torch.tensor([x.shape[0] for x in tree_leaves(tree)], dtype=torch.int64)
    group = mesh.get_group()
    dev = _comm_device(group)
    parts = [torch.empty_like(dims, device=dev) for _ in range(mesh.size())]
    dist.all_gather(parts, dims.to(dev), group=group)
    if any(not torch.equal(p.cpu(), dims) for p in parts):
        raise ValueError("host_local_batch: the ranks' shards have different leading dims: "
                         f"{[p.tolist() for p in parts]}")
    return tree


def _checksum(buf: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of the bytes: equal buffers, equal sums."""
    w = torch.arange(buf.numel(), dtype=torch.int64, device=buf.device) % 65521 + 1
    return (buf.long() * w).sum()


def replicate_global(tree, mesh):
    """The tree, after checking that every rank passed the same tensors
    (maps, specs, parameters): one all-reduce of a checksum per leaf, its
    maximum and its negated minimum together. Raises where they differ."""
    leaves, _ = _flatten(tree)
    group = mesh.get_group()
    dev = _comm_device(group)
    sums = torch.stack([_checksum(_to_bytes([x], dev)) for x in leaves]) if leaves else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    both = torch.cat([sums, -sums])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    hi, neg_lo = both.split(len(leaves))
    if not torch.equal(hi, -neg_lo):
        bad = (hi != -neg_lo).nonzero().flatten().tolist()
        raise ValueError(f"replicate_global: leaves {bad} differ between ranks")
    return tree
