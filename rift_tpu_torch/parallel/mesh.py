"""Data parallelism over the scenario axis (port of rift_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a 1-D `scenario` mesh: the
scenario and batch axis of every rollout and training tensor is sharded,
the parameters are replicated, and XLA inserts the gradient psum. The
PyTorch idiom is one process per GPU (`torchrun`) in a `torch.distributed`
process group: each rank holds its contiguous block of the scenarios, the
block that JAX's `P("scenario")` gives device r, and the collectives are
explicit (rl/trainer.py all-reduces the gradients; runner.py gathers the
fine-tune samples and the statistics).

Pytrees here are nested dicts, tuples and the port's tensor dataclasses
(SimState, CriteriaState, ScenarioSpec); other leaves (None, Python numbers) pass
through. Each collective over a tree moves all its tensors as one byte
buffer: one call, whatever the number of leaves.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils.tensors import TensorDataclass

AXIS = "scenario"


def _flatten(tree):
    """(tensor leaves, rebuild(new leaves) -> tree of the same structure)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, (dict, tuple, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        parts = {k: _flatten(v) for k, v in items}
    elif isinstance(tree, TensorDataclass):
        parts = {f.name: _flatten(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    else:
        return [], lambda xs: tree
    leaves, bounds = [], {}
    for k, (ls, _) in parts.items():
        bounds[k] = (len(leaves), len(leaves) + len(ls))
        leaves += ls

    def rebuild(xs):
        kw = {k: parts[k][1](xs[a:b]) for k, (a, b) in bounds.items()}
        if isinstance(tree, dict):
            return kw
        if isinstance(tree, (tuple, list)):
            return type(tree)(kw.values())
        return tree.replace(**kw)

    return leaves, rebuild


def tree_leaves(tree) -> list:
    return _flatten(tree)[0]


def _comm_device(group) -> torch.device:
    """Where a collective's buffer lives: the card for NCCL, the host for
    gloo (which gathers only host tensors)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _to_bytes(leaves, device) -> torch.Tensor:
    if not leaves:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    return torch.cat([x.detach().contiguous().reshape(-1).view(torch.uint8).to(device)
                      for x in leaves])


def _from_bytes(buf: torch.Tensor, like: list) -> list:
    """Split a byte buffer back into tensors shaped, typed and placed as
    `like`."""
    out, off = [], 0
    for x in like:
        n = x.numel() * x.element_size()
        piece = buf[off:off + n].clone().view(x.dtype).reshape(x.shape)
        out.append(piece.to(x.device))
        off += n
    return out


def make_mesh(n: int | None = None, axis: str = AXIS):
    """A 1-D DeviceMesh named (`axis`,) over the process group's n ranks (n:
    all of them, the only size a one-process-per-GPU group can shard over).
    `init_distributed` must have joined the group."""
    from torch.distributed.device_mesh import init_device_mesh

    from .multihost import mesh_device_type

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed() first")
    world = dist.get_world_size()
    if n not in (None, world):
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}: one "
                         "process per GPU shards over all of them")
    return init_device_mesh(mesh_device_type(), (world,), mesh_dim_names=(axis,))


def shard_batch(tree, mesh, axis: str = AXIS):
    """This rank's contiguous block [r*S/n, (r+1)*S/n) of every leaf's
    leading dim (JAX's P("scenario") block of device r). S must divide by n."""
    n, r = mesh.size(), mesh.get_local_rank()

    def take(x):
        S = x.shape[0]
        if S % n:
            raise ValueError(f"a leading dim of {S} does not split over {n} ranks")
        return x[r * (S // n):(r + 1) * (S // n)]

    leaves, rebuild = _flatten(tree)
    return rebuild([take(x) for x in leaves])


def replicate(tree, mesh):
    """Every tensor of `tree` as rank 0 holds it (one broadcast)."""
    leaves, rebuild = _flatten(tree)
    group = mesh.get_group()
    buf = _to_bytes(leaves, _comm_device(group))
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return rebuild(_from_bytes(buf, leaves))


def gather_scenarios(tree, mesh, dim: int = 0):
    """The inverse of `shard_batch`: every rank's block of each leaf, joined
    along `dim` in rank order (one all-gather). Each rank passes leaves of
    the same shapes."""
    leaves, rebuild = _flatten(tree)
    n = mesh.size()
    if n == 1:
        return tree
    group = mesh.get_group()
    moved = [x.movedim(dim, 0) for x in leaves]
    buf = _to_bytes(moved, _comm_device(group))
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    blocks = [_from_bytes(p, moved) for p in parts]
    return rebuild([torch.cat([b[i] for b in blocks]).movedim(0, dim)
                    for i in range(len(leaves))])


def all_reduce_sum_(x: torch.Tensor, mesh) -> torch.Tensor:
    """In-place sum of `x` over the ranks (on the host for gloo)."""
    group = mesh.get_group()
    dev = _comm_device(group)
    y = x if x.device == dev else x.to(dev)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    if y is not x:
        x.copy_(y)
    return x


def all_ranks(flag: bool, mesh) -> bool:
    """True when `flag` holds on every rank (a host decision that all ranks
    must take alike, such as ending an episode)."""
    t = torch.tensor([0 if flag else 1], dtype=torch.int64)
    return int(all_reduce_sum_(t, mesh)) == 0
