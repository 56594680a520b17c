"""Data parallel over ranks (counterpart of the JAX ``parallel/mesh.py``).

The JAX package runs one process per host and one SPMD program over a device
mesh: batches are sharded on the 'data' axis, parameters replicated, and every
loss, normalizer and metric is computed over the GLOBAL batch, with XLA inserting
the gradient all-reduce. The reference (and this port) runs one process per card,
a rank, each holding 1/W of the global batch (``pt/engine/trainer.py:92-95``).
To give the JAX result, a step over W ranks:

- sums every data-dependent count behind a loss normalizer or a metric over the
  ranks before it is used (:func:`global_sum`, active inside
  :func:`global_counts`), so that each rank's loss is its share of the global
  loss and each metric its share of the global value;
- sums the gradients (:func:`all_reduce_grads`, no 1/W): the sum of the shares'
  gradients is the global loss's gradient, which the optimizer then clips as the
  JAX package clips the global one;
- sums the metrics' shares only at the writer's cadence (:func:`all_reduce_sum`).

Averaging per-rank gradients of per-rank normalized losses, as a plain DDP wrapper
would, gives (1/W) sum_r grad(S_r) / N_r instead of grad(sum_r S_r) / sum_r N_r:
the two differ as soon as the ranks' counts differ, which pseudo-labels make the
rule.

The collectives are NCCL's on the card and gloo's on the CPU, as XLA's are the
JAX package's. A world of one has no process group and does no collective: every
function here is then the identity.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..structures import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[object] = None      # the process group; None in a world of one
    backend: Optional[str] = None

    @property
    def distributed(self) -> bool:
        return self.world_size > 1


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def make_mesh(device=None, backend: Optional[str] = None,
              world_size: Optional[int] = None) -> Mesh:
    """Join the data-parallel group of the launcher's environment.

    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` come
    from ``torchrun`` or from the CLI's ``--num-gpus`` launch; without them the world
    is one process. ``device`` is the card unless the caller names the CPU; a rank on
    the card takes card ``LOCAL_RANK``. The backend is NCCL on the card and gloo on
    the CPU; ``backend`` overrides it (gloo lets two ranks share one card). A
    ``world_size`` below the environment's runs a subset: the first ``world_size``
    ranks form the group (``PARALLEL.ALLOW_DEVICE_SUBSET``).
    """
    dev = resolve_device(device)
    world = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    rank = _env_int("RANK", 0)
    if rank >= world:
        raise ValueError(f"rank {rank} is outside the {world}-rank group")
    if world == 1:
        return Mesh(0, 1, dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int("LOCAL_RANK", rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    if dist.get_world_size() != world or dist.get_rank() != rank:
        raise RuntimeError(f"the process group is rank {dist.get_rank()} of "
                           f"{dist.get_world_size()}, not rank {rank} of {world}")
    return Mesh(rank, world, dev, dist.group.WORLD, dist.get_backend())


def process_index() -> int:
    """This process's rank in the default group (0 without one): the rank that
    writes files."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


# ---------------------------------------------------------------- data and state
def _tree_map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a global batch: rows [rank n, (rank + 1) n) of every
    tensor or array leaf, n = rows / world size."""
    if not mesh.distributed:
        return tree

    def take(x):
        if x.shape[0] % mesh.world_size:
            raise ValueError(f"{x.shape[0]} rows do not split over {mesh.world_size} ranks")
        n = x.shape[0] // mesh.world_size
        return x[mesh.rank * n:(mesh.rank + 1) * n]

    return _tree_map(take, tree)


def _state_tensors(obj) -> List[torch.Tensor]:
    """The tensors a replica holds: a module's parameters and buffers, or a train
    state's student, teacher and momentum traces."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.state_dict().values())
    out = _state_tensors(obj.student) + _state_tensors(obj.teacher)
    opt = obj.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            out.extend(v for v in opt.state.get(p, {}).values() if torch.is_tensor(v))
    return out


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    """Apply ``op`` to one flat buffer per dtype and copy the result back in place."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        for t, chunk in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(chunk.view_as(t))


@torch.no_grad()
def replicate(mesh: Mesh, obj):
    """Broadcast rank 0's parameters and buffers (and a train state's momentum) to
    every rank, in place; returns ``obj``."""
    if mesh.distributed:
        _flat_collective(_state_tensors(obj), lambda t: dist.broadcast(t, 0, group=mesh.group))
    return obj


@torch.no_grad()
def all_reduce_grads(mesh: Mesh, params: Iterable[torch.Tensor]) -> None:
    """Sum every parameter's gradient over the ranks, in place. A parameter with no
    gradient gets a zero one first, so every rank reduces the same buffer."""
    if not mesh.distributed:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _flat_collective([p.grad for p in params],
                     lambda t: dist.all_reduce(t, group=mesh.group))


# ---------------------------------------------------------------- scalars
def host_max(mesh: Mesh, value: float) -> float:
    """Max of a host scalar over the ranks (the reference reduces ``data_time`` so,
    ``pt/engine/trainer.py:403-411``); a tensor on the group's device, as NCCL needs."""
    if not mesh.distributed:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t.item())


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the ranks, as a new tensor (the metrics' shares)."""
    if not mesh.distributed:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.group)
    return x


def broadcast_values(mesh: Mesh, values: Sequence[float]) -> List[float]:
    """Rank 0's ``values`` on every rank (a decision only rank 0 can make)."""
    if not mesh.distributed:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, 0, group=mesh.group)
    return t.tolist()


# ---------------------------------------------------------------- normalizers
_COUNTS: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("global_counts",
                                                                         default=None)


@contextlib.contextmanager
def global_counts(mesh: Optional[Mesh]):
    """Within this block, :func:`global_sum` sums over ``mesh``'s ranks: the train
    steps run their losses in it. Outside it (evaluation, a validation loss on rank 0
    alone) every count is the rank's own and no collective runs."""
    token = _COUNTS.set(mesh)
    try:
        yield
    finally:
        _COUNTS.reset(token)


def global_sum(x):
    """A count behind a loss normalizer or a metric, summed over the ranks of the
    enclosing :func:`global_counts` (the identity outside one, or in a world of one).

    A tensor is all-reduced; an ``int`` is a static row count, equal on every rank
    (the batch splits evenly), so it is multiplied by the world size.
    """
    mesh = _COUNTS.get()
    if mesh is None or not mesh.distributed:
        return x
    if isinstance(x, int):
        return x * mesh.world_size
    return all_reduce_sum(mesh, x)
