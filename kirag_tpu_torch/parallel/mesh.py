"""Device mesh and the collectives of the port (port of
:mod:`kirag_tpu.parallel.mesh`).

The reference builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. Here the programming model is SPMD over ``torch.distributed``:
one process a rank, one device a rank, every rank running the same program on
the same inputs. A rank holds its own shard as a plain tensor, and every
collective is an explicit call of this module (NCCL on CUDA devices, gloo on
the CPU). On the H100 machine's torch 2.11, gloo takes every collective used
here on CUDA tensors too (``tools/probe_gloo_cuda.py``: all_gather,
all_reduce and broadcast, f32 and bf16), copying them through host memory
itself, so no collective here depends on the backend.

:func:`create_mesh` lays the world's ranks out as the reference lays its
devices out (``np.asarray(devices).reshape(data, model)``): rank ``r`` sits at
data index ``r // model`` and model index ``r % model``. Each axis has one
process group per line of the grid along it: the ranks that differ only in
that axis's index, in index order, so that a group's rank order is the axis
order.

Axes:

- ``data``: the corpus-row sharding of the index, and data parallelism of
  training (each rank its rows of the batch);
- ``model``: tensor parallelism of the LLM's and the encoder's weights.

Training differentiates through three of the collectives, each a
``torch.autograd.Function`` whose backward is the collective the program
needs (every rank of a group computes the same loss):

- :func:`all_gather_rows`: the group's rows concatenated; backward, this
  rank's rows of the incoming gradient (no collective: a sum over the group,
  as ``torch.distributed.nn.functional.all_gather`` takes, would count each
  gradient once a rank);
- :func:`copy_to_model` (identity; backward, the sum over the model axis) in
  front of a column-parallel projection, and :func:`reduce_from_model` (the
  sum; backward, identity) after a row-parallel one: Megatron's pair.

Unlike the reference, a mesh must cover the whole world: a process cannot
sit out a collective, so ``data * model != world size`` raises ValueError.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"


AXES = MeshAxes()


class Mesh:
    """A row-major grid of the world's ranks with named axes.

    ``shape`` maps each axis name to its size, ``coords`` to this rank's index
    along it; :meth:`group` is this rank's process group along an axis (None
    when no process group is initialized: one process, every collective the
    identity)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        world = dist.get_world_size() if dist.is_initialized() else 1
        size = int(np.prod(sizes))
        if size != world:
            raise ValueError(f"a mesh of {dict(self.shape)} needs {size} ranks, the world has "
                             f"{world}: every rank must be in the mesh (a process cannot "
                             "sit out a collective)")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        grid = np.arange(size).reshape(tuple(sizes))
        self.devices = grid  # the reference's device grid, of ranks
        self.coords: Dict[str, int] = {
            name: int(c) for name, c in zip(self.axis_names,
                                            np.unravel_index(self.rank, tuple(sizes)))}
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        self._ranks: Dict[str, List[int]] = {}
        for a, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, self.shape[name])
            for line in lines:
                ranks = [int(r) for r in line]
                # every rank creates every group, in the same order
                group = dist.new_group(ranks) if dist.is_initialized() else None
                if self.rank in ranks:
                    self._groups[name], self._ranks[name] = group, ranks

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis`` (JAX's ``axis_index``)."""
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self._groups[axis]

    def group_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's group along ``axis``, in axis order."""
        return list(self._ranks[axis])


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None, init_method: Optional[str] = None,
                     timeout_s: float = 600.0) -> Optional[torch.device]:
    """Join the process group (counterpart of ``jax.distributed.initialize``).

    The world size, rank and rendezvous come from the arguments, or else
    from torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``). A world of one process is a no-op
    (None is returned); so is a second call. Otherwise returns the rank's
    device: ``cuda:LOCAL_RANK`` (made current) when a GPU is there, else the
    CPU. ``backend`` defaults to NCCL for a CUDA device and gloo for the CPU.
    ``init_method`` overrides the rendezvous (e.g. ``file://...``)."""
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    rank = int(process_id if process_id is not None else os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", rank if num_processes is not None else 0))
    if torch.cuda.is_available():
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if dist.is_initialized():
        return device
    if init_method is None:
        init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return device


def create_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A 2-D ``(data, model)`` mesh over the world's ranks; ``data=None``
    takes every rank that ``model`` leaves. Raises ValueError unless
    ``data * model`` is the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if world % model != 0:
            raise ValueError(f"model axis size {model} does not divide the world size {world}")
        data = world // model
    return Mesh((AXES.data, AXES.model), (data, model))


def local_mesh_1d(axis: str = AXES.data) -> Mesh:
    """A 1-D mesh over every rank, for single-axis programs."""
    return Mesh((axis,), (dist.get_world_size() if dist.is_initialized() else 1,))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_range(n_rows: int, mesh: Mesh, axis: str = AXES.data) -> Tuple[int, int]:
    """``(start, stop)`` of this rank's rows of ``n_rows`` sharded over
    ``axis`` (``PartitionSpec(axis)``); ``n_rows`` must divide evenly."""
    shards = mesh.size(axis)
    if n_rows % shards:
        raise ValueError(f"{n_rows} rows do not divide the {axis} axis's {shards} shards")
    per = n_rows // shards
    start = mesh.index(axis) * per
    return start, start + per


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = AXES.data) -> torch.Tensor:
    """This rank's rows of ``x`` sharded over ``axis`` (a view)."""
    start, stop = shard_range(x.shape[0], mesh, axis)
    return x[start:stop]


def all_gather_cols(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The group's tensors along ``axis`` concatenated along dim 1, in group
    order: JAX's ``all_gather(x, axis, axis=1, tiled=True)``. Every rank of
    the group calls it with a tensor of the same shape."""
    group = mesh.group(axis)
    if group is None:
        return x
    return torch.cat(all_gather_list(x, mesh, axis), dim=1)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of the group's tensors along ``axis``, on every rank of it
    (JAX's ``psum``); returns a new tensor."""
    group = mesh.group(axis)
    out = x.contiguous().clone()
    if group is None:
        return out
    dist.all_reduce(out, group=group)
    return out


def all_gather_list(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """The group's tensors along ``axis`` (each of ``x``'s shape), in group
    order."""
    group = mesh.group(axis)
    if group is None:
        return [x]
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    return parts


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.rows, ctx.start = x.shape[0], mesh.index(axis) * x.shape[0]
        return torch.cat(all_gather_list(x, mesh, axis))

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.start:ctx.start + ctx.rows], None, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The group's tensors along ``axis`` concatenated along dim 0, in group
    order (JAX's ``all_gather(x, axis, tiled=True)``). Differentiable: the
    gradient of ``x`` is this rank's rows of the result's gradient, since
    every rank of the group computes the same loss from the result."""
    return _GatherRows.apply(x, mesh, axis)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.mesh, ctx.axis), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` itself; in the backward, its gradient summed over ``axis``.
    Goes in front of a column-parallel projection: each rank's columns give
    a part of the input's gradient."""
    return _CopyToModel.apply(x, mesh, axis)


def reduce_from_model(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a row-parallel projection's partial
    products); in the backward, the gradient itself on every rank."""
    return _ReduceFromModel.apply(x, mesh, axis)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The model axis of a mesh that a model's weights are sharded over."""

    mesh: Any
    axis: str

    @property
    def size(self) -> int:
        return self.mesh.size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.index(self.axis)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """``x`` of the first rank of this rank's group along ``axis`` (of the
    whole mesh when None), on every rank of it; returns a new tensor."""
    out = x.contiguous().clone()
    if not dist.is_initialized():
        return out
    if axis is None:
        group, src = None, 0
    else:
        group, src = mesh.group(axis), mesh.group_ranks(axis)[0]
        if group is None:
            return out
    dist.broadcast(out, src=src, group=group)
    return out
