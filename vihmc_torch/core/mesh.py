"""The ``('chains', 'data')`` mesh over ``torch.distributed`` ranks, the chain
axis of a sampler, and the data-parallel likelihood.

In the JAX package a ``jax.sharding.Mesh`` lays the chain axis of a vmapped
sampler over devices and GSPMD turns every cross-chain reduction and every
sum over a sharded data axis into a collective. PyTorch has no such
compiler, so each coupling is an explicit collective here:

* the mesh is ``torch.distributed.device_mesh.DeviceMesh``, a grid of
  process ranks ``(n_chains, n_data)`` named ``('chains', 'data')``
  (:func:`~vihmc_torch.chains.make_chain_mesh`): ``get_group('chains')``
  holds the ranks that share this rank's data coordinate and split the
  chains, ``get_group('data')`` those that share its chains and split the
  data. With no process group up the mesh is :class:`TrivialMesh`, the
  1 x 1 mesh, whose collectives are no-ops.
* :class:`ChainAxis` is what a sampler sees of the chain axis: ``total``
  chains, of which this rank holds the rows ``[start, start + n_local)``;
  :meth:`ChainAxis.sum` and :meth:`ChainAxis.mean` reduce over dim 0 and
  all-reduce over the ``'chains'`` group (the coupled dual averaging, the
  pooled Welford metric, ChEES's cross-chain means), and
  :meth:`ChainAxis.local` keeps this rank's rows of a ``(total, ...)``
  block. Every sampler draws the whole block of a transition's random
  numbers from its one generator and keeps its rows, so a seed gives the
  same chains on one rank and on N.
* :func:`data_parallel_ll` is the likelihood over a ``'data'``-sharded
  batch. A closure over a local shard computes a partial sum; the global
  sum and its gradient need the tensor-parallel pair of autograd functions:
  the parameters enter through "copy" (forward identity, backward
  all-reduce) and the partial sum leaves through "reduce" (forward
  all-reduce, backward identity). A prior added outside counts once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_AXES = ("chains", "data")


class TrivialMesh:
    """The 1 x 1 ``('chains', 'data')`` mesh of a process with no process
    group: the part of ``DeviceMesh``'s interface the port reads, with no
    group to reduce over."""

    shape = (1, 1)
    mesh = torch.zeros((1, 1), dtype=torch.int)

    def get_group(self, mesh_dim=None):
        return None

    def get_rank(self) -> int:
        return 0

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def __repr__(self):
        return "TrivialMesh(shape=(1, 1), mesh_dim_names=('chains', 'data'))"


Mesh = Union[DeviceMesh, TrivialMesh]


def axis_size(mesh: Optional[Mesh], name: str) -> int:
    """The number of shards along the mesh axis ``name`` (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape[MESH_AXES.index(name)])


def axis_group(mesh: Optional[Mesh], name: str):
    """The process group of this rank's line along ``name``; None without a
    mesh or on the trivial mesh (nothing to reduce over)."""
    return None if mesh is None else mesh.get_group(name)


def mesh_shape(mesh: Optional[Mesh]) -> dict:
    """``{'chains': n, 'data': m}``, as JAX's ``Mesh.shape`` reads."""
    return {name: axis_size(mesh, name) for name in MESH_AXES}


class ChainAxis:
    """The chain axis of a sampler: ``total`` chains over ``n_shards``
    ``'chains'`` shards, this rank holding shard ``index`` (see the module
    doc). ``group`` None: one process, no collective."""

    def __init__(self, total: int, group=None, n_shards: int = 1, index: int = 0):
        if total % n_shards:
            raise ValueError(f"{total} chains cannot be sharded evenly over {n_shards} "
                             f"'chains' shards")
        self.total = int(total)
        self.group = group
        self.n_local = self.total // n_shards
        self.start = index * self.n_local

    @property
    def count(self) -> int:
        """The number of chains a reduction runs over (all shards)."""
        return self.total

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x.sum(0)`` over every shard's chains."""
        s = x.sum(0)
        if self.group is not None:
            dist.all_reduce(s.reshape(-1), group=self.group)
        return s

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over every shard's chains, ``sum / total``."""
        return self.sum(x) / self.total

    def local(self, x):
        """This rank's rows of a chain-major ``(total, ...)`` tensor; tuples,
        lists, dicts and dataclasses (a transition's noise) are mapped, other
        values returned as they are."""
        if self.n_local == self.total or x is None:
            return x
        if isinstance(x, torch.Tensor):
            return x[self.start:self.start + self.n_local]
        if isinstance(x, np.ndarray):
            return x[self.start:self.start + self.n_local]
        if isinstance(x, (tuple, list)):
            return type(x)(self.local(v) for v in x)
        if isinstance(x, dict):
            return {k: self.local(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: self.local(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x


def chain_axis(mesh: Optional[Mesh], total: int) -> ChainAxis:
    """The chain axis of ``total`` chains split over ``mesh``'s ``'chains'``
    shards (the one-process axis without a mesh)."""
    if mesh is None:
        return ChainAxis(total)
    return ChainAxis(total, axis_group(mesh, "chains"), axis_size(mesh, "chains"),
                     mesh.get_local_rank("chains"))


def _collective_device(group):
    """Where a host array goes for a collective: the card under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(group, x):
    """Concatenate every rank's ``x`` (a tensor or a numpy array, the same
    shape on every rank of ``group``) along dim 0, in rank order."""
    if group is None:
        return x
    if isinstance(x, np.ndarray):
        dtype = x.dtype
        t = torch.from_numpy(np.ascontiguousarray(x.astype(np.uint8) if dtype == bool else x))
        out = all_gather_rows(group, t.to(_collective_device(group)))
        out = out.cpu().numpy()
        return out.astype(bool) if dtype == bool else out
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)


class _CopyToGroup(torch.autograd.Function):
    """Forward identity; backward all-reduces the gradient over ``group``
    (through :class:`_ReduceFromGroup`, so a double backward -- a
    Hessian-vector product -- sums over the group again)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromGroup.apply(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward all-reduces (sums) over ``group``; backward identity (through
    :class:`_CopyToGroup`, the adjoint pair)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _CopyToGroup.apply(grad, ctx.group), None


def data_parallel_ll(mesh: Optional[Mesh], ll_fn: Callable) -> Callable:
    """``ll(q, *args)``: ``ll_fn`` on this rank's ``'data'`` shard, summed
    over the shards, with the gradient of the global sum (module doc).
    ``ll_fn(q, *args) -> (C,)`` must be a sum over the sharded batch (a
    prior belongs outside, added once). ``ll_fn`` itself on a mesh with one
    data shard."""
    group = axis_group(mesh, "data")
    if group is None or axis_size(mesh, "data") == 1:
        return ll_fn

    def ll(q, *args):
        return _ReduceFromGroup.apply(ll_fn(_CopyToGroup.apply(q, group), *args), group)

    return ll


def data_parallel_grad(mesh: Optional[Mesh], grad_fn: Callable) -> Callable:
    """An explicit likelihood gradient on this rank's ``'data'`` shard
    (``grad_fn(q, *args) -> (C, d)``, e.g. a Gram field without its prior),
    all-reduced over the shards."""
    group = axis_group(mesh, "data")
    if group is None or axis_size(mesh, "data") == 1:
        return grad_fn

    def grad(q, *args):
        g = grad_fn(q, *args).contiguous().clone()
        dist.all_reduce(g, group=group)
        return g

    return grad


def is_lead(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes a mesh run's files: the mesh's first rank
    (every process without a mesh)."""
    return mesh is None or mesh.get_rank() == int(mesh.mesh.flatten()[0])
