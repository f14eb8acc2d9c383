"""Multi-chain sampling: chains are the batch axis of one device, and a
``('chains', 'data')`` mesh of processes splits them over ranks.

Counterpart of ``vihmc_tpu/chains/parallel.py``: ``make_chain_mesh``,
``shard_batch`` and ``shard_query`` (:30-69), and ``sample_chains``,
``ChainSampler``, ``sample_chains_nuts`` and ``sample_chains_chees``
(:107-254). On one device every transition advances all C chains in one
call. Each chain keeps its own dual averaging unless the config couples it
(``da_axis='chains'``); ChEES couples the chains by construction. The random
numbers come from the generator streams of ``seed`` (JAX folds the chain
index into its key; the streams cannot be replayed across the two).

With ``mesh=`` (a ``DeviceMesh`` built by :func:`make_chain_mesh` over
``torch.distributed`` ranks) each rank runs its
C/N rows of the chains, every coupling of the chains all-reduces over the
``'chains'`` group, and the result holds this rank's rows, as a
multi-process JAX array holds its addressable shard; :func:`gather_chains`
collects them on every rank (``process_allgather`` in JAX). Each rank
draws every transition's random block for all C chains and keeps its rows,
so a seed gives the same chains on 1 rank and on N. The chain count must
divide by the ``'chains'`` shards. Data sharded over ``'data'``
(:func:`shard_batch`, :func:`shard_query`) needs its likelihood wrapped in
:func:`~vihmc_torch.core.mesh.data_parallel_ll`: where GSPMD sums a closure
over sharded arrays across the devices, a closure over a local shard sums
only that shard.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core.mesh import (MESH_AXES, Mesh, TrivialMesh, all_gather_rows, axis_group,
                                   axis_size)
from vihmc_torch.hmc.chees import ChEESConfig, chees_sample
from vihmc_torch.hmc.kernel import HMCConfig, SampleResult, normalize_log_prob
from vihmc_torch.hmc.metric import EigenMetric, LowRankMetric, as_inv_mass
from vihmc_torch.hmc.nuts import NUTSConfig, nuts_sample


def make_chain_mesh(n_chain_shards: Optional[int] = None, n_data_shards: int = 1,
                    devices=None) -> Mesh:
    """Build a ``('chains', 'data')`` ``DeviceMesh`` over the process ranks
    ``devices`` (default: every rank of the process group; JAX takes a list
    of devices). ``n_chain_shards`` defaults to the ranks over
    ``n_data_shards``; the first ``n_chain_shards x n_data_shards`` ranks
    are used, row-major. The mesh's device type is ``'cuda'`` under NCCL and
    ``'cpu'`` otherwise (gloo's collectives take tensors on either). With no
    process group up it is the trivial 1 x 1 mesh, whose collectives are
    no-ops, so ``sample_chains(mesh=make_chain_mesh())`` is
    ``sample_chains()``. Collective over the world: every rank calls it."""
    up = dist.is_available() and dist.is_initialized()
    ranks = np.asarray(list(range(dist.get_world_size() if up else 1)) if devices is None
                       else list(devices), np.int64)
    if n_chain_shards is None:
        n_chain_shards = ranks.size // n_data_shards
    n = n_chain_shards * n_data_shards
    if n < 1 or n > ranks.size:
        raise ValueError(f"a {n_chain_shards} x {n_data_shards} mesh needs {n} ranks; "
                         f"{ranks.size} available")
    if not up:
        return TrivialMesh()
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.as_tensor(ranks[:n]).reshape(n_chain_shards, n_data_shards),
                      mesh_dim_names=MESH_AXES)


def _data_shard(mesh: Mesh, x, axis: int):
    n, j = axis_size(mesh, "data"), mesh.get_local_rank("data")
    if n == 1:
        return x
    if isinstance(x, torch.Tensor):
        return torch.tensor_split(x, n, dim=axis)[j].contiguous()
    return np.ascontiguousarray(np.array_split(np.asarray(x), n, axis=axis)[j])


def shard_batch(mesh: Mesh, tree, axis: int = 0):
    """This rank's slice of every tensor (or array) of ``tree`` along
    ``axis``, split over the ``'data'`` mesh axis (replicated over
    ``'chains'``); shards may be uneven (``torch.tensor_split``). A
    likelihood summed over this axis must go through
    :func:`~vihmc_torch.core.mesh.data_parallel_ll`."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(mesh, v, axis) for v in tree)
    return _data_shard(mesh, tree, axis)


def shard_query(mesh: Mesh, trunk_x, y):
    """Shard the DeepONet query (trunk) axis over ``'data'``: ``trunk_x``
    ``(P, coords)`` along axis 0 and ``y`` ``(B, P)`` along axis 1, this
    rank's slices (the function axis stays whole). The likelihood over them
    goes through :func:`~vihmc_torch.core.mesh.data_parallel_ll`."""
    return _data_shard(mesh, trunk_x, 0), _data_shard(mesh, y, 1)


def _gather_blocks(group, x, n_local: int):
    """``x`` with every per-chain block gathered over ``group``: a tensor or
    array of two or more axes whose first holds the ``n_local`` chains
    (``(C, S, ...)`` draws, REFRESH frozen vectors, index sets); dicts are
    mapped; per-draw ``(S,)`` arrays and shared ``(D,)`` vectors stay."""
    if isinstance(x, dict):
        return {k: _gather_blocks(group, v, n_local) for k, v in x.items()}
    if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 2 and x.shape[0] == n_local:
        return all_gather_rows(group, x)
    return x


def _gather_state(group, state, n_local: int):
    """A sampler state with its per-chain tensors gathered over ``group``:
    every field whose first axis holds the ``n_local`` chains (``(C,)``
    included: log densities, dual-averaging fields), nested states mapped,
    ``aux`` by :func:`_gather_blocks` (a shared ``(D,)`` frozen vector stays)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "aux":
            v = _gather_blocks(group, v, n_local)
        elif isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n_local:
            v = all_gather_rows(group, v)
        elif dataclasses.is_dataclass(v):
            v = _gather_state(group, v, n_local)
        out[f.name] = v
    return dataclasses.replace(state, **out)


def gather_chains(mesh: Optional[Mesh], result: SampleResult) -> SampleResult:
    """The whole chain axis of a mesh run's ``result`` on every rank: the
    per-chain arrays (``(C/N, ...)`` on each rank) and the final state's
    per-chain tensors all-gathered over ``'chains'``, in chain order; per-draw
    arrays shared by the chains (ChEES's ``step_sizes``) stay as they are.
    The result itself without a mesh."""
    group = axis_group(mesh, "chains")
    if group is None or axis_size(mesh, "chains") == 1:
        return result
    n_local = result.samples.shape[0]
    arrays = {f: _gather_blocks(group, getattr(result, f), n_local)
              for f in ("samples", "log_probs", "accept_probs", "accepted", "step_sizes",
                        "divergent", "aux_trace")}
    return dataclasses.replace(result, final_state=_gather_state(group, result.final_state,
                                                                 n_local), **arrays)


def sample_chains(log_prob_fn: Callable, init_positions: torch.Tensor, config: HMCConfig,
                  inv_mass=1.0, aux=None, aux_refresh: Optional[Callable] = None,
                  shard_log_prob_fn: Optional[Callable] = None, shard_data=None,
                  grad_fn: Optional[Callable] = None, delta_fn: Optional[Callable] = None,
                  seed: int = 0, mesh: Optional[Mesh] = None) -> SampleResult:
    """Run the ``(C, d)`` chains ``init_positions`` for ``config.num_samples``
    draws in one call; result arrays ``(C, S, ...)``, every draw kept. On a
    ``mesh`` this rank runs, and the result holds, its ``C/N`` rows (module
    doc)."""
    inv_mass = as_inv_mass(inv_mass, init_positions.device)
    return sample_chains_resumable(
        normalize_log_prob(log_prob_fn), init_positions, config, config.num_samples,
        inv_mass, aux, grad_fn=normalize_log_prob(grad_fn), delta_fn=delta_fn, seed=seed,
        aux_refresh=aux_refresh, shard_log_prob_fn=shard_log_prob_fn,
        shard_data=shard_data, mesh=mesh)


class ChainSampler:
    """A sampler handle bound to one posterior, config and set of hooks
    (the JAX handle owns one compiled program; here it only keeps the
    arguments):

        sampler = ChainSampler(log_prob, config, aux_refresh=refresh)
        res1 = sampler(1, inits, inv_mass=m, aux=aux0)
    """

    def __init__(self, log_prob_fn: Callable, config: HMCConfig,
                 aux_refresh: Optional[Callable] = None,
                 shard_log_prob_fn: Optional[Callable] = None,
                 grad_fn: Optional[Callable] = None, delta_fn: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None):
        self.config = config
        self._kw = dict(aux_refresh=aux_refresh, shard_log_prob_fn=shard_log_prob_fn,
                        grad_fn=grad_fn, delta_fn=delta_fn, mesh=mesh)
        self._log_prob_fn = log_prob_fn

    def __call__(self, seed: int, init_positions: torch.Tensor, inv_mass=1.0, aux=None,
                 shard_data=None) -> SampleResult:
        return sample_chains(self._log_prob_fn, init_positions, self.config,
                             inv_mass=inv_mass, aux=aux, shard_data=shard_data, seed=seed,
                             **self._kw)


def _diagonal_only(inv_mass):
    if isinstance(inv_mass, (LowRankMetric, EigenMetric)):
        raise TypeError("structured metrics are supported by the HMC kernel only "
                        "(sample_chains); NUTS/ChEES take diagonal metrics")


def sample_chains_nuts(log_prob_fn: Callable, init_positions: torch.Tensor,
                       config: NUTSConfig, inv_mass=1.0, aux=None,
                       aux_refresh: Optional[Callable] = None,
                       grad_fn: Optional[Callable] = None, seed: int = 0, thin: int = 1,
                       segment_size: Optional[int] = None,
                       progress: Optional[Callable] = None,
                       aux_draw: Optional[Callable] = None,
                       mesh: Optional[Mesh] = None) -> SampleResult:
    """Multi-chain NUTS (:func:`~vihmc_torch.hmc.nuts.nuts_sample`, batched;
    on a ``mesh`` this rank's rows)."""
    _diagonal_only(inv_mass)
    return nuts_sample(log_prob_fn, init_positions, config,
                       inv_mass=as_inv_mass(inv_mass, init_positions.device), aux=aux,
                       aux_refresh=aux_refresh, grad_fn=grad_fn, seed=seed, thin=thin,
                       segment_size=segment_size, progress=progress,
                       aux_draw=aux_draw, mesh=mesh)


def sample_chains_chees(log_prob_fn: Callable, init_positions: torch.Tensor,
                        config: ChEESConfig, inv_mass=1.0, aux=None,
                        aux_refresh: Optional[Callable] = None,
                        grad_fn: Optional[Callable] = None, seed: int = 0, thin: int = 1,
                        segment_size: Optional[int] = None,
                        progress: Optional[Callable] = None,
                        aux_draw: Optional[Callable] = None,
                        mesh: Optional[Mesh] = None) -> SampleResult:
    """Multi-chain ChEES-HMC: the chains are coupled through the shared step
    and trajectory length (on a ``mesh`` through collectives over its
    ``'chains'`` shards). ``aux`` is shared (JAX tiles it over the chains,
    which evaluates the same density)."""
    _diagonal_only(inv_mass)
    return chees_sample(log_prob_fn, init_positions, config, inv_mass=inv_mass, aux=aux,
                        aux_refresh=aux_refresh, grad_fn=grad_fn, seed=seed, thin=thin,
                        segment_size=segment_size, progress=progress,
                        aux_draw=aux_draw, mesh=mesh)
