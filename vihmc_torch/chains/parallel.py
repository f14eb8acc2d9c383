"""Multi-chain sampling on one device: chains are the batch axis.

Counterpart of ``sample_chains``, ``ChainSampler``, ``sample_chains_nuts``
and ``sample_chains_chees`` of ``vihmc_tpu/chains/parallel.py`` (:107-254),
without the mesh: every transition advances all C chains in one call. Each
chain keeps its own dual averaging unless the config couples it
(``da_axis='chains'``); ChEES couples the chains by construction. The random
numbers come from the generator streams of ``seed`` (JAX folds the chain
index into its key; the streams cannot be replayed across the two).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.hmc.chees import ChEESConfig, chees_sample
from vihmc_torch.hmc.kernel import HMCConfig, SampleResult, normalize_log_prob
from vihmc_torch.hmc.metric import EigenMetric, LowRankMetric, as_inv_mass
from vihmc_torch.hmc.nuts import NUTSConfig, nuts_sample


def sample_chains(log_prob_fn: Callable, init_positions: torch.Tensor, config: HMCConfig,
                  inv_mass=1.0, aux=None, aux_refresh: Optional[Callable] = None,
                  shard_log_prob_fn: Optional[Callable] = None, shard_data=None,
                  grad_fn: Optional[Callable] = None, delta_fn: Optional[Callable] = None,
                  seed: int = 0) -> SampleResult:
    """Run the ``(C, d)`` chains ``init_positions`` for ``config.num_samples``
    draws in one call; result arrays ``(C, S, ...)``, every draw kept."""
    inv_mass = as_inv_mass(inv_mass, init_positions.device)
    return sample_chains_resumable(
        normalize_log_prob(log_prob_fn), init_positions, config, config.num_samples,
        inv_mass, aux, grad_fn=normalize_log_prob(grad_fn), delta_fn=delta_fn, seed=seed,
        aux_refresh=aux_refresh, shard_log_prob_fn=shard_log_prob_fn,
        shard_data=shard_data)


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
                 grad_fn: Optional[Callable] = None, delta_fn: Optional[Callable] = None):
        self.config = config
        self._kw = dict(aux_refresh=aux_refresh, shard_log_prob_fn=shard_log_prob_fn,
                        grad_fn=grad_fn, delta_fn=delta_fn)
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
                       aux_draw: Optional[Callable] = None) -> SampleResult:
    """Multi-chain NUTS (:func:`~vihmc_torch.hmc.nuts.nuts_sample`, batched)."""
    _diagonal_only(inv_mass)
    return nuts_sample(log_prob_fn, init_positions, config,
                       inv_mass=as_inv_mass(inv_mass, init_positions.device), aux=aux,
                       aux_refresh=aux_refresh, grad_fn=grad_fn, seed=seed, thin=thin,
                       segment_size=segment_size, progress=progress,
                       aux_draw=aux_draw)


def sample_chains_chees(log_prob_fn: Callable, init_positions: torch.Tensor,
                        config: ChEESConfig, inv_mass=1.0, aux=None,
                        aux_refresh: Optional[Callable] = None,
                        grad_fn: Optional[Callable] = None, seed: int = 0, thin: int = 1,
                        segment_size: Optional[int] = None,
                        progress: Optional[Callable] = None,
                        aux_draw: Optional[Callable] = None) -> SampleResult:
    """Multi-chain ChEES-HMC: the chains are coupled through the shared step
    and trajectory length. ``aux`` is shared (JAX tiles it over the chains,
    which evaluates the same density)."""
    _diagonal_only(inv_mass)
    return chees_sample(log_prob_fn, init_positions, config, inv_mass=inv_mass, aux=aux,
                        aux_refresh=aux_refresh, grad_fn=grad_fn, seed=seed, thin=thin,
                        segment_size=segment_size, progress=progress,
                        aux_draw=aux_draw)
