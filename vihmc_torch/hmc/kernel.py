"""The HMC transition of the operator row, chain-batched.

Counterpart of ``vihmc_tpu/hmc/kernel.py`` restricted to the paths the
operator recipe takes (``bench.py`` coupled recipe, :663-683):

* a gradient-only leapfrog trajectory on ``grad_fn`` (the clipped Gram field)
  and the PAIRED MH delta ``delta_fn`` -- no density recompute at q0
  (kernel.py:507-515);
* ``sampler='hmc_nuts'`` dual averaging with ``adapt_forever``: the adapting
  iterate is used at every draw and updated at every draw;
* coupled adaptation (``da_axis='chains'``): the accept statistic is the mean
  over the chain dimension (kernel.py:683-687), so all chains share one step;
* ``jitter_eps``: the step is scaled per chain by ``U[low, 1]`` with
  ``low = max(jitter_low_frac, 1/L)`` (kernel.py:549-552);
* a fixed metric (diagonal inverse mass or :class:`LowRankMetric`);
* the NaN-safe accept (kernel.py:641-655).

The transition takes its random numbers as tensors (:class:`TransitionNoise`):
the caller draws them from its ``torch.Generator`` (:func:`draw_noise`), and a
test can inject the JAX sampler's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from vihmc_torch.hmc.adaptation import DualAveragingState, da_init, da_update
from vihmc_torch.hmc.integrators import leapfrog_grad_only
from vihmc_torch.hmc.metric import (mass_kinetic_energy, mass_sample_momentum,
                                    momentum_normals_shape)

#: log-Hamiltonian error below which a transition counts as divergent
DIVERGENCE_THRESHOLD = -1000.0


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """The recipe's sampler settings (see module doc for the fixed paths)."""

    num_samples: int = 100
    num_leapfrog: int = 10
    step_size: float = 0.1
    target_accept: float = 0.8
    jitter_low_frac: float = 0.5


@dataclasses.dataclass
class HMCState:
    position: torch.Tensor          # (C, d)
    log_prob: torch.Tensor          # (C,)
    grad: torch.Tensor              # (C, d) -- the trajectory field at position
    da: DualAveragingState          # fields (C,)
    aux: torch.Tensor               # (D,) frozen full vector, shared


@dataclasses.dataclass
class TransitionNoise:
    """Every random number of one transition."""

    z1: torch.Tensor                # (C, d) momentum normals
    z2: Optional[torch.Tensor]      # (C, k) low-rank momentum normals, or None
    u_jitter: torch.Tensor          # (C,) U[0, 1) for the step jitter
    u_accept: torch.Tensor          # (C,) U[0, 1) for the MH test


def draw_noise(generator: torch.Generator, inv_mass, n_chains: int, dim: int,
               device) -> TransitionNoise:
    s1, s2 = momentum_normals_shape(inv_mass, n_chains, dim)
    z1 = torch.randn(s1, generator=generator, device=device)
    z2 = None if s2 is None else torch.randn(s2, generator=generator, device=device)
    u = torch.rand((2, n_chains), generator=generator, device=device)
    return TransitionNoise(z1=z1, z2=z2, u_jitter=u[0], u_accept=u[1])


def init_state(log_prob_fn: Callable, position: torch.Tensor,
               config: HMCConfig, aux: torch.Tensor,
               grad_fn: Callable) -> HMCState:
    """Exact log-density and the trajectory field at the initial positions."""
    c = position.shape[0]
    return HMCState(position=position, log_prob=log_prob_fn(position, aux),
                    grad=grad_fn(position, aux),
                    da=da_init(config.step_size, shape=(c,), device=position.device),
                    aux=aux)


def clipped_grad_fn(base: Callable, max_norm: float, inv_mass=1.0) -> Callable:
    """Per-chain preconditioned norm clip of a gradient field: ``g`` where
    ``sqrt(sum inv_mass g^2) <= max_norm``, rescaled to that norm beyond.
    ``inv_mass`` is the DIAGONAL inverse mass (the recipe passes the Laplace
    diagonal, not the low-rank metric)."""

    def gfn(q, aux):
        g = base(q, aux)
        norm = torch.sqrt((inv_mass * g * g).sum(-1, keepdim=True))
        return g * torch.clamp(max_norm / (norm + 1e-30), max=1.0)

    return gfn


def make_kernel(config: HMCConfig, inv_mass, grad_fn: Callable,
                delta_fn: Callable):
    """``kernel(state, noise) -> (state, info)`` for all chains at once.

    ``grad_fn(q (C, d), aux) -> (C, d)``; ``delta_fn(q1, q0, aux) ->
    (log p(q1) - log p(q0), log p(q1))``, each ``(C,)``.
    """
    n_lf = config.num_leapfrog
    low = min(max(config.jitter_low_frac, 1.0 / max(n_lf, 1)), 1.0)

    def kernel(state: HMCState, noise: TransitionNoise):
        aux = state.aux
        q0, g0, lp0 = state.position, state.grad, state.log_prob
        eps = torch.exp(state.da.log_step) * (noise.u_jitter * (1.0 - low) + low)

        p0 = mass_sample_momentum(inv_mass, noise.z1, noise.z2)
        ke0 = mass_kinetic_energy(inv_mass, p0)
        q1, p1, g1 = leapfrog_grad_only(lambda q: grad_fn(q, aux), q0, p0, g0,
                                        eps, n_lf, inv_mass)
        ke1 = mass_kinetic_energy(inv_mass, p1)

        dlp, lp1 = delta_fn(q1, q0, aux)
        delta = dlp - (ke1 - ke0)
        finite = torch.isfinite(delta)
        accept_prob = torch.where(
            finite, torch.clamp(torch.exp(torch.clamp(delta, max=0.0)), max=1.0),
            torch.zeros_like(delta))
        accept = finite & (torch.log(noise.u_accept) < delta)
        divergent = ~finite | (delta < DIVERGENCE_THRESHOLD)

        keep = accept[:, None]
        stat = accept_prob.mean().expand_as(accept_prob)  # coupled over chains
        new_state = HMCState(
            position=torch.where(keep, q1, q0),
            log_prob=torch.where(accept, lp1, lp0),
            grad=torch.where(keep, g1, g0),
            da=da_update(state.da, stat, config.target_accept),
            aux=aux)
        info = {"accept_prob": accept_prob, "accepted": accept,
                "step_size": eps, "divergent": divergent,
                "log_prob": new_state.log_prob}
        return new_state, info

    return kernel
