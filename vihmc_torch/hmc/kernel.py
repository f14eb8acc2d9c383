"""The HMC transition, chain-batched.

Counterpart of ``vihmc_tpu/hmc/kernel.py`` restricted to the paths the
operator row and the stage-3 operator pipeline take:

* the trajectory: gradient-only leapfrog on ``grad_fn`` (a Gram field or a
  clipped autodiff field), or, with no ``grad_fn``, value-and-grad leapfrog
  on autograd of ``log_prob_fn`` (integrators.py:27-50);
* the frozen-coordinate refresh (``aux_refresh``, kernel.py:497-506): before
  the draw each chain's frozen vector is redrawn (so ``aux`` becomes
  ``(C, D)``) and lp0 and the trajectory field at q0 are recomputed at it --
  that one density evaluation replaces the unpaired test's recompute below.
  JAX's ``refresh_during_burn=False`` is not ported (no pipeline sets it);
* the MH test: the PAIRED delta ``delta_fn`` with no density recompute at q0
  (kernel.py:507-515), or, with no ``delta_fn``, the unpaired test
  ``(lp1 - ke1) - (lp0 - ke0)`` with lp0 RECOMPUTED in every transition and
  never taken from the state (kernel.py:516-533: a cached value from another
  evaluation would enter every MH delta as a reduction-order offset);
* the step: ``sampler='hmc'``, a fixed ``step_size``; or ``'hmc_nuts'``, the
  operator recipe's dual averaging -- ``adapt_forever`` (the adapting iterate
  is used and updated at every draw) and coupled over chains
  (``da_axis='chains'``: the accept statistic is the chain mean,
  kernel.py:683-687, so all chains share one step). The other adaptation
  modes of the JAX kernel are not ported;
* ``jitter_eps``: the step is scaled per chain by ``U[low, 1]`` with
  ``low = max(jitter_low_frac, 1/L)`` (kernel.py:549-552);
* a fixed metric (scalar or diagonal inverse mass, or :class:`LowRankMetric`);
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
from vihmc_torch.hmc.integrators import leapfrog, leapfrog_grad_only
from vihmc_torch.hmc.metric import (mass_kinetic_energy, mass_sample_momentum,
                                    momentum_normals_shape)

#: log-Hamiltonian error below which a transition counts as divergent
DIVERGENCE_THRESHOLD = -1000.0


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """Sampler settings (see module doc for the ported paths). The defaults
    are the operator recipe's: coupled adapt-forever dual averaging with
    step jitter."""

    num_samples: int = 100
    num_leapfrog: int = 10
    step_size: float = 0.1
    target_accept: float = 0.8
    jitter_low_frac: float = 0.5
    sampler: str = "hmc_nuts"           # 'hmc_nuts' (dual averaging) | 'hmc' (fixed step)
    jitter_eps: bool = True


@dataclasses.dataclass
class HMCState:
    position: torch.Tensor          # (C, d)
    log_prob: torch.Tensor          # (C,)
    grad: torch.Tensor              # (C, d) -- the trajectory field at position
    da: DualAveragingState          # fields (C,)
    aux: torch.Tensor               # frozen full vector: (D,) shared, or (C, D) per chain


@dataclasses.dataclass
class TransitionNoise:
    """Every random number of one transition."""

    z1: torch.Tensor                # (C, d) momentum normals
    z2: Optional[torch.Tensor]      # (C, k) low-rank momentum normals, or None
    u_jitter: torch.Tensor          # (C,) U[0, 1) for the step jitter
    u_accept: torch.Tensor          # (C,) U[0, 1) for the MH test
    z_aux: Optional[torch.Tensor] = None  # (C, D) normals of the frozen refresh, or None


def draw_noise(generator: torch.Generator, inv_mass, n_chains: int, dim: int,
               device, aux_dim: Optional[int] = None) -> TransitionNoise:
    """One transition's draws, in this order: the momentum normals, the two
    uniforms and, only when ``aux_dim`` is given (REFRESH), the refresh
    normals -- so runs without a refresh keep their streams."""
    s1, s2 = momentum_normals_shape(inv_mass, n_chains, dim)
    z1 = torch.randn(s1, generator=generator, device=device)
    z2 = None if s2 is None else torch.randn(s2, generator=generator, device=device)
    u = torch.rand((2, n_chains), generator=generator, device=device)
    z_aux = None if aux_dim is None else torch.randn((n_chains, aux_dim),
                                                     generator=generator, device=device)
    return TransitionNoise(z1=z1, z2=z2, u_jitter=u[0], u_accept=u[1], z_aux=z_aux)


def value_and_grad(log_prob_fn: Callable, q: torch.Tensor, aux):
    """``(log_prob (C,), d log_prob / dq (C, d))`` by autograd; chains are
    independent, so one backward of the sum gives every chain's gradient."""
    with torch.enable_grad():
        x = q.detach().requires_grad_(True)
        lp = log_prob_fn(x, aux)
        (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g


def init_state(log_prob_fn: Callable, position: torch.Tensor,
               config: HMCConfig, aux: torch.Tensor,
               grad_fn: Optional[Callable] = None) -> HMCState:
    """Exact log-density and the trajectory field at the initial positions
    (autograd of ``log_prob_fn`` when ``grad_fn`` is None)."""
    c = position.shape[0]
    if grad_fn is None:
        lp, g = value_and_grad(log_prob_fn, position, aux)
    else:
        lp, g = log_prob_fn(position, aux), grad_fn(position, aux)
    return HMCState(position=position, log_prob=lp, grad=g,
                    da=da_init(config.step_size, shape=(c,), device=position.device),
                    aux=aux)


def clipped_grad_fn(base: Callable, max_norm: float, inv_mass=1.0,
                    is_grad: bool = True) -> Callable:
    """Per-chain preconditioned norm clip of a gradient field: ``g`` where
    ``sqrt(sum inv_mass g^2) <= max_norm``, rescaled to that norm beyond.
    ``base(q, aux)`` is a gradient oracle (``is_grad=True``) or a log-density
    to differentiate by autograd (``is_grad=False``). ``inv_mass`` is the
    DIAGONAL inverse mass (a low-rank metric's diagonal view)."""
    raw = base if is_grad else (lambda q, aux: value_and_grad(base, q, aux)[1])

    def gfn(q, aux):
        g = raw(q, aux)
        norm = torch.sqrt((inv_mass * g * g).sum(-1, keepdim=True))
        return g * torch.clamp(max_norm / (norm + 1e-30), max=1.0)

    return gfn


def make_kernel(config: HMCConfig, inv_mass, grad_fn: Optional[Callable] = None,
                delta_fn: Optional[Callable] = None,
                log_prob_fn: Optional[Callable] = None,
                aux_refresh: Optional[Callable] = None):
    """``kernel(state, noise) -> (state, info)`` for all chains at once.

    ``grad_fn(q (C, d), aux) -> (C, d)`` is the trajectory field (None:
    autograd of ``log_prob_fn``); ``delta_fn(q1, q0, aux) -> (log p(q1) -
    log p(q0), log p(q1))``, each ``(C,)`` (None: the unpaired test on
    ``log_prob_fn(q (C, d), aux) -> (C,)``, lp0 recomputed in-step).
    ``aux_refresh(z (C, D)) -> aux (C, D)`` redraws the frozen vectors from
    ``noise.z_aux`` before each draw (the REFRESH policy).
    """
    if config.sampler not in ("hmc", "hmc_nuts"):
        raise ValueError(f"sampler {config.sampler!r}: 'hmc' or 'hmc_nuts'")
    if log_prob_fn is None and (delta_fn is None or grad_fn is None
                                or aux_refresh is not None):
        raise ValueError("log_prob_fn is needed unless both grad_fn and delta_fn are given "
                         "and there is no refresh")
    n_lf = config.num_leapfrog
    adapt = config.sampler == "hmc_nuts"
    low = min(max(config.jitter_low_frac, 1.0 / max(n_lf, 1)), 1.0)

    def kernel(state: HMCState, noise: TransitionNoise):
        q0 = state.position
        if aux_refresh is not None:
            # new frozen vectors: the density and the field at q0 change too
            aux = aux_refresh(noise.z_aux)
            if grad_fn is not None:
                lp0, g0 = log_prob_fn(q0, aux), grad_fn(q0, aux)
            else:
                lp0, g0 = value_and_grad(log_prob_fn, q0, aux)
        else:
            aux, g0 = state.aux, state.grad
            # paired: the MH test never reads lp0; unpaired: recompute, never cache
            lp0 = state.log_prob if delta_fn is not None else log_prob_fn(q0, aux)
        if adapt:
            eps = torch.exp(state.da.log_step)
        else:
            eps = torch.full_like(state.da.log_step, config.step_size)
        if config.jitter_eps:
            eps = eps * (noise.u_jitter * (1.0 - low) + low)

        p0 = mass_sample_momentum(inv_mass, noise.z1, noise.z2)
        ke0 = mass_kinetic_energy(inv_mass, p0)
        if grad_fn is not None:
            q1, p1, g1 = leapfrog_grad_only(lambda q: grad_fn(q, aux), q0, p0, g0,
                                            eps, n_lf, inv_mass)
            lp1 = None if delta_fn is not None else log_prob_fn(q1, aux)
        else:
            q1, p1, lp1, g1 = leapfrog(lambda q: value_and_grad(log_prob_fn, q, aux),
                                       q0, p0, g0, eps, n_lf, inv_mass)
        ke1 = mass_kinetic_energy(inv_mass, p1)

        if delta_fn is not None:
            dlp, lp1 = delta_fn(q1, q0, aux)
            delta = dlp - (ke1 - ke0)
        else:
            delta = (lp1 - ke1) - (lp0 - ke0)
        finite = torch.isfinite(delta)
        accept_prob = torch.where(
            finite, torch.clamp(torch.exp(torch.clamp(delta, max=0.0)), max=1.0),
            torch.zeros_like(delta))
        accept = finite & (torch.log(noise.u_accept) < delta)
        divergent = ~finite | (delta < DIVERGENCE_THRESHOLD)

        keep = accept[:, None]
        if adapt:
            stat = accept_prob.mean().expand_as(accept_prob)  # coupled over chains
            da = da_update(state.da, stat, config.target_accept)
        else:
            da = state.da
        new_state = HMCState(
            position=torch.where(keep, q1, q0),
            log_prob=torch.where(accept, lp1, lp0),
            grad=torch.where(keep, g1, g0),
            da=da, aux=aux)
        info = {"accept_prob": accept_prob, "accepted": accept,
                "step_size": eps, "divergent": divergent,
                "log_prob": new_state.log_prob}
        return new_state, info

    return kernel
