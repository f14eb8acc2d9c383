"""The HMC transition, chain-batched.

Counterpart of ``vihmc_tpu/hmc/kernel.py``. :class:`HMCConfig` has every
field of the JAX config that has an effect there (``store_burn`` has none),
with its default and meaning; the fields whose paths
are not ported (``adapt_mass``, ``mass_schedule``, ``refresh_during_burn=False``,
``init_step_search``, ``momentum_persistence``, ``store_aux_trace``,
``metric_axis``) raise ``NotImplementedError`` when set away from their
default. The ported paths:

* the trajectory: gradient-only leapfrog on ``grad_fn`` (a Gram field, a
  Gaussian field or a clipped autodiff field), or, with no ``grad_fn``,
  value-and-grad leapfrog on autograd of ``log_prob_fn``
  (integrators.py:27-50); with ``jitter_l`` the L steps run and the steps
  past each chain's drawn length are masked (kernel.py:593-629); with
  ``integrator='splitting'`` the split-Hamiltonian integrator over data
  shards (kernel.py:584-592), the endpoint's density and gradient by
  autograd of the full ``log_prob_fn``;
* the frozen-coordinate refresh (``aux_refresh``, kernel.py:497-506): before
  the draw each chain's aux is redrawn (REFRESH: a frozen vector, so ``aux``
  becomes ``(C, D)``; trunk subsampling: an index set, ``(C, p)``) and lp0
  and the trajectory field at q0 are recomputed at it -- that one density
  evaluation replaces the unpaired test's recompute below;
* the MH test: the PAIRED delta ``delta_fn`` with no density recompute at q0
  (kernel.py:507-515), or, with no ``delta_fn``, the unpaired test
  ``(lp1 - ke1) - (lp0 - ke0)`` with lp0 RECOMPUTED in every transition and
  never taken from the state (kernel.py:516-533: a cached value from another
  evaluation would enter every MH delta as a reduction-order offset);
* the step (kernel.py:535-552): ``sampler='hmc'``, a fixed ``step_size``; or
  ``'hmc_nuts'``, dual averaging -- the adapting iterate during the first
  ``burn`` draws and the averaged ``log_step_avg`` after, or the adapting
  iterate throughout under ``adapt_forever``, clamped to ``[min_step,
  max_step]``; the update runs only in burn unless ``adapt_forever``, per
  chain, or coupled over chains under ``da_axis='chains'`` (the accept
  statistic is the chain mean, kernel.py:683-698, so all chains share one
  step). ``jitter_eps`` scales the step per chain by ``U[low, 1]`` with
  ``low = max(jitter_low_frac, 1/L)``;
* a fixed metric (scalar or diagonal inverse mass, or :class:`LowRankMetric`);
* the NaN-safe accept (kernel.py:641-655).

The transition reads the draw's global iteration (the burn boundary) from
``HMCState.iteration``, which it advances; so the iteration carries across
segments. It takes its random numbers as tensors (:class:`TransitionNoise`):
the caller draws them from its ``torch.Generator`` (:func:`draw_noise`), and
a test can inject the JAX sampler's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from vihmc_torch.hmc.adaptation import DualAveragingState, da_init, da_update
from vihmc_torch.hmc.integrators import leapfrog, leapfrog_grad_only, split_leapfrog
from vihmc_torch.hmc.metric import (mass_kinetic_energy, mass_sample_momentum,
                                    momentum_normals_shape)

#: log-Hamiltonian error below which a transition counts as divergent
DIVERGENCE_THRESHOLD = -1000.0


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """Sampler settings: the JAX config's fields, defaults and meanings (see
    the module doc for what is ported; the JAX module documents each
    option's motivation)."""

    num_samples: int = 100
    num_leapfrog: int = 10
    step_size: float = 0.1
    burn: int = 0                       # draws before adaptation freezes
    sampler: str = "hmc"                # 'hmc' (fixed step) | 'hmc_nuts' (dual averaging)
    integrator: str = "leapfrog"        # 'leapfrog' | 'splitting'
    target_accept: float = 0.8
    adapt_mass: bool = False            # not ported
    mass_schedule: str = "half"         # not ported (only with adapt_mass)
    jitter_l: bool = False              # trajectory length ~ U{max(1, round(frac L)), ..., L}
    jitter_low_frac: float = 0.0
    jitter_eps: bool = False            # step multiplier ~ U[max(frac, 1/L), 1]
    adapt_forever: bool = False         # dual averaging past burn, adapting iterate
    max_step: Optional[float] = None    # clamp of the adapted step
    min_step: Optional[float] = None
    refresh_during_burn: bool = True    # False is not ported
    da_axis: Optional[str] = None       # None: per chain; 'chains': chain-mean statistic
    metric_axis: Optional[str] = None   # not ported (only with adapt_mass)
    init_step_search: bool = False      # not ported
    momentum_persistence: float = 0.0   # not ported
    store_aux_trace: bool = False       # not ported


#: fields whose non-default values select paths the port does not run
_UNPORTED = ("adapt_mass", "mass_schedule", "refresh_during_burn", "metric_axis",
             "init_step_search", "momentum_persistence", "store_aux_trace")


def check_config(config: HMCConfig):
    """Raise on settings the port does not run (``NotImplementedError``) or
    that JAX rejects (``ValueError``)."""
    default = HMCConfig()
    bad = [f for f in _UNPORTED if getattr(config, f) != getattr(default, f)]
    if bad:
        raise NotImplementedError(f"HMCConfig fields not ported yet: {', '.join(bad)}")
    if config.sampler not in ("hmc", "hmc_nuts"):
        raise ValueError(f"sampler {config.sampler!r}: 'hmc' or 'hmc_nuts'")
    if config.integrator not in ("leapfrog", "splitting"):
        raise ValueError(f"integrator {config.integrator!r}: 'leapfrog' or 'splitting'")
    if config.da_axis not in (None, "chains"):
        raise ValueError(f"da_axis {config.da_axis!r}: None or 'chains'")
    if config.jitter_l and config.jitter_eps:
        raise ValueError("jitter_l and jitter_eps are mutually exclusive")


def jitter_l_range(config: HMCConfig):
    """``(low, high)`` of the ``jitter_l`` trajectory length, ``high``
    exclusive (kernel.py:597-598), or None without ``jitter_l``."""
    if not config.jitter_l:
        return None
    return max(1, int(round(config.jitter_low_frac * config.num_leapfrog))), \
        config.num_leapfrog + 1


@dataclasses.dataclass
class HMCState:
    position: torch.Tensor          # (C, d)
    log_prob: torch.Tensor          # (C,)
    grad: torch.Tensor              # (C, d) -- the trajectory field at position
    da: DualAveragingState          # fields (C,)
    aux: torch.Tensor               # shared (D,) / (p,), or per chain (C, D) / (C, p)
    iteration: int = 0              # global index of the next draw


@dataclasses.dataclass
class TransitionNoise:
    """Every random number of one transition."""

    z1: torch.Tensor                # (C, d) momentum normals
    z2: Optional[torch.Tensor]      # (C, k) low-rank momentum normals, or None
    u_jitter: torch.Tensor          # (C,) U[0, 1) for the step jitter
    u_accept: torch.Tensor          # (C,) U[0, 1) for the MH test
    z_aux: Optional[torch.Tensor] = None    # the refresh hook's draw, or None
    n_steps: Optional[torch.Tensor] = None  # (C,) int64 jitter_l lengths, or None


def draw_noise(generator: torch.Generator, inv_mass, n_chains: int, dim: int,
               device, aux_draw: Optional[Callable] = None,
               n_steps_range=None) -> TransitionNoise:
    """One transition's draws, in this order: the momentum normals, the two
    uniforms, then only when their option is on: the refresh hook's draw
    ``aux_draw(generator)`` and the ``jitter_l`` lengths, uniform integers in
    ``n_steps_range`` -- so every configuration keeps the streams it had
    before those options existed."""
    s1, s2 = momentum_normals_shape(inv_mass, n_chains, dim)
    z1 = torch.randn(s1, generator=generator, device=device)
    z2 = None if s2 is None else torch.randn(s2, generator=generator, device=device)
    u = torch.rand((2, n_chains), generator=generator, device=device)
    z_aux = None if aux_draw is None else aux_draw(generator)
    n_steps = None
    if n_steps_range is not None:
        n_steps = torch.randint(n_steps_range[0], n_steps_range[1], (n_chains,),
                                generator=generator, device=device)
    return TransitionNoise(z1=z1, z2=z2, u_jitter=u[0], u_accept=u[1], z_aux=z_aux,
                           n_steps=n_steps)


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


def gaussian_field_grad(mu: torch.Tensor, sigma: torch.Tensor, alpha: float = 1.0):
    """The Gaussian-score trajectory field ``-(q - mu) / (alpha sigma^2)``
    (kernel.py:393-420): leapfrog on the score of ``N(mu, alpha sigma^2)``,
    e.g. the VI posterior over the subspace, costs no likelihood evaluation;
    the exact density at the endpoints keeps MH unbiased. ``grad(q (C, d),
    aux) -> (C, d)``."""
    inv_var = 1.0 / (alpha * sigma ** 2)

    def grad(q, aux=None):
        return -(q - mu) * inv_var

    return grad


def make_kernel(config: HMCConfig, inv_mass, grad_fn: Optional[Callable] = None,
                delta_fn: Optional[Callable] = None,
                log_prob_fn: Optional[Callable] = None,
                aux_refresh: Optional[Callable] = None,
                shard_log_prob_fn: Optional[Callable] = None, shard_data=None):
    """``kernel(state, noise) -> (state, info)`` for all chains at once.

    ``grad_fn(q (C, d), aux) -> (C, d)`` is the trajectory field (None:
    autograd of ``log_prob_fn``); ``delta_fn(q1, q0, aux) -> (log p(q1) -
    log p(q0), log p(q1))``, each ``(C,)`` (None: the unpaired test on
    ``log_prob_fn(q (C, d), aux) -> (C,)``, lp0 recomputed in-step).
    ``aux_refresh(z) -> aux`` redraws every chain's aux from ``noise.z_aux``
    before each draw. ``integrator='splitting'`` takes
    ``shard_log_prob_fn(q (C, d), shard, aux) -> (C,)`` and ``shard_data``,
    a tensor or a tuple of tensors with the shard index as leading axis.
    """
    check_config(config)
    if config.integrator == "splitting":
        if delta_fn is not None:
            raise ValueError("delta_fn requires the plain leapfrog integrator")
        if shard_log_prob_fn is None or shard_data is None:
            raise ValueError("splitting integrator requires shard_log_prob_fn and shard_data")
        if grad_fn is not None:
            raise ValueError("grad_fn is incompatible with the splitting integrator")
    if log_prob_fn is None and (delta_fn is None or grad_fn is None
                                or aux_refresh is not None):
        raise ValueError("log_prob_fn is needed unless both grad_fn and delta_fn are given "
                         "and there is no refresh")
    n_lf = config.num_leapfrog
    adapt = config.sampler == "hmc_nuts"
    low = min(max(config.jitter_low_frac, 1.0 / max(n_lf, 1)), 1.0)

    def kernel(state: HMCState, noise: TransitionNoise):
        q0 = state.position
        in_burn = state.iteration < config.burn
        if aux_refresh is not None:
            # new aux: the density and the field at q0 change too
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
            use_iterate = config.adapt_forever or in_burn
            eps = torch.exp(state.da.log_step if use_iterate else state.da.log_step_avg)
            if config.max_step is not None:
                eps = torch.clamp(eps, max=config.max_step)
            if config.min_step is not None:
                eps = torch.clamp(eps, min=config.min_step)
        else:
            eps = torch.full_like(state.da.log_step, config.step_size)
        if config.jitter_eps:
            eps = eps * (noise.u_jitter * (1.0 - low) + low)

        p0 = mass_sample_momentum(inv_mass, noise.z1, noise.z2)
        ke0 = mass_kinetic_energy(inv_mass, p0)
        n_steps = noise.n_steps if config.jitter_l else None
        if config.integrator == "splitting":
            def shard_vag(q, shard):
                return value_and_grad(lambda x, a: shard_log_prob_fn(x, shard, a), q, aux)

            q1, p1 = split_leapfrog(shard_vag, shard_data, q0, p0, eps, n_lf, inv_mass)
            lp1, g1 = value_and_grad(log_prob_fn, q1, aux)
        elif grad_fn is not None:
            q1, p1, g1 = leapfrog_grad_only(lambda q: grad_fn(q, aux), q0, p0, g0,
                                            eps, n_lf, inv_mass, n_steps=n_steps)
            lp1 = None if delta_fn is not None else log_prob_fn(q1, aux)
        else:
            q1, p1, lp1, g1 = leapfrog(lambda q: value_and_grad(log_prob_fn, q, aux),
                                       q0, p0, g0, eps, n_lf, inv_mass, n_steps=n_steps)
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
        da = state.da
        if adapt and (config.adapt_forever or in_burn):
            stat = accept_prob
            if config.da_axis == "chains":
                stat = accept_prob.mean().expand_as(accept_prob)
            da = da_update(state.da, stat, config.target_accept)
        new_state = HMCState(
            position=torch.where(keep, q1, q0),
            log_prob=torch.where(accept, lp1, lp0),
            grad=torch.where(keep, g1, g0),
            da=da, aux=aux, iteration=state.iteration + 1)
        info = {"accept_prob": accept_prob, "accepted": accept,
                "step_size": eps, "divergent": divergent,
                "log_prob": new_state.log_prob}
        return new_state, info

    return kernel
