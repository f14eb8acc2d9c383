"""The HMC transition, chain-batched, and the single-call sampler.

Counterpart of ``vihmc_tpu/hmc/kernel.py``. :class:`HMCConfig` has every
field of the JAX config that has an effect there (``store_burn`` has none),
with its default and meaning (``store_aux_trace``: the sampler keeps each
draw's aux as ``SampleResult.aux_trace``,
:func:`~vihmc_torch.chains.resume.sample_chains_resumable`). The paths:

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
  evaluation replaces the unpaired test's recompute below; with
  ``refresh_during_burn=False`` the old aux is kept through burn (the draw
  still happens, so the stream does not shift);
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
  step); ``init_step_search`` starts each chain's dual averaging at the
  step of :func:`~vihmc_torch.hmc.adaptation.find_reasonable_step_size`.
  ``jitter_eps`` scales the step per chain by ``U[low, 1]`` with
  ``low = max(jitter_low_frac, 1/L)``;
* the metric: fixed (scalar or diagonal inverse mass, :class:`LowRankMetric`
  or :class:`EigenMetric`), or with ``adapt_mass`` a Welford estimate of the
  posterior variances (kernel.py:554-566, :666-680): under ``'half'`` the
  positions of the first ``burn // 2`` draws are accumulated and the shrunk
  estimate ``n/(n+5) var + 1e-3 5/(n+5)`` replaces the base metric from
  there on; under ``'windowed'`` (:func:`mass_window_schedule`) the carried
  ``inv_mass`` is replaced at each window's last draw by the estimate shrunk
  toward the base metric, the accumulator resets and dual averaging restarts
  (``da_restart``). ``metric_axis='chains'`` pools the moments over the
  chains (:func:`pooled_variance`);
* ``momentum_persistence`` alpha > 0, the Horowitz partial refresh
  (kernel.py:568-580, :656-664): ``p0 = alpha p + sqrt(1 - alpha^2) xi`` from
  the momentum carried in the state (draw 0 refreshes fully); an accepted
  draw carries the trajectory's end momentum, a rejected one the flipped
  ``-p0``;
* the NaN-safe accept (kernel.py:641-655).

The transition reads the draw's global iteration (the burn, switch and
window boundaries) from ``HMCState.iteration``, which it advances; so the
iteration, the Welford state, the carried metric and the momentum all carry
across segments. It takes its random numbers as tensors
(:class:`TransitionNoise`): the caller draws them from its
``torch.Generator`` (:func:`draw_noise`), and a test can inject the JAX
sampler's own draws. On a chain mesh the state and the noise hold one
rank's rows and the two chain couplings (the chain-mean accept statistic,
the pooled moments) reduce over every shard through the kernel's
:class:`~vihmc_torch.core.mesh.ChainAxis` (GSPMD's collectives in JAX,
kernel.py:269-272, :686). :func:`sample` runs ``num_samples`` draws in one call
and returns a :class:`SampleResult` (kernel.py:721-768).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Optional

import numpy as np
import torch

from vihmc_torch.core import profiling
from vihmc_torch.core.mesh import ChainAxis
from vihmc_torch.hmc.adaptation import (DualAveragingState, da_init, da_restart,
                                        da_update, find_reasonable_step_size)
from vihmc_torch.hmc.integrators import leapfrog, leapfrog_grad_only, split_leapfrog
from vihmc_torch.hmc.metric import (EigenMetric, LowRankMetric, mass_kinetic_energy,
                                    mass_sample_momentum, momentum_normals_shape)

#: log-Hamiltonian error below which a transition counts as divergent
DIVERGENCE_THRESHOLD = -1000.0


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """Sampler settings: the JAX config's fields, defaults and meanings (see
    the module doc for what each path does; the JAX module documents each
    option's motivation)."""

    num_samples: int = 100
    num_leapfrog: int = 10
    step_size: float = 0.1
    burn: int = 0                       # draws before adaptation freezes
    sampler: str = "hmc"                # 'hmc' (fixed step) | 'hmc_nuts' (dual averaging)
    integrator: str = "leapfrog"        # 'leapfrog' | 'splitting'
    target_accept: float = 0.8
    adapt_mass: bool = False            # Welford diagonal mass during burn
    mass_schedule: str = "half"         # 'half' | 'windowed' (with adapt_mass)
    jitter_l: bool = False              # trajectory length ~ U{max(1, round(frac L)), ..., L}
    jitter_low_frac: float = 0.0
    jitter_eps: bool = False            # step multiplier ~ U[max(frac, 1/L), 1]
    adapt_forever: bool = False         # dual averaging past burn, adapting iterate
    max_step: Optional[float] = None    # clamp of the adapted step
    min_step: Optional[float] = None
    refresh_during_burn: bool = True    # False: the aux stays fixed until burn ends
    da_axis: Optional[str] = None       # None: per chain; 'chains': chain-mean statistic
    metric_axis: Optional[str] = None   # None: per chain; 'chains': pooled Welford moments
    init_step_search: bool = False      # Algorithm-4 step search at init ('hmc_nuts')
    momentum_persistence: float = 0.0   # Horowitz partial momentum refresh alpha
    store_aux_trace: bool = False       # keep every draw's aux (the frozen VI draw)


def check_config(config: HMCConfig):
    """Raise ``ValueError`` on settings that JAX rejects."""
    if config.sampler not in ("hmc", "hmc_nuts"):
        raise ValueError(f"sampler {config.sampler!r}: 'hmc' or 'hmc_nuts'")
    if config.integrator not in ("leapfrog", "splitting"):
        raise ValueError(f"integrator {config.integrator!r}: 'leapfrog' or 'splitting'")
    for axis in ("da_axis", "metric_axis"):
        if getattr(config, axis) not in (None, "chains"):
            raise ValueError(f"{axis} {getattr(config, axis)!r}: None or 'chains'")
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
class WelfordState:
    """Running mean and sum of squared deviations of each chain's position;
    ``count`` (0-d) is the number of draws accumulated, the same for every
    chain."""

    mean: torch.Tensor   # (C, d)
    m2: torch.Tensor     # (C, d)
    count: torch.Tensor  # ()

    @classmethod
    def zeros_like(cls, position: torch.Tensor) -> "WelfordState":
        return cls(mean=torch.zeros_like(position), m2=torch.zeros_like(position),
                   count=torch.zeros((), dtype=torch.float32, device=position.device))

    def update(self, x: torch.Tensor) -> "WelfordState":
        count = self.count + 1.0
        delta = x - self.mean
        mean = self.mean + delta / count
        return WelfordState(mean=mean, m2=self.m2 + delta * (x - mean), count=count)

    @property
    def variance(self) -> torch.Tensor:
        return self.m2 / torch.clamp(self.count - 1.0, min=1.0)


@dataclasses.dataclass
class HMCState:
    position: torch.Tensor          # (C, d)
    log_prob: torch.Tensor          # (C,)
    grad: torch.Tensor              # (C, d) -- the trajectory field at position
    da: DualAveragingState          # fields (C,)
    aux: torch.Tensor               # shared (D,) / (p,), or per chain (C, D) / (C, p)
    iteration: int = 0              # global index of the next draw
    welford: Optional[WelfordState] = None      # with adapt_mass
    inv_mass: Optional[torch.Tensor] = None     # (C, d) carried metric, 'windowed'
    momentum: Optional[torch.Tensor] = None     # (C, d) with momentum_persistence


def mass_window_schedule(burn: int):
    """Stan-style warmup windows inside ``burn`` draws (kernel.py:207-234):
    ``(start, ends)`` -- Welford accumulation covers ``[start, ends[-1])``,
    split into doubling windows with exclusive ends ``ends``; empty ``ends``
    when burn is too short for windowing."""
    if burn < 20:
        return 0, ()
    start = max(int(0.15 * burn), 1)
    term = max(int(0.10 * burn), 1)
    region = burn - start - term
    if region < 10:
        return 0, ()
    w = max(region // 15, 5)
    ends, pos = [], start
    while pos + w <= start + region:
        pos += w
        ends.append(pos)
        w *= 2
    if not ends:
        return 0, ()
    ends[-1] = start + region  # absorb the tail into the final window
    return start, tuple(ends)


def pooled_variance(welford: WelfordState, axis: Optional[str],
                    chains: Optional[ChainAxis] = None):
    """``(variance, effective_count)``: each chain's own (``axis`` None,
    ``(C, d)``), or pooled over the chains (``'chains'``, ``(d,)``: the
    within-chain sums of squares plus the between-chain dispersion of the
    means, C times the count). ``chains``: the chain axis the moments pool
    over, all-reduced across its shards (default: this process's chains)."""
    if axis is None:
        return welford.variance, welford.count
    chains = ChainAxis(welford.mean.shape[0]) if chains is None else chains
    n = welford.count
    c = float(chains.count)
    mean_p = chains.mean(welford.mean)
    m2_p = chains.mean(welford.m2)
    between = chains.mean((welford.mean - mean_p) ** 2)
    n_tot = c * n
    ss = c * (m2_p + n * between)
    return ss / torch.clamp(n_tot - 1.0, min=1.0), n_tot


def windowed_metric_update(welford: WelfordState, position: torch.Tensor, iteration: int,
                           win_start: int, win_ends, base_inv_mass,
                           carried_inv_mass: torch.Tensor, metric_axis=None,
                           chains: Optional[ChainAxis] = None):
    """One windowed-warmup step (kernel.py:278-302): accumulate ``position``
    inside the window region; at a window's last draw replace the carried
    inverse mass by the variance estimate shrunk toward ``base_inv_mass``,
    ``n/(n+5) var + 5/(n+5) base``, and reset the accumulator. Returns
    ``(welford, inv_mass, is_window_end)``."""
    if win_start <= iteration < win_ends[-1]:
        welford = welford.update(position)
    is_win_end = any(iteration == e - 1 for e in win_ends)
    inv_mass = carried_inv_mass
    if is_win_end:
        var, n = pooled_variance(welford, metric_axis, chains)
        base = base_inv_mass * torch.ones_like(position)
        inv_mass = (n / (n + 5.0)) * var + (5.0 / (n + 5.0)) * base
        welford = WelfordState.zeros_like(position)
    return welford, inv_mass, is_win_end


def metric_carries(adapt_mass: bool, mass_schedule: str, position: torch.Tensor, inv_mass):
    """``(welford, carried_inv_mass)`` of a fresh state: the Welford
    accumulator with ``adapt_mass``, and under ``'windowed'`` the base metric
    broadcast to every chain (kernel.py:344-352)."""
    welford = WelfordState.zeros_like(position) if adapt_mass else None
    carried = None
    if adapt_mass and mass_schedule == "windowed":
        carried = torch.broadcast_to(torch.as_tensor(inv_mass, dtype=position.dtype,
                                                     device=position.device),
                                     position.shape).clone()
    return welford, carried


def advance_metric(state, position: torch.Tensor, schedule, inv_mass, metric_axis=None,
                   chains: Optional[ChainAxis] = None):
    """The adaptive metric's bookkeeping after a draw (kernel.py:666-680,
    nuts.py:301-312): ``schedule`` is ``(windowed, win_start, win_ends,
    switch)`` or None without ``adapt_mass``. Returns ``(welford,
    carried_inv_mass, is_window_end)``."""
    if schedule is None:
        return state.welford, state.inv_mass, False
    windowed, win_start, win_ends, switch = schedule
    if windowed:
        return windowed_metric_update(state.welford, position, state.iteration, win_start,
                                      win_ends, inv_mass, state.inv_mass, metric_axis, chains)
    welford = state.welford.update(position) if state.iteration < switch else state.welford
    return welford, state.inv_mass, False


def current_inv_mass(state, schedule, inv_mass, pooled_axis=None,
                     chains: Optional[ChainAxis] = None):
    """The inverse mass of this draw (kernel.py:556-566, nuts.py:232-242):
    under ``'windowed'`` the carried estimate, under ``'half'`` from the
    switch on the Welford variance (pooled over ``pooled_axis``) shrunk
    toward 1e-3, ``n/(n+5) var + 1e-3 5/(n+5)``, before it the base metric
    broadcast to the chains; without ``adapt_mass`` (``schedule`` None) the
    base ``inv_mass`` as given."""
    if schedule is None:
        return inv_mass
    windowed, _, _, switch = schedule
    if windowed:
        return state.inv_mass
    if state.iteration >= switch:
        var, n = pooled_variance(state.welford, pooled_axis, chains)
        return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return inv_mass * torch.ones_like(state.position)


def mass_schedule_of(adapt_mass: bool, mass_schedule: str, burn: int):
    """``(windowed, win_start, win_ends, switch)`` for :func:`advance_metric`,
    or None without ``adapt_mass``; a burn too short for windows falls back
    to the ``'half'`` switch, as in JAX."""
    if not adapt_mass:
        return None
    win_start, win_ends = 0, ()
    if mass_schedule == "windowed":
        win_start, win_ends = mass_window_schedule(burn)
    return len(win_ends) > 0, win_start, win_ends, max(burn // 2, 1)


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


def normalize_log_prob(fn: Optional[Callable]) -> Optional[Callable]:
    """Accept ``f(q)`` as well as ``f(q, aux)`` (decided once, by signature,
    as the JAX package's ``_normalize_log_prob``)."""
    if fn is None:
        return None
    try:
        n = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n = 2
    return fn if n >= 2 else (lambda q, aux: fn(q))


def value_and_grad(log_prob_fn: Callable, q: torch.Tensor, aux):
    """``(log_prob (C,), d log_prob / dq (C, d))`` by autograd; chains are
    independent, so one backward of the sum gives every chain's gradient."""
    profiling.count("density.calls")
    with torch.enable_grad():
        x = q.detach().requires_grad_(True)
        lp = log_prob_fn(x, aux)
        (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g


def _check_metric(inv_mass, config: HMCConfig):
    if isinstance(inv_mass, (LowRankMetric, EigenMetric)) and (
            config.adapt_mass or config.init_step_search):
        raise ValueError("structured metrics are fixed: incompatible with "
                         "adapt_mass / init_step_search")


def _density(log_prob_fn: Callable, q: torch.Tensor, aux):
    profiling.count("density.calls")
    return log_prob_fn(q, aux)


def init_state(log_prob_fn: Callable, position: torch.Tensor,
               config: HMCConfig, aux: torch.Tensor,
               grad_fn: Optional[Callable] = None, inv_mass=1.0,
               step_noise: Optional[torch.Tensor] = None) -> HMCState:
    """Exact log-density and the trajectory field at the initial positions
    (autograd of ``log_prob_fn`` when ``grad_fn`` is None), the dual
    averaging at ``step_size`` -- or, with ``init_step_search`` under
    ``'hmc_nuts'``, at each chain's searched step from the momentum normals
    ``step_noise`` (C, d) -- and the adaptive-metric and momentum carries
    when their options are on (kernel.py:321-360). Span ``vihmc.init_state``
    around the initial density and field."""
    _check_metric(inv_mass, config)
    c = position.shape[0]
    with profiling.span("vihmc.init_state", position.device):
        if grad_fn is None:
            lp, g = value_and_grad(log_prob_fn, position, aux)
        else:
            lp, g = _density(log_prob_fn, position, aux), grad_fn(position, aux)
    step0 = config.step_size
    if config.init_step_search and config.sampler == "hmc_nuts":
        if step_noise is None:
            raise ValueError("init_step_search requires init_state(step_noise=...)")
        step0 = find_reasonable_step_size(
            lambda qq: value_and_grad(log_prob_fn, qq, aux), position, step_noise,
            init_step=config.step_size, inv_mass=inv_mass)
    welford, carried = metric_carries(config.adapt_mass, config.mass_schedule, position,
                                      inv_mass)
    # zeros placeholder: draw 0 refreshes fully, so it never enters a draw
    momentum = torch.zeros_like(position) if config.momentum_persistence > 0.0 else None
    return HMCState(position=position, log_prob=lp, grad=g,
                    da=da_init(step0, shape=(c,), device=position.device),
                    aux=aux, welford=welford, inv_mass=carried, momentum=momentum)


def clipped_grad_fn(base: Callable, max_norm: float, inv_mass=1.0,
                    is_grad: bool = True) -> Callable:
    """Per-chain preconditioned norm clip of a gradient field: ``g`` where
    ``sqrt(sum inv_mass g^2) <= max_norm``, rescaled to that norm beyond.
    ``base(q, aux)`` is a gradient oracle (``is_grad=True``) or a log-density
    to differentiate by autograd (``is_grad=False``). ``inv_mass`` is the
    DIAGONAL inverse mass (a structured metric's ``mass_diag_inv`` view)."""
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
                shard_log_prob_fn: Optional[Callable] = None, shard_data=None,
                chains: Optional[ChainAxis] = None):
    """``kernel(state, noise) -> (state, info)`` for all chains at once.

    ``grad_fn(q (C, d), aux) -> (C, d)`` is the trajectory field (None:
    autograd of ``log_prob_fn``); ``delta_fn(q1, q0, aux) -> (log p(q1) -
    log p(q0), log p(q1))``, each ``(C,)`` (None: the unpaired test on
    ``log_prob_fn(q (C, d), aux) -> (C,)``, lp0 recomputed in-step).
    ``aux_refresh(z) -> aux`` redraws every chain's aux from ``noise.z_aux``
    before each draw. ``integrator='splitting'`` takes
    ``shard_log_prob_fn(q (C, d), shard, aux) -> (C,)`` and ``shard_data``,
    a tensor or a tuple of tensors with the shard index as leading axis.
    ``inv_mass`` is the base metric (the adaptive metric's start and
    shrinkage target under ``adapt_mass``). ``chains``: the chain axis the
    coupled statistics (``da_axis``, ``metric_axis``) reduce over, across
    its shards on a mesh (default: the state's chains); the state and the
    noise hold this rank's rows.
    """
    check_config(config)
    if isinstance(inv_mass, (LowRankMetric, EigenMetric)) and config.adapt_mass:
        raise ValueError("structured metrics are fixed: incompatible with adapt_mass")
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
    schedule = mass_schedule_of(config.adapt_mass, config.mass_schedule, config.burn)
    alpha = config.momentum_persistence

    def kernel(state: HMCState, noise: TransitionNoise):
        q0, it = state.position, state.iteration
        axis = ChainAxis(q0.shape[0]) if chains is None else chains
        in_burn = it < config.burn
        if aux_refresh is not None:
            # new aux: the density and the field at q0 change too
            aux = aux_refresh(noise.z_aux)
            if not config.refresh_during_burn and in_burn:
                aux = state.aux
            if grad_fn is not None:
                lp0, g0 = _density(log_prob_fn, q0, aux), grad_fn(q0, aux)
            else:
                lp0, g0 = value_and_grad(log_prob_fn, q0, aux)
        else:
            aux, g0 = state.aux, state.grad
            # paired: the MH test never reads lp0; unpaired: recompute, never cache
            lp0 = state.log_prob if delta_fn is not None else _density(log_prob_fn, q0, aux)
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

        inv_mass_t = current_inv_mass(state, schedule, inv_mass, config.metric_axis, axis)
        p0 = mass_sample_momentum(inv_mass_t, noise.z1, noise.z2)
        if alpha > 0.0 and it > 0:
            p0 = alpha * state.momentum + (1.0 - alpha ** 2) ** 0.5 * p0
        ke0 = mass_kinetic_energy(inv_mass_t, p0)
        n_steps = noise.n_steps if config.jitter_l else None
        if config.integrator == "splitting":
            def shard_vag(q, shard):
                return value_and_grad(lambda x, a: shard_log_prob_fn(x, shard, a), q, aux)

            q1, p1 = split_leapfrog(shard_vag, shard_data, q0, p0, eps, n_lf, inv_mass_t)
            lp1, g1 = value_and_grad(log_prob_fn, q1, aux)
        elif grad_fn is not None:
            q1, p1, g1 = leapfrog_grad_only(lambda q: grad_fn(q, aux), q0, p0, g0,
                                            eps, n_lf, inv_mass_t, n_steps=n_steps)
            if delta_fn is None:
                # the unpaired MH test's density at the proposal
                profiling.count("mh.calls")
                with profiling.detail_span("vihmc.mh"):
                    lp1 = _density(log_prob_fn, q1, aux)
        else:
            q1, p1, lp1, g1 = leapfrog(lambda q: value_and_grad(log_prob_fn, q, aux),
                                       q0, p0, g0, eps, n_lf, inv_mass_t, n_steps=n_steps)
        ke1 = mass_kinetic_energy(inv_mass_t, p1)

        if delta_fn is not None:
            profiling.count("mh.calls")
            with profiling.detail_span("vihmc.mh"):
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
        position = torch.where(keep, q1, q0)
        # Horowitz: an accepted draw keeps the trajectory's end momentum, a
        # rejected one flips the carried momentum (kinetic energy is even in p)
        momentum = torch.where(keep, p1, -p0) if alpha > 0.0 else None

        welford, carried, is_win_end = advance_metric(state, position, schedule, inv_mass,
                                                      config.metric_axis, axis)

        da = state.da
        if adapt:
            if config.adapt_forever or in_burn:
                stat = accept_prob
                if config.da_axis == "chains":
                    stat = axis.mean(accept_prob).expand_as(accept_prob)
                da = da_update(state.da, stat, config.target_accept)
            if is_win_end:
                da = da_restart(da)
        new_state = HMCState(
            position=position, log_prob=torch.where(accept, lp1, lp0),
            grad=torch.where(keep, g1, g0), da=da, aux=aux, iteration=it + 1,
            welford=welford, inv_mass=carried, momentum=momentum)
        info = {"accept_prob": accept_prob, "accepted": accept,
                "step_size": eps, "divergent": divergent,
                "log_prob": new_state.log_prob}
        return new_state, info

    return kernel


@dataclasses.dataclass
class SampleResult:
    """Draws and per-draw statistics on the host, chain-major: ``(C, S, ...)``
    (``(S, ...)`` for a single chain given as a ``(d,)`` position to
    :func:`sample`); the samples thinned by the sampler's ``thin``."""

    samples: np.ndarray        # (C, S // thin, d)
    log_probs: np.ndarray      # (C, S)
    accept_probs: np.ndarray   # (C, S)
    accepted: np.ndarray       # (C, S) bool
    step_sizes: np.ndarray     # (C, S)
    divergent: np.ndarray      # (C, S) bool
    final_state: Any
    aux_trace: Any = None      # per-draw aux (store_aux_trace) or sampler extras
                               # (NUTS tree_leaves, ChEES n_steps)

    @property
    def acceptance_rate(self) -> float:
        return float(np.mean(self.accepted))

    @property
    def num_divergent(self) -> int:
        return int(np.sum(self.divergent))

    def single_chain(self) -> "SampleResult":
        """The result of a one-chain run with the chain axis dropped."""
        one = {f: getattr(self, f)[0] for f in ("samples", "log_probs", "accept_probs",
                                                "accepted", "step_sizes", "divergent")}
        trace = None if self.aux_trace is None else {k: v[0] for k, v in self.aux_trace.items()}
        return dataclasses.replace(self, aux_trace=trace, **one)


def sample(log_prob_fn: Callable, init_position: torch.Tensor, config: HMCConfig,
           inv_mass=1.0, aux=None, aux_refresh: Optional[Callable] = None,
           shard_log_prob_fn: Optional[Callable] = None, shard_data=None,
           grad_fn: Optional[Callable] = None, delta_fn: Optional[Callable] = None,
           seed: int = 0) -> SampleResult:
    """Draw ``config.num_samples`` HMC samples in one call (kernel.py:721).

    ``init_position`` (d,) runs one chain and returns ``(S, ...)`` arrays;
    ``(C, d)`` runs C chains batched. ``log_prob_fn`` and ``grad_fn`` take
    ``(q (C, d)[, aux])``. The random numbers come from the generator streams
    of ``seed`` (:func:`~vihmc_torch.chains.parallel.sample_chains`)."""
    from vihmc_torch.chains.parallel import sample_chains

    single = init_position.ndim == 1
    q0 = init_position[None] if single else init_position
    res = sample_chains(log_prob_fn, q0, config, inv_mass, aux, aux_refresh=aux_refresh,
                        shard_log_prob_fn=shard_log_prob_fn, shard_data=shard_data,
                        grad_fn=grad_fn, delta_fn=delta_fn, seed=seed)
    return res.single_chain() if single else res
