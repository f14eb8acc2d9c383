"""ChEES-HMC: cross-chain adaptive trajectory length, chain-batched.

Counterpart of ``vihmc_tpu/hmc/chees.py`` (:49-264). All chains advance
together and share one step and one trajectory time T. Each draw's step
count is ``clip(rint(u T / eps), 1, max_steps)`` with u the Halton point of
the draw (:func:`halton_base2`) -- one scalar for all chains -- so the
leapfrog loop is a Python loop of that many steps (the one host read of a
draw). With a ``grad_fn`` the trajectory follows that field and the exact
density is evaluated at the endpoint only (:158-168); with none, every step
evaluates the density and its autograd gradient.

During ``burn`` the step follows dual averaging on the cross-chain mean
acceptance, and log T follows Adam on the ChEES gradient estimated across
chains (:196-228), with the substitution that keeps divergent chains finite
(their proposal replaced by the start and their velocity by 0); both freeze
after burn. The random numbers come as a :class:`ChEESNoise`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from vihmc_torch.hmc.adaptation import DualAveragingState, da_init, da_update
from vihmc_torch.hmc.kernel import (DIVERGENCE_THRESHOLD, SampleResult,
                                    normalize_log_prob, value_and_grad)


@dataclasses.dataclass(frozen=True)
class ChEESConfig:
    """The JAX config's fields and defaults."""

    num_samples: int = 200
    step_size: float = 0.1            # initial step size
    init_traj_length: float = 1.0     # initial integration time T
    burn: int = 100                   # adaptation window (both eps and T)
    max_steps: int = 256              # cap on leapfrog steps per draw
    target_accept: float = 0.651
    adam_lr: float = 0.025            # learning rate for log T
    adam_b1: float = 0.9
    adam_b2: float = 0.999


@dataclasses.dataclass
class ChEESState:
    position: torch.Tensor    # (C, d)
    log_prob: torch.Tensor    # (C,)
    grad: torch.Tensor        # (C, d)
    da: DualAveragingState    # scalar fields: one step for all chains
    log_T: torch.Tensor       # ()
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    adam_t: torch.Tensor
    aux: Any = None
    iteration: int = 0        # global index of the next draw


@dataclasses.dataclass
class ChEESNoise:
    z: torch.Tensor                 # (C, d) momentum normals
    u_accept: torch.Tensor          # (C,) U[0, 1)
    z_aux: Optional[torch.Tensor] = None


def draw_chees_noise(generator: torch.Generator, n_chains: int, dim: int, device,
                     aux_draw: Optional[Callable] = None) -> ChEESNoise:
    """Momentum normals, the accept uniforms, then the refresh hook's draw."""
    z = torch.randn((n_chains, dim), generator=generator, device=device)
    u = torch.rand((n_chains,), generator=generator, device=device)
    return ChEESNoise(z=z, u_accept=u, z_aux=None if aux_draw is None else aux_draw(generator))


def halton_base2(i: int) -> float:
    """Van der Corput radical inverse base 2 of ``i + 1``, summed in float32
    over 30 bits as the JAX function does."""
    bits = torch.arange(30)
    digits = ((i + 1) >> bits & 1).to(torch.float32)
    return float((digits * 2.0 ** -(bits.to(torch.float32) + 1.0)).sum())


def init_chees_state(log_prob_fn: Callable, positions: torch.Tensor, config: ChEESConfig,
                     aux=None, grad_fn: Optional[Callable] = None) -> ChEESState:
    """The density and the trajectory field at the inits, the dual averaging
    at ``step_size`` and ``log T = log init_traj_length`` (chees.py:110-119)."""
    if grad_fn is None:
        lp, g = value_and_grad(log_prob_fn, positions, aux)
    else:
        lp, g = log_prob_fn(positions, aux), grad_fn(positions, aux)
    dev = positions.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return ChEESState(
        position=positions, log_prob=lp, grad=g, da=da_init(config.step_size, device=dev),
        log_T=torch.log(torch.tensor(config.init_traj_length, dtype=torch.float32,
                                     device=dev)),
        adam_m=zero, adam_v=zero.clone(), adam_t=zero.clone(), aux=aux)


def make_chees_kernel(log_prob_fn: Callable, config: ChEESConfig, inv_mass=1.0,
                      aux_refresh: Optional[Callable] = None,
                      grad_fn: Optional[Callable] = None):
    """``kernel(state, noise) -> (state, info)`` (chees.py:121-247).
    ``inv_mass``: scalar or (d,) diagonal. ``info``: ``log_prob``,
    ``accept_prob``, ``accepted``, ``divergent`` and ``step_size`` (C,), and
    the shared ``n_steps`` (an int) and ``traj_length``."""

    def kernel(state: ChEESState, noise: ChEESNoise):
        q0, it = state.position, state.iteration
        in_burn = it < config.burn
        if aux_refresh is not None:
            aux = aux_refresh(noise.z_aux)
            if grad_fn is not None:
                lp0, g0 = log_prob_fn(q0, aux), grad_fn(q0, aux)
            else:
                lp0, g0 = value_and_grad(log_prob_fn, q0, aux)
        else:
            aux, lp0, g0 = state.aux, state.log_prob, state.grad

        eps = torch.exp(state.da.log_step if in_burn else state.da.log_step_avg)
        big_t = torch.exp(state.log_T)
        u = halton_base2(it)
        # the shared step count: the draw's one host read
        n_steps = int(torch.clamp(torch.round(u * big_t / eps).to(torch.int32), 1,
                                  config.max_steps))

        im = inv_mass * torch.ones_like(q0[0])
        p0 = noise.z / torch.sqrt(im)
        ke0 = 0.5 * (im * p0 * p0).sum(-1)
        q, p, g, lp1 = q0, p0, g0, lp0
        for _ in range(n_steps):
            p_half = p + 0.5 * eps * g
            q = q + eps * (im * p_half)
            if grad_fn is not None:
                g = grad_fn(q, aux)
            else:
                lp1, g = value_and_grad(log_prob_fn, q, aux)
            p = p_half + 0.5 * eps * g
        q1, p1, g1 = q, p, g
        if grad_fn is not None:
            lp1 = log_prob_fn(q1, aux)
        ke1 = 0.5 * (im * p1 * p1).sum(-1)

        delta = (lp1 - ke1) - (lp0 - ke0)
        finite = torch.isfinite(delta)
        accept_prob = torch.where(
            finite, torch.clamp(torch.exp(torch.clamp(delta, max=0.0)), max=1.0),
            torch.zeros_like(delta))
        accept = finite & (torch.log(noise.u_accept) < delta)
        divergent = ~finite | (delta < DIVERGENCE_THRESHOLD)
        keep = accept[:, None]
        position = torch.where(keep, q1, q0)
        log_prob = torch.where(accept, lp1, lp0)
        grads = torch.where(keep, g1, g0)

        da = state.da
        log_t, adam_m, adam_v, adam_t = state.log_T, state.adam_m, state.adam_v, state.adam_t
        if in_burn:
            da = da_update(state.da, accept_prob.mean(), config.target_accept)
            # the ChEES gradient across chains; a divergent chain's proposal
            # is replaced by its start and its velocity by 0 (its weight is 0)
            fin = finite[:, None]
            q1_safe = torch.where(fin, q1, q0)
            v1 = im * torch.where(fin, p1, torch.zeros_like(p1))
            d_old = ((q0 - q0.mean(0)) ** 2).sum(-1)
            centred = q1_safe - q1_safe.mean(0)
            d_new = (centred ** 2).sum(-1)
            dir_dot = (centred * v1).sum(-1)
            w = accept_prob / torch.clamp(accept_prob.sum(), min=1e-12)
            grad_t = (w * (d_new - d_old) * dir_dot).sum() * u * big_t
            grad_t = torch.where(torch.isfinite(grad_t), grad_t, torch.zeros_like(grad_t))
            b1, b2 = config.adam_b1, config.adam_b2
            adam_t = state.adam_t + 1.0
            adam_m = b1 * state.adam_m + (1 - b1) * grad_t
            adam_v = b2 * state.adam_v + (1 - b2) * grad_t ** 2
            m_hat = adam_m / (1 - b1 ** adam_t)
            v_hat = adam_v / (1 - b2 ** adam_t)
            log_t = state.log_T + config.adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
            # keep T within [eps, max_steps eps]
            log_t = torch.clamp(log_t, torch.log(eps), torch.log(config.max_steps * eps))
        new_state = ChEESState(position=position, log_prob=log_prob, grad=grads, da=da,
                               log_T=log_t, adam_m=adam_m, adam_v=adam_v, adam_t=adam_t,
                               aux=aux, iteration=it + 1)
        info = {"log_prob": log_prob, "accept_prob": accept_prob, "accepted": accept,
                "divergent": divergent, "step_size": eps.expand_as(accept_prob),
                "n_steps": n_steps, "traj_length": big_t}
        return new_state, info

    return kernel


def chees_sample(log_prob_fn: Callable, init_positions: torch.Tensor, config: ChEESConfig,
                 inv_mass=1.0, aux=None, aux_refresh: Optional[Callable] = None,
                 grad_fn: Optional[Callable] = None, seed: int = 0, thin: int = 1,
                 segment_size: Optional[int] = None,
                 progress: Optional[Callable] = None,
                 aux_draw: Optional[Callable] = None) -> SampleResult:
    """``config.num_samples`` ChEES draws of the coupled chains
    ``init_positions`` (C, d); arrays ``(C, S, ...)`` as in JAX, except
    ``step_sizes`` ``(S,)`` (shared). ``aux`` may be shared (D,) or per chain;
    ``aux_refresh(z) -> (C, D)`` redraws every chain's from
    ``aux_draw(generator)`` (default ``(C, D)`` standard normals).
    ``aux_trace`` holds the per-draw ``n_steps`` and ``traj_length`` ``(S,)``. Segments, streams and thinning as in
    :func:`~vihmc_torch.hmc.nuts.nuts_sample`."""
    from vihmc_torch.chains.resume import resolve_aux_draw, run_segments

    n_chains, dim = init_positions.shape
    dev = init_positions.device
    log_prob_fn = normalize_log_prob(log_prob_fn)
    grad_fn = normalize_log_prob(grad_fn)
    inv_mass = torch.as_tensor(inv_mass, dtype=torch.float32, device=dev)
    kernel = make_chees_kernel(log_prob_fn, config, inv_mass, aux_refresh, grad_fn)
    state = init_chees_state(log_prob_fn, init_positions, config, aux, grad_fn)
    aux_draw = resolve_aux_draw(aux_refresh, aux_draw, aux, n_chains, dev)

    def step(st, gen):
        return kernel(st, draw_chees_noise(gen, n_chains, dim, dev, aux_draw))

    state, samples, out = run_segments(
        step, state, config.num_samples, segment_size or config.num_samples, thin, seed,
        dev, extra_keys=("n_steps", "traj_length"), progress=progress)
    return SampleResult(samples=samples, log_probs=out["log_prob"],
                        accept_probs=out["accept_prob"], accepted=out["accepted"],
                        step_sizes=out["step_size"][0], divergent=out["divergent"],
                        final_state=state,
                        aux_trace={"n_steps": out["n_steps"],
                                   "traj_length": out["traj_length"]})
