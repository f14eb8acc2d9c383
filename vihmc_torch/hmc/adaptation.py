"""Dual-averaging step-size adaptation (Hoffman & Gelman 2014, Alg. 5).

Counterpart of ``vihmc_tpu/hmc/adaptation.py`` (:32-113) with the same
constants: ``da_init``, ``da_update``, ``da_restart`` (the restart at a mass
window's end) and ``find_reasonable_step_size`` (Algorithm 4). State fields
are tensors of any shape (the sampler keeps one entry per chain, as the JAX
sampler's vmapped state does).
"""

from __future__ import annotations

import dataclasses
import math

import torch

GAMMA = 0.05
T0 = 10.0
KAPPA = 0.75


@dataclasses.dataclass
class DualAveragingState:
    log_step: torch.Tensor       # current (adapting) log step size
    log_step_avg: torch.Tensor   # averaged iterate
    h_bar: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor              # adaptation updates performed


def da_init(step_size, shape=(), device="cpu") -> DualAveragingState:
    """``step_size``: a float, or a tensor broadcast to ``shape`` (one
    searched step per chain)."""
    # logs taken in f32, as jnp.log of f32 values
    eps = torch.as_tensor(step_size, dtype=torch.float32, device=device)
    log_eps = torch.log(torch.broadcast_to(eps, shape)).clone()
    log_ten = torch.log(torch.tensor(10.0, dtype=torch.float32, device=device))
    return DualAveragingState(
        log_step=log_eps, log_step_avg=log_eps.clone(),
        h_bar=torch.zeros(shape, dtype=torch.float32, device=device),
        mu=log_ten + log_eps,
        t=torch.zeros(shape, dtype=torch.float32, device=device))


def da_update(state: DualAveragingState, accept_prob,
              target_accept: float = 0.8) -> DualAveragingState:
    t = state.t + 1.0
    eta_h = 1.0 / (t + T0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target_accept - accept_prob)
    log_step = state.mu - torch.sqrt(t) / GAMMA * h_bar
    eta_x = t ** (-KAPPA)
    log_step_avg = eta_x * log_step + (1.0 - eta_x) * state.log_step_avg
    return DualAveragingState(log_step=log_step, log_step_avg=log_step_avg,
                              h_bar=h_bar, mu=state.mu, t=t)


def da_restart(state: DualAveragingState) -> DualAveragingState:
    """Re-initialize the adaptation around the current adapting step (after
    a metric update the old statistics describe another Hamiltonian)."""
    log_ten = torch.log(torch.tensor(10.0, dtype=torch.float32, device=state.log_step.device))
    return DualAveragingState(
        log_step=state.log_step, log_step_avg=state.log_step.clone(),
        h_bar=torch.zeros_like(state.h_bar), mu=log_ten + state.log_step,
        t=torch.zeros_like(state.t))


def find_reasonable_step_size(value_and_grad_fn, q: torch.Tensor, z: torch.Tensor,
                              init_step: float = 1.0, inv_mass=1.0,
                              max_doublings: int = 50) -> torch.Tensor:
    """Per-chain initial step (Algorithm 4): from ``init_step``, double (or
    halve) each chain's step until one leapfrog step from ``q`` (C, d) with
    momentum ``z / sqrt(inv_mass)`` crosses 50 % acceptance, at most
    ``max_doublings`` times. ``value_and_grad_fn(q) -> ((C,), (C, d))``;
    ``z`` (C, d) are the standard normals (JAX draws them from its key).
    Returns ``(C,)`` steps; a chain stops as its own while loop would."""
    from vihmc_torch.hmc.integrators import leapfrog

    lp0, g0 = value_and_grad_fn(q)
    p0 = z * torch.sqrt(1.0 / torch.as_tensor(inv_mass, dtype=q.dtype, device=q.device))
    ke0 = 0.5 * (inv_mass * p0 * p0).sum(-1)

    def log_accept(step):
        _, p1, lp1, _ = leapfrog(value_and_grad_fn, q, p0, g0, step, 1, inv_mass)
        delta = (lp1 - 0.5 * (inv_mass * p1 * p1).sum(-1)) - (lp0 - ke0)
        return torch.where(torch.isfinite(delta), delta, torch.full_like(delta, -math.inf))

    step = torch.full((q.shape[0],), init_step, dtype=torch.float32, device=q.device)
    direction = torch.where(log_accept(step) > math.log(0.5), 1.0, -1.0)
    active = torch.ones_like(step, dtype=torch.bool)
    for _ in range(max_doublings):
        active = active & (direction * log_accept(step) > -direction * math.log(2.0))
        if not bool(active.any()):
            break
        step = torch.where(active, step * torch.exp2(direction), step)
    return step
