"""Dual-averaging step-size adaptation (Hoffman & Gelman 2014, Alg. 5).

Counterpart of ``vihmc_tpu/hmc/adaptation.py`` (:32-60) with the same
constants. State fields are tensors of any shape (the sampler keeps one entry
per chain, as the JAX sampler's vmapped state does).
"""

from __future__ import annotations

import dataclasses

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


def da_init(step_size: float, shape=(), device="cpu") -> DualAveragingState:
    # logs taken in f32, as jnp.log of f32 values
    log_eps = torch.log(torch.full(shape, step_size, dtype=torch.float32, device=device))
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
