"""Leapfrog integrators: value-and-grad and gradient-only.

Counterparts of ``leapfrog`` and ``leapfrog_grad_only`` in
``vihmc_tpu/hmc/integrators.py`` (:27-76); the ``lax.scan`` over steps is a
Python loop. ``step_size`` is a scalar or a per-chain ``(C,)`` tensor.
"""

from __future__ import annotations

import torch

from vihmc_torch.hmc.metric import mass_velocity


def _per_chain(step_size):
    if isinstance(step_size, torch.Tensor) and step_size.ndim:
        return step_size[:, None]
    return step_size


def leapfrog(value_and_grad_fn, q, p, grad, step_size, num_steps: int, inv_mass=1.0):
    """``num_steps`` synchronized leapfrog steps with one value-and-grad
    evaluation each; returns ``(q, p, log_prob, grad)`` at the endpoint.

    ``value_and_grad_fn(q) -> (log_prob (C,), grad (C, d))``; ``grad`` is the
    gradient at the initial ``q``. With ``num_steps = 0`` the log-density is
    zeros, as in JAX.
    """
    eps = _per_chain(step_size)
    lp = torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)
    for _ in range(num_steps):
        p_half = p + 0.5 * eps * grad
        q = q + eps * mass_velocity(inv_mass, p_half)
        lp, grad = value_and_grad_fn(q)
        p = p_half + 0.5 * eps * grad
    return q, p, lp, grad


def leapfrog_grad_only(grad_fn, q, p, grad, step_size, num_steps: int,
                       inv_mass=1.0):
    """``num_steps`` synchronized leapfrog steps; returns ``(q, p, grad)``.

    Never evaluates the density: the caller evaluates the exact density (or
    the paired delta) once at the endpoint. Any deterministic ``grad_fn``
    keeps the integrator reversible and volume-preserving.
    """
    eps = _per_chain(step_size)
    for _ in range(num_steps):
        p_half = p + 0.5 * eps * grad
        q = q + eps * mass_velocity(inv_mass, p_half)
        grad = grad_fn(q)
        p = p_half + 0.5 * eps * grad
    return q, p, grad
