"""Leapfrog with a gradient-only oracle.

Counterpart of ``leapfrog_grad_only`` in ``vihmc_tpu/hmc/integrators.py``
(:53-76); the ``lax.scan`` over steps is a Python loop. ``step_size`` is a
scalar or a per-chain ``(C,)`` tensor.
"""

from __future__ import annotations

import torch

from vihmc_torch.hmc.metric import mass_velocity


def leapfrog_grad_only(grad_fn, q, p, grad, step_size, num_steps: int,
                       inv_mass=1.0):
    """``num_steps`` synchronized leapfrog steps; returns ``(q, p, grad)``.

    Never evaluates the density: the caller evaluates the exact density (or
    the paired delta) once at the endpoint. Any deterministic ``grad_fn``
    keeps the integrator reversible and volume-preserving.
    """
    eps = step_size[:, None] if isinstance(step_size, torch.Tensor) and step_size.ndim else step_size
    for _ in range(num_steps):
        p_half = p + 0.5 * eps * grad
        q = q + eps * mass_velocity(inv_mass, p_half)
        grad = grad_fn(q)
        p = p_half + 0.5 * eps * grad
    return q, p, grad
