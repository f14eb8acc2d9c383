"""Leapfrog integrators: value-and-grad, gradient-only and split-Hamiltonian.

Counterparts of ``leapfrog``, ``leapfrog_grad_only`` and ``split_leapfrog``
in ``vihmc_tpu/hmc/integrators.py`` (:27-109); the ``lax.scan`` over steps is
a Python loop. ``step_size`` is a scalar or a per-chain ``(C,)`` tensor.
``n_steps`` (C,) masks the steps past each chain's own trajectory length
(the ``jitter_l`` scans of ``vihmc_tpu/hmc/kernel.py:593-629``): every step
runs for every chain, and a chain keeps its state from its last unmasked
step. Each field evaluation is a ``vihmc.field`` per-draw span and a ``field.calls``
count (:mod:`vihmc_torch.core.profiling`).
"""

from __future__ import annotations

import torch

from vihmc_torch.core import profiling
from vihmc_torch.hmc.metric import mass_velocity


def _per_chain(step_size):
    if isinstance(step_size, torch.Tensor) and step_size.ndim:
        return step_size[:, None]
    return step_size


def leapfrog(value_and_grad_fn, q, p, grad, step_size, num_steps: int, inv_mass=1.0,
             n_steps=None):
    """``num_steps`` synchronized leapfrog steps with one value-and-grad
    evaluation each; returns ``(q, p, log_prob, grad)`` at the endpoint.

    ``value_and_grad_fn(q) -> (log_prob (C,), grad (C, d))``; ``grad`` is the
    gradient at the initial ``q``. With ``num_steps = 0`` the log-density is
    zeros, as in JAX.
    """
    eps = _per_chain(step_size)
    lp = torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)
    for i in range(num_steps):
        p_half = p + 0.5 * eps * grad
        q_new = q + eps * mass_velocity(inv_mass, p_half)
        profiling.count("field.calls")
        with profiling.detail_span("vihmc.field"):
            lp_new, g_new = value_and_grad_fn(q_new)
        p_new = p_half + 0.5 * eps * g_new
        if n_steps is None:
            q, p, lp, grad = q_new, p_new, lp_new, g_new
        else:
            keep = i < n_steps
            q, p, grad = (torch.where(keep[:, None], a, b)
                          for a, b in ((q_new, q), (p_new, p), (g_new, grad)))
            lp = torch.where(keep, lp_new, lp)
    return q, p, lp, grad


def leapfrog_grad_only(grad_fn, q, p, grad, step_size, num_steps: int,
                       inv_mass=1.0, n_steps=None):
    """``num_steps`` synchronized leapfrog steps; returns ``(q, p, grad)``.

    Never evaluates the density: the caller evaluates the exact density (or
    the paired delta) once at the endpoint. Any deterministic ``grad_fn``
    keeps the integrator reversible and volume-preserving.
    """
    eps = _per_chain(step_size)
    for i in range(num_steps):
        p_half = p + 0.5 * eps * grad
        q_new = q + eps * mass_velocity(inv_mass, p_half)
        profiling.count("field.calls")
        with profiling.detail_span("vihmc.field"):
            g_new = grad_fn(q_new)
        p_new = p_half + 0.5 * eps * g_new
        if n_steps is None:
            q, p, grad = q_new, p_new, g_new
        else:
            keep = (i < n_steps)[:, None]
            q, p, grad = (torch.where(keep, a, b)
                          for a, b in ((q_new, q), (p_new, p), (g_new, grad)))
    return q, p, grad


def _shard(shard_data, i: int):
    if isinstance(shard_data, (tuple, list)):
        return tuple(x[i] for x in shard_data)
    return shard_data[i]


def split_leapfrog(shard_value_and_grad_fn, shard_data, q, p, step_size, num_steps: int,
                   inv_mass=1.0):
    """Split-Hamiltonian integration over data shards (Neal 2011, 5.1):
    each outer step runs, for every shard in turn, a half kick on that
    shard's potential, a drift of ``step_size / M``, and a half kick.

    ``shard_value_and_grad_fn(q (C, d), shard) -> (shard log-prob (C,),
    grad (C, d))``; ``shard_data`` is a tensor or a tuple of tensors whose
    leading axis is the shard index (M shards). Returns ``(q, p)``: the
    caller evaluates the full density at the endpoint.
    """
    first = shard_data[0] if isinstance(shard_data, (tuple, list)) else shard_data
    n_shards = first.shape[0]
    eps = _per_chain(step_size)
    drift = eps / n_shards
    for _ in range(num_steps):
        for i in range(n_shards):
            shard = _shard(shard_data, i)
            _, g = shard_value_and_grad_fn(q, shard)
            p = p + 0.5 * eps * g
            q = q + drift * mass_velocity(inv_mass, p)
            _, g = shard_value_and_grad_fn(q, shard)
            p = p + 0.5 * eps * g
    return q, p
