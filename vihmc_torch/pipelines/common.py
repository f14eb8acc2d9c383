"""Flat-vector DeepONet closures and the paired MH delta evaluators.

Counterpart of ``vihmc_tpu/pipelines/common.py``: ``make_flat_deeponet``
(:50-66), ``make_paired_subspace_delta`` (:154-192, the composed plain path)
and ``make_fused_paired_subspace_delta`` (:195-226, the kernel path the
operator row runs on the card). Every closure takes chain-batched tensors:
flat ``(C, D)``, subspace ``(C, d)``; the frozen vector ``aux`` is ``(D,)``.
"""

from __future__ import annotations

import math

import torch

from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.dists.likelihoods import GNLL_EPS, nll_log_likelihood
from vihmc_torch.models.deeponet import (DeepONetConfig, deeponet_apply,
                                         deeponet_features, unravel_deeponet)
from vihmc_torch.ops.deeponet_merge import fused_paired_delta, y_sums


def make_flat_deeponet(cfg: DeepONetConfig, compute_dtype=None):
    """``apply_flat(flat (C, D), branch_x, trunk_x) -> (C, B, P)`` f32.

    With ``compute_dtype`` the forward runs in that dtype (parameters and
    inputs cast) and the result returns as f32, as in JAX.
    """

    def apply_flat(flat, branch_x, trunk_x):
        if compute_dtype is None:
            return deeponet_apply(cfg, unravel_deeponet(cfg, flat), branch_x, trunk_x)
        params = unravel_deeponet(cfg, flat.to(compute_dtype))
        out = deeponet_apply(cfg, params, branch_x.to(compute_dtype),
                             trunk_x.to(compute_dtype))
        return out.float()

    return apply_flat


def make_paired_subspace_delta(apply_flat, branch_x, trunk_x, y, tau_var,
                               idx, prior):
    """Composed paired MH delta: ``delta_fn(q1, q0, aux) -> (dlp (C,), lp1 (C,))``.

    Both forwards run in IEEE f32 and are materialized; ``dlp`` is one
    reduction of per-cell differences ``-0.5/var sum (e1 - e0)(e1 + e0)``
    plus the prior difference, ``lp1`` the proposal's log-density record
    (torch GaussianNLLLoss convention, no 2 pi constant).
    """
    var = max(float(tau_var), GNLL_EPS)
    const = -0.5 * y.numel() * math.log(var)

    def delta_fn(q1, q0, aux):
        with true_f32():
            p1 = apply_flat(scatter_subspace(aux, q1, idx), branch_x, trunk_x)
            p0 = apply_flat(scatter_subspace(aux, q0, idx), branch_x, trunk_x)
        e1 = p1 - y
        e0 = p0 - y
        dll = (-0.5 / var) * ((e1 - e0) * (e1 + e0)).flatten(1).sum(-1)
        dpr = prior.log_prob(q1) - prior.log_prob(q0)
        lp1 = (-0.5 / var) * (e1 * e1).flatten(1).sum(-1) + const + prior.log_prob(q1)
        return dll + dpr, lp1

    return delta_fn


def make_fused_paired_subspace_delta(cfg: DeepONetConfig, branch_x, trunk_x,
                                     y, tau_var, idx, prior):
    """Kernel variant of :func:`make_paired_subspace_delta`: the feature
    stacks run composed in IEEE f32, then both endpoint merges and their
    paired reduction run in :func:`~vihmc_torch.ops.deeponet_merge.
    fused_paired_delta` (one kernel launch for all chains on the card)."""
    tau = float(tau_var)
    sums_y = y_sums(y)

    def delta_fn(q1, q0, aux):
        params1 = unravel_deeponet(cfg, scatter_subspace(aux, q1, idx))
        params0 = unravel_deeponet(cfg, scatter_subspace(aux, q0, idx))
        with true_f32():
            bout1, tout1 = deeponet_features(cfg, params1, branch_x, trunk_x)
            bout0, tout0 = deeponet_features(cfg, params0, branch_x, trunk_x)
        dll, lp1 = fused_paired_delta(
            bout1.contiguous(), tout1.contiguous(), params1["b"],
            bout0.contiguous(), tout0.contiguous(), params0["b"], y, tau,
            y_sum_pair=sums_y)
        lp_q1 = prior.log_prob(q1)
        return dll + (lp_q1 - prior.log_prob(q0)), lp1 + lp_q1

    return delta_fn


def make_nll_log_likelihood(cfg: DeepONetConfig, branch_x, trunk_x, y, tau_var):
    """Composed f32 log-likelihood ``full_ll(flat (C, D)) -> (C,)``: the
    materialized forward in IEEE f32 and ``-sum`` Gaussian NLL -- the
    ``full_ll`` of ``bench.py:465-481`` (initial state, Lanczos HVPs)."""
    apply_flat = make_flat_deeponet(cfg)

    def full_ll(flat):
        with true_f32():
            pred = apply_flat(flat, branch_x, trunk_x)
        return nll_log_likelihood(pred, y, tau_var)

    return full_ll
