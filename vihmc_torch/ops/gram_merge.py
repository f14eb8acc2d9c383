"""Gram-form trajectory gradient of the DeepONet merge + Gaussian NLL.

Counterpart of ``vihmc_tpu/ops/gram_merge.py`` (``merge_nll_gram_cotangents``,
``make_gram_grad_full``). With residual cotangent r = (y - pred)/var the merge
cotangents need only K x K Gram matrices and two thin contractions against the
data, never the (B, P) prediction:

    d ll/d bout = (y @ tout  - bout @ (tout^T tout) - b sum_j tout_j) / var
    d ll/d tout = (y^T @ bout - tout @ (bout^T bout) - b sum_i bout_i) / var
    d ll/d b    = (sum y - (sum_i bout_i).(sum_j tout_j) - B P b) / var

The feature VJP then runs through ``torch.autograd`` over the chain-batched
feature stacks. This is plain matmul work (XLA's in JAX), so it stays
``torch.matmul``.

Precision. With ``compute_dtype=torch.bfloat16`` the stacks, the data and the
cotangents entering the VJP are bf16, as in JAX. Where JAX writes
``preferred_element_type=float32`` (the Gram matrices and the two data
contractions) the port upcasts the bf16 operands to f32 and multiplies under
:func:`~vihmc_torch.core.precision.bf16_exact_tf32`: every bf16 value is exact
in TF32, so the products are exact and accumulate in f32 to an f32 result --
the same contract, on the tensor cores. The gradient is a trajectory field
only: any deterministic field keeps leapfrog reversible and volume-preserving,
and MH on the exact f32 density stays unbiased.

Only the full grid (stride 1) is ported; the query and function subsets can
follow.
"""

from __future__ import annotations

import contextlib

import torch

from vihmc_torch.core.precision import bf16_exact_tf32
from vihmc_torch.models.deeponet import (DeepONetConfig, deeponet_features,
                                         unravel_deeponet)

GNLL_EPS = 1e-6


def merge_nll_gram_cotangents(bout, tout, bias, y, tau):
    """``(d ll/d bout (C,B,K), d ll/d tout (C,P,K), d ll/d bias (C,))`` in f32,
    without forming (B, P). ``y`` (B, P) is shared by all chains."""
    var = max(float(tau), GNLL_EPS)
    f32 = torch.float32
    bo, to, yy = bout.to(f32), tout.to(f32), y.to(f32)
    b = bias.to(f32)
    sum_t = to.sum(-2)                                        # (C, K)
    sum_b = bo.sum(-2)                                        # (C, K)
    with bf16_exact_tf32() if bout.dtype == torch.bfloat16 else contextlib.nullcontext():
        gram_t = torch.matmul(to.transpose(-1, -2), to)       # (C, K, K)
        gram_b = torch.matmul(bo.transpose(-1, -2), bo)
        yt = torch.matmul(yy, to)                             # (C, B, K)
        yb = torch.matmul(yy.T, bo)                           # (C, P, K)
        ct_bout = (yt - torch.matmul(bo, gram_t) - b[:, None, None] * sum_t[:, None, :]) / var
        ct_tout = (yb - torch.matmul(to, gram_b) - b[:, None, None] * sum_b[:, None, :]) / var
    n = y.shape[0] * y.shape[1]
    ct_bias = (yy.sum() - (sum_b * sum_t).sum(-1) - n * b) / var
    return ct_bout, ct_tout, ct_bias


def make_gram_grad_full(cfg: DeepONetConfig, branch_x, trunk_x, y, tau_var,
                        compute_dtype=None):
    """``grad_full(flat (C, D)) -> (C, D)`` f32: d log-likelihood / d flat of
    the shared-grid homoscedastic DeepONet (NLL with variance ``tau_var``),
    equal to autograd of the composed likelihood up to the Gram-form
    rounding. ``compute_dtype=torch.bfloat16`` runs stacks, data and VJP in
    bf16 (module doc)."""
    if cfg.noise_neurons:
        raise ValueError("Gram-form gradient covers the homoscedastic merge only")
    if trunk_x.ndim != 2:
        raise ValueError("Gram-form gradient requires a shared query grid (P, 2)")
    dt = torch.float32 if compute_dtype is None else compute_dtype
    bx, tx, yy = branch_x.to(dt), trunk_x.to(dt), y.to(dt)

    def grad_full(flat: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            leaf = flat.detach().to(torch.float32).requires_grad_(True)
            params = unravel_deeponet(cfg, leaf.to(dt))
            bout, tout = deeponet_features(cfg, params, bx, tx)
            bias = params["b"]
            with torch.no_grad():
                cts = merge_nll_gram_cotangents(bout, tout, bias, yy, tau_var)
            cts = [ct.to(dt) for ct in cts]
            (g,) = torch.autograd.grad((bout, tout, bias), leaf, grad_outputs=cts)
        return g

    return grad_full
