"""Gram-form trajectory gradient of the DeepONet merge + Gaussian NLL.

Counterpart of ``vihmc_tpu/ops/gram_merge.py`` (``merge_nll_gram_cotangents``,
``make_gram_grad_full``, ``infer_grid_shape``, ``grid_stride_subset``). With
residual cotangent r = (y - pred)/var the merge cotangents need only K x K
Gram matrices and two thin contractions against the data, never the (B, P)
prediction:

    d ll/d bout = (y @ tout  - bout @ (tout^T tout) - b sum_j tout_j) / var
    d ll/d tout = (y^T @ bout - tout @ (bout^T bout) - b sum_i bout_i) / var
    d ll/d b    = (sum y - (sum_i bout_i).(sum_j tout_j) - B P b) / var

The feature VJP then runs through ``torch.autograd`` over the chain-batched
feature stacks. This is plain matmul work (XLA's in JAX), so it stays
``torch.matmul``.

The stride surrogates. ``query_subset`` keeps only those query points and
``fn_subset`` only those training functions, the likelihood term rescaled by
``P / p`` and ``B / b``: every cost of the field scales with the points and
functions kept, and the fixed subsets keep it deterministic, so MH on the
exact full density at the endpoints stays unbiased (only acceptance moves).
:func:`grid_stride_subset` gives every ``stride``-th point of the regular
(t, x) grid in both dimensions.

Precision. With ``compute_dtype=torch.bfloat16`` the stacks, the data and the
cotangents entering the VJP are bf16, as in JAX (the subsets are taken
first, and the rescale applies to the f32 cotangents before their cast).
Where JAX writes ``preferred_element_type=float32`` (the Gram matrices and
the two data contractions) the port upcasts the bf16 operands to f32 and
multiplies under :func:`~vihmc_torch.core.precision.bf16_exact_tf32`: every
bf16 value is exact in TF32, so the products are exact and accumulate in f32
to an f32 result -- the same contract, on the tensor cores. The gradient is a
trajectory field only: any deterministic field keeps leapfrog reversible and
volume-preserving, and MH on the exact f32 density stays unbiased.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vihmc_torch.core.precision import bf16_exact_tf32
from vihmc_torch.core.profiling import span
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
                        compute_dtype=None, query_subset=None, fn_subset=None,
                        prior=None):
    """``grad_full(flat (C, D)) -> (C, D)`` f32: d log-likelihood / d flat of
    the shared-grid homoscedastic DeepONet (NLL with variance ``tau_var``),
    equal to autograd of the composed likelihood up to the Gram-form
    rounding; plus ``prior.grad(flat)`` when a full-vector ``prior`` is given.
    ``query_subset`` / ``fn_subset`` (index arrays into the P points / the B
    functions) make it the rescaled stride surrogate; ``compute_dtype=
    torch.bfloat16`` runs stacks, data and VJP in bf16 (module doc). Spans
    ``vihmc.field.forward`` (unravel and feature stacks),
    ``vihmc.field.cotangents`` (the Gram cotangents, scaled and cast) and
    ``vihmc.field.vjp`` (the feature VJP)."""
    if cfg.noise_neurons:
        raise ValueError("Gram-form gradient covers the homoscedastic merge only")
    if trunk_x.ndim != 2:
        raise ValueError("Gram-form gradient requires a shared query grid (P, 2)")
    ll_scale = 1.0
    if query_subset is not None:
        sel = torch.as_tensor(np.asarray(query_subset), dtype=torch.int64,
                              device=trunk_x.device)
        ll_scale = trunk_x.shape[0] / sel.shape[0]
        trunk_x, y = trunk_x[sel], y[:, sel]
    if fn_subset is not None:
        fsel = torch.as_tensor(np.asarray(fn_subset), dtype=torch.int64,
                               device=branch_x.device)
        ll_scale = ll_scale * (branch_x.shape[0] / fsel.shape[0])
        branch_x, y = branch_x[fsel], y[fsel]
    dt = torch.float32 if compute_dtype is None else compute_dtype
    bx, tx, yy = (t.to(dt).contiguous() for t in (branch_x, trunk_x, y))

    def grad_full(flat: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            leaf = flat.detach().to(torch.float32).requires_grad_(True)
            with span("vihmc.field.forward"):
                params = unravel_deeponet(cfg, leaf.to(dt))
                bout, tout = deeponet_features(cfg, params, bx, tx)
            bias = params["b"]
            with span("vihmc.field.cotangents"):
                with torch.no_grad():
                    cts = merge_nll_gram_cotangents(bout, tout, bias, yy, tau_var)
                    if ll_scale != 1.0:
                        cts = [ll_scale * ct for ct in cts]
                cts = [ct.to(dt) for ct in cts]
            with span("vihmc.field.vjp"):
                (g,) = torch.autograd.grad((bout, tout, bias), leaf, grad_outputs=cts)
        if prior is not None:
            g = g + prior.grad(flat)
        return g

    return grad_full


def infer_grid_shape(trunk_x):
    """``(nt, nx)`` of a t-major raveled regular grid ``trunk_x`` (nt nx, 2)
    with columns (t, x): each t value fills one contiguous block of nx rows.
    Raises ValueError if the layout does not hold."""
    t = np.asarray(trunk_x.cpu() if isinstance(trunk_x, torch.Tensor) else trunk_x)[:, 0]
    nx = int(np.sum(t == t[0]))
    p = t.shape[0]
    if nx == 0 or p % nx:
        raise ValueError(f"not a regular t-major grid: P={p}, nx={nx}")
    nt = p // nx
    rows = t.reshape(nt, nx)
    if not (rows == rows[:, :1]).all():
        raise ValueError("not a regular t-major grid: t varies within rows")
    return nt, nx


def grid_stride_subset(nt: int, nx: int, stride: int) -> np.ndarray:
    """Indices of every ``stride``-th point of a t-major (nt, nx) raveled
    grid in both dimensions, the first point of each included."""
    ti = np.arange(0, nt, stride)
    xi = np.arange(0, nx, stride)
    return (ti[:, None] * nx + xi[None, :]).ravel()
