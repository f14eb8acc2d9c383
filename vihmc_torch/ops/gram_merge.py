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
feature stacks. In bf16 (``compute_dtype=torch.bfloat16``) with tanh stacks
that fit them (:func:`~vihmc_torch.ops.field_stacks.fusable`), the stacks are
the fused layers of :mod:`vihmc_torch.ops.field_stacks` (CUDA kernels on the
card, their plain version on the CPU): the inputs are padded and cast once
when the field is made, and the VJP writes the flat gradient itself. Every
other field (f32, relu or sine stacks) runs ``mlp_stack`` with ``torch.matmul``
(XLA's matmuls in JAX).

The stride surrogates. ``query_subset`` keeps only those query points and
``fn_subset`` only those training functions, the likelihood term rescaled by
``P / p`` and ``B / b``: every cost of the field scales with the points and
functions kept, and the fixed subsets keep it deterministic, so MH on the
exact full density at the endpoints stays unbiased (only acceptance moves).
:func:`grid_stride_subset` gives every ``stride``-th point of the regular
(t, x) grid in both dimensions.

Precision. With ``compute_dtype=torch.bfloat16`` the stacks, the data and the
cotangents entering the VJP are bf16, as in JAX (the subsets are taken
first, and the rescale applies to the f32 cotangents before their cast); on
the fused stacks the biases, tanh and its derivative stay f32, each
activation is rounded once, and the weight gradients are summed in f32.
Where JAX writes ``preferred_element_type=float32`` (the Gram matrices and
the two data contractions) the port keeps the bf16 operands and asks for an
f32 result (``out_dtype``): exact products, summed in f32 on the tensor
cores -- the same contract. ``feat @ gram`` multiplies by an f32 Gram matrix,
so it runs as two such products, on a bf16 high part of the Gram matrix and
on the bf16 rounding of the rest (16 mantissa bits). The CPU has no
``out_dtype`` product, and f32 stacks want none: there the operands are f32
and every product is f32. The gradient is a trajectory field only: any
deterministic field keeps leapfrog reversible and volume-preserving, and MH
on the exact f32 density stays unbiased.
"""

from __future__ import annotations

import numpy as np
import torch

from vihmc_torch.core.profiling import count, detail_span
from vihmc_torch.models.deeponet import (DeepONetConfig, bc_embedding, deeponet_features,
                                         unravel_deeponet)
from vihmc_torch.ops.field_stacks import FeatureStacks, fusable

GNLL_EPS = 1e-6


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def pad_queries(y: torch.Tensor, dtype) -> torch.Tensor:
    """``y`` (B, P) as (B, P8) in ``dtype``, P8 the multiple of 8 at or above
    P, the pad columns zero: every row of the data operand starts on 16
    bytes."""
    b, p = y.shape
    out = y.new_zeros((b, _ceil8(p)), dtype=dtype)
    out[:, :p] = y
    return out


def _merged_route(feat: torch.Tensor) -> bool:
    """bf16 features on CUDA: bf16 operands, f32 products (``out_dtype``)."""
    return feat.is_cuda and feat.dtype == torch.bfloat16


def _side_by_side(feat, rows: int, k8: int, dtype, bufs, key):
    """``feat`` (C, N, K) as (rows, C, K8), K8 > K: each row holds every
    chain's K features in a block of K8, then a one (rows below N: zero), then
    zeros. Against the block, a Gram matrix's row K is the features' column
    sums, and ``feat @ gram`` adds that row. With ``bufs`` (a dict) the array
    is kept there and reused for features of the same shape: only the
    features are written again."""
    c, n, k = feat.shape
    buf = None if bufs is None else bufs.get(key)
    if buf is None or buf.shape != (rows, c, k8) or buf.dtype != dtype:
        buf = feat.new_zeros((rows, c, k8), dtype=dtype)
        buf[:n, :, k] = 1
        if bufs is not None:
            bufs[key] = buf
    buf[:n, :, :k] = feat.transpose(0, 1)
    return buf


def _gram_parts(gram: torch.Tensor, merged: bool):
    """The right-hand operands whose products sum to ``feat @ gram``: on the
    merged route a bf16 high part and the bf16 rounding of the rest (16
    mantissa bits together, against TF32's 10), else ``gram`` itself."""
    if not merged:
        return (gram,)
    hi = gram.to(torch.bfloat16)
    return hi, torch.sub(gram, hi, out=torch.empty_like(hi))


def _gram_cotangents(bout, tout, bias, yp, y_sum, var, scale=1.0,
                     out_dtype=torch.float32, bufs=None):
    """``scale`` x the Gram cotangents (module doc) of C chains at once:
    ``(ct_bout (C, B, K), ct_tout (C, P, K), ct_bias (C,))`` in ``out_dtype``,
    contiguous. ``yp`` is :func:`pad_queries` of ``y``, ``y_sum`` the sum of
    ``y``; ``bufs`` a dict that keeps the layouts between calls.

    The chains' features lie side by side (:func:`_side_by_side`), each in a
    block of K8 columns: ``t`` (P8, C K8) and ``bo`` (B, C K8). The Gram
    matrices of the blocks carry the column sums in row K; scaled by the
    bias, that row makes ``feat @ gram`` carry the bias term as well. Then
    ``s yp @ t`` and ``s yp^T @ bo`` are one GEMM each over every chain
    (``s = scale / var``), their chain blocks take ``- s feat @ gram`` in
    place (batched), and one copy writes each cotangent. On CUDA with bf16
    features (the merged route) the operands stay bf16 and every product
    returns f32 (``out_dtype``): exact products, f32 sums. Elsewhere the
    operands are f32 and so are the products."""
    c, b, k = bout.shape
    p, p8, k8 = tout.shape[1], yp.shape[1], _ceil8(k + 1)
    merged = _merged_route(bout)
    op = torch.bfloat16 if merged else torch.float32
    f32 = {"out_dtype": torch.float32} if merged else {}
    s = scale / var
    t = _side_by_side(tout, p8, k8, op, bufs, "t")
    bo = _side_by_side(bout, b, k8, op, bufs, "bo")
    t_c, bo_c = t.transpose(0, 1), bo.transpose(0, 1)        # (C, P8, K8), (C, B, K8)
    gram_t = torch.bmm(t_c.transpose(1, 2), t_c, **f32)       # (C, K8, K8)
    gram_b = torch.bmm(bo_c.transpose(1, 2), bo_c, **f32)
    sum_t, sum_b = gram_t[:, k, :k], gram_b[:, k, :k]          # (C, K) each
    bb = bias.to(torch.float32)
    ct_bias = (sum_b * sum_t).sum(-1).add_(bb, alpha=b * p).mul_(-s).add_(s * y_sum)
    gram_t[:, k].mul_(bb[:, None])
    gram_b[:, k].mul_(bb[:, None])
    yt = yp.new_empty((b, c * k8), dtype=torch.float32)
    yb = yp.new_empty((p8, c * k8), dtype=torch.float32)
    torch.addmm(yt, yp, t.view(p8, c * k8), beta=0, alpha=s, out=yt, **f32)
    torch.addmm(yb, yp.T, bo.view(b, c * k8), beta=0, alpha=s, out=yb, **f32)
    yt_c = yt.view(b, c, k8).transpose(0, 1)                  # (C, B, K8)
    yb_c = yb.view(p8, c, k8).transpose(0, 1)                 # (C, P8, K8)
    for acc, feat, gram in ((yt_c, bo_c, gram_t), (yb_c, t_c, gram_b)):
        for part in _gram_parts(gram, merged):
            torch.baddbmm(acc, feat, part, beta=1, alpha=-s, out=acc, **f32)
    if merged:
        count("field.cotangents.merged")
    ct_bout = bout.new_empty((c, b, k), dtype=out_dtype).copy_(yt_c[:, :, :k])
    ct_tout = tout.new_empty((c, p, k), dtype=out_dtype).copy_(yb_c[:, :p, :k])
    return ct_bout, ct_tout, ct_bias.to(out_dtype)


def merge_nll_gram_cotangents(bout, tout, bias, y, tau):
    """``(d ll/d bout (C,B,K), d ll/d tout (C,P,K), d ll/d bias (C,))`` in f32,
    without forming (B, P). ``y`` (B, P) is shared by all chains."""
    yp = pad_queries(y, torch.bfloat16 if _merged_route(bout) else torch.float32)
    return _gram_cotangents(bout, tout, bias, yp, y.sum(dtype=torch.float32),
                            max(float(tau), GNLL_EPS))


def make_gram_grad_full(cfg: DeepONetConfig, branch_x, trunk_x, y, tau_var,
                        compute_dtype=None, query_subset=None, fn_subset=None,
                        prior=None):
    """``grad_full(flat (C, D)) -> (C, D)`` f32: d log-likelihood / d flat of
    the shared-grid homoscedastic DeepONet (NLL with variance ``tau_var``),
    equal to autograd of the composed likelihood up to the Gram-form
    rounding; plus ``prior.grad(flat)`` when a full-vector ``prior`` is given.
    ``query_subset`` / ``fn_subset`` (index arrays into the P points / the B
    functions) make it the rescaled stride surrogate; ``compute_dtype=
    torch.bfloat16`` runs stacks, data and VJP in bf16 (module doc), on the
    fused stacks where :func:`fusable` admits them. Spans
    ``vihmc.field.forward`` (the feature stacks: the fused stacks' pack and
    forward, or unravel and ``mlp_stack``), ``vihmc.field.cotangents`` (the
    Gram cotangents, scaled and cast) and ``vihmc.field.vjp`` (the feature
    VJP under ``autograd.grad``)."""
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
    yy = y.to(dt).contiguous()
    yp = pad_queries(yy, torch.bfloat16 if _merged_route(yy) else torch.float32)
    y_sum = float(yy.sum(dtype=torch.float32))
    var = max(float(tau_var), GNLL_EPS)
    bufs = {}
    trunk_in = bc_embedding(trunk_x.float()) if cfg.impose_bc else trunk_x.float()
    if dt == torch.bfloat16 and fusable(cfg, branch_x.shape[1], trunk_in.shape[1]):
        features = FeatureStacks(cfg, branch_x.float(), trunk_in, dt)
    else:
        bx, tx = branch_x.to(dt).contiguous(), trunk_x.to(dt).contiguous()

        def features(leaf):
            params = unravel_deeponet(cfg, leaf.to(dt))
            return (*deeponet_features(cfg, params, bx, tx), params["b"])

    def grad_full(flat: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            leaf = flat.detach().to(torch.float32).requires_grad_(True)
            with detail_span("vihmc.field.forward"):
                bout, tout, bias = features(leaf)
            with detail_span("vihmc.field.cotangents"):
                with torch.no_grad():
                    cts = _gram_cotangents(bout, tout, bias, yp, y_sum, var, ll_scale, dt,
                                           bufs)
            with detail_span("vihmc.field.vjp"):
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
