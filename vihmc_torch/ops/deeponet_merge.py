"""Fused paired MH log-density difference of the DeepONet merge.

Counterpart of the paired half of ``vihmc_tpu/ops/deeponet_merge.py``
(``fused_paired_delta``, ``paired_delta_reference``). The MH test of the
operator row needs, per chain,

    ll(q1) - ll(q0) = -0.5/var * sum (e1 - e0)(e1 + e0),   e_i = m_i + b_i - y,

over the (B, P) = (1000, 10201) grid, with ``m_i = bout_i @ tout_i^T``.
:func:`paired_sums` computes five sums of the two merges in one CUDA kernel
(``csrc/paired_sums.cu``) without writing either (B, P) product to device
memory; :func:`fused_paired_delta` closes the scalar-bias algebra on the host
side as torch ops on the device. The MH-critical sums D and Bd add SMALL
per-cell differences, so the f32 error stays far below a nat.

:func:`paired_sums_reference` is the plain version: it materializes both
products per chain. CPU tensors take it; CUDA tensors launch the kernel or
raise -- there is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vihmc_torch.core.precision import true_f32
from vihmc_torch.ops import cuda_build

GNLL_EPS = 1e-6
N_SUMS = 5  # D, Bd, Sm, Q1, C1


def _check_inputs(bout1, tout1, bout0, tout0, y):
    ts = (bout1, tout1, bout0, tout0, y)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("paired_sums takes torch tensors")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("paired_sums takes float32 tensors, got "
                        f"{[t.dtype for t in ts]}")
    dev = bout1.device
    if any(t.device != dev for t in ts):
        raise ValueError("paired_sums inputs must share one device")
    if bout1.ndim != 3 or tout1.ndim != 3 or y.ndim != 2:
        raise ValueError("paired_sums takes bout (C, B, K), tout (C, P, K), y (B, P)")
    c, b, k = bout1.shape
    p = tout1.shape[1]
    if (tuple(bout0.shape) != (c, b, k) or tuple(tout1.shape) != (c, p, k)
            or tuple(tout0.shape) != (c, p, k) or tuple(y.shape) != (b, p)):
        raise ValueError(
            f"shape mismatch: bout1 {tuple(bout1.shape)}, bout0 "
            f"{tuple(bout0.shape)}, tout1 {tuple(tout1.shape)}, tout0 "
            f"{tuple(tout0.shape)}, y {tuple(y.shape)}")
    if min(c, b, p, k) < 1:
        raise ValueError("paired_sums needs non-empty inputs")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("paired_sums takes contiguous tensors")
    return c, b, p, k


def paired_sums_reference(bout1, tout1, bout0, tout0, y) -> torch.Tensor:
    """Plain version: ``(C, 5)`` f32 sums ``[D, Bd, Sm, Q1, C1]``, both
    products materialized per chain in IEEE f32."""
    _check_inputs(bout1, tout1, bout0, tout0, y)
    rows = []
    with true_f32():
        for c in range(bout1.shape[0]):
            m1 = bout1[c] @ tout1[c].T
            m0 = bout0[c] @ tout0[c].T
            dm = m1 - m0
            sm = m1 + m0
            rows.append(torch.stack([(dm * (sm - 2.0 * y)).sum(), dm.sum(),
                                     sm.sum(), (m1 * m1).sum(),
                                     (m1 * y).sum()]))
    return torch.stack(rows)


def paired_sums(bout1, tout1, bout0, tout0, y) -> torch.Tensor:
    """``(C, 5)`` f32 sums ``[D, Bd, Sm, Q1, C1]`` per chain (see module doc).

    CUDA tensors: one launch of the hand-written kernel for all chains (plus
    its fixed-order reduction), counted in ``paired_sums.launches``. CPU
    tensors: :func:`paired_sums_reference`. Anything else raises.
    """
    c, b, p, k = _check_inputs(bout1, tout1, bout0, tout0, y)
    dev = bout1.device
    if dev.type == "cpu":
        return paired_sums_reference(bout1, tout1, bout0, tout0, y)
    if dev.type != "cuda":
        raise ValueError(f"paired_sums runs on CUDA or CPU tensors, not {dev}")
    lib = cuda_build.load("paired_sums")
    with torch.cuda.device(dev):
        scratch = torch.empty((c, lib.vihmc_paired_sums_scratch(b, p)),
                              dtype=torch.float32, device=dev)
        out = torch.empty((c, N_SUMS), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vihmc_paired_sums(
            bout1.data_ptr(), tout1.data_ptr(), bout0.data_ptr(),
            tout0.data_ptr(), y.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            c, b, p, k, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"paired_sums kernel launch failed: CUDA error {err}")
    paired_sums.launches += 1
    return out


paired_sums.launches = 0


def y_sums(y: torch.Tensor):
    """``(sum y, sum y^2)`` in f64 -- computed once per dataset."""
    y64 = y.double()
    return y64.sum(), (y64 * y64).sum()


def close_paired_sums(sums, bias1, bias0, n_valid: int, tau: float, sum_y, sum_y2):
    """``(dll, lp1)`` per chain from the five sums and the scalar biases.

    The closure runs in f64 (five scalars per chain) and returns f32; JAX
    closes in f32, so the port's rounding here is only smaller.
    """
    s = sums.double()
    d, bd, sm, q1, c1 = s.unbind(-1)
    b1, b0 = bias1.double(), bias0.double()
    var = max(float(tau), GNLL_EPS)
    db = b1 - b0
    sb = b1 + b0
    # sum (e1-e0)(e1+e0) expanded so every MH-critical sum adds small terms
    core = d + sb * bd + db * (sm - 2.0 * sum_y) + db * sb * n_valid
    dll = (-0.5 / var) * core
    b1s = 0.5 * (sm + bd)  # sum(m1) = (Sm + Bd) / 2
    sum_e1sq = (q1 + 2.0 * b1 * b1s - 2.0 * c1 + n_valid * b1 * b1
                - 2.0 * b1 * sum_y + sum_y2)
    lp1 = -0.5 * (n_valid * math.log(var) + sum_e1sq / var)
    return dll.float(), lp1.float()


def fused_paired_delta(bout1, tout1, bias1, bout0, tout0, bias0, y, tau,
                       y_sum_pair=None):
    """Paired MH delta ``(ll(q1) - ll(q0), ll(q1))`` per chain, ``(C,)`` each,
    without materializing either (B, P) prediction.

    ``bout`` (C, B, K), ``tout`` (C, P, K), ``bias`` (C,), ``y`` (B, P), all
    f32 on one device. ``y_sum_pair`` is :func:`y_sums` of ``y``, computed
    once by the caller (recomputed here when omitted).
    """
    sums = paired_sums(bout1, tout1, bout0, tout0, y)
    sum_y, sum_y2 = y_sums(y) if y_sum_pair is None else y_sum_pair
    return close_paired_sums(sums, bias1, bias0, y.shape[0] * y.shape[1], tau,
                             sum_y, sum_y2)


def paired_delta_reference(bout1, tout1, b1, bout0, tout0, b0, y, tau):
    """Materialized reference of the paired delta: ``(dll, lp1)``, ``(C,)`` each."""
    var = max(float(tau), GNLL_EPS)
    with true_f32():
        p1 = torch.matmul(bout1, tout1.transpose(-1, -2)) + b1[:, None, None]
        p0 = torch.matmul(bout0, tout0.transpose(-1, -2)) + b0[:, None, None]
    e1, e0 = p1 - y, p0 - y
    dll = (-0.5 / var) * ((e1 - e0) * (e1 + e0)).flatten(1).sum(-1)
    lp1 = -0.5 * (math.log(var) + e1 * e1 / var).flatten(1).sum(-1)
    return dll, lp1
