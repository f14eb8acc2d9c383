"""Fused DeepONet merge + Gaussian NLL, and the fused paired MH delta.

Counterpart of ``vihmc_tpu/ops/deeponet_merge.py``, both halves.

**The merge half** (``merge_nll_reference``, ``fused_merge_nll``, :51-238).
The exact density of the unpaired MH test is

    ll = -sum 0.5 (log var + (bout @ tout^T + b - y)^2 / var)

over the (B, P) grid. :func:`merge_sums` computes ``S1 = sum m (m - 2 y)``
and ``S2 = sum m`` of ``m = bout @ tout^T`` in one CUDA kernel
(``csrc/merge_sums.cu``) for all chains, without writing the (B, P) product,
and :func:`fused_merge_nll` closes the scalar-bias algebra in f64:
``SSE = S1 + sum y^2 + 2 b (S2 - sum y) + N b^2``. Its backward is the
composed VJP of the JAX ``_bwd``: the prediction is rematerialized with
``torch.matmul`` (XLA in JAX, not Pallas). :func:`merge_sums_reference` is
the plain version.

**The paired half.** The MH test of the operator row needs, per chain,

    ll(q1) - ll(q0) = -0.5/var * sum (e1 - e0)(e1 + e0),   e_i = m_i + b_i - y,

over the (B, P) = (1000, 10201) grid, with ``m_i = bout_i @ tout_i^T``.
:func:`paired_sums` computes five sums of the two merges in one CUDA kernel
(``csrc/paired_sums.cu``) without writing either (B, P) product to device
memory; :func:`fused_paired_delta` closes the scalar-bias algebra on the host
side as torch ops on the device. The MH-critical sums D and Bd add SMALL
per-cell differences, so the f32 error stays far below a nat.

:func:`paired_sums_reference` is the plain version: it materializes both
products per chain. For both kernels, CPU tensors take the plain version;
CUDA tensors launch the kernel or raise -- there is no fallback.

**Two kernels per function.** Each source holds the chain-batched tiled
kernel (128 x 128 tiles that walk every chain) and a small-problem kernel
(one chain and 64 P rows x 16-64 B rows per block, one launch). The wrapper
picks one by a plain rule on (C, B), :func:`_sums_path`: the small kernel at
one or two chains and below 128 B rows, where the tiled one has little to
overlap or pads its tile with zeros.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.profiling import count
from vihmc_torch.ops import cuda_build

GNLL_EPS = 1e-6
N_SUMS = 5  # D, Bd, Sm, Q1, C1
N_MERGE_SUMS = 2  # S1, S2
SMALL_B = 128      # B rows below which the small kernel runs at any C (the tiled tile's rows)
SMALL_MAX_C = 2    # chains up to which it runs at B >= SMALL_B
SMALL_P_ROWS = 64  # P rows of a small-kernel block (wgmma's M)


def _sums_path(c: int, b: int) -> str:
    """``'small'`` or ``'tiled'``: the kernel both wrappers launch for C
    chains of B rows. On an H100 at B = 1000, P = 10,201, K = 100 the small
    kernel's time grows with C about as fast as the tiled one's work, while
    the tiled one's falls per chain as its walk overlaps chains: the small
    one is faster at C = 1 and 2, the tiled one from C = 4 (``chip_smoke.py``
    phase 28 (c) prints the table and holds the rule to it). Below 128 rows
    the tiled tile is mostly zeros, and the small kernel is faster at every
    C measured (1 to 8)."""
    return "small" if c <= SMALL_MAX_C or b < SMALL_B else "tiled"


def _count(kernel: str, c: int, path: str, flops: int):
    """Count one launch of ``kernel`` at C = ``c`` on ``path``: its launches,
    those at C = 1 (the unbatched form's) and those of the small kernel
    apart, and its products' FLOPs in ``kernel.flops``."""
    count(f"{kernel}.launches")
    count(f"{kernel}.launches_c1", int(c == 1))
    count(f"{kernel}.launches_small", int(path == "small"))
    count("kernel.flops", flops)


def _small_tile_n(b: int) -> int:
    """B rows of a small-kernel block (wgmma's N): 16, 32 or 64."""
    return 16 if b <= 16 else 32 if b <= 32 else 64


def _small_blocks(b: int, p: int) -> int:
    """Small-kernel blocks per chain, one slot of sums each."""
    return -(-p // SMALL_P_ROWS) * -(-b // _small_tile_n(b))


_tickets: dict = {}


def chain_tickets(dev, stream: int, c: int) -> torch.Tensor:
    """Per-chain counters on (device, stream) of the kernels whose last block
    of a chain adds the blocks' slots in order (the small merge kernels here,
    the FNO projection's backward in ``fno_project``): zeroed once here, and
    set back to 0 by that last block of every launch, so launches on one
    stream share them in turn."""
    t = _tickets.get((dev, stream))
    if t is None or t.numel() < c:
        t = torch.zeros(max(c, 64), dtype=torch.int32, device=dev)
        _tickets[(dev, stream)] = t
    return t


def _check_merge_inputs(bout, tout, y):
    ts = (bout, tout, y)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("merge_sums takes torch tensors")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"merge_sums takes float32 tensors, got {[t.dtype for t in ts]}")
    if any(t.device != bout.device for t in ts):
        raise ValueError("merge_sums inputs must share one device")
    if bout.ndim != 3 or tout.ndim != 3 or y.ndim != 2:
        raise ValueError("merge_sums takes bout (C, B, K), tout (C, P, K), y (B, P)")
    c, b, k = bout.shape
    p = tout.shape[1]
    if tuple(tout.shape) != (c, p, k) or tuple(y.shape) != (b, p):
        raise ValueError(f"shape mismatch: bout {tuple(bout.shape)}, tout "
                         f"{tuple(tout.shape)}, y {tuple(y.shape)}")
    if min(c, b, p, k) < 1:
        raise ValueError("merge_sums needs non-empty inputs")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("merge_sums takes contiguous tensors")
    return c, b, p, k


def merge_sums_reference(bout, tout, y) -> torch.Tensor:
    """Plain version: ``(C, 2)`` f64 sums ``[S1, S2]``; the product and each
    cell's term in IEEE f32, the sums in f64."""
    _check_merge_inputs(bout, tout, y)
    rows = []
    with true_f32():
        for c in range(bout.shape[0]):
            m = bout[c] @ tout[c].T
            rows.append(torch.stack([(m * (m - 2.0 * y)).sum(dtype=torch.float64),
                                     m.sum(dtype=torch.float64)]))
    return torch.stack(rows)


def merge_sums(bout, tout, y) -> torch.Tensor:
    """``(C, 2)`` f64 sums ``[S1, S2]`` per chain (see module doc).

    CUDA tensors: one launch of a hand-written kernel for all chains, the one
    :func:`_sums_path` picks, counted in ``merge_sums.launches`` (at C = 1
    also in ``merge_sums.launches_c1``, on the small kernel also in
    ``merge_sums.launches_small``). CPU tensors: :func:`merge_sums_reference`.
    Anything else raises. The result is f64, not the f32 of JAX: ``S1`` is about
    ``-sum y^2`` (~1.7e6) at reference scale, where rounding it to f32 alone
    moves ll by up to 0.03 nats, and f32 accumulation across tiles by more.
    """
    c, b, p, k = _check_merge_inputs(bout, tout, y)
    if bout.device.type == "cpu":
        return merge_sums_reference(bout, tout, y)
    return _merge_launch(_sums_path(c, b), bout, tout, y)


def _merge_launch(path, bout, tout, y) -> torch.Tensor:
    """One launch of the ``path`` kernel ('small' or 'tiled') on CUDA
    tensors, counted on :func:`merge_sums`."""
    c, b, p, k = _check_merge_inputs(bout, tout, y)
    dev = bout.device
    if dev.type != "cuda":
        raise ValueError(f"merge_sums runs on CUDA or CPU tensors, not {dev}")
    lib = cuda_build.load("merge_sums")
    with torch.cuda.device(dev):
        out = torch.empty((c, N_MERGE_SUMS), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "small":
            nblk = _small_blocks(b, p)
            slots = torch.empty((c, nblk * N_MERGE_SUMS), dtype=torch.float64, device=dev)
            err = lib.vihmc_merge_sums_small(
                bout.data_ptr(), tout.data_ptr(), y.data_ptr(), slots.data_ptr(),
                chain_tickets(dev, stream, c).data_ptr(), out.data_ptr(), c, b, p, k, nblk,
                ctypes.c_void_p(stream))
        else:
            scratch = torch.empty((c, lib.vihmc_merge_sums_scratch(b, p)),
                                  dtype=torch.float64, device=dev)
            err = lib.vihmc_merge_sums(bout.data_ptr(), tout.data_ptr(), y.data_ptr(),
                                       scratch.data_ptr(), out.data_ptr(), c, b, p, k,
                                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"merge_sums {path} kernel launch failed: CUDA error {err}")
    _count("merge_sums", c, path, 2 * c * b * p * k)
    return out


def merge_nll_reference(bout, tout, bias, y, tau) -> torch.Tensor:
    """Materialized reference, per chain: ``-sum gaussian_nll(bout @ tout^T +
    bias, y, tau)``; ``bout`` (C, B, K), ``tout`` (C, P, K), ``bias`` (C,) ->
    (C,). Differentiable by autograd."""
    var = max(float(tau), GNLL_EPS)
    with true_f32():
        pred = torch.matmul(bout, tout.transpose(-1, -2)) + bias[:, None, None]
    return -(0.5 * (math.log(var) + (pred - y) ** 2 / var)).flatten(1).sum(-1)


class _FusedMergeNLL(torch.autograd.Function):
    """Forward: one :func:`merge_sums` launch and the f64 closure (JAX
    ``_fused_nll_call`` :176-186). Backward: the composed VJP of JAX ``_bwd``
    (:194-212) with ``pred`` rematerialized in IEEE f32."""

    @staticmethod
    def forward(ctx, bout, tout, bias, y, tau, sum_y, sum_y2):
        n = y.shape[0] * y.shape[1]
        var = max(float(tau), GNLL_EPS)
        s1, s2 = merge_sums(bout, tout, y).unbind(-1)
        b = bias.double()
        sse = s1 + sum_y2 + 2.0 * b * (s2 - sum_y) + n * b * b
        ctx.save_for_backward(bout, tout, bias, y)
        ctx.var, ctx.sum_y, ctx.n = var, sum_y, n
        return (-0.5 * (n * math.log(var) + sse / var)).float()

    @staticmethod
    def backward(ctx, ct):
        bout, tout, bias, y = ctx.saved_tensors
        var = ctx.var
        with true_f32():
            pred = torch.matmul(bout, tout.transpose(-1, -2)) + bias[:, None, None]
            dpred = ct[:, None, None] * (-(pred - y) / var)
            g_bout = torch.matmul(dpred, tout)
            g_tout = torch.matmul(dpred.transpose(-1, -2), bout)
        # closed-form bias gradient: S2 = sum(pred - b) taken per cell, which
        # avoids the cancellation of sum(pred) - N b over large grids
        s2 = (pred - bias[:, None, None]).flatten(1).sum(-1)
        g_bias = ct * (-(s2 - ctx.sum_y.to(s2.dtype) + ctx.n * bias) / var)
        return g_bout, g_tout, g_bias, None, None, None, None


def fused_merge_nll(bout, tout, bias, y, tau, y_sum_pair=None) -> torch.Tensor:
    """``-sum gaussian_nll(bout @ tout^T + bias, y, tau)`` per chain, ``(C,)``
    f32, without materializing the (B, P) prediction in the forward.

    ``bout`` (C, B, K), ``tout`` (C, P, K), ``bias`` (C,), ``y`` (B, P), all
    f32 on one device; differentiable in ``bout``, ``tout`` and ``bias``.
    ``y_sum_pair`` is :func:`y_sums` of ``y``, computed once by the caller
    (recomputed here when omitted). The variance is ``max(tau, 1e-6)``.
    """
    sum_y, sum_y2 = y_sums(y) if y_sum_pair is None else y_sum_pair
    return _FusedMergeNLL.apply(bout.contiguous(), tout.contiguous(), bias, y,
                                float(tau), sum_y, sum_y2)


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

    CUDA tensors: one launch of a hand-written kernel for all chains, the one
    :func:`_sums_path` picks, counted in ``paired_sums.launches`` (at C = 1
    also in ``paired_sums.launches_c1``, on the small kernel also in
    ``paired_sums.launches_small``). CPU tensors: :func:`paired_sums_reference`.
    Anything else raises.
    """
    c, b, p, k = _check_inputs(bout1, tout1, bout0, tout0, y)
    if bout1.device.type == "cpu":
        return paired_sums_reference(bout1, tout1, bout0, tout0, y)
    return _paired_launch(_sums_path(c, b), bout1, tout1, bout0, tout0, y)


def _paired_launch(path, bout1, tout1, bout0, tout0, y) -> torch.Tensor:
    """One launch of the ``path`` kernel ('small' or 'tiled') on CUDA
    tensors, counted on :func:`paired_sums`."""
    c, b, p, k = _check_inputs(bout1, tout1, bout0, tout0, y)
    dev = bout1.device
    if dev.type != "cuda":
        raise ValueError(f"paired_sums runs on CUDA or CPU tensors, not {dev}")
    lib = cuda_build.load("paired_sums")
    feats = [t.data_ptr() for t in (bout1, tout1, bout0, tout0, y)]
    with torch.cuda.device(dev):
        out = torch.empty((c, N_SUMS), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "small":
            nblk = _small_blocks(b, p)
            slots = torch.empty((c, nblk * N_SUMS), dtype=torch.float64, device=dev)
            err = lib.vihmc_paired_sums_small(
                *feats, slots.data_ptr(), chain_tickets(dev, stream, c).data_ptr(),
                out.data_ptr(), c, b, p, k, nblk, ctypes.c_void_p(stream))
        else:
            scratch = torch.empty((c, lib.vihmc_paired_sums_scratch(b, p)),
                                  dtype=torch.float32, device=dev)
            err = lib.vihmc_paired_sums(*feats, scratch.data_ptr(), out.data_ptr(),
                                        c, b, p, k, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"paired_sums {path} kernel launch failed: CUDA error {err}")
    _count("paired_sums", c, path, 2 * 2 * c * b * p * k)   # the two products m1, m0
    return out


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
