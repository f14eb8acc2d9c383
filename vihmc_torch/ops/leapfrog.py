"""Fused leapfrog half-kick + drift.

Counterpart of ``vihmc_tpu/ops/leapfrog.py``: ``leapfrog_update_reference``
and ``fused_leapfrog_update`` (:32-82),

    p_half = p + 0.5 * eps * g
    q_new  = q + eps * inv_mass * p_half,

over ``(..., D)`` tensors with a scalar or ``(D,)`` diagonal inverse mass.
:func:`fused_leapfrog_update` launches the hand-written CUDA kernel
(``csrc/leapfrog_update.cu``) on CUDA tensors and takes the plain version on
CPU tensors. As in the JAX package, no integrator calls it: the samplers'
leapfrog (:mod:`vihmc_torch.hmc.integrators`) stays composed torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from vihmc_torch.core.profiling import count
from vihmc_torch.ops import cuda_build


def leapfrog_update_reference(q, p, g, eps, inv_mass):
    """Plain version: ``(q_new, p_half)``; ``inv_mass`` a tensor that
    broadcasts against ``q``."""
    p_half = p + 0.5 * eps * g
    q_new = q + eps * inv_mass * p_half
    return q_new, p_half


def _mass_tensor(inv_mass, q):
    """The inverse mass as an f32 tensor on ``q``'s device: ``(1,)`` for a
    scalar (JAX fills ``full_like(q, value)``, the same value per element),
    ``(D,)`` otherwise."""
    d = q.shape[-1]
    if inv_mass is None:
        inv_mass = 1.0
    im = torch.as_tensor(inv_mass, dtype=torch.float32, device=q.device)
    if im.ndim == 0:
        return im.reshape(1)
    if tuple(im.shape) != (d,):
        raise ValueError(f"inverse mass must be a scalar or ({d},), got {tuple(im.shape)}")
    return im.contiguous()


def fused_leapfrog_update(q, p, g, eps, inv_mass=None):
    """``(q_new, p_half)`` for ``q``, ``p``, ``g`` of one shape ``(..., D)``.

    ``eps`` is a Python float (or a 0-d tensor); ``inv_mass`` None (identity),
    a scalar or ``(D,)``. CUDA tensors: one launch of the kernel, counted in
    ``leapfrog_update.launches``; CPU tensors:
    :func:`leapfrog_update_reference`. Anything else raises.
    """
    ts = (q, p, g)
    if any(not isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("fused_leapfrog_update takes torch tensors")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"fused_leapfrog_update takes float32 tensors, got "
                        f"{[t.dtype for t in ts]}")
    if p.shape != q.shape or g.shape != q.shape or q.ndim < 1 or q.numel() == 0:
        raise ValueError(f"q, p, g must share one non-empty (..., D) shape, got "
                         f"{tuple(q.shape)}, {tuple(p.shape)}, {tuple(g.shape)}")
    dev = q.device
    if any(t.device != dev for t in ts):
        raise ValueError("fused_leapfrog_update inputs must share one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("fused_leapfrog_update takes contiguous tensors")
    eps = float(eps)
    im = _mass_tensor(inv_mass, q)
    if dev.type == "cpu":
        return leapfrog_update_reference(q, p, g, eps, im)
    if dev.type != "cuda":
        raise ValueError(f"fused_leapfrog_update runs on CUDA or CPU tensors, not {dev}")
    lib = cuda_build.load("leapfrog_update")
    with torch.cuda.device(dev):
        q_new = torch.empty_like(q)
        p_half = torch.empty_like(p)
        ptrs = (q, p, g, q_new, p_half)
        vec = int(all(t.data_ptr() % 16 == 0 for t in ptrs))
        stream = torch.cuda.current_stream(dev).cuda_stream
        # ctypes rounds eps and 0.5 * eps to f32 once each, as the plain
        # version's scalar operands are rounded
        err = lib.vihmc_leapfrog_update(
            q.data_ptr(), p.data_ptr(), g.data_ptr(), im.data_ptr(), q_new.data_ptr(),
            p_half.data_ptr(), q.numel(), im.numel(), eps, 0.5 * eps, vec,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"leapfrog_update kernel launch failed: CUDA error {err}")
    count("leapfrog_update.launches")
    return q_new, p_half
