"""Matmul precision policy on the card.

Counterpart of ``vihmc_tpu/core/precision.py`` and of the
``jax.default_matmul_precision('float32')`` blocks around every MH density
(``pipelines/common.py:182,217``, ``bench.py:479``). On an H100 a float32
matmul may run on the tensor cores in TF32 (10-bit mantissa) when
``torch.backends.cuda.matmul.allow_tf32`` is set; TF32 noise in an MH density
revives the acceptance ceiling the paired delta exists to remove, so every
density evaluation runs under :func:`true_f32`.

:func:`bf16_exact_tf32` is the opposite switch for one narrow use: matmuls
whose float32 operands are upcast bfloat16 values. TF32 holds every bfloat16
value exactly (8-bit exponent, 10- vs 7-bit mantissa), so on those operands
the tensor cores form exact products and accumulate them in float32 -- the
``preferred_element_type=float32`` contract of the JAX Gram gradient.

:func:`matmul_precision` is the counterpart of JAX's ``matmul_precision``
(``jax.default_matmul_precision``) for callers outside the densities: it
takes JAX's precision names and restores the previous state on exit. No
density path enters it by default.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _matmul_tf32(allow: bool):
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    prev_prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.set_float32_matmul_precision("high" if allow else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_prec)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


#: JAX's matmul precision names -> torch's float32 matmul precision
MATMUL_PRECISIONS = {"float32": "highest", "highest": "highest",
                     "tensorfloat32": "high", "high": "high",
                     "bfloat16": "medium", "default": "medium"}


@contextlib.contextmanager
def matmul_precision(mode: str):
    """Context: float32 matmuls at JAX's precision ``mode`` -- ``'float32'``
    (IEEE), ``'tensorfloat32'`` (TF32 tensor cores) or ``'bfloat16'``
    (``'highest'``, ``'high'`` and ``'default'`` are JAX's other names for
    them) -- through ``torch.set_float32_matmul_precision``, which also sets
    ``torch.backends.cuda.matmul.allow_tf32``; the previous precision is
    restored on exit."""
    if mode not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {mode!r}: one of {sorted(MATMUL_PRECISIONS)}")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(MATMUL_PRECISIONS[mode])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def true_f32():
    """Context: float32 matmuls in IEEE float32 (no TF32)."""
    return _matmul_tf32(False)


def bf16_exact_tf32():
    """Context: TF32 allowed, for float32 matmuls of upcast bfloat16 values only."""
    return _matmul_tf32(True)
