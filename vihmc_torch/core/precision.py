"""Matmul precision policy on the card.

Counterpart of ``vihmc_tpu/core/precision.py`` and of the
``jax.default_matmul_precision('float32')`` blocks around every MH density
(``pipelines/common.py:182,217``, ``bench.py:479``). On an H100 a float32
matmul may run on the tensor cores in TF32 (10-bit mantissa) when
``torch.backends.cuda.matmul.allow_tf32`` is set; TF32 noise in an MH density
revives the acceptance ceiling the paired delta exists to remove, so every
density evaluation runs under :func:`true_f32`.

:func:`matmul_precision` is the counterpart of JAX's ``matmul_precision``
(``jax.default_matmul_precision``) for callers outside the densities: it
takes JAX's precision names and restores the previous state on exit. No
density path enters it by default.
"""

from __future__ import annotations

import contextlib

import torch


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


@contextlib.contextmanager
def true_f32():
    """Context: float32 matmuls in IEEE float32 (no TF32)."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    prev_prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_prec)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
