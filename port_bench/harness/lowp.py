"""Matmuls of the plain references, at the precision they are asked for.

``None`` is IEEE float32: the references switch TF32 off around their work.
The lower precisions are the controls of ``correct``: every operand of every
matmul (forward and backward) is rounded to the format, and the products
accumulate in float32, as the tensor cores do:

* ``tf32``: 10-bit mantissa, round to nearest even (the step below float32);
* ``fp8``: e4m3 with one scale per matrix (the step below bfloat16).
"""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & -8192).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(max(x.ndim - 2, 0), x.ndim))
    scale = x.detach().abs().amax(dim=dims, keepdim=True) / 448.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDERS = {"tf32": round_tf32, "fp8": round_fp8}


def _st(x, r):
    """``x`` rounded by ``r``, with the identity as its derivative."""
    return x + (r(x.detach()) - x.detach())


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fmt):
        ctx.save_for_backward(a, b)
        ctx.fmt = fmt
        r = ROUNDERS[fmt]
        return torch.matmul(r(a), r(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ROUNDERS[ctx.fmt]
        gr = _st(g, r)
        ga = torch.matmul(gr, _st(b, r).transpose(-1, -2))
        gb = torch.matmul(_st(a, r).transpose(-1, -2), gr)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, fmt=None) -> torch.Tensor:
    """``a @ b`` in IEEE float32 (``fmt`` None) or with ``fmt``'s operands;
    ``a`` and ``b`` have the same leading dimensions."""
    if fmt is None:
        return torch.matmul(a, b)
    return _RoundedMatmul.apply(a, b, fmt)


@contextlib.contextmanager
def ieee_f32():
    """TF32 off for the block (the reference's float32 is IEEE float32)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])
