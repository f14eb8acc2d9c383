"""Flat parameter layout and subspace scatter/gather.

Counterpart of ``vihmc_tpu/core/ravel.py``. The JAX package flattens its
parameter pytrees with ``jax.flatten_util.ravel_pytree``, which walks dict
keys in sorted order. For a stack of linear layers stored as ``{'w', 'b'}``
dicts that puts each layer's bias BEFORE its weight, and the weight is
``(out, in)`` row-major. The port keeps that order exactly, so a flat vector
means the same parameters on both sides (``tests/test_torch_core.py`` checks
it against ``ravel_pytree``).

Every function here takes a leading chain dimension: a flat batch is
``(C, D)``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LinearSlice:
    """Offsets of one linear layer inside the flat vector (bias, then weight)."""

    b: int
    w: int
    d_in: int
    d_out: int

    @property
    def end(self) -> int:
        return self.w + self.d_in * self.d_out


def stack_slices(dims, start: int):
    """Slices of a stack of linear layers ``dims = [(d_in, d_out), ...]``
    laid out from ``start``. Returns ``(slices, end)``."""
    out, pos = [], start
    for d_in, d_out in dims:
        sl = LinearSlice(b=pos, w=pos + d_out, d_in=d_in, d_out=d_out)
        out.append(sl)
        pos = sl.end
    return out, pos


def unravel_stack(flat: torch.Tensor, slices):
    """Per-layer ``(w (C, out, in), b (C, out))`` views of a ``(C, D)`` batch."""
    c = flat.shape[0]
    return [(flat[:, s.w:s.end].reshape(c, s.d_out, s.d_in),
             flat[:, s.b:s.w]) for s in slices]


def scatter_subspace(frozen: torch.Tensor, sub: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Full ``(C, D)`` vectors: ``frozen`` (D,) with ``sub`` (C, d) written at ``idx``."""
    full = frozen.expand(sub.shape[0], -1).clone()
    full[:, idx] = sub
    return full


def gather_subspace(full: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Subspace coordinates ``(C, d)`` of full ``(C, D)`` vectors."""
    return full[:, idx]
