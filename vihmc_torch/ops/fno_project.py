"""The FNO2d's projection on the bf16 field as fused kernels (``csrc/fno_project.cu``).

The projection of :mod:`vihmc_torch.models.fno` is the unpad, ``fc1`` to
``fc_dim``, the exact (erf) GELU and ``fc2`` to one channel. Its plain form
(``models/fno._Project``) forms the hidden ``z1`` (C, fc_dim, n S1 S2) in
float32 and passes over it about a dozen times each way. Here one autograd
Function, :class:`FusedProject`, does the same arithmetic with the hidden in
registers:

* forward: ``x`` (the last Fourier layer's f32 output, C, W, n, S1 + p,
  S2 + p) and ``W1`` rounded once to bf16, ``z1 = W1 x + b1`` summed in f32,
  ``gelu(z1)`` in f32 rounded to bf16, times the bf16-rounded ``w2``, summed
  in f32, plus ``b2``: ``out`` (C, n, S1, S2) f32. Only ``x`` is kept.
* backward, from ``g`` (the cotangent of ``out``): ``z1`` again; in f32
  ``dz1 = gelu'(z1) (w2 g)`` (``w2`` unrounded), ``db1 = sum dz1``,
  ``db2 = sum g`` and ``dw2 = sum bf16(g) bf16(gelu(z1))``; then ``dz1``
  rounded once to bf16 gives ``dx = W1^T dz1`` (zero at the pad points) and
  ``dw1 = dz1 x^T``, bf16 operands summed in f32.

Every product operand is rounded to bf16 where ``_Project`` rounds it, so
the two differ only in the order of f32 sums.

Which calls take it is :func:`fused`'s rule: a bf16 projection (``op`` is
``torch.bfloat16``) of a CUDA tensor. Such a call launches the kernels (one
forward, one backward) or raises; nothing falls back. Every other call (the
IEEE-f32 density and MH delta, the f32 probe sensitivity, any CPU tensor)
keeps ``_Project``. The kernels take a width up to ``WC`` (channels pad to it
with zeros) and an ``fc_dim`` up to ``MAX_FC`` (padded with zero rows to a
multiple of ``HC``, one hidden chunk); both paddings are exact.
:func:`project_reference` and :func:`project_backward_reference` are the
plain version of the kernels' arithmetic on any device.

Counters: ``fno_project.launches`` (the kernels' launches, one a direction),
``kernel.flops`` (the model's products at the real points: ``2 C N F (W +
1)`` forward, ``2 C N F (2 W + 1)`` backward, ``N = n S1 S2``; the kernel's
recompute of ``fc1`` and the pad points not counted), ``fno.project.fused``
(projection calls on the kernel route, one forward and one backward).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch
from torch.nn.functional import gelu

from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.profiling import count, detail_span
from vihmc_torch.ops import cuda_build
from vihmc_torch.ops.deeponet_merge import chain_tickets

WC = 32        # channels the kernels take (padded with zeros)
HC = 64        # hidden units of a chunk (the kernels' wgmma N of fc1)
MAX_FC = 256   # fc_dim the kernels take
TP = 64        # padded points of a kernel tile
DESC_WORDS = 29

_NULL = contextlib.nullcontext()


def fused(op, x: torch.Tensor) -> bool:
    """The route rule: a bf16 projection of a CUDA tensor takes the kernels."""
    return op is torch.bfloat16 and x.is_cuda


def _chunks(fc_dim: int) -> int:
    """Hidden chunks of the kernel instantiation that takes ``fc_dim``."""
    return 2 if fc_dim <= 2 * HC else 4


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _plain_hidden(x, w1, b1):
    """``(xb (C, W, NP) bf16-rounded, w1b, z1 (C, F, NP))`` over the padded grid."""
    c, w = x.shape[:2]
    xb = _rounded(x.reshape(c, w, -1))
    w1b = _rounded(w1)
    return xb, w1b, torch.bmm(w1b, xb) + b1[..., None]


def project_reference(x, w1, b1, w2, b2, s1: int, s2: int) -> torch.Tensor:
    """Plain forward of the kernels' arithmetic: ``out`` (C, n, s1, s2) f32
    from ``x`` (C, W, n, P1, P2), ``w1`` (C, F, W), ``b1`` (C, F), ``w2``
    (C, 1, F), ``b2`` (C, 1); IEEE f32 products of the bf16-rounded operands."""
    c, _, n, p1, p2 = x.shape
    with true_f32():
        _, _, z1 = _plain_hidden(x, w1, b1)
        out = torch.bmm(_rounded(w2), _rounded(gelu(z1))) + b2[..., None]
    return out.view(c, n, p1, p2)[..., :s1, :s2].contiguous()


def project_backward_reference(x, g, w1, b1, w2, b2, s1: int, s2: int):
    """Plain backward of the kernels' arithmetic: ``(dx, dw1, db1, dw2,
    db2)`` for the cotangent ``g`` (C, n, s1, s2) of ``out``, shaped as ``x``
    and the weights (module doc)."""
    c, w, n, p1, p2 = x.shape
    with true_f32():
        xb, w1b, z1 = _plain_hidden(x, w1, b1)
        gp = g.new_zeros((c, n, p1, p2))
        gp[..., :s1, :s2] = g
        gp = gp.view(c, 1, -1)
        dw2 = torch.bmm(_rounded(gp), _rounded(gelu(z1)).transpose(1, 2))
        db2 = gp.sum(-1)
        dz1 = torch.ops.aten.gelu_backward(w2.transpose(1, 2) * gp, z1)
        db1 = dz1.sum(-1)
        dzb = _rounded(dz1)
        dw1 = torch.bmm(dzb, xb.transpose(1, 2))
        dx = torch.bmm(w1b.transpose(1, 2), dzb).view(c, w, n, p1, p2)
    return dx, dw1, db1, dw2, db2


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _rows(t: torch.Tensor):
    """``(t as (C, k) with contiguous rows, its chain stride)`` (a view of
    the flat parameters stays a view)."""
    t = t.reshape(t.shape[0], -1)
    if t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


@functools.lru_cache(maxsize=None)
def _resident_blocks(backward: bool, nch: int, device_index: int) -> int:
    """Blocks of one kernel the whole card holds at once."""
    lib = cuda_build.load("fno_project")
    with torch.cuda.device(device_index):
        per_sm = lib.vihmc_fno_project_occupancy(int(backward), nch)
    if per_sm < 1:
        raise RuntimeError(f"fno_project occupancy query failed: CUDA error {-per_sm}")
    return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def _blocks(backward: bool, x: torch.Tensor, fc_dim: int) -> int:
    """Blocks a chain: the card's resident blocks shared by the chains, at
    most one a tile."""
    c, _, n, p1, p2 = x.shape
    tiles = -(-n * p1 * p2 // TP)
    return max(1, min(tiles, _resident_blocks(backward, _chunks(fc_dim), x.device.index) // c))


def _check_inputs(x, w1, b1, w2, b2, s1, s2):
    c, w, _, p1, p2 = x.shape
    f = w1.shape[1]
    tensors = (x, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 or t.device != x.device for t in tensors):
        raise ValueError("the fused projection takes float32 tensors on one device")
    if (tuple(w1.shape) != (c, f, w) or tuple(b1.shape) != (c, f)
            or tuple(w2.shape) != (c, 1, f) or tuple(b2.shape) != (c, 1)):
        raise ValueError(f"projection weights {tuple(w1.shape)}, {tuple(b1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(b2.shape)} for an input {tuple(x.shape)}")
    if w > WC or f > MAX_FC:
        raise ValueError(f"the fused projection takes a width up to {WC} and an fc_dim up "
                         f"to {MAX_FC}, not {w} and {f}")
    if s1 > p1 or s2 > p2:
        raise ValueError(f"a {s1} x {s2} grid does not fit the padded {p1} x {p2}")


def _launch(backward: bool, x, w1, b1, w2, b2, s1, s2, blocks: int, out=None, g=None, dx=None,
            slots=None, tickets=None, grads=(None,) * 4):
    """One launch on the current stream; ``grads`` is ``(dw1, db1, dw2, db2)``."""
    c, w, n, p1, p2 = x.shape
    f = w1.shape[1]
    w1r, w1_cs = _rows(w1)
    b1r, b1_cs = _rows(b1)
    w2r, w2_cs = _rows(w2)
    b2r, b2_cs = _rows(b2)
    np_ = n * p1 * p2
    ptrs = [x, w1r, b1r, w2r, b2r, g, out, dx, slots, tickets, *grads]
    desc = np.array([0 if t is None else t.data_ptr() for t in ptrs]
                    + [np_, w1_cs, b1_cs, w2_cs, b2_cs, w, f, n, p1, p2, s1, s2,
                       -(-np_ // TP), c, blocks], dtype=np.int64)
    assert desc.size == DESC_WORDS
    lib = cuda_build.load("fno_project")
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        err = lib.vihmc_fno_project(int(backward), _chunks(f), desc.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"fno_project {'backward' if backward else 'forward'} launch "
                           f"failed: CUDA error {err}")
    count("fno_project.launches")
    count("kernel.flops", 2 * c * n * s1 * s2 * f * ((2 * w + 1) if backward else (w + 1)))


def project_forward(x, w1, b1, w2, b2, s1: int, s2: int) -> torch.Tensor:
    """One launch of the forward kernel: ``out`` (C, n, s1, s2) f32."""
    _check_inputs(x, w1, b1, w2, b2, s1, s2)
    x = x.contiguous()
    c, _, n = x.shape[:3]
    out = torch.empty((c, n, s1, s2), dtype=torch.float32, device=x.device)
    _launch(False, x, w1, b1, w2, b2, s1, s2, _blocks(False, x, w1.shape[1]), out=out)
    return out


def project_backward(x, g, w1, b1, w2, b2, s1: int, s2: int):
    """One launch of the backward kernel: ``(dx, dw1, db1, dw2, db2)``."""
    _check_inputs(x, w1, b1, w2, b2, s1, s2)
    x = x.contiguous()
    c, w, n = x.shape[:3]
    f = w1.shape[1]
    if g.dtype != torch.float32 or tuple(g.shape) != (c, n, s1, s2) or g.device != x.device:
        raise ValueError(f"the projection's cotangent must be float32 {(c, n, s1, s2)} on "
                         f"{x.device}, not {g.dtype} {tuple(g.shape)} on {g.device}")
    g = g.contiguous()
    dev, f32 = x.device, torch.float32
    blocks = _blocks(True, x, f)
    dx = torch.empty_like(x)
    dw1 = torch.empty((c, f, w), dtype=f32, device=dev)
    db1 = torch.empty((c, f), dtype=f32, device=dev)
    dw2 = torch.empty((c, 1, f), dtype=f32, device=dev)
    db2 = torch.empty((c, 1), dtype=f32, device=dev)
    words = cuda_build.load("fno_project").vihmc_fno_project_slot_words(_chunks(f))
    slots = torch.empty((c, blocks, words), dtype=f32, device=dev)
    tickets = chain_tickets(dev, torch.cuda.current_stream(dev).cuda_stream, c)
    _launch(True, x, w1, b1, w2, b2, s1, s2, blocks, g=g, dx=dx, slots=slots, tickets=tickets,
            grads=(dw1, db1, dw2, db2))
    return dx, dw1, db1, dw2, db2


class FusedProject(torch.autograd.Function):
    """``_Project``'s signature without ``op`` (it is bf16): ``x`` (C, W, n,
    S1 + p, S2 + p) to ``out`` (C, n, S1, S2) by the kernels, both ways
    (module doc); spans ``vihmc.fno.pointwise`` as ``_Project``'s."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, s1, s2, spans):
        with detail_span("vihmc.fno.pointwise") if spans else _NULL:
            out = project_forward(x, w1, b1, w2, b2, s1, s2)
        count("fno.project.fused")
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.dims, ctx.spans = (s1, s2), spans
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        with detail_span("vihmc.fno.pointwise") if ctx.spans else _NULL:
            grads = project_backward(x, g, w1, b1, w2, b2, *ctx.dims)
        count("fno.project.fused")
        return (*grads, None, None, None)
