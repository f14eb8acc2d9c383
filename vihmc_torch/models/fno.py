"""The Fourier neural operator FNO-2d, chain-batched over flat parameter vectors.

The published block (Li et al., "Fourier Neural Operator for Parametric
Partial Differential Equations", ICLR 2021, arXiv 2010.08895; the class
``FNO2d`` of ``fourier_2d.py`` in ``github.com/zongyi-li/fourier_neural_operator``):
the lift ``fc0 = Linear(3, width)`` on the channels ``(a, grid_1, grid_2)``;
``F.pad(x, [0, padding, 0, padding])``; ``n_layers`` Fourier layers, each the
spectral convolution (``rfft2``, the modes ``[:modes1, :modes2]`` and
``[-modes1:, :modes2]`` mixed per mode by complex ``(width, width, modes1,
modes2)`` weights ``weights1`` and ``weights2``, ``irfft2``) plus a 1x1
``Conv2d(width, width, 1)``, exact (erf) GELU after all but the last; the
unpad; ``fc1 = Linear(width, fc_dim)``, GELU, ``fc2 = Linear(fc_dim, 1)``. At
the defaults that is 2,368,001 real parameters.

The flat layout is the module's ``parameters()`` order with each complex
weight as its ``torch.view_as_real`` pairs (real, then imaginary, innermost)::

    fc0.weight (width, in_channels), fc0.bias (width,),
    conv{l}.weights1, conv{l}.weights2 (width, width, modes1, modes2, 2), l = 0..n_layers-1,
    w{l}.weight (width, width, 1, 1), w{l}.bias (width,), l = 0..n_layers-1,
    fc1.weight (fc_dim, width), fc1.bias (fc_dim,), fc2.weight (1, fc_dim), fc2.bias (1,)

so ``torch.cat([torch.view_as_real(p).flatten() if p.is_complex() else p.flatten()
for p in model.parameters()])`` of a ``fourier_2d.FNO2d`` is its flat vector
(:func:`param_slices` gives each name's offsets and shape).

The forward runs ``C`` parameter vectors at once, each on the same function
batch (or each on its own, :func:`fno_apply_chains`). Activations are
``(C, width, n, S1 + padding, S2 + padding)``, channels before functions, so
that a 1x1 convolution is one GEMM per chain over every function and grid
point and the transforms are contiguous batched 2-D FFTs. The layers are
``torch.autograd.Function`` s with their backward written out: the lift,
each 1x1 convolution with its GELU, and the projection (``_Lift``,
``_Pointwise``, ``_Project``), and the spectral convolution (``_Spectral``),
whose backward is the same transforms again (the adjoint of the corner
mixing between an ``rfft2`` and an ``irfft2``, derived below). With
``gemm=torch.bfloat16`` every GEMM-shaped product (lift, 1x1 convolutions,
mode mixing, projection, and their backward products) takes bf16 operands
and sums in float32: on CUDA as a bf16 product with a float32 result, on the
CPU as the float32 product of the bf16-rounded operands (exact products,
float32 sums: the same contract). The transforms and everything elementwise
stay float32; cuFFT's half-precision transforms take only powers of two.
A bf16 projection on CUDA runs instead as the fused kernels of
:mod:`vihmc_torch.ops.fno_project` (``fc1``, GELU and ``fc2`` one launch each
way, the hidden never in device memory), with ``_Project``'s roundings.

The spectral adjoint. With ``G = rfft2(g)`` of the output's cotangent ``g``
and ``N = S1 S2`` (padded), the cotangent of the kept modes is ``c_l G / N``,
``c_l`` = 2 for the columns ``irfft2`` mirrors (``1 <= l <= S2 - (S2 // 2 +
1)``) and 1 for column 0; the input's cotangent is ``N irfft2`` of the modes'
cotangent divided by ``c_l``. The two factors cancel: ``dx = irfft2(pad(G
W^H))``, and only the weights' cotangent ``M^H c_l G / N`` carries them.

Per-draw spans (``core/profiling.detail_span``, with ``spans=True``):
``vihmc.fno.spectral`` around each spectral convolution's forward,
``vihmc.fno.spectral.bwd`` around its backward, ``vihmc.fno.pointwise``
around the lift, each 1x1 convolution with its GELU and the projection,
forward and backward. Counter
``fno.fft_bytes``: the bytes the transforms must move (each reads its input
once and writes its output once), counted from the shapes at every forward
and backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
from torch.nn.functional import gelu

from vihmc_torch.core.profiling import count, detail_span
from vihmc_torch.ops import fno_project

_NULL = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class FNO2dConfig:
    """The published ``FNO2d`` (``fourier_2d.py``: modes 12 x 12, width 32,
    four Fourier layers, padding 9, ``fc1`` to 128, GELU)."""

    modes1: int = 12
    modes2: int = 12
    width: int = 32
    n_layers: int = 4
    fc_dim: int = 128
    in_channels: int = 3
    padding: int = 9
    activation: str = "gelu"

    @property
    def num_params(self) -> int:
        return param_slices(self)[-1][2]


def param_slices(cfg: FNO2dConfig) -> list:
    """``[(name, start, stop, shape)]`` of the flat layout, in order (module doc)."""
    if cfg.activation != "gelu":
        raise ValueError(f"FNO2d activation {cfg.activation!r}: the published block is 'gelu'")
    w, m1, m2 = cfg.width, cfg.modes1, cfg.modes2
    shapes = [("fc0.weight", (w, cfg.in_channels)), ("fc0.bias", (w,))]
    for lay in range(cfg.n_layers):
        shapes += [(f"conv{lay}.weights1", (w, w, m1, m2, 2)),
                   (f"conv{lay}.weights2", (w, w, m1, m2, 2))]
    for lay in range(cfg.n_layers):
        shapes += [(f"w{lay}.weight", (w, w, 1, 1)), (f"w{lay}.bias", (w,))]
    shapes += [("fc1.weight", (cfg.fc_dim, w)), ("fc1.bias", (cfg.fc_dim,)),
               ("fc2.weight", (1, cfg.fc_dim)), ("fc2.bias", (1,))]
    out, pos = [], 0
    for name, shape in shapes:
        out.append((name, pos, pos + math.prod(shape), shape))
        pos += math.prod(shape)
    return out


def unravel_fno(cfg: FNO2dConfig, flat: torch.Tensor) -> dict:
    """``{name: (C, *shape) view}`` of a ``(C, D)`` batch of flat vectors."""
    c = flat.shape[0]
    if flat.shape[-1] != cfg.num_params:
        raise ValueError(f"flat vectors of {flat.shape[-1]} for an FNO2d of {cfg.num_params}")
    return {name: flat[:, a:b].view(c, *shape) for name, a, b, shape in param_slices(cfg)}


def init_fno(cfg: FNO2dConfig, generator: Optional[torch.Generator] = None,
             device="cpu") -> torch.Tensor:
    """``(D,)`` f32 weights drawn by ``fourier_2d.py``'s initialisation laws,
    one draw per tensor in the layout's order from ``generator``: a linear or
    1x1 convolution's weight and bias ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``
    (torch's default), each spectral weight ``U(0, 1) / width^2`` in its real
    and in its imaginary part (``scale * torch.rand(..., dtype=cfloat)``)."""
    parts = []
    for name, a, b, _ in param_slices(cfg):
        u = torch.rand(b - a, generator=generator, device=device)
        layer = name.split(".")[0]
        if layer.startswith("conv"):
            parts.append(u / (cfg.width * cfg.width))
            continue
        fan_in = {"fc0": cfg.in_channels, "fc2": cfg.fc_dim}.get(layer, cfg.width)
        parts.append((2.0 * u - 1.0) / math.sqrt(fan_in))
    return torch.cat(parts)


def fno_grid(s1: int, s2: int, device=None) -> torch.Tensor:
    """``(s1, s2, 2)``: ``fourier_2d.py``'s ``get_grid`` (``linspace(0, 1)``
    along the first axis, then along the second)."""
    g1 = torch.linspace(0.0, 1.0, s1, device=device)
    g2 = torch.linspace(0.0, 1.0, s2, device=device)
    return torch.stack(torch.meshgrid(g1, g2, indexing="ij"), dim=-1)


def fno_input(u0: torch.Tensor, nt: int) -> torch.Tensor:
    """``(n, nt, nx, 3)``: the space-time input of initial conditions ``u0``
    (n, nx), ``a(t, x) = u0(x)`` on every one of the ``nt`` time rows, then the
    grid channels ``(t, x)`` in [0, 1]."""
    n, nx = u0.shape
    a = u0[:, None, :, None].expand(n, nt, nx, 1)
    grid = fno_grid(nt, nx, u0.device).to(u0.dtype).expand(n, nt, nx, 2)
    return torch.cat([a, grid], dim=-1)


# ---------------------------------------------------------------------------
# Products and elementwise pieces
# ---------------------------------------------------------------------------

def _aligned(t: torch.Tensor) -> bool:
    """A 3-D bf16 operand cuBLAS takes with 16-byte aligned rows and batches."""
    s = t.stride()
    if not ((s[2] == 1 and s[1] % 8 == 0) or (s[1] == 1 and s[2] % 8 == 0)):
        return False
    return s[0] % 8 == 0 and t.storage_offset() % 8 == 0


def _op(t: torch.Tensor, op) -> torch.Tensor:
    """``t`` as a GEMM operand: itself (``op`` None) or cast to ``op``."""
    return t if op is None else t.to(op)


#: a product deeper than this over at most ``_DEEP_BATCH`` batch entries runs
#: as one ``mm`` per entry: cuBLAS splits the depth of a single product over
#: the card, not that of a batched one (a weight gradient summed over
#: millions of grid points would run on one thread block per entry)
_DEEP, _DEEP_BATCH = 1 << 16, 8


def _bmm(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    if a.shape[0] <= _DEEP_BATCH and a.shape[-1] > _DEEP:
        return torch.stack([torch.mm(x, y, **kw) for x, y in zip(a, b)])
    return torch.bmm(a, b, **kw)


def _mm(a: torch.Tensor, b: torch.Tensor, op) -> torch.Tensor:
    """``a @ b`` (3-D, equal leading dims): in the operands' own dtype (``op``
    None), or with ``op`` bf16 the operands rounded to bf16 and the products
    summed in float32 (module doc)."""
    if op is None:
        return _bmm(a, b)
    a16, b16 = a.to(op), b.to(op)
    if a16.is_cuda and _aligned(a16) and _aligned(b16):
        return _bmm(a16, b16, out_dtype=torch.float32)
    return _bmm(a16.float(), b16.float())


def _chains(t: torch.Tensor, c: int) -> torch.Tensor:
    """``t`` with a leading chain axis of ``c`` (a shared operand is expanded)."""
    return t.expand(c, *t.shape[-2:]) if t.dim() == 2 else t


def gelu_backward(g: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``g`` times d GELU / dz at ``z`` (the exact, erf GELU), one pass."""
    return torch.ops.aten.gelu_backward(g, z)


def fft_bytes(c: int, ch: int, n: int, s1: int, s2: int) -> int:
    """Bytes an ``rfft2`` and an ``irfft2`` of ``(c, ch, n, s1, s2)`` float32
    must move: each reads its input and writes its output once (the half
    spectrum is complex64)."""
    real = c * ch * n * s1 * s2 * 4
    half = c * ch * n * s1 * (s2 // 2 + 1) * 8
    return 2 * (real + half)


def _corners(z: torch.Tensor, m1: int, m2: int) -> torch.Tensor:
    """The kept modes ``[:m1, :m2]`` and ``[-m1:, :m2]`` of a half spectrum
    ``(C, ch, n, S1, S2r)``, as the real operand of the per-mode product:
    ``(C M, n, 2 ch)`` with ``M = 2 m1 m2`` modes (row, then column) and the
    real parts before the imaginary ones."""
    c, ch, n = z.shape[:3]
    zc = torch.cat([z[..., :m1, :m2], z[..., -m1:, :m2]], dim=-2)      # (C, ch, n, 2m1, m2)
    zr = torch.cat([zc.real, zc.imag], dim=1)                             # (C, 2ch, n, 2m1, m2)
    return zr.permute(0, 3, 4, 2, 1).reshape(c * 2 * m1 * m2, n, 2 * ch)


def _uncorners(o: torch.Tensor, c: int, n: int, s1: int, s2r: int, m1: int,
               m2: int) -> torch.Tensor:
    """The inverse of :func:`_corners`: ``(C M, n, 2 ch)`` into a zero half
    spectrum ``(C, ch, n, s1, s2r)`` (complex64 from float32)."""
    ch = o.shape[-1] // 2
    o = o.view(c, 2 * m1, m2, n, 2 * ch).permute(0, 4, 3, 1, 2)          # (C, 2ch, n, 2m1, m2)
    oc = torch.complex(o[:, :ch].contiguous(), o[:, ch:].contiguous())
    out = torch.zeros((c, ch, n, s1, s2r), dtype=oc.dtype, device=o.device)
    out[..., :m1, :m2] = oc[..., :m1, :]
    out[..., s1 - m1:, :m2] = oc[..., m1:, :]
    return out


def _mixing_matrix(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``(C M, 2i, 2o)`` real form ``[[Wr, Wi], [-Wi, Wr]]`` of each mode's
    complex ``(i, o)`` weights, so that ``[Mr | Mi] @ W = [Or | Oi]`` for
    ``O = M W``; ``w1``, ``w2`` are ``(C, i, o, m1, m2, 2)`` real pairs."""
    c, i, o, m1, m2, _ = w1.shape
    wc = torch.cat([w1, w2], dim=3).permute(0, 3, 4, 1, 2, 5)            # (C, 2m1, m2, i, o, 2)
    wr, wi = wc[..., 0], wc[..., 1]
    top = torch.cat([wr, wi], dim=-1)
    bottom = torch.cat([-wi, wr], dim=-1)
    return torch.cat([top, bottom], dim=-2).reshape(c * 2 * m1 * m2, 2 * i, 2 * o)


def _mixing_grads(dw: torch.Tensor, c: int, i: int, o: int, m1: int, m2: int):
    """The weights' cotangents ``(C, i, o, m1, m2, 2)`` x 2 from that of the
    real form ``(C M, 2i, 2o)``: ``dWr = TL + BR``, ``dWi = TR - BL``."""
    dw = dw.view(c, 2 * m1, m2, 2 * i, 2 * o)
    dr = dw[..., :i, :o] + dw[..., i:, o:]
    di = dw[..., :i, o:] - dw[..., i:, :o]
    d = torch.stack([dr, di], dim=-1).permute(0, 3, 4, 1, 2, 5)          # (C, i, o, 2m1, m2, 2)
    return d[:, :, :, :m1].contiguous(), d[:, :, :, m1:].contiguous()


def _column_weights(m2: int, s2: int, device) -> torch.Tensor:
    """``c_l`` of the kept columns (module doc)."""
    s2r = s2 // 2 + 1
    cols = torch.arange(m2, device=device)
    return torch.where((cols >= 1) & (cols <= s2 - s2r), 2.0, 1.0)


# ---------------------------------------------------------------------------
# The layers as autograd Functions
# ---------------------------------------------------------------------------

class _Lift(torch.autograd.Function):
    """``fc0`` on the input channels, then the zero padding: ``a_t`` (Cin, N)
    shared or (C, Cin, N) per chain, ``N = n S1 S2``; weights (C, W, Cin),
    bias (C, W); out (C, W, n, S1 + p, S2 + p)."""

    @staticmethod
    def forward(ctx, a_t, w0, b0, n, s1, s2, pad, op, spans):
        with detail_span("vihmc.fno.pointwise") if spans else _NULL:
            c, w = w0.shape[:2]
            h = _mm(w0, _chains(a_t, c), op).add_(b0[..., None])
            x0 = h.new_zeros((c, w, n, s1 + pad, s2 + pad))
            x0[..., :s1, :s2] = h.view(c, w, n, s1, s2)
        ctx.save_for_backward(a_t, w0)
        ctx.dims, ctx.op, ctx.spans = (n, s1, s2), op, spans
        return x0

    @staticmethod
    def backward(ctx, g):
        a_t, w0 = ctx.saved_tensors
        n, s1, s2 = ctx.dims
        with detail_span("vihmc.fno.pointwise") if ctx.spans else _NULL:
            c, w, cin = w0.shape
            # the sum over n S1 S2 points as one short product per function
            # (C n, W, P) @ (C n, P, Cin), then summed over the functions: a
            # single product with that depth would run on a handful of blocks
            gc = g[..., :s1, :s2].permute(0, 2, 1, 3, 4).reshape(c * n, w, s1 * s2)
            an = a_t.reshape(-1, cin, n, s1 * s2).transpose(1, 2).expand(c, n, cin, s1 * s2)
            dw0 = _mm(gc, an.reshape(c * n, cin, s1 * s2).transpose(1, 2), ctx.op)
            dw0 = dw0.view(c, n, w, cin).sum(1)
            db0 = gc.view(c, n, w, -1).sum((1, 3))
        return None, dw0, db0, None, None, None, None, None, None


class _Spectral(torch.autograd.Function):
    """The spectral convolution of ``x`` (C, i, n, S1, S2) with the corner
    weights ``w1``, ``w2`` (C, i, o, m1, m2, 2): ``irfft2`` of the mixed kept
    modes of ``rfft2(x)``; its backward is the adjoint (module doc)."""

    @staticmethod
    def forward(ctx, x, w1, w2, op, spans):
        with detail_span("vihmc.fno.spectral") if spans else _NULL:
            c, i, n, s1, s2 = x.shape
            o, m1, m2 = w1.shape[2], w1.shape[3], w1.shape[4]
            if 2 * m1 > s1 or m2 > s2 // 2 + 1:
                raise ValueError(f"{m1} x {m2} modes do not fit a {s1} x {s2} grid")
            count("fno.fft_bytes", fft_bytes(c, i, n, s1, s2))
            a = _op(_corners(torch.fft.rfft2(x), m1, m2), op)
            wb = _mixing_matrix(w1, w2)
            out = _mm(a, wb, op)
            y = torch.fft.irfft2(_uncorners(out, c, n, s1, s2 // 2 + 1, m1, m2), s=(s1, s2))
        ctx.save_for_backward(a, w1, w2)
        ctx.dims, ctx.op, ctx.spans = (c, i, o, n, s1, s2, m1, m2), op, spans
        return y

    @staticmethod
    def backward(ctx, g):
        a, w1, w2 = ctx.saved_tensors
        c, i, o, n, s1, s2, m1, m2 = ctx.dims
        with detail_span("vihmc.fno.spectral.bwd") if ctx.spans else _NULL:
            count("fno.fft_bytes", fft_bytes(c, o, n, s1, s2))
            gm =_corners(torch.fft.rfft2(g.contiguous()), m1, m2)     # (C M, n, 2o)
            wb = _mixing_matrix(w1, w2)
            da = _mm(gm, wb.transpose(1, 2), ctx.op)                     # (C M, n, 2i)
            dx = torch.fft.irfft2(_uncorners(da, c, n, s1, s2 // 2 + 1, m1, m2), s=(s1, s2))
            scale = _column_weights(m2, s2, g.device) / (s1 * s2)
            gs = (gm.view(c, 2 * m1, m2, n, 2 * o) * scale[:, None, None]).view_as(gm)
            dwb = _mm(a.transpose(1, 2), gs, ctx.op)                     # (C M, 2i, 2o)
            dw1, dw2 = _mixing_grads(dwb, c, i, o, m1, m2)
        return dx, dw1, dw2, None, None


class _Pointwise(torch.autograd.Function):
    """A Fourier layer's 1x1 convolution, the sum with the spectral branch
    ``s``, and the GELU (``act``): ``act(s + w x + b)``; ``x``, ``s`` (C, i, n,
    S1, S2), ``w`` (C, o, i, 1, 1), ``b`` (C, o)."""

    @staticmethod
    def forward(ctx, s, x, w, b, act, op, spans):
        with detail_span("vihmc.fno.pointwise") if spans else _NULL:
            c, i = x.shape[:2]
            o = w.shape[1]
            x_op = _op(x.reshape(c, i, -1), op)
            z = _mm(w.view(c, o, i), x_op, op).view_as(s)
            z.add_(s).add_(b.view(c, o, 1, 1, 1))
            out = gelu(z) if act else z
        ctx.save_for_backward(x_op, w, z if act else None)
        ctx.act, ctx.op, ctx.spans = act, op, spans
        return out

    @staticmethod
    def backward(ctx, g):
        x_op, w, z = ctx.saved_tensors
        with detail_span("vihmc.fno.pointwise") if ctx.spans else _NULL:
            c, o, i = w.shape[:3]
            gz = gelu_backward(g, z) if ctx.act else g.contiguous()
            gzf = gz.view(c, o, -1)
            dx = _mm(w.view(c, o, i).transpose(1, 2), gzf, ctx.op).view(c, i, *g.shape[2:])
            dw = _mm(gzf, x_op.transpose(1, 2), ctx.op).view(c, o, i, 1, 1)
            db = gzf.sum(-1)
        return gz, dx, dw, db, None, None, None


class _Project(torch.autograd.Function):
    """The unpad, ``fc1``, GELU and ``fc2``: ``x`` (C, W, n, S1 + p, S2 + p)
    to (C, n, S1, S2)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, s1, s2, op, spans):
        with detail_span("vihmc.fno.pointwise") if spans else _NULL:
            c, w, n = x.shape[:3]
            xu = _op(x[..., :s1, :s2], op).reshape(c, w, n * s1 * s2)
            z1 = _mm(w1, xu, op).add_(b1[..., None])                  # (C, F, N)
            out = _mm(w2, gelu(z1), op).add_(b2[..., None])           # (C, 1, N)
        ctx.save_for_backward(xu, z1, w1, w2)
        ctx.dims, ctx.op, ctx.spans = (n, s1, s2, x.shape[-2], x.shape[-1]), op, spans
        return out.view(c, n, s1, s2)

    @staticmethod
    def backward(ctx, g):
        xu, z1, w1, w2 = ctx.saved_tensors
        n, s1, s2, p1, p2 = ctx.dims
        op = ctx.op
        with detail_span("vihmc.fno.pointwise") if ctx.spans else _NULL:
            c, f, w = w1.shape
            gf = g.reshape(c, 1, n * s1 * s2)
            dw2 = _mm(gf, _op(gelu(z1), op).transpose(1, 2), op)     # (C, 1, F)
            db2 = gf.sum(-1)
            dz1 = gelu_backward(w2.transpose(1, 2) * gf, z1)           # (C, F, N)
            dw1 = _mm(dz1, xu.transpose(1, 2), op)                      # (C, F, W)
            db1 = dz1.sum(-1)
            dxu = _mm(w1.transpose(1, 2), dz1, op)                      # (C, W, N)
            dx = dxu.new_zeros((c, w, n, p1, p2))
            dx[..., :s1, :s2] = dxu.view(c, w, n, s1, s2)
        return dx, dw1, db1, dw2, db2, None, None, None, None


# ---------------------------------------------------------------------------
# The forwards
# ---------------------------------------------------------------------------

def fno_apply_chains(cfg: FNO2dConfig, flat_c: torch.Tensor, a: torch.Tensor,
                     gemm: Optional[torch.dtype] = None, spans: bool = False) -> torch.Tensor:
    """``(C, n, S1, S2)``: the FNO2d of each of the ``C`` flat vectors
    ``flat_c`` (C, D) on the inputs ``a`` (n, S1, S2, in_channels), shared by
    every chain, or (C, n, S1, S2, in_channels), each chain its own.
    ``gemm``: the GEMM operands' dtype (None: ``flat_c``'s own, float32 in
    the pipelines; ``torch.bfloat16``: bf16 operands, float32 sums).
    Differentiable in ``flat_c`` (module doc)."""
    op = gemm
    p = unravel_fno(cfg, flat_c)
    n, s1, s2, cin = a.shape[-4:]
    if cin != cfg.in_channels:
        raise ValueError(f"{cin} input channels for an FNO2d of {cfg.in_channels}")
    a_t = a.movedim(-1, -4).reshape(*a.shape[:-4], cin, n * s1 * s2).to(flat_c.dtype)
    x = _Lift.apply(a_t, p["fc0.weight"], p["fc0.bias"], n, s1, s2, cfg.padding, op, spans)
    for lay in range(cfg.n_layers):
        s = _Spectral.apply(x, p[f"conv{lay}.weights1"], p[f"conv{lay}.weights2"], op, spans)
        x = _Pointwise.apply(s, x, p[f"w{lay}.weight"], p[f"w{lay}.bias"],
                             lay < cfg.n_layers - 1, op, spans)
    proj = (x, p["fc1.weight"], p["fc1.bias"], p["fc2.weight"], p["fc2.bias"], s1, s2)
    if fno_project.fused(op, x):
        return fno_project.FusedProject.apply(*proj, spans)
    return _Project.apply(*proj, op, spans)


def fno_apply(cfg: FNO2dConfig, flat: torch.Tensor, a: torch.Tensor,
              gemm: Optional[torch.dtype] = None, spans: bool = False) -> torch.Tensor:
    """``(n, S1, S2)``: the FNO2d of one flat vector ``flat`` (D,) on ``a``
    (n, S1, S2, in_channels)."""
    return fno_apply_chains(cfg, flat[None], a, gemm, spans)[0]


def fno_field_bytes(cfg: FNO2dConfig, s1: int, s2: int, grad: bool = True) -> int:
    """Device bytes one function of one chain holds at the peak of a forward
    (``grad`` False) or of a forward and backward: the tensors the backward
    keeps (each layer's pre-activation, its bf16 input, the projection's
    input and pre-activation) and the largest layer's temporaries."""
    w, f = cfg.width, cfg.fc_dim
    pts, grid = s1 * s2, (s1 + cfg.padding) * (s2 + cfg.padding)
    temp = 4 * max(6 * w * grid, 3 * f * pts)
    if not grad:
        return temp
    kept = cfg.n_layers * w * grid * (4 + 2) + (2 * w + 4 * f) * pts
    return kept + temp
