"""The bf16 Gram field's feature stacks as fused layers (``csrc/field_stack.cu``).

The Gram field (:mod:`vihmc_torch.ops.gram_merge`) needs both tanh stacks of
the DeepONet, branch and trunk, forward and backward, for every chain. Run as
PyTorch ops, each layer is a GEMM, a bias add and a tanh, and autograd mirrors
them with a tanh backward, a bias sum and two GEMMs. Here one autograd
Function, :class:`FeatureStacks`, does the same arithmetic:

* forward: the weights cast once to bf16 (the bias stays f32), products of
  bf16 operands summed in f32, the bias and tanh in f32, each activation
  rounded once to bf16 and kept for the backward; the last layer's output
  (the features) rounded once to bf16;
* backward, from the bf16 cotangents of the features, layer by layer:
  ``dW = g^T y`` and ``db = sum_rows g`` in f32 (bf16 operands, f32 sums),
  written straight into the ``(C, D)`` f32 gradient, and ``g_below =
  (g W) * (1 - y^2)`` in f32, rounded once to bf16.

CUDA tensors launch the kernels of ``csrc/field_stack.cu``: one ``pack``
(the weights into padded bf16 tiles), one ``stack_forward`` for both stacks,
and one ``layer_backward`` per layer for both stacks, counted in
``field_stacks.launches`` (their products in ``kernel.flops``). CPU tensors
run the plain version of the same arithmetic (:func:`stacks_forward_reference`,
:func:`stacks_backward_reference`). Nothing falls back from one to the other.

Which fields take it is :func:`fusable`'s rule: tanh stacks whose widths fit
the kernels' padded tiles (an input or hidden width of at most ``WP - 1``,
the ones column needs the last; an output of at most ``WP``), at most
``MAX_LAYERS`` layers. The f32 field and the MH test's f32 stacks keep
``mlp_stack`` and autograd (the Lanczos HVPs need a double backward, which
this Function does not give).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.profiling import count
from vihmc_torch.models.deeponet import DeepONetConfig, param_slices
from vihmc_torch.ops import cuda_build

WP = 112            # padded output width of every layer (the kernels' wgmma N)
TR = 128            # rows of a kernel block's tile
MAX_LAYERS = 16     # layers of a stack the kernels take
MAX_SPLITS = 16     # backward blocks per chain and stack, at most
WAVES = 4           # backward blocks per SM the split rule aims for
STACK_WORDS = 10 + 4 * MAX_LAYERS   # the C side's descriptor words per stack
STEP_WORDS = 25                     # and per backward step


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def fusable(cfg: DeepONetConfig, in_branch: int, in_trunk: int) -> bool:
    """Whether the stacks of ``cfg`` on inputs of these widths fit the fused
    layers: tanh, every input and hidden width below ``WP`` (the padding's
    last column carries the ones), the latent width at most ``WP``, and at
    most ``MAX_LAYERS`` layers a stack."""
    if cfg.activation != "tanh" or max(cfg.depth_branch, cfg.depth_trunk) > MAX_LAYERS:
        return False
    ins = (in_branch, in_trunk, cfg.width_branch, cfg.width_trunk)
    return max(ins) < WP and cfg.latent <= WP and min(cfg.depth_branch, cfg.depth_trunk) >= 1


class _Stack:
    """One stack: its layers' flat offsets and its shared input, padded to
    ``kin`` columns (a multiple of 16) with ones in the last."""

    def __init__(self, slices, x: torch.Tensor, dtype):
        n, d_in = x.shape
        self.slices = slices
        self.n, self.d_in, self.kin = n, d_in, _pad16(d_in + 1)
        self.tiles = -(-n // TR)
        self.x = x.new_zeros((n, self.kin), dtype=dtype)
        self.x[:, :d_in] = x
        self.x[:, -1] = 1

    @property
    def x_in(self) -> torch.Tensor:
        """The input without its padding."""
        return self.x[:, :self.d_in]

    def flops(self, c: int) -> int:
        """Products of one forward: 2 per multiply-add."""
        return 2 * c * self.n * sum(s.d_in * s.d_out for s in self.slices)


class FeatureStacks:
    """The branch and trunk stacks of ``cfg`` on the shared ``branch_x`` (B,
    in_branch) and trunk input ``trunk_in`` (P, in_trunk: the embedded grid),
    both cast once to ``dtype``. ``stacks(leaf)`` maps the f32 flat ``(C, D)``
    ``leaf`` to ``(bout (C, B, K), tout (C, P, K), bias (C,))`` in ``dtype``,
    differentiable in ``leaf`` (module doc). The kernels take bf16 only; the
    plain version any float dtype (f32 keeps its activations exact, so a test
    can hold the written-out backward to autograd's).

    Counters over every plan: ``field_stacks.launches`` (per call 2 forward,
    then one per layer of the deeper stack) and ``kernel.flops`` (the
    launches' products, 2 per multiply-add)."""

    def __init__(self, cfg: DeepONetConfig, branch_x: torch.Tensor, trunk_in: torch.Tensor,
                 dtype=torch.bfloat16):
        if not fusable(cfg, branch_x.shape[1], trunk_in.shape[1]):
            raise ValueError("the stacks do not fit the fused layers (fusable)")
        if branch_x.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(f"the fused stacks' kernels take bfloat16, not {dtype}")
        sl = param_slices(cfg)
        self.dtype, self.num_params = dtype, sl["size"]
        self.stacks = [_Stack(sl["branch"], branch_x, dtype), _Stack(sl["trunk"], trunk_in, dtype)]
        self.device = branch_x.device
        self._tickets = None
        if self.device.type == "cuda":
            cuda_build.load("field_stack")
            self.n_sm = torch.cuda.get_device_properties(self.device).multi_processor_count

    def __call__(self, leaf: torch.Tensor):
        return _FusedStacks.apply(leaf, self)

    def tickets(self, c: int) -> torch.Tensor:
        """The backward's per-chain counters of both stacks (2, >= c) int32,
        zeroed once here and left at 0 by every launch."""
        if self._tickets is None or self._tickets.shape[1] < c:
            self._tickets = torch.zeros((2, max(c, 64)), dtype=torch.int32, device=self.device)
        return self._tickets


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _layer(leaf: torch.Tensor, s, dtype):
    """``(W (C, out, in) rounded to dtype, in f32; b (C, out) f32)``."""
    c = leaf.shape[0]
    w = leaf[:, s.w:s.end].reshape(c, s.d_out, s.d_in).to(dtype).float()
    return w, leaf[:, s.b:s.w]


def stacks_forward_reference(plan: FeatureStacks, leaf: torch.Tensor):
    """Plain forward: ``(features, acts)``, per stack the ``(C, N, K)``
    features and the list of its tanh outputs ``(C, N, width)``, in the
    plan's dtype. Products of dtype values in IEEE f32, f32 sums."""
    feats, acts = [], []
    with true_f32():
        for st in plan.stacks:
            h, kept = st.x_in.float(), []
            for i, s in enumerate(st.slices):
                w, b = _layer(leaf, s, plan.dtype)
                pre = torch.matmul(h, w.transpose(1, 2)) + b[:, None, :]
                if i + 1 == len(st.slices):
                    feats.append(pre.to(plan.dtype))
                else:
                    kept.append(torch.tanh(pre).to(plan.dtype))
                    h = kept[-1].float()
            acts.append(kept)
    return feats, acts


def stacks_backward_reference(plan: FeatureStacks, leaf: torch.Tensor, acts, cts) -> torch.Tensor:
    """Plain backward: the f32 ``(C, D)`` gradient of ``sum <cts, features>``
    in the stacks' parameters (index 0, the merge bias, left 0), with
    ``acts`` from :func:`stacks_forward_reference` and ``cts`` the features'
    cotangents in the plan's dtype. Written out layer by layer as the kernels
    compute it (module doc)."""
    c = leaf.shape[0]
    grad = leaf.new_zeros((c, plan.num_params), dtype=torch.float32)
    with true_f32():
        for st, kept, ct in zip(plan.stacks, acts, cts):
            g = ct.float()
            for i in reversed(range(len(st.slices))):
                s = st.slices[i]
                y = kept[i - 1].float() if i else st.x_in.float().expand(c, -1, -1)
                grad[:, s.w:s.end] = torch.matmul(g.transpose(1, 2), y).reshape(c, -1)
                grad[:, s.b:s.w] = g.sum(1)
                if i:
                    w, _ = _layer(leaf, s, plan.dtype)
                    g = (torch.matmul(g, w) * (1 - y * y)).to(plan.dtype).float()
    return grad


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _vec(ld: int, width: int) -> int:
    """Elements per copy of a row tile: the widest of 8, 4, 2 dividing both."""
    return next(v for v in (8, 4, 2) if ld % v == 0 and width % v == 0)


def _split_rule(c: int, tiles, n_sm: int):
    """``[(per_block, splits)]`` per stack for the backward: a block walks
    ``per_block`` tiles of one chain; the blocks of both stacks come to about
    ``WAVES`` per SM (the row: 8 tiles a block, 10 trunk and 1 branch blocks a
    chain, 528 blocks on 132 SMs), at most ``MAX_SPLITS`` a chain and stack,
    so the last block's fixed-order sum of the slots stays short."""
    per = max(1, -(-c * sum(tiles) // (WAVES * n_sm)))
    out = []
    for t in tiles:
        pb = max(per, -(-t // MAX_SPLITS))
        out.append((pb, -(-t // pb)))
    return out


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"field_stack {what} launch failed: CUDA error {err}")


def _forward_launch(plan: FeatureStacks, leaf: torch.Tensor):
    """Pack and forward (two launches): ``(features, (wb tiles, acts))``."""
    if (leaf.dtype != torch.float32 or leaf.ndim != 2 or leaf.shape[1] != plan.num_params
            or not leaf.is_contiguous() or leaf.device != plan.device):
        raise ValueError(f"the fused stacks take a contiguous f32 (C, {plan.num_params}) "
                         f"batch on {plan.device}, not {leaf.dtype} {tuple(leaf.shape)} "
                         f"on {leaf.device}")
    lib = cuda_build.load("field_stack")
    c, dev = leaf.shape[0], leaf.device
    bf = torch.bfloat16
    desc = np.zeros(3 + 2 * STACK_WORDS, dtype=np.int64)
    desc[:3] = (c, plan.num_params, leaf.data_ptr())
    feats, saved, packed = [], [], []   # packed: alive until both kernels are queued
    for k, st in enumerate(plan.stacks):
        nl = len(st.slices)
        wf = torch.empty((c, nl, WP * WP), dtype=bf, device=dev)
        wb = torch.empty_like(wf)
        bias = torch.empty((c, nl, WP), dtype=torch.float32, device=dev)
        acts = torch.empty((max(nl - 1, 1), c, st.n, WP), dtype=bf, device=dev)
        out = torch.empty((c, st.n, st.slices[-1].d_out), dtype=bf, device=dev)
        w = desc[3 + k * STACK_WORDS:3 + (k + 1) * STACK_WORDS]
        w[:10] = (_ptr(st.x), _ptr(acts), _ptr(out), _ptr(wf), _ptr(wb), _ptr(bias), st.n,
                  st.kin, nl, st.tiles)
        for i, s in enumerate(st.slices):
            w[10 + 4 * i:14 + 4 * i] = (s.b, s.w, s.d_in, s.d_out)
        feats.append(out)
        saved.append((wb, acts))
        packed.append((wf, bias))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.vihmc_field_forward(desc.ctypes.data, ctypes.c_void_p(stream)), "forward")
    count("field_stacks.launches", 2)
    count("kernel.flops", sum(st.flops(c) for st in plan.stacks))
    return feats, saved


def _backward_launch(plan: FeatureStacks, saved, cts) -> torch.Tensor:
    """One launch per layer for both stacks: the f32 ``(C, D)`` gradient
    (index 0 not written)."""
    c, dev = cts[0].shape[0], cts[0].device
    for st, ct in zip(plan.stacks, cts):
        want = (c, st.n, st.slices[-1].d_out)
        if ct.dtype != torch.bfloat16 or tuple(ct.shape) != want or ct.device != plan.device:
            raise ValueError(f"a feature cotangent must be bf16 {want} on {plan.device}, "
                             f"not {ct.dtype} {tuple(ct.shape)} on {ct.device}")
    lib = cuda_build.load("field_stack")
    bf = torch.bfloat16
    grad = torch.empty((c, plan.num_params), dtype=torch.float32, device=dev)
    tickets = plan.tickets(c)
    splits = _split_rule(c, [st.tiles for st in plan.stacks], plan.n_sm)
    state = []
    for st, (wb, acts), ct, (pb, ns) in zip(plan.stacks, saved, cts, splits):
        g = ct.contiguous()
        if g.shape[-1] % 2:
            g = torch.nn.functional.pad(g, (0, 1))
        deep = len(st.slices) > 1
        gbuf = [torch.empty((c, st.n, WP), dtype=bf, device=dev) for _ in range(2 if deep else 0)]
        slots = torch.empty((c, ns, WP * WP), dtype=torch.float32, device=dev)
        state.append((g, gbuf, slots, wb, acts, pb, ns))
    bwd_flops, layers = 0, max(len(st.slices) for st in plan.stacks)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for i in range(layers):
            desc = np.zeros(3 + 2 * STEP_WORDS, dtype=np.int64)
            desc[0] = c
            for k, (st, (g, gbuf, slots, wb, acts, pb, ns)) in enumerate(zip(plan.stacks, state)):
                li = len(st.slices) - 1 - i
                if li < 0:
                    continue
                s = st.slices[li]
                g_in = g if i == 0 else gbuf[(i - 1) % 2]
                gld = g_in.shape[-1]
                gwidth = s.d_out if i == 0 else WP
                if gwidth % 2:
                    gwidth += 1   # the zero column padded in above
                y, yld, y_cs, kin = ((acts[li - 1], WP, st.n * WP, WP) if li else
                                     (st.x, st.kin, 0, st.kin))
                gout = gbuf[i % 2] if li else None
                desc[1 + k] = 1
                desc[3 + k * STEP_WORDS:3 + (k + 1) * STEP_WORDS] = (
                    _ptr(g_in), _ptr(y), _ptr(gout), wb.data_ptr() + 2 * li * WP * WP,
                    _ptr(slots), _ptr(tickets[k]), _ptr(grad), st.n * gld, y_cs,
                    wb.shape[1] * WP * WP, plan.num_params, gld, gwidth, _vec(gld, gwidth), yld,
                    kin, _vec(yld, kin), st.n, st.tiles, ns, pb, s.b, s.w, s.d_in, s.d_out)
                bwd_flops += 2 * c * st.n * s.d_in * s.d_out * (2 if li else 1)
            _check(lib.vihmc_field_backward(desc.ctypes.data, stream), "backward")
    count("field_stacks.launches", layers)
    count("kernel.flops", bwd_flops)
    return grad


class _FusedStacks(torch.autograd.Function):
    """``leaf`` (C, D) f32 -> ``(bout, tout, bias)`` in the plan's dtype; the
    backward returns the f32 gradient in ``leaf`` (module doc)."""

    @staticmethod
    def forward(ctx, leaf, plan):
        leaf = leaf.contiguous()
        count("field.stacks.fused", len(plan.stacks))
        if leaf.is_cuda:
            feats, ctx.saved = _forward_launch(plan, leaf)
        else:
            feats, ctx.saved = stacks_forward_reference(plan, leaf)
            ctx.save_for_backward(leaf)
        ctx.plan = plan
        return (*feats, leaf[:, 0].to(plan.dtype, copy=True))

    @staticmethod
    def backward(ctx, *cts):
        *ct_feats, ct_bias = cts
        if ct_feats[0].is_cuda:
            grad = _backward_launch(ctx.plan, ctx.saved, ct_feats)
        else:
            (leaf,) = ctx.saved_tensors
            grad = stacks_backward_reference(ctx.plan, leaf, ctx.saved, ct_feats)
        grad[:, 0] = ct_bias
        ctx.saved = None
        return grad, None
