"""The bf16 Gram field's fused feature stacks (``vihmc_torch/ops/field_stacks.py``)
on the CPU: the Function's plain version, forward and written-out backward,
against autograd of ``mlp_stack``; the bf16 field on the fused stacks against
JAX's bf16 field; the rule that picks the fused stacks; the backward's split
rule. The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import tiny_problem

from vihmc_torch.core import profiling
from vihmc_torch.models.deeponet import (DeepONetConfig, bc_embedding, param_slices,
                                         unravel_deeponet)
from vihmc_torch.models.mlp import mlp_stack
from vihmc_torch.ops.field_stacks import (WP, FeatureStacks, _split_rule, fusable,
                                          stacks_backward_reference, stacks_forward_reference)
from vihmc_torch.ops.gram_merge import make_gram_grad_full

jax.config.update("jax_platforms", "cpu")

# the DeepONet's widths (inputs 101 and 5, width 100), nine layers a stack
ROW_CFG = DeepONetConfig()


def _inputs(b, p, seed):
    rng = np.random.default_rng(seed)
    bx = torch.as_tensor(rng.normal(size=(b, ROW_CFG.in_branch)), dtype=torch.float32)
    tx = torch.as_tensor(rng.random((p, 2)), dtype=torch.float32)
    return rng, bx, tx


def _autograd_stacks(cfg, flat, bx, tin, cts, dtype):
    """Features and gradient by autograd of ``mlp_stack`` in f32, on weights
    rounded to ``dtype`` (as the fused stacks round them) and inputs of
    ``dtype`` values; the bias and every activation stay f32."""
    leaf = flat.clone().requires_grad_(True)
    params = unravel_deeponet(cfg, leaf)

    def rounded(layers):
        return [(w + (w.detach().to(dtype).float() - w.detach()), b) for w, b in layers]

    bout = mlp_stack(rounded(params["branch"]), bx.to(dtype).float())
    tout = mlp_stack(rounded(params["trunk"]), tin.to(dtype).float())
    (g,) = torch.autograd.grad((bout, tout, params["b"]), leaf,
                               grad_outputs=[ct.float() for ct in cts])
    return (bout.detach(), tout.detach()), g


def _fused(plan, flat, cts):
    leaf = flat.clone().requires_grad_(True)
    outs = plan(leaf)
    (g,) = torch.autograd.grad(outs, leaf, grad_outputs=cts)
    return outs, g


@pytest.mark.parametrize("c,b,p", [(1, 37, 301), (3, 37, 301), (3, 130, 129)])
def test_plain_stacks_in_f32_equal_autograd_of_mlp_stack(c, b, p):
    """The plain version with f32 activations: the written-out backward is
    autograd's gradient of ``mlp_stack`` to f32 rounding, on the DeepONet's
    widths, at one and three chains, with B and P off the kernels' 128-row
    tile; the merge bias' cotangent lands at index 0."""
    rng, bx, tx = _inputs(b, p, seed=c + b)
    tin = bc_embedding(tx)
    plan = FeatureStacks(ROW_CFG, bx, tin, torch.float32)
    flat = torch.as_tensor(0.1 * rng.normal(size=(c, ROW_CFG.num_params)), dtype=torch.float32)
    cts = [torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
           for s in ((c, b, 100), (c, p, 100), (c,))]
    (bout, tout, bias), g = _fused(plan, flat, cts)
    (want_b, want_t), want = _autograd_stacks(ROW_CFG, flat, bx, tin, cts, torch.float32)
    torch.testing.assert_close(bout, want_b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tout, want_t, rtol=1e-5, atol=1e-6)
    assert torch.equal(bias, flat[:, 0]) and torch.equal(g[:, 0], cts[2])
    err = ((g - want).norm(dim=1) / want.norm(dim=1)).max().item()
    assert err < 1e-5, err


@pytest.mark.parametrize("c,b,p", [(1, 37, 301), (3, 130, 129)])
def test_plain_stacks_in_bf16_follow_autograd_of_mlp_stack(c, b, p):
    """The plain version as the field runs it (bf16 weights, inputs,
    activations and cotangents; bias, tanh and sums in f32): features and
    gradient within bf16's rounding of autograd of ``mlp_stack`` in f32 on the
    same rounded weights (each of nine layers rounds once, so the gradient
    agrees to 2e-2 of each chain's norm, cosine above 0.999)."""
    rng, bx, tx = _inputs(b, p, seed=10 + c)
    tin = bc_embedding(tx)
    bf = torch.bfloat16
    plan = FeatureStacks(ROW_CFG, bx, tin, bf)
    flat = torch.as_tensor(0.1 * rng.normal(size=(c, ROW_CFG.num_params)), dtype=torch.float32)
    cts = [torch.as_tensor(rng.normal(size=s), dtype=torch.float32).to(bf)
           for s in ((c, b, 100), (c, p, 100), (c,))]
    (bout, tout, _), g = _fused(plan, flat, cts)
    assert bout.dtype == tout.dtype == bf and g.dtype == torch.float32
    (want_b, want_t), want = _autograd_stacks(ROW_CFG, flat, bx, tin, cts, bf)
    for got_f, want_f in ((bout, want_b), (tout, want_t)):
        assert ((got_f.float() - want_f).norm() / want_f.norm()).item() < 1e-2
    err = ((g - want).norm(dim=1) / want.norm(dim=1)).max().item()
    cos = torch.nn.functional.cosine_similarity(g, want, dim=1).min().item()
    assert err < 2e-2 and cos > 0.999, (err, cos)


def test_plain_backward_writes_each_layer_at_its_offsets():
    """The written-out backward of one stack alone (the other's cotangent
    zero) fills exactly that stack's slices of the flat gradient."""
    rng, bx, tx = _inputs(20, 30, seed=3)
    cfg = DeepONetConfig(in_branch=101, width_branch=9, width_trunk=9, depth_branch=3,
                         depth_trunk=4, output_neurons=7)
    plan = FeatureStacks(cfg, bx, bc_embedding(tx), torch.float32)
    flat = torch.as_tensor(0.3 * rng.normal(size=(2, cfg.num_params)), dtype=torch.float32)
    feats, acts = stacks_forward_reference(plan, flat)
    sl = param_slices(cfg)
    for k, name in enumerate(("branch", "trunk")):
        cts = [torch.zeros_like(f) for f in feats]
        cts[k] = torch.ones_like(feats[k])
        g = stacks_backward_reference(plan, flat, acts, cts)
        lo, hi = sl[name][0].b, sl[name][-1].end
        assert g[:, lo:hi].abs().sum(1).min() > 0
        assert not g[:, :lo].any() and not g[:, hi:].any()


def test_fused_stacks_pad_the_inputs_with_a_ones_column():
    """The shared inputs are cast once and padded to a multiple of 16 with
    ones in the last column (5 -> 16, 101 -> 112): the kernels' bias column."""
    _, bx, tx = _inputs(7, 9, seed=4)
    plan = FeatureStacks(ROW_CFG, bx, bc_embedding(tx))
    for st, x, kin in zip(plan.stacks, (bx, bc_embedding(tx)), (112, 16)):
        assert st.x.shape == (x.shape[0], kin) and st.x.dtype == torch.bfloat16
        assert torch.equal(st.x_in, x.to(torch.bfloat16))
        assert (st.x[:, -1] == 1).all() and not st.x[:, x.shape[1]:-1].any()


@pytest.mark.parametrize("kw,fits", [
    ({}, True),
    (dict(activation="relu"), False),
    (dict(activation="sine"), False),
    (dict(width_branch=WP - 1, width_trunk=WP - 1), True),
    (dict(width_trunk=WP), False),
    (dict(output_neurons=WP), True),
    (dict(output_neurons=WP + 1), False),
    (dict(depth_branch=17), False),
])
def test_fusable_rule(kw, fits):
    """Tanh stacks whose input and hidden widths leave the ones column free,
    with a latent width of at most 112 and at most 16 layers."""
    assert fusable(DeepONetConfig(**kw), 101, 5) is fits


@pytest.mark.parametrize("c,tiles,want", [
    (48, [8, 80], [(8, 1), (8, 10)]),     # the row: 528 blocks, four per SM
    (1, [8, 80], [(1, 8), (5, 16)]),      # the warm start: 16 slots at most
    (48, [4, 21], [(3, 2), (3, 7)]),      # stride 2: 500 functions x 2601 points
])
def test_backward_split_rule(c, tiles, want):
    assert _split_rule(c, tiles, 132) == want


@pytest.mark.parametrize("c", [1, 3])
def test_fused_bf16_field_matches_jax(c):
    """make_gram_grad_full in bf16 on the DeepONet's widths (9 functions x
    20 points) takes the fused stacks (``field.stacks.fused`` counts 2 a
    call) and agrees with JAX's bf16 field within test_torch_ops.py's bf16
    tolerances (5e-2 of the gradient's largest entry, cosine above 0.999)."""
    from vihmc_tpu.models import DeepONetConfig as JCfg
    from vihmc_tpu.ops.gram_merge import make_gram_grad_full as j_make

    tp = tiny_problem(seed=30)
    rng = np.random.default_rng(30)
    bx = rng.normal(size=(tp.bx.shape[0], 101)).astype(np.float32)
    flats = (0.1 * rng.normal(size=(c, ROW_CFG.num_params))).astype(np.float32)
    jgrad, _, _ = j_make(JCfg(), jnp.asarray(bx), jnp.asarray(tp.tx), jnp.asarray(tp.y),
                         tp.tau, compute_dtype=jnp.bfloat16)
    field = make_gram_grad_full(ROW_CFG, torch.as_tensor(bx), tp.t("tx"), tp.t("y"), tp.tau,
                                compute_dtype=torch.bfloat16)
    n0 = profiling.counters().get("field.stacks.fused", 0)
    got = field(torch.as_tensor(flats))
    assert profiling.counters()["field.stacks.fused"] == n0 + 2
    for k in range(c):
        want = np.asarray(jgrad(jnp.asarray(flats[k])))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[k].numpy() / scale, want / scale, rtol=5e-2, atol=5e-2)
        cos = np.dot(got[k].numpy(), want) / (np.linalg.norm(want) * np.linalg.norm(got[k]))
        assert cos > 0.999


def _dispatch_case(case):
    """A call that must not take the fused stacks: the f32 field, a relu
    field in bf16, the MH test's fused paired delta, the f32 density."""
    from vihmc_torch.pipelines.common import (make_fused_paired_subspace_delta,
                                              make_nll_log_likelihood)

    tp = tiny_problem(seed=31)
    flat = torch.as_tensor(tp.frozen)[None].repeat(2, 1)
    args = (tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau)
    if case == "f32_field":
        return lambda: make_gram_grad_full(tp.tcfg, *args)(flat)
    if case == "relu_bf16_field":
        cfg = DeepONetConfig(**{**tp.tcfg.__dict__, "activation": "relu"})
        return lambda: make_gram_grad_full(cfg, *args, compute_dtype=torch.bfloat16)(flat)
    if case == "mh_delta":
        q = torch.as_tensor(tp.frozen[tp.idx])[None].repeat(2, 1)
        delta = make_fused_paired_subspace_delta(tp.tcfg, *args, tp.tspec.idx, tp.tprior)
        return lambda: delta(q + 1e-3, q, torch.as_tensor(tp.frozen))
    return lambda: make_nll_log_likelihood(tp.tcfg, *args)(flat)


@pytest.mark.parametrize("case", ["f32_field", "relu_bf16_field", "mh_delta", "density"])
def test_only_the_bf16_tanh_field_takes_the_fused_stacks(case):
    """``field.stacks.fused`` stays where it was through each call; the bf16
    tanh field on the same problem counts 2 a call."""
    fn = _dispatch_case(case)
    n0 = profiling.counters().get("field.stacks.fused", 0)
    out = fn()
    assert all(torch.isfinite(t).all() for t in (out if isinstance(out, tuple) else (out,)))
    assert profiling.counters().get("field.stacks.fused", 0) == n0
    tp = tiny_problem(seed=31)
    field = make_gram_grad_full(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau,
                                compute_dtype=torch.bfloat16)
    for calls in (1, 2):
        field(torch.as_tensor(tp.frozen)[None])
        assert profiling.counters()["field.stacks.fused"] == n0 + 2 * calls
