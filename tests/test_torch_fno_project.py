"""The FNO2d's fused projection (``vihmc_torch/ops/fno_project.py``) on the CPU:
the route rule (only a bf16 projection of a CUDA tensor takes the kernels),
the plain version of the kernels' arithmetic against ``_Project``'s bf16 path
and its autograd, and the checks the wrapper makes before a launch. The
kernels themselves run in ``tests/test_torch_cuda.py`` on a card."""

from __future__ import annotations

import types

import pytest
import torch

from vihmc_torch.core.profiling import counter
from vihmc_torch.models.fno import (FNO2dConfig, _Project, fno_apply_chains, fno_input, init_fno,
                                    unravel_fno)
from vihmc_torch.ops import fno_project
from vihmc_torch.pipelines.common import make_fno_grad_full, make_fno_nll_log_likelihood

CFG = FNO2dConfig(modes1=3, modes2=3, width=6, fc_dim=16, padding=2)


def _projection_inputs(c=2, w=6, f=16, n=3, s1=5, s2=7, pad=2, seed=0):
    """``x`` (C, W, n, s1 + pad, s2 + pad) and the weights as views of a flat
    (C, D) leaf, as ``unravel_fno`` gives them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(c, w, n, s1 + pad, s2 + pad, generator=g)
    d = f * w + 2 * f + 1 + 5
    leaf = (torch.rand(c, d, generator=g) * 2 - 1) / w ** 0.5
    w1 = leaf[:, :f * w].view(c, f, w)
    b1 = leaf[:, f * w:f * w + f]
    w2 = leaf[:, f * w + f:f * w + 2 * f].view(c, 1, f)
    b2 = leaf[:, f * w + 2 * f:f * w + 2 * f + 1]
    gout = torch.randn(c, n, s1, s2, generator=g)
    return x, leaf, (w1, b1, w2, b2), gout


@pytest.mark.parametrize("op,cuda,want", [(torch.bfloat16, True, True),
                                          (torch.bfloat16, False, False),
                                          (None, True, False), (None, False, False),
                                          (torch.float32, True, False),
                                          (torch.float16, True, False)])
def test_only_a_bf16_projection_on_cuda_takes_the_kernels(op, cuda, want):
    assert fno_project.fused(op, types.SimpleNamespace(is_cuda=cuda)) is want


@pytest.mark.parametrize("gemm", [None, torch.bfloat16])
def test_cpu_field_and_density_never_count_the_kernels(gemm):
    """The bf16 and the f32 field and the f32 density on the CPU keep
    ``_Project``: neither counter moves."""
    g = torch.Generator().manual_seed(1)
    u0, y = torch.randn(4, 6, generator=g), torch.randn(4, 5 * 6, generator=g)
    flat = torch.stack([init_fno(CFG, g), init_fno(CFG, g)])
    n0, k0 = counter("fno_project.launches"), counter("fno.project.fused")
    grad = make_fno_grad_full(CFG, u0, y, 1.0, gemm, max_bytes=1)(flat)
    ll = make_fno_nll_log_likelihood(CFG, u0, y, 1.0)(flat)
    assert torch.isfinite(grad).all() and torch.isfinite(ll).all()
    assert counter("fno_project.launches") == n0 and counter("fno.project.fused") == k0


def test_plain_version_is_project_s_bf16_arithmetic():
    """The plain version of the kernels (over the padded grid) against
    ``_Project`` with bf16 operands and its autograd: the same roundings, so
    only the order of f32 sums differs."""
    x, leaf, (w1, b1, w2, b2), gout = _projection_inputs()
    s1, s2 = gout.shape[-2:]
    xl = x.clone().requires_grad_(True)
    ll = leaf.clone().requires_grad_(True)
    c, f, w = w1.shape
    views = (ll[:, :f * w].view(c, f, w), ll[:, f * w:f * w + f],
             ll[:, f * w + f:f * w + 2 * f].view(c, 1, f), ll[:, f * w + 2 * f:f * w + 2 * f + 1])
    want = _Project.apply(xl, *views, s1, s2, torch.bfloat16, False)
    dx_w, dleaf = torch.autograd.grad(want, (xl, ll), gout)
    got = fno_project.project_reference(x, w1, b1, w2, b2, s1, s2)
    torch.testing.assert_close(got, want.detach(), rtol=1e-5, atol=1e-5)
    dx, dw1, db1, dw2, db2 = fno_project.project_backward_reference(x, gout, w1, b1, w2, b2,
                                                                     s1, s2)
    torch.testing.assert_close(dx, dx_w, rtol=1e-5, atol=1e-5)
    wants = (dleaf[:, :f * w].view(c, f, w), dleaf[:, f * w:f * w + f],
             dleaf[:, f * w + f:f * w + 2 * f].view(c, 1, f),
             dleaf[:, f * w + 2 * f:f * w + 2 * f + 1])
    for got_g, want_g in zip((dw1, db1, dw2, db2), wants):
        torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-5 * want_g.abs().max().item())


def test_plain_backward_is_zero_on_the_pad_points():
    x, _, weights, gout = _projection_inputs(seed=3)
    s1, s2 = gout.shape[-2:]
    dx = fno_project.project_backward_reference(x, gout, *weights, s1, s2)[0]
    assert (dx[..., s1:, :] == 0).all() and (dx[..., :, s2:] == 0).all()
    assert (dx[..., :s1, :s2] != 0).any()


def test_plain_version_matches_the_model_s_bf16_output(monkeypatch):
    """fno_apply_chains' bf16 output on the CPU (``_Project``) equals the plain
    version applied to the last Fourier layer's output."""
    g = torch.Generator().manual_seed(2)
    flat = torch.stack([init_fno(CFG, g), init_fno(CFG, g)])
    a = fno_input(torch.randn(3, 6, generator=g), 5)
    captured = {}
    real = _Project.apply

    def capture(x, *rest):
        captured["x"] = x
        return real(x, *rest)

    monkeypatch.setattr(_Project, "apply", staticmethod(capture))
    out = fno_apply_chains(CFG, flat, a, torch.bfloat16)
    monkeypatch.undo()
    p = unravel_fno(CFG, flat)
    want = fno_project.project_reference(captured["x"], p["fc1.weight"], p["fc1.bias"],
                                         p["fc2.weight"], p["fc2.bias"], 5, 6)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w,f", [(40, 128), (32, 300)], ids=["width", "fc_dim"])
def test_wrapper_refuses_widths_the_kernels_do_not_take(w, f):
    x, _, (w1, b1, w2, b2), gout = _projection_inputs(w=w, f=f)
    s1, s2 = gout.shape[-2:]
    with pytest.raises(ValueError, match="width up to"):
        fno_project.project_forward(x, w1, b1, w2, b2, s1, s2)
    with pytest.raises(ValueError, match="width up to"):
        fno_project.project_backward(x, gout, w1, b1, w2, b2, s1, s2)


def test_wrapper_refuses_other_dtypes_and_shapes():
    x, _, (w1, b1, w2, b2), gout = _projection_inputs()
    s1, s2 = gout.shape[-2:]
    with pytest.raises(ValueError, match="float32"):
        fno_project.project_forward(x.double(), w1, b1, w2, b2, s1, s2)
    with pytest.raises(ValueError, match="projection weights"):
        fno_project.project_forward(x, w1, b1[:, :3], w2, b2, s1, s2)
    with pytest.raises(ValueError, match="does not fit"):
        fno_project.project_forward(x, w1, b1, w2, b2, s1 + 5, s2)


@pytest.mark.parametrize("f,nch", [(1, 2), (64, 2), (100, 2), (128, 2), (129, 4), (256, 4)])
def test_hidden_chunks_of_the_kernel_for_fc_dim(f, nch):
    assert fno_project._chunks(f) == nch
