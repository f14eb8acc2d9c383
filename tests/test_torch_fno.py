"""The FNO2d (``vihmc_torch/models/fno.py``) and its stage-3 pieces
(``pipelines/common.py``) on the CPU, at a small size with seeded weights:
the published module's layout and forward, the plain reference of the
benchmark (``port_bench/reference/fno2d-burgers.py``), the layers' backward
(``gradcheck`` in float64), the chain batch against a loop, the chunked
autograd field and the float64-summed density and MH delta against the
reference, and the Rademacher-probe sensitivity against ``jacrev``."""

from __future__ import annotations

import importlib.util
import os

import pytest
import torch
import torch.nn.functional as tnf
from torch import nn

from vihmc_torch.bench_fno import fno_rows
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.dists.priors import DiagonalGaussianPrior
from vihmc_torch.models.fno import (FNO2dConfig, _Lift, _Pointwise, _Project, _Spectral,
                                    fno_apply, fno_apply_chains, fno_field_bytes, fno_input,
                                    init_fno, param_slices, unravel_fno)
from vihmc_torch.pipelines.common import (fno_chunks, fno_vi_apply, make_fno_grad_full,
                                          make_fno_nll_log_likelihood,
                                          make_fno_paired_subspace_delta)
from vihmc_torch.sensitivity.scores import mean_squared_jacobian, sensitivity_scores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FNO2dConfig(modes1=3, modes2=3, width=6, fc_dim=16, padding=2)
MODEL = {"modes1": 3, "modes2": 3, "width": 6, "n_layers": 4, "fc_dim": 16, "in_channels": 3,
         "padding": 2, "num_params": CFG.num_params}
NT = NX = 12
B = 6


def _reference_class():
    path = os.path.join(ROOT, "port_bench", "reference", "fno2d-burgers.py")
    spec = importlib.util.spec_from_file_location("fno2d_burgers_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Reference


class _Spectral2d(nn.Module):
    """``fourier_2d.py``'s ``SpectralConv2d``, written out for the test."""

    def __init__(self, width, m1, m2):
        super().__init__()
        self.m1, self.m2 = m1, m2
        scale = 1.0 / (width * width)
        self.weights1 = nn.Parameter(scale * torch.rand(width, width, m1, m2, dtype=torch.cfloat))
        self.weights2 = nn.Parameter(scale * torch.rand(width, width, m1, m2, dtype=torch.cfloat))

    def forward(self, x):
        x_ft = torch.fft.rfft2(x)
        out = torch.zeros(x.shape[0], self.weights1.shape[1], x.size(-2), x.size(-1) // 2 + 1,
                          dtype=torch.cfloat)
        m1, m2 = self.m1, self.m2
        out[:, :, :m1, :m2] = torch.einsum("bixy,ioxy->boxy", x_ft[:, :, :m1, :m2],
                                           self.weights1)
        out[:, :, -m1:, :m2] = torch.einsum("bixy,ioxy->boxy", x_ft[:, :, -m1:, :m2],
                                            self.weights2)
        return torch.fft.irfft2(out, s=(x.size(-2), x.size(-1)))


class _FNO2d(nn.Module):
    """``fourier_2d.py``'s ``FNO2d`` at ``CFG``'s sizes (its registration
    order: fc0, conv0..3, w0..3, fc1, fc2)."""

    def __init__(self, cfg):
        super().__init__()
        self.pad = cfg.padding
        self.fc0 = nn.Linear(cfg.in_channels, cfg.width)
        for lay in range(cfg.n_layers):
            setattr(self, f"conv{lay}", _Spectral2d(cfg.width, cfg.modes1, cfg.modes2))
        for lay in range(cfg.n_layers):
            setattr(self, f"w{lay}", nn.Conv2d(cfg.width, cfg.width, 1))
        self.fc1 = nn.Linear(cfg.width, cfg.fc_dim)
        self.fc2 = nn.Linear(cfg.fc_dim, 1)
        self.n_layers = cfg.n_layers

    def forward(self, x):
        x = self.fc0(x).permute(0, 3, 1, 2)
        x = tnf.pad(x, [0, self.pad, 0, self.pad])
        for lay in range(self.n_layers):
            x = getattr(self, f"conv{lay}")(x) + getattr(self, f"w{lay}")(x)
            if lay < self.n_layers - 1:
                x = tnf.gelu(x)
        x = x[..., :-self.pad, :-self.pad].permute(0, 2, 3, 1)
        return self.fc2(tnf.gelu(self.fc1(x)))[..., 0]


def _flat_of(module):
    return torch.cat([torch.view_as_real(p).flatten() if p.is_complex() else p.flatten()
                      for p in module.parameters()]).detach()


def _data(seed=0):
    g = torch.Generator().manual_seed(seed)
    u0 = torch.randn(B, NX, generator=g)
    y = torch.randn(B, NT * NX, generator=g)
    flat = init_fno(CFG, g) * 3.0
    return u0, y, flat


def _reference(u0, y, flat, idx, scores=None, sigma=None):
    mu = flat
    sigma = torch.full_like(flat, 0.01) if sigma is None else sigma
    inputs = {"u0": u0, "y": y, "mu": mu, "sigma": sigma, "eps": torch.zeros_like(flat),
              "idx": idx, "scores": torch.ones_like(flat) if scores is None else scores}
    return _reference_class()(inputs, MODEL, {"tau_var": 1.0}, {"field": {"clip": 1e30}},
                              block=4)


def test_published_size_and_layout():
    assert FNO2dConfig().num_params == 2_368_001
    sl = param_slices(FNO2dConfig())
    assert [s[0] for s in sl[:4]] == ["fc0.weight", "fc0.bias", "conv0.weights1",
                                      "conv0.weights2"]
    assert all(a[2] == b[1] for a, b in zip(sl, sl[1:]))
    spectral = sum(s[2] - s[1] for s in sl if s[0].startswith("conv"))
    assert spectral == 2_359_296


def test_flat_layout_is_the_module_s_parameters_with_real_then_imaginary():
    torch.manual_seed(1)
    module = _FNO2d(CFG)
    flat = _flat_of(module)
    assert flat.shape == (CFG.num_params,)
    p = unravel_fno(CFG, flat[None])
    for name, param in module.named_parameters():
        got = p[name][0]
        want = torch.view_as_real(param) if param.is_complex() else param
        assert torch.equal(got, want.detach()), name
    w1 = p["conv2.weights1"][0]
    assert torch.equal(torch.view_as_complex(w1.contiguous()),
                       module.conv2.weights1.detach())
    assert torch.equal(w1[..., 1], module.conv2.weights1.detach().imag)


def test_fno_apply_matches_the_published_module():
    torch.manual_seed(2)
    module = _FNO2d(CFG)
    u0, _, _ = _data()
    a = fno_input(u0, NT)
    want = module(a).detach()
    got = fno_apply(CFG, _flat_of(module), a)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fno_input_is_u0_on_every_row_then_the_grid():
    u0, _, _ = _data()
    a = fno_input(u0, NT)
    assert a.shape == (B, NT, NX, 3)
    assert torch.equal(a[:, 5, :, 0], u0)
    assert torch.equal(a[0, :, 0, 1], torch.linspace(0, 1, NT))
    assert torch.equal(a[0, 0, :, 2], torch.linspace(0, 1, NX))


def test_fno_apply_matches_the_plain_reference():
    u0, y, flat = _data()
    ref = _reference(u0, y, flat, torch.arange(5))
    want = ref.predict(flat, u0)
    got = fno_apply(CFG, flat, fno_input(u0, NT)).reshape(B, -1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_chains_equal_a_loop_of_single_vectors():
    u0, _, flat = _data()
    g = torch.Generator().manual_seed(3)
    flats = flat + 0.05 * torch.randn(3, flat.shape[0], generator=g)
    a = fno_input(u0, NT)
    got = fno_apply_chains(CFG, flats, a)
    for c in range(3):
        torch.testing.assert_close(got[c], fno_apply(CFG, flats[c], a), rtol=1e-5, atol=1e-5)
    assert torch.equal(fno_apply_chains(CFG, flats, a).flatten(2), got.flatten(2))
    # each chain on its own functions
    per = torch.stack([a[:2], a[2:4], a[4:]])
    got = fno_apply_chains(CFG, flats, per)
    for c in range(3):
        torch.testing.assert_close(got[c], fno_apply(CFG, flats[c], per[c]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("s2,m2", [(8, 3), (7, 4)])
def test_layer_backwards_pass_gradcheck_in_float64(s2, m2):
    torch.manual_seed(4)
    dt = torch.float64
    c, i, n, s1, m1 = 1, 2, 2, 5, 2
    x = torch.randn(c, i, n, s1, s2, dtype=dt, requires_grad=True)
    w1, w2 = (torch.randn(c, i, i, m1, m2, 2, dtype=dt, requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(lambda x, a, b: _Spectral.apply(x, a, b, None, False),
                                    (x, w1, w2), fast_mode=True)
    s = torch.randn(c, i, n, s1, s2, dtype=dt, requires_grad=True)
    w = torch.randn(c, i, i, 1, 1, dtype=dt, requires_grad=True)
    b = torch.randn(c, i, dtype=dt, requires_grad=True)
    for act in (True, False):
        assert torch.autograd.gradcheck(
            lambda s, x, w, b: _Pointwise.apply(s, x, w, b, act, None, False), (s, x, w, b),
            fast_mode=True)
    wf1 = torch.randn(c, 5, i, dtype=dt, requires_grad=True)
    bf1 = torch.randn(c, 5, dtype=dt, requires_grad=True)
    wf2 = torch.randn(c, 1, 5, dtype=dt, requires_grad=True)
    bf2 = torch.randn(c, 1, dtype=dt, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, a, b, e, f: _Project.apply(x, a, b, e, f, 4, s2 - 2, None, False),
        (x, wf1, bf1, wf2, bf2), fast_mode=True)
    a_t = torch.randn(3, n * 3 * (s2 - 2), dtype=dt)
    w0 = torch.randn(c, i, 3, dtype=dt, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda w, b: _Lift.apply(a_t, w, b, n, 3, s2 - 2, 2, None, False), (w0, b),
        fast_mode=True)


def _ref_ll_grad(ref, w, u0, y):
    with torch.enable_grad():
        x = w.detach().clone().requires_grad_(True)
        ll = -0.5 * ((ref.predict(x, u0) - y) ** 2).sum()
        (g,) = torch.autograd.grad(ll, x)
    return g


@pytest.mark.parametrize("per_chunk", [1, 2, 4, 6])
def test_chunked_field_equals_the_reference_autograd_field(per_chunk):
    u0, y, flat = _data()
    ref = _reference(u0, y, flat, torch.arange(5))
    flats = torch.stack([flat, flat * 0.9])
    max_bytes = per_chunk * 2 * fno_field_bytes(CFG, NT, NX)
    chunks = fno_chunks(CFG, B, 2, NT, NX, max_bytes)
    assert len(chunks) == -(-B // per_chunk) and max(b - a for a, b in chunks) <= per_chunk
    got = make_fno_grad_full(CFG, u0, y, 1.0, max_bytes=max_bytes)(flats)
    for c in range(2):
        want = _ref_ll_grad(ref, flats[c], u0, y)
        torch.testing.assert_close(got[c], want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def test_bf16_field_is_close_to_the_f32_field():
    u0, y, flat = _data()
    g32 = make_fno_grad_full(CFG, u0, y, 1.0)(flat[None])[0]
    g16 = make_fno_grad_full(CFG, u0, y, 1.0, torch.bfloat16, max_bytes=1)(flat[None])[0]
    assert (g16 - g32).norm() / g32.norm() < 0.05
    assert torch.nn.functional.cosine_similarity(g16, g32, dim=0) > 0.999


def test_f64_summed_density_and_delta_match_the_reference():
    u0, y, flat = _data()
    idx = torch.arange(0, CFG.num_params, 97)
    ref = _reference(u0, y, flat, idx)
    sub = flat[idx]
    g = torch.Generator().manual_seed(5)
    q0 = sub + 0.01 * torch.randn(3, idx.shape[0], generator=g)
    q1 = q0 + 0.003 * torch.randn(3, idx.shape[0], generator=g)
    prior = DiagonalGaussianPrior(loc=sub, scale=torch.full_like(sub, 0.01))
    delta = make_fno_paired_subspace_delta(CFG, u0, y, 1.0, idx, prior, max_bytes=1)
    dlp, lp1 = delta(q1, q0, flat)
    torch.testing.assert_close(dlp.double(), ref.delta(q1, q0), rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(lp1.double(), ref.log_prob(q1), rtol=1e-6, atol=1e-2)
    ll = make_fno_nll_log_likelihood(CFG, u0, y, 1.0, max_bytes=1)
    full = scatter_subspace(flat, q1, idx)
    torch.testing.assert_close((ll(full) + prior.log_prob(q1)).double(), ref.log_prob(q1),
                               rtol=1e-6, atol=1e-2)


def test_vi_apply_is_the_bbb_forward_and_refuses_point_subsets():
    u0, y, flat = _data()
    vp = {"mu": flat, "rho": torch.full_like(flat, -5.0)}
    trunk = torch.zeros(NT * NX, 2)
    apply_fn = fno_vi_apply(CFG)
    out = apply_fn(vp, {"branch": u0, "trunk": trunk}, sample=False)
    torch.testing.assert_close(out[0], fno_apply(CFG, flat, fno_input(u0, NT)).reshape(B, -1))
    eps = torch.randn(2, flat.shape[0])
    out = apply_fn(vp, {"branch": u0, "trunk": trunk}, eps=eps)
    w = flat + eps * torch.nn.functional.softplus(vp["rho"])
    torch.testing.assert_close(out, fno_apply_chains(CFG, w, fno_input(u0, NT)).flatten(2))
    with pytest.raises(ValueError):
        apply_fn(vp, {"branch": u0, "trunk": torch.zeros(B, 7, 2)})


# -- the probe form of the sensitivity scores ------------------------------------

SMALL = FNO2dConfig(modes1=2, modes2=2, width=3, n_layers=1, fc_dim=8, padding=1)


def _plain_one(cfg, nt):
    """One example's output through the plain reference (``jacrev``-able)."""
    ref_cls = _reference_class()
    model = {"modes1": cfg.modes1, "modes2": cfg.modes2, "width": cfg.width,
             "n_layers": cfg.n_layers, "fc_dim": cfg.fc_dim, "in_channels": 3,
             "padding": cfg.padding, "num_params": cfg.num_params}

    def apply_one(flat, u0):
        ref = ref_cls.__new__(ref_cls)
        ref.model, ref.nt = model, nt
        ref.slices = {n: (a, b, s) for n, a, b, s in param_slices(cfg)}
        return ref.predict(flat, u0[None])[0]

    return apply_one


def test_probe_scores_converge_to_the_exact_mean_squared_jacobian():
    assert 200 <= SMALL.num_params <= 220
    g = torch.Generator().manual_seed(6)
    flat = init_fno(SMALL, g) * 4.0
    u0 = torch.randn(2, 6, generator=g)
    exact = mean_squared_jacobian(_plain_one(SMALL, 6), flat, u0)
    est = mean_squared_jacobian(None, flat, u0, probes=4096, seed=11,
                                apply_rows=fno_rows(SMALL, 6))
    keep = exact > 1e-6 * exact.max()
    assert keep.sum() > 150
    rel = ((est - exact).abs() / exact)[keep]
    assert rel.max() < 0.10, rel.max()


def test_probe_scores_repeat_for_a_seed_and_move_with_it():
    g = torch.Generator().manual_seed(7)
    flat = init_fno(SMALL, g)
    sigma = torch.full_like(flat, 0.02)
    u0 = torch.randn(4, 6, generator=g)
    rows = fno_rows(SMALL, 6)
    a = sensitivity_scores(None, flat, sigma, u0, chunk_size=3, probes=4, seed=5,
                           apply_rows=rows)
    b = sensitivity_scores(None, flat, sigma, u0, chunk_size=3, probes=4, seed=5,
                           apply_rows=rows)
    c = sensitivity_scores(None, flat, sigma, u0, chunk_size=3, probes=4, seed=6,
                           apply_rows=rows)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_probe_scores_are_the_plain_reference_s_per_function_vjps():
    """``fno_probe_scores`` (every probe of every picked function a row of one
    chain-batched pass) against the reference's own estimate by the same
    seeded rule, one plain VJP per probe and function, float64 sums."""
    from vihmc_torch.bench_fno import fno_probe_scores

    u0, y, flat = _data()
    sigma = torch.rand(flat.shape[0], generator=torch.Generator().manual_seed(9)) * 0.02 + 0.01
    ref = _reference(u0, y, flat, torch.arange(5), sigma=sigma)
    want = ref.probe_scores(functions=4, probes=3, seed=20101895)
    got = torch.as_tensor(fno_probe_scores(CFG, flat, sigma, u0, NT, 4, 3, 20101895))
    assert ((got.double() - want).norm() / want.norm()) < 1e-5
    top = torch.sort(torch.argsort(want, descending=True, stable=True)[:64]).values
    assert torch.equal(top, torch.sort(torch.argsort(got, descending=True)[:64]).values)


def test_probe_default_rows_vmap_the_one_example_forward():
    from vihmc_torch.models.mlp import MLPConfig, mlp_apply
    cfg = MLPConfig()
    g = torch.Generator().manual_seed(8)
    flat = torch.randn(cfg.num_params, generator=g)
    x = torch.randn(5, 1, generator=g)

    def one(p, xi):
        return mlp_apply(cfg, p[None], xi[None])[0]

    exact = mean_squared_jacobian(one, flat, x)
    est = mean_squared_jacobian(one, flat, x, probes=2048, seed=1)
    # one output per example: every probe is exact, up to the float32 sums
    torch.testing.assert_close(est, exact, rtol=1e-4, atol=0.0)


def test_probes_zero_is_the_exact_path_bit_for_bit():
    from vihmc_torch.models.deeponet import DeepONetConfig, deeponet_apply, unravel_deeponet
    from vihmc_torch.models.mlp import MLPConfig, mlp_apply
    g = torch.Generator().manual_seed(9)
    mlp = MLPConfig()
    flat = torch.randn(mlp.num_params, generator=g)
    x = torch.randn(7, 1, generator=g)

    def one(p, xi):
        return mlp_apply(mlp, p[None], xi[None])[0]

    assert torch.equal(mean_squared_jacobian(one, flat, x, 3),
                       mean_squared_jacobian(one, flat, x, 3, probes=0))
    don = DeepONetConfig(in_branch=4, in_trunk=2, width_branch=5, width_trunk=5, depth_branch=2,
                         depth_trunk=2, output_neurons=3, impose_bc=False)
    flat = 0.3 * torch.randn(don.num_params, generator=g)
    sigma = torch.rand(don.num_params, generator=g)
    inputs = {"branch": torch.randn(5, 4, generator=g), "trunk": torch.randn(5, 3, 2,
                                                                               generator=g)}

    def one_op(p, ex):
        return deeponet_apply(don, unravel_deeponet(don, p[None]), ex["branch"][None],
                              ex["trunk"][None])[0]

    assert torch.equal(sensitivity_scores(one_op, flat, sigma, inputs, 2),
                       sensitivity_scores(one_op, flat, sigma, inputs, 2, probes=0))


def test_chunks_are_multiples_of_eight_within_the_budget():
    per = 4 * fno_field_bytes(FNO2dConfig(), 101, 101)
    chunks = fno_chunks(FNO2dConfig(), 1000, 4, 101, 101, 485.5 * per)
    assert [b - a for a, b in chunks] == [336, 336, 328]
    assert fno_chunks(FNO2dConfig(), 1000, 4, 101, 101, None) == [(0, 1000)]
    # a budget below one function's bytes: one function a chunk
    assert fno_chunks(CFG, B, 1, NT, NX, 1) == [(i, i + 1) for i in range(B)]


def test_operator_vi_trainer_runs_the_bayesian_fno():
    """Stage 1 on a small Bayesian FNO2d through ``vi_train.run_operator``
    (minibatches of functions on the shared grid): the ELBO goes down and
    the best state is the trained posterior's."""
    from vihmc_torch.pipelines import vi_train
    from vihmc_torch.pipelines.configs import OperatorVIRunConfig
    from vihmc_torch.vi.elbo import ELBOConfig
    from vihmc_torch.vi.train import VIConfig

    g = torch.Generator().manual_seed(12)
    u0 = torch.randn(16, NX, generator=g)
    trunk = torch.stack(torch.meshgrid(torch.linspace(0, 1, NT), torch.linspace(0, 1, NX),
                                       indexing="ij"), -1).reshape(-1, 2)
    sol = u0[:, None, :].expand(16, NT, NX).reshape(16, -1) * 0.5
    split = {"branch_in": u0, "trunk_in": trunk, "solution": sol}
    cfg = OperatorVIRunConfig(model=CFG, batch_size=8, p=NT * NX, vi=VIConfig(
        epochs=6, lr_start=1e-2, num_ens=2, prior_sigma=0.1,
        elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=1.0)))
    init = {"mu": init_fno(CFG, g), "rho": torch.full((CFG.num_params,), -5.0)}
    out = vi_train.run_operator(cfg, seed=0, data=(split, split), init_vp=init, device="cpu")
    rows = out["metrics"]
    assert rows.shape == (6, 4) and torch.isfinite(torch.as_tensor(rows)).all()
    assert rows[-1, 0] < rows[0, 0] and rows[-1, 1] < rows[0, 1]
    assert out["best_state"].vp["mu"].shape == (CFG.num_params,)
