"""The port's CUDA kernels on the card, against their plain PyTorch versions
and float64: ``paired_sums``, ``merge_sums`` (with ``fused_merge_nll``) and
``fused_leapfrog_update``.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX). Without a card every
test skips: a CUDA kernel has no CPU or interpret mode.
"""

import numpy as np
import pytest
import torch

from vihmc_torch.core.profiling import counter
from vihmc_torch.ops.deeponet_merge import (_merge_launch, _paired_launch, _sums_path,
                                            close_paired_sums, fused_merge_nll,
                                            fused_paired_delta, merge_nll_reference,
                                            merge_sums, merge_sums_reference,
                                            paired_sums, paired_sums_reference,
                                            y_sums)
from vihmc_torch.ops.leapfrog import (fused_leapfrog_update,
                                      leapfrog_update_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _features(seed, c, b, p, k, device):
    """Features at q0 and at q1 one small step away, and y (B, P)."""
    rng = np.random.default_rng(seed)
    bout0 = rng.normal(size=(c, b, k)).astype(np.float32)
    tout0 = rng.normal(size=(c, p, k)).astype(np.float32)
    bout1 = (bout0 + 1e-3 * rng.normal(size=(c, b, k))).astype(np.float32)
    tout1 = (tout0 + 1e-3 * rng.normal(size=(c, p, k))).astype(np.float32)
    y = rng.normal(size=(b, p)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (bout1, tout1, bout0, tout0, y)]


def _sums_f64(bout1, tout1, bout0, tout0, y):
    """The five sums in float64, and for each the sum of its terms written
    with the magnitudes of their operands (the scale of f32 rounding)."""
    b1, t1, b0, t0, yy = (t.double() for t in (bout1, tout1, bout0, tout0, y))
    m1 = b1 @ t1.transpose(-1, -2)
    m0 = b0 @ t0.transpose(-1, -2)
    dm, sm = m1 - m0, m1 + m0
    terms = [dm * (sm - 2 * yy), dm, sm, m1 * m1, m1 * yy]
    both = m1.abs() + m0.abs()
    mags = [both * (both + 2 * yy.abs()), both, both, m1 * m1, (m1 * yy).abs()]
    return (torch.stack([t.sum((1, 2)) for t in terms], dim=-1),
            torch.stack([t.sum((1, 2)) for t in mags], dim=-1))


def test_paired_sums_kernel_matches_plain_version(cuda_device):
    """Ragged C = 3, 130 x 301 x 12: Delta ll within 1e-2 nats of the plain
    version (the paired form's stated error) and lp1 within rtol 1e-5."""
    bout1, tout1, bout0, tout0, y = _features(5, 3, 130, 301, 12, cuda_device)
    bias1 = torch.tensor([0.34, 0.2, -0.1], device=cuda_device)
    bias0 = torch.tensor([0.31, 0.21, -0.12], device=cuda_device)
    n = counter("paired_sums.launches")
    d_k, lp_k = fused_paired_delta(bout1, tout1, bias1, bout0, tout0, bias0, y, 0.7)
    torch.cuda.synchronize()
    assert counter("paired_sums.launches") == n + 1
    sums_p = paired_sums_reference(bout1, tout1, bout0, tout0, y)
    d_p, lp_p = close_paired_sums(sums_p, bias1, bias0, y.numel(), 0.7, *y_sums(y))
    np.testing.assert_allclose(d_k.cpu().numpy(), d_p.cpu().numpy(), atol=1e-2, rtol=0)
    np.testing.assert_allclose(lp_k.cpu().numpy(), lp_p.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("b,p,k", [(200, 1000, 100), (64, 64, 16), (1, 1, 1), (130, 301, 1),
                                   (257, 515, 12), (129, 129, 33), (1000, 1021, 100),
                                   (131, 300, 113)])
def test_paired_sums_kernel_matches_float64(cuda_device, b, p, k):
    """Against a float64 evaluation: each of the five sums within 1e-5 of
    the sum of its terms' operand magnitudes (f32 products and f32 sums
    inside a block round at that scale; D and Bd add small differences, so a
    bound relative to the sums themselves would not hold). K that is not a
    multiple of the mma depth 16 (1, 12, 33, 100, 113) leaves a ragged last K
    chunk, and K % 4 != 0 takes the 4-byte copies; B, P off the 128 x 128
    tile leave ragged edges; 1 x 1 x 1 is a block that is all edge."""
    feats = _features(6, 2, b, p, k, cuda_device)
    got = paired_sums(*feats).double()
    want, mag = _sums_f64(*feats)
    torch.cuda.synchronize()
    err = ((got - want).abs() / mag.clamp(min=1e-30)).max().item()
    assert err < 1e-5, err


def test_paired_sums_kernel_is_deterministic_and_checks_inputs(cuda_device):
    """Two launches on the same inputs agree bit for bit (fixed-order
    reduction, no atomics); a non-contiguous or mixed-device input raises
    before any launch."""
    feats = _features(7, 4, 257, 515, 33, cuda_device)
    a = paired_sums(*feats)
    b = paired_sums(*feats)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    n = counter("paired_sums.launches")
    bad = feats[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        paired_sums(feats[0], bad, *feats[2:])
    with pytest.raises(ValueError):
        paired_sums(feats[0], feats[1], feats[2], feats[3], feats[4].cpu())
    with pytest.raises(TypeError):
        paired_sums(feats[0].half(), *feats[1:])
    with pytest.raises(ValueError):
        paired_sums(feats[0], feats[1], feats[2][:, :-1].contiguous(), *feats[3:])
    assert counter("paired_sums.launches") == n


def test_paired_sums_equal_endpoints_give_zero_delta(cuda_device):
    """q1 = q0: both products run the same instructions on the same bits, so
    D and Bd are exactly 0 and Sm is exactly 2 sum m1."""
    bout1, tout1, _, _, y = _features(13, 3, 300, 700, 100, cuda_device)
    got = paired_sums(bout1, tout1, bout1.clone(), tout1.clone(), y)
    torch.cuda.synchronize()
    assert bool((got[:, 0] == 0).all()) and bool((got[:, 1] == 0).all()), got[:, :2]


def test_paired_sums_at_reference_scale(cuda_device):
    """Features whose merge reaches |m| ~ 10 over a y of the Burgers data's
    scale: each sum within 1e-5 of its terms' magnitudes of float64, and the
    closed Delta ll's error against float64 at most twice the plain IEEE f32
    version's plus 1e-3 nats."""
    c, b, p, k = 2, 1000, 1021, 100
    rng = np.random.default_rng(14)
    bout0 = rng.normal(scale=0.7, size=(c, b, k)).astype(np.float32)
    tout0 = rng.normal(scale=0.7, size=(c, p, k)).astype(np.float32)
    bout1 = (bout0 + 1e-3 * rng.normal(size=bout0.shape)).astype(np.float32)
    tout1 = (tout0 + 1e-3 * rng.normal(size=tout0.shape)).astype(np.float32)
    y = rng.normal(scale=1.3, size=(b, p)).astype(np.float32)
    feats = [torch.as_tensor(a, device=cuda_device) for a in (bout1, tout1, bout0, tout0, y)]
    got = paired_sums(*feats)
    want, mag = _sums_f64(*feats)
    torch.cuda.synchronize()
    assert (want[:, 3].sqrt() / (b * p) ** 0.5).max().item() > 4.0  # rms |m1| ~ 4.9, max ~ 25
    err = ((got.double() - want).abs() / mag).max().item()
    assert err < 1e-5, err
    bias = torch.zeros(c, device=cuda_device)
    sy = y_sums(feats[4])
    d_k, _ = close_paired_sums(got, bias, bias, b * p, 1.0, *sy)
    d_p, _ = close_paired_sums(paired_sums_reference(*feats), bias, bias, b * p, 1.0, *sy)
    d_64, _ = close_paired_sums(want, bias, bias, b * p, 1.0, *sy)
    err_k = (d_k.double() - d_64.double()).abs().max().item()
    err_p = (d_p.double() - d_64.double()).abs().max().item()
    assert err_k <= 2 * err_p + 1e-3, (err_k, err_p)


def test_paired_sums_unaligned_features_and_repeat_launches(cuda_device):
    """Contiguous views that start 4 bytes into a buffer take the 4-byte
    copies; they give the same sums as aligned copies of the same values, and
    each layout repeats bit for bit."""
    aligned = _features(15, 2, 200, 300, 100, cuda_device)
    views = []
    for t in aligned[:4]:
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        buf[1:] = t.flatten()
        views.append(buf[1:].view(t.shape))
    a1 = paired_sums(*aligned)
    a2 = paired_sums(*aligned)
    u1 = paired_sums(*views, aligned[4])
    u2 = paired_sums(*views, aligned[4])
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(u1, u2)
    assert torch.equal(a1, u1)


def _merge_features(seed, c, b, p, k, device):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(a.astype(np.float32), device=device) for a in
            (rng.normal(size=(c, b, k)), rng.normal(size=(c, p, k)),
             rng.normal(size=(b, p)))]


def _merge_sums_f64(bout, tout, y):
    """S1, S2 in float64, and for each the sum of its terms' magnitudes."""
    b, t, yy = (a.double() for a in (bout, tout, y))
    m = b @ t.transpose(-1, -2)
    sums = torch.stack([(m * (m - 2 * yy)).sum((1, 2)), m.sum((1, 2))], -1)
    mags = torch.stack([(m * m + 2 * (m * yy).abs()).sum((1, 2)), m.abs().sum((1, 2))], -1)
    return sums, mags


@pytest.mark.parametrize("b,p,k", [(200, 1000, 100), (130, 301, 12), (1, 1, 1), (130, 301, 1),
                                   (257, 515, 12), (129, 129, 33), (1000, 1021, 100),
                                   (131, 300, 113), (10, 10201, 100)])
def test_merge_sums_kernel_matches_plain_and_float64(cuda_device, b, p, k):
    """Each sum within 1e-5 of its terms' magnitudes of the float64 sums and
    of the plain version (f32 products round at that scale; the sums are
    f64 on both sides). K off the mma depth 16 (1, 12, 33, 100, 113) leaves a
    ragged last K chunk, B, P off the 128 x 128 tile a ragged tile edge,
    1 x 1 x 1 a block that is all edge; B = 10 is hmc_nuts's training set,
    below one 64-row tile."""
    feats = _merge_features(8, 2, b, p, k, cuda_device)
    n = counter("merge_sums.launches")
    got = merge_sums(*feats)
    torch.cuda.synchronize()
    assert counter("merge_sums.launches") == n + 1
    assert got.dtype == torch.float64 and got.shape == (2, 2)
    want, mag = _merge_sums_f64(*feats)
    plain = merge_sums_reference(*feats)
    for ref in (want, plain):
        err = ((got - ref).abs() / mag.clamp(min=1e-30)).max().item()
        assert err < 1e-5, err


def test_merge_sums_kernel_is_deterministic_and_checks_inputs(cuda_device):
    """Two launches agree bit for bit (fixed-order f64 reduction); a wrong
    dtype, shape or device raises before any launch."""
    feats = _merge_features(9, 3, 257, 515, 33, cuda_device)
    a = merge_sums(*feats)
    b = merge_sums(*feats)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    n = counter("merge_sums.launches")
    with pytest.raises(TypeError):
        merge_sums(feats[0].double(), *feats[1:])
    with pytest.raises(ValueError):
        merge_sums(feats[0], feats[1][:, :, :-1].contiguous(), feats[2])
    with pytest.raises(ValueError):
        merge_sums(feats[0], feats[1], feats[2].cpu())
    assert counter("merge_sums.launches") == n


def test_merge_sums_at_reference_scale(cuda_device):
    """|m| ~ 10 over a y of the data's scale, so |S1| ~ 1e6 or more: each sum
    within 1e-7 of its terms' magnitudes of float64 (the stage-3 check's
    MERGE_RTOL_MAG), and two launches bit for bit equal, on aligned and on
    4-byte-offset features."""
    c, b, p, k = 2, 1000, 1021, 100
    rng = np.random.default_rng(17)
    bout = rng.normal(scale=0.7, size=(c, b, k)).astype(np.float32)
    tout = rng.normal(scale=0.7, size=(c, p, k)).astype(np.float32)
    y = rng.normal(scale=1.3, size=(b, p)).astype(np.float32)
    feats = [torch.as_tensor(a, device=cuda_device) for a in (bout, tout, y)]
    views = []
    for t in feats[:2]:
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        buf[1:] = t.flatten()
        views.append(buf[1:].view(t.shape))
    want, mag = _merge_sums_f64(*feats)
    assert want[:, 0].abs().min().item() > 1e6
    for fs in (feats[:2], views):
        got = merge_sums(*fs, feats[2])
        again = merge_sums(*fs, feats[2])
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        err = ((got - want).abs() / mag).max().item()
        assert err < 1e-7, err


def test_fused_merge_nll_on_the_card(cuda_device):
    """ll through the kernel against the plain f32 reference (rtol 1e-5) and
    its gradient against autograd of the reference (relative error 1e-4)."""
    bout, tout, y = _merge_features(10, 3, 300, 700, 20, cuda_device)
    bout, tout = 0.1 * bout, 0.1 * tout
    bias = torch.tensor([0.3, -0.2, 0.05], device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (bout, tout, bias)]
    got = fused_merge_nll(*leaves, y, 0.9)
    g_got = torch.autograd.grad(got.sum(), leaves)
    ref_leaves = [t.clone().requires_grad_(True) for t in (bout, tout, bias)]
    ref = merge_nll_reference(*ref_leaves, y, 0.9)
    g_ref = torch.autograd.grad(ref.sum(), ref_leaves)
    np.testing.assert_allclose(got.detach().cpu().numpy(), ref.detach().cpu().numpy(),
                               rtol=1e-5)
    flat_got = torch.cat([g.flatten() for g in g_got])
    flat_ref = torch.cat([g.flatten() for g in g_ref])
    rel = ((flat_got - flat_ref).norm() / flat_ref.norm()).item()
    assert rel < 1e-4, rel


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("mass", ["scalar", "diagonal"])
def test_leapfrog_kernel_matches_plain_version(cuda_device, aligned, mass):
    """(16, 4099) batch (odd D: the float4 groups straddle rows and leave a
    tail), through the float4 kernel or, on a 4-byte-offset view, the scalar
    one: within one ulp of the plain version (both round each product and
    sum separately, in the same order; nvcc may not contract them)."""
    c, d = 16, 4099
    rng = np.random.default_rng(11)
    bufs = [torch.as_tensor(rng.normal(size=c * d + 1).astype(np.float32), device=cuda_device)
            for _ in range(3)]
    q, p, g = ((bf[:-1] if aligned else bf[1:]).view(c, d) for bf in bufs)
    im = 0.37 if mass == "scalar" else torch.as_tensor(
        (0.5 + rng.random(d)).astype(np.float32), device=cuda_device)
    n = counter("leapfrog_update.launches")
    qk, pk = fused_leapfrog_update(q, p, g, 3e-3, im)
    torch.cuda.synchronize()
    assert counter("leapfrog_update.launches") == n + 1
    im_t = torch.as_tensor(im, dtype=torch.float32, device=cuda_device)
    qr, pr = leapfrog_update_reference(q, p, g, 3e-3, im_t)
    for a, r in ((qk, qr), (pk, pr)):
        ulp = torch.finfo(torch.float32).eps * r.abs().clamp(min=torch.finfo(torch.float32).tiny)
        assert bool(((a - r).abs() <= ulp).all()), (a - r).abs().max().item()


# ---------------------------------------------------------------------------
# Stages 1-2 and the REFRESH policy on the card (no kernel of their own: the
# same code on CUDA tensors against the CPU)
# ---------------------------------------------------------------------------

SMALL_DEEPONET_KW = dict(in_branch=17, in_trunk=5, width_branch=16, width_trunk=16,
                         depth_branch=3, depth_trunk=3)


def _small_vi_case(seed):
    from vihmc_torch.models.deeponet import DeepONetConfig

    rng = np.random.default_rng(seed)
    cfg = DeepONetConfig(**SMALL_DEEPONET_KW)
    d = cfg.num_params
    arrays = {"mu": 0.1 * rng.normal(size=d), "rho": -5.0 + 0.1 * rng.normal(size=d),
              "eps": rng.normal(size=(3, d)), "branch": rng.normal(size=(6, 17)),
              "trunk": rng.random(size=(6, 40, 2)), "y": rng.normal(size=(6, 40))}
    return cfg, {k: torch.as_tensor(v.astype(np.float32)) for k, v in arrays.items()}


def test_bayesian_forward_and_ensemble_step_on_cuda_match_cpu(cuda_device):
    """The small DeepONet's Bayesian forward (3 injected draws, per-example
    points) and one VI step (loss, gradients, parameters after Adam) on the
    card against the same code on the CPU: rtol 1e-5 (IEEE f32 on both sides,
    different reduction orders)."""
    from vihmc_torch.core.precision import true_f32
    from vihmc_torch.models.bayesian import BayesianFlat
    from vihmc_torch.pipelines.common import deeponet_vi_apply
    from vihmc_torch.vi.elbo import ELBOConfig
    from vihmc_torch.vi.train import VIConfig, VITrainer

    cfg, a = _small_vi_case(21)
    vi = VIConfig(lr_start=1e-3, num_ens=3, prior_sigma=0.1,
                  elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=1.0))
    results = {}
    for dev in ("cpu", cuda_device):
        t = {k: v.to(dev) for k, v in a.items()}
        model = BayesianFlat(deeponet_vi_apply(cfg), t["mu"], t["rho"])
        batch = {"branch": t["branch"], "trunk": t["trunk"], "y": t["y"]}
        with true_f32():
            pred = model(batch, eps=t["eps"]).detach()
            trainer = VITrainer(model, vi, train_size=6 * 400)
            loss = trainer.step(batch, eps=t["eps"])
        results[str(dev)] = [x.detach().cpu() for x in
                             (pred, loss, model.mu.grad, model.rho.grad, model.mu, model.rho)]
    for got, want in zip(results[str(cuda_device)], results["cpu"]):
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6 * scale)


def test_chunked_and_unchunked_jacobians_agree_on_cuda(cuda_device):
    """The small DeepONet's mean squared Jacobian over 6 examples x 40 points,
    in chunks of 4 (a ragged last chunk) and all at once on the card, and
    all at once on the CPU: rtol 1e-5 of the largest entry."""
    from vihmc_torch.pipelines.common import make_flat_deeponet
    from vihmc_torch.sensitivity import mean_squared_jacobian

    cfg, a = _small_vi_case(22)
    apply_flat = make_flat_deeponet(cfg)

    def apply_one(f, x):
        return apply_flat(f[None], x["branch"][None, :], x["trunk"][None])[0, 0]

    out = {}
    for dev, chunk in (("cpu", 0), (cuda_device, 0), (cuda_device, 4)):
        inputs = {"branch": a["branch"].to(dev), "trunk": a["trunk"].to(dev)}
        out[(str(dev), chunk)] = mean_squared_jacobian(apply_one, a["mu"].to(dev), inputs,
                                                       chunk).cpu()
    want = out[("cpu", 0)]
    for key, got in out.items():
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


def test_refresh_on_cuda_keeps_per_chain_frozen_vectors_and_merge_sums_count(cuda_device):
    """Stage 3 under REFRESH on the card with the fused density and the Gram
    field (small DeepONet, 3 chains, 6 draws): every chain ends with its own
    frozen vector, ``merge_sums`` launched 1 + 2 x draws times (the recompute
    at the new frozen vectors replaces the unpaired one), finite samples."""
    from vihmc_torch.models.deeponet import DeepONetConfig
    from vihmc_torch.pipelines.configs import VIHMCRunConfig
    from vihmc_torch.pipelines.vi_hmc import run_operator

    rng = np.random.default_rng(23)
    cfg_d = DeepONetConfig(**SMALL_DEEPONET_KW)
    d = cfg_d.num_params
    t, x = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 11), indexing="ij")
    split = lambda n: {"branch_in": rng.normal(size=(n, 17)).astype(np.float32),  # noqa: E731
                       "trunk_in": np.stack([t.ravel(), x.ravel()], -1).astype(np.float32),
                       "solution": (0.3 * rng.normal(size=(n, 99))).astype(np.float32)}
    arts = {"mu": (0.1 * rng.normal(size=d)).astype(np.float32),
            "sigma": (0.02 + 0.03 * rng.random(d)).astype(np.float32),
            "indices": np.sort(rng.choice(d, size=40, replace=False))}
    cfg = VIHMCRunConfig(num_samples=6, step_size=1e-3, num_chains=3, num_leapfrog=4,
                         tau_out=1.0, frozen_policy="refresh", vi_mass=True,
                         clip_grad=13.0 * 40 ** 0.5, jitter_eps=True, jitter_low_frac=0.5)
    n = counter("merge_sums.launches")
    out = run_operator(cfg, cfg_d, arts, data=(split(12), split(5)), use_fused=True,
                       segment_size=3, device=cuda_device)
    torch.cuda.synchronize()
    assert counter("merge_sums.launches") - n == 1 + 2 * cfg.num_samples
    aux = out["result"].final_state.aux
    assert aux.shape == (3, d) and aux.device.type == "cuda"
    assert not torch.equal(aux[0], aux[1]) and not torch.equal(aux[1], aux[2])
    assert np.isfinite(out["result"].samples).all()
    assert all(np.isfinite(v).all() for v in out["metrics"].values())


def _small_stage3_case(seed):
    from vihmc_torch.models.deeponet import DeepONetConfig

    rng = np.random.default_rng(seed)
    cfg_d = DeepONetConfig(**SMALL_DEEPONET_KW)
    d = cfg_d.num_params
    t, x = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 11), indexing="ij")
    split = lambda n: {"branch_in": rng.normal(size=(n, 17)).astype(np.float32),  # noqa: E731
                       "trunk_in": np.stack([t.ravel(), x.ravel()], -1).astype(np.float32),
                       "solution": (0.3 * rng.normal(size=(n, 99))).astype(np.float32)}
    arts = {"mu": (0.1 * rng.normal(size=d)).astype(np.float32),
            "sigma": (0.02 + 0.03 * rng.random(d)).astype(np.float32),
            "indices": np.sort(rng.choice(d, size=40, replace=False))}
    return cfg_d, (split(12), split(5)), arts


@pytest.mark.parametrize("variant", ["stride", "gauss"])
def test_stage3_variants_on_cuda_launch_merge_sums_per_density(cuda_device, variant):
    """Stage 3's stride (3/3 Gram surrogate) and gauss (VI-Gaussian field)
    variants on the card with the fused density (small DeepONet, 3 chains, 6
    draws): ``merge_sums`` launched 1 + 2 x draws times, the Gram field
    1 + L x draws times for stride and never for gauss, finite samples and
    metrics."""
    import vihmc_torch.pipelines.vi_hmc as vi_hmc
    from vihmc_torch.pipelines.configs import VIHMCRunConfig

    cfg_d, data, arts = _small_stage3_case(24)
    field = dict(coarse_stride=3, fn_stride=3) if variant == "stride" else dict(gauss_field=1.0)
    cfg = VIHMCRunConfig(num_samples=6, step_size=1e-3, num_chains=3, num_leapfrog=4,
                         tau_out=1.0, frozen_policy="draw", vi_mass=True,
                         clip_grad=13.0 * 40 ** 0.5, jitter_eps=True, jitter_low_frac=0.5,
                         **field)
    calls = []
    real = vi_hmc.make_gram_grad_full

    def counted(*a, **kw):
        f = real(*a, **kw)
        return lambda full: (calls.append(1), f(full))[1]

    vi_hmc.make_gram_grad_full = counted
    try:
        n = counter("merge_sums.launches")
        out = vi_hmc.run_operator(cfg, cfg_d, arts, data=data, use_fused=True,
                                  segment_size=3, device=cuda_device)
        torch.cuda.synchronize()
    finally:
        vi_hmc.make_gram_grad_full = real
    assert counter("merge_sums.launches") - n == 1 + 2 * cfg.num_samples
    assert len(calls) == (1 + cfg.L * cfg.num_samples if variant == "stride" else 0)
    assert np.isfinite(out["result"].samples).all()
    assert all(np.isfinite(v).all() for v in out["metrics"].values())


def test_hmc_nuts_fused_on_cuda_launches_and_frozen_step(cuda_device):
    """hmc_nuts on the card with the fused density and the Gram field (small
    DeepONet, 3 chains, 20 draws, burn 2): ``merge_sums`` launched
    1 + 2 x draws times; after burn every chain's step is constant at
    exp(log_step_avg); finite samples."""
    from vihmc_torch.pipelines import hmc_nuts
    from vihmc_torch.pipelines.configs import OperatorHMCRunConfig

    cfg_d, data, _ = _small_stage3_case(25)
    cfg = OperatorHMCRunConfig(model=cfg_d, n_train=12, n_valid=5, num_samples=20,
                               step_size=2e-3, post_std=0.1)
    assert cfg.burn == 2
    inits = 0.1 * np.random.default_rng(25).normal(size=(3, cfg_d.num_params))
    n = counter("merge_sums.launches")
    out = hmc_nuts.run(cfg, data=data, num_chains=3, use_fused=True, inits=inits,
                       device=cuda_device)
    torch.cuda.synchronize()
    assert counter("merge_sums.launches") - n == 1 + 2 * cfg.num_samples
    res = out["result"]
    post = res.step_sizes[:, cfg.burn:]
    assert (post == post[:, :1]).all()
    np.testing.assert_allclose(post[:, 0], torch.exp(res.final_state.da.log_step_avg).cpu(),
                               rtol=1e-6)
    assert np.isfinite(res.samples).all()


@pytest.mark.parametrize("algorithm", ["nuts", "chees"])
def test_stage3_nuts_and_chees_on_cuda_launch_merge_sums(cuda_device, algorithm):
    """Stage 3 under NUTS (depth 3) and ChEES (at most 6 steps) on the card
    with the fused density and the stride Gram field (small DeepONet, 3
    chains, 5 draws): ``merge_sums`` launched 1 + 7 x draws times for NUTS
    (every tree leaf evaluates the density) and 1 + draws for ChEES (the
    trajectory's end only); finite samples and metrics."""
    from vihmc_torch.pipelines.configs import VIHMCRunConfig
    from vihmc_torch.pipelines.vi_hmc import run_operator

    cfg_d, data, arts = _small_stage3_case(26)
    cfg = VIHMCRunConfig(num_samples=5, step_size=1e-3, num_chains=3, num_leapfrog=4,
                         tau_out=1.0, frozen_policy="draw", vi_mass=True,
                         clip_grad=13.0 * 40 ** 0.5, coarse_stride=3, fn_stride=3,
                         algorithm=algorithm, nuts_max_depth=3, chees_max_steps=6)
    n = counter("merge_sums.launches")
    out = run_operator(cfg, cfg_d, arts, data=data, use_fused=True, use_gram=True,
                       segment_size=5, device=cuda_device)
    torch.cuda.synchronize()
    per_draw = 7 if algorithm == "nuts" else 1
    assert counter("merge_sums.launches") - n == 1 + per_draw * cfg.num_samples
    assert out["algorithm"] == algorithm
    assert np.isfinite(out["result"].samples).all()
    assert all(np.isfinite(v).all() for v in out["metrics"].values())


def test_resume_on_cuda_with_merge_sums_is_bit_equal(cuda_device, tmp_path):
    """Stage 3 on the card with the fused density (small DeepONet, 3 chains,
    12 draws in segments of 4, REFRESH): stopped after segment 1 by a
    progress callback that raises, then resumed into the same checkpoint
    directory; the samples equal the uninterrupted run's bit for bit.
    ``merge_sums`` runs 1 + 2 x draws-run-in-the-call times on each leg (the
    initial state is evaluated on a resume too, as in JAX)."""
    from vihmc_torch.pipelines.configs import VIHMCRunConfig
    from vihmc_torch.pipelines.vi_hmc import run_operator

    cfg_d, data, arts = _small_stage3_case(27)
    cfg = VIHMCRunConfig(num_samples=12, step_size=1e-3, num_chains=3, num_leapfrog=4,
                         tau_out=1.0, frozen_policy="refresh", vi_mass=True,
                         clip_grad=13.0 * 40 ** 0.5, jitter_eps=True, jitter_low_frac=0.5)
    kw = dict(data=data, use_fused=True, segment_size=4, evaluate=False, device=cuda_device)

    def launches(fn):
        n = counter("merge_sums.launches")
        out = fn()
        torch.cuda.synchronize()
        return out, counter("merge_sums.launches") - n

    full, n_full = launches(lambda: run_operator(cfg, cfg_d, arts, **kw))
    assert n_full == 1 + 2 * 12

    class Stop(Exception):
        pass

    def stop(seg, n_seg, state):
        raise Stop

    ck = str(tmp_path / "ck")
    n0 = counter("merge_sums.launches")
    with pytest.raises(Stop):
        run_operator(cfg, cfg_d, arts, checkpoint_dir=ck, progress=stop, **kw)
    torch.cuda.synchronize()
    assert counter("merge_sums.launches") - n0 == 1 + 2 * 4
    resumed, n_res = launches(lambda: run_operator(cfg, cfg_d, arts, checkpoint_dir=ck, **kw))
    assert n_res == 1 + 2 * 8
    np.testing.assert_array_equal(resumed["result"].samples, full["result"].samples)
    assert torch.equal(resumed["result"].final_state.aux, full["result"].final_state.aux)


def test_cli_vi_hmc_on_cuda(cuda_device, tmp_path):
    """The command line on the card: vi-nn with sensitivity, then vi-hmc
    --device cuda with the VI trace; finite samples and trace."""
    from vihmc_torch.pipelines import cli

    out = str(tmp_path)
    assert cli.main(["vi-nn", "--epochs", "5", "--with-sensitivity", "--out", out,
                     "--uid", "vi", "--device", "cuda"]) == 0
    assert cli.main(["vi-hmc", "--artifacts", f"{out}/vi", "--num-samples", "6",
                     "--num-chains", "2", "--policy", "refresh", "--save-vi-trace",
                     "--out", out, "--uid", "hmc", "--device", "cuda"]) == 0
    assert np.isfinite(np.load(tmp_path / "hmc" / "hmc_params.npy")).all()
    assert np.load(tmp_path / "hmc" / "vi_params.npy").shape == (2, 6, 141)


def test_kernel_flops_counted_with_the_launches(cuda_device):
    """The mfu blocks' FLOP count (``core.profiling.count_flops``) sees the
    kernels' products, which torch's counter cannot: one ``paired_sums``
    launch adds its two products (4 C B P K) and one ``merge_sums`` launch
    its one (2 C B P K), on top of the matmuls torch issues in the call."""
    from vihmc_torch.core.profiling import count_flops
    from vihmc_torch.ops.deeponet_merge import merge_sums

    c, b, p, k = 3, 64, 130, 16
    feats = _features(17, c, b, p, k, cuda_device)
    x = torch.ones((5, 7), device=cuda_device)
    flops, _ = count_flops(lambda: (paired_sums(*feats), x @ x.T))
    assert flops == 4 * c * b * p * k + 2 * 5 * 7 * 5
    flops, _ = count_flops(lambda: merge_sums(feats[0], feats[1], feats[4]))
    assert flops == 2 * c * b * p * k


# The small-problem kernels (one chain and 64 P rows x 16-64 B rows per
# block, one launch): ragged B, P and K, K % 4 != 0 (4-byte loads), several
# chains, more chains than the wrapper's first counter buffer (64), and B past
# one 64-row tile.
SMALL_SHAPES = [(1, 1000, 1021, 100), (3, 10, 515, 100), (2, 63, 301, 13), (1, 130, 129, 33),
                (4, 1, 1, 1), (1, 17, 64, 7), (2, 127, 700, 200), (65, 10, 130, 16)]


@pytest.mark.parametrize("c,b,p,k", SMALL_SHAPES)
def test_small_merge_kernel_matches_plain_and_float64(cuda_device, c, b, p, k):
    """Each sum within 1e-5 of its terms' magnitudes of float64 and of the
    plain version (as the tiled kernel's test); two launches bit for bit
    equal; each launch counted in ``merge_sums.launches`` and ``.launches_small``."""
    feats = _merge_features(31, c, b, p, k, cuda_device)
    n, n_small = counter("merge_sums.launches"), counter("merge_sums.launches_small")
    got = _merge_launch("small", *feats)
    again = _merge_launch("small", *feats)
    torch.cuda.synchronize()
    assert counter("merge_sums.launches") == n + 2
    assert counter("merge_sums.launches_small") == n_small + 2
    assert torch.equal(got, again)
    want, mag = _merge_sums_f64(*feats)
    for ref in (want, merge_sums_reference(*feats)):
        err = ((got - ref).abs() / mag.clamp(min=1e-30)).max().item()
        assert err < 1e-5, err


@pytest.mark.parametrize("c,b,p,k", SMALL_SHAPES)
def test_small_paired_kernel_matches_float64(cuda_device, c, b, p, k):
    """The five sums within 1e-5 of their terms' operand magnitudes of
    float64 (as the tiled kernel's test), two launches bit for bit equal, and
    D = Bd = 0 exactly at q1 = q0."""
    feats = _features(32, c, b, p, k, cuda_device)
    n_small = counter("paired_sums.launches_small")
    got = _paired_launch("small", *feats)
    again = _paired_launch("small", *feats)
    same = _paired_launch("small", feats[0], feats[1], feats[0].clone(), feats[1].clone(),
                          feats[4])
    torch.cuda.synchronize()
    assert counter("paired_sums.launches_small") == n_small + 3
    assert torch.equal(got, again)
    assert bool((same[:, :2] == 0).all()), same[:, :2]
    want, mag = _sums_f64(*feats)
    err = ((got.double() - want).abs() / mag.clamp(min=1e-30)).max().item()
    assert err < 1e-5, err


def test_wrappers_take_the_small_kernels_by_the_rule(cuda_device):
    """``merge_sums`` and ``paired_sums`` launch the small kernel where
    ``_sums_path`` says so (C <= 2, or B < 128) and the tiled one elsewhere,
    and both give the same sums within 1e-5 of the terms' magnitudes."""
    for c, b in [(1, 1000), (2, 200), (4, 10), (3, 127), (3, 130), (16, 128)]:
        feats = _features(33, c, b, 70, 20, cuda_device)
        small = _sums_path(c, b) == "small"
        n_m, n_p = counter("merge_sums.launches_small"), counter("paired_sums.launches_small")
        got_m = merge_sums(feats[0], feats[1], feats[4])
        got_p = paired_sums(*feats)
        assert counter("merge_sums.launches_small") - n_m == int(small)
        assert counter("paired_sums.launches_small") - n_p == int(small)
        other = "tiled" if small else "small"
        alt_m = _merge_launch(other, feats[0], feats[1], feats[4])
        alt_p = _paired_launch(other, *feats)
        torch.cuda.synchronize()
        _, mag_m = _merge_sums_f64(feats[0], feats[1], feats[4])
        _, mag_p = _sums_f64(*feats)
        assert ((got_m - alt_m).abs() / mag_m).max().item() < 1e-5
        assert ((got_p.double() - alt_p.double()).abs() / mag_p).max().item() < 1e-5
    assert _sums_path(3, 130) == "tiled" and _sums_path(2, 1000) == "small"


def test_small_kernels_at_reference_scale(cuda_device):
    """|m| ~ 10 over a y of the data's scale at one chain of the operator
    shape's B: merge sums within 1e-7 of their terms' magnitudes of float64
    (the stage-3 check), the paired Delta ll's error against float64 at most
    twice the plain version's plus 1e-3 nats, and 4-byte-offset features
    give the aligned features' sums bit for bit."""
    c, b, p, k = 1, 1000, 1021, 100
    rng = np.random.default_rng(34)
    bout0 = rng.normal(scale=0.7, size=(c, b, k)).astype(np.float32)
    tout0 = rng.normal(scale=0.7, size=(c, p, k)).astype(np.float32)
    bout1 = (bout0 + 1e-3 * rng.normal(size=bout0.shape)).astype(np.float32)
    tout1 = (tout0 + 1e-3 * rng.normal(size=tout0.shape)).astype(np.float32)
    y = rng.normal(scale=1.3, size=(b, p)).astype(np.float32)
    feats = [torch.as_tensor(a, device=cuda_device) for a in (bout1, tout1, bout0, tout0, y)]
    views = []
    for t in feats[:4]:
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        buf[1:] = t.flatten()
        views.append(buf[1:].view(t.shape))
    got_m = _merge_launch("small", feats[0], feats[1], feats[4])
    got_mu = _merge_launch("small", views[0], views[1], feats[4])
    got_p = _paired_launch("small", *feats)
    got_pu = _paired_launch("small", *views, feats[4])
    torch.cuda.synchronize()
    assert torch.equal(got_m, got_mu) and torch.equal(got_p, got_pu)
    want_m, mag_m = _merge_sums_f64(feats[0], feats[1], feats[4])
    assert ((got_m - want_m).abs() / mag_m).max().item() < 1e-7
    want_p, _ = _sums_f64(*feats)
    bias = torch.zeros(c, device=cuda_device)
    sy = y_sums(feats[4])
    d_k, _ = close_paired_sums(got_p, bias, bias, b * p, 1.0, *sy)
    d_p, _ = close_paired_sums(paired_sums_reference(*feats), bias, bias, b * p, 1.0, *sy)
    d_64, _ = close_paired_sums(want_p, bias, bias, b * p, 1.0, *sy)
    err_k = (d_k.double() - d_64.double()).abs().max().item()
    err_p = (d_p.double() - d_64.double()).abs().max().item()
    assert err_k <= 2 * err_p + 1e-3, (err_k, err_p)


def _gram_cotangents_f64(bout, tout, bias, y, var):
    """The Gram cotangents in float64, chain by chain."""
    f64 = torch.float64
    yy = y.to(f64)
    out = [[], [], []]
    for c in range(bout.shape[0]):
        bo, to, b = bout[c].to(f64), tout[c].to(f64), bias[c].to(f64)
        sum_t, sum_b = to.sum(0), bo.sum(0)
        out[0].append((yy @ to - bo @ (to.T @ to) - b * sum_t) / var)
        out[1].append((yy.T @ bo - to @ (bo.T @ bo) - b * sum_b) / var)
        out[2].append((yy.sum() - sum_b @ sum_t - yy.numel() * b) / var)
    return [torch.stack(o) for o in out]


def test_merged_gram_cotangents_at_f32_accumulation_level(cuda_device):
    """The merged bf16 -> f32 route on the card at C = 4, B = 64, P = 1,001
    (odd: the query pad is exercised), K = 100, against float64 on the same
    bf16 values: every row of both cotangents within 1e-5 of its norm and the
    bias cotangent within 1e-5 (f32 sums of exact products; a bf16-rounded
    result is over 100x further off); ``field.cotangents.merged`` counts one
    per merged call, and none for a f32 field on the card."""
    from vihmc_torch.core import profiling
    from vihmc_torch.models.deeponet import DeepONetConfig
    from vihmc_torch.ops.gram_merge import make_gram_grad_full, merge_nll_gram_cotangents

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(16)
    bf = torch.bfloat16
    bout, tout, bias, y = (torch.randn(s, generator=gen, device=cuda_device).to(bf)
                           for s in ((4, 64, 100), (4, 1001, 100), (4,), (64, 1001)))
    n0 = profiling.counters().get("field.cotangents.merged", 0)
    got = merge_nll_gram_cotangents(bout, tout, bias, y, 0.7)
    torch.cuda.synchronize()
    want = _gram_cotangents_f64(bout, tout, bias, y, 0.7)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = ((g.double() - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
        rounded = ((g.to(bf).double() - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
        assert err <= 1e-5 and 100 * err < rounded, (err, rounded)
    assert ((got[2].double() - want[2]).abs() / want[2].abs()).max().item() <= 1e-5
    assert profiling.counters()["field.cotangents.merged"] == n0 + 1

    cfg = DeepONetConfig(in_branch=6, in_trunk=5, width_branch=9, width_trunk=9,
                         depth_branch=3, depth_trunk=3)
    bx = torch.randn(64, 6, generator=gen, device=cuda_device)
    tx = torch.rand(1001, 2, generator=gen, device=cuda_device)
    flat = 0.3 * torch.randn(3, cfg.num_params, generator=gen, device=cuda_device)
    y32 = y.float()
    g_bf = make_gram_grad_full(cfg, bx, tx, y32, 0.7, compute_dtype=bf)
    g_32 = make_gram_grad_full(cfg, bx, tx, y32, 0.7)
    for _ in range(2):
        assert torch.isfinite(g_bf(flat)).all() and torch.isfinite(g_32(flat)).all()
    assert profiling.counters()["field.cotangents.merged"] == n0 + 3


# -- the fused bf16 feature stacks of the Gram field (csrc/field_stack.cu) --

def _stack_problem(c, b, p, device, seed=21, cfg=None):
    """The DeepONet's stacks (widths 100, inputs 101 and 5, nine layers each
    unless ``cfg`` says otherwise) on B functions and P grid points, a flat
    batch at the init's scale, and bf16 cotangents of the features."""
    from vihmc_torch.models.deeponet import DeepONetConfig, bc_embedding, init_deeponet
    from vihmc_torch.ops.field_stacks import FeatureStacks

    cfg = cfg or DeepONetConfig()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bx = torch.randn(b, cfg.in_branch, generator=gen, device=device)
    tx = torch.rand(p, 2, generator=gen, device=device)
    plan = FeatureStacks(cfg, bx, bc_embedding(tx))
    base = init_deeponet(cfg, device=device)
    flat = base + 0.05 * torch.randn(c, cfg.num_params, generator=gen, device=device)
    k = cfg.latent
    cts = [torch.randn(c, n, k, generator=gen, device=device).to(torch.bfloat16)
           for n in (b, p)] + [torch.randn(c, generator=gen, device=device).to(torch.bfloat16)]
    return cfg, plan, flat, cts


def _stacks_vjp(plan, flat, cts):
    leaf = flat.clone().requires_grad_(True)
    with torch.enable_grad():
        outs = plan(leaf)
        (g,) = torch.autograd.grad(outs, leaf, grad_outputs=cts)
    return [o.detach() for o in outs[:2]], g


@pytest.mark.parametrize("c,b,p", [(48, 1000, 10201), (1, 1000, 10201), (48, 500, 2601),
                                   (3, 37, 301)])
def test_field_stacks_kernels_match_plain_version(cuda_device, c, b, p):
    """The kernels against the plain version on the card, at the row's shapes
    (C 48, B 1000, P 10,201), at C = 1 (the warm start), on the stride-2
    subsets (500 functions, 51 x 51 points) and ragged small: the features
    within bf16 rounding of the plain version's (both sum f32 products in
    another order, so a rounding may land one unit apart), every chain's
    gradient within 5e-3 of the plain one's norm."""
    from vihmc_torch.ops.field_stacks import (stacks_backward_reference,
                                              stacks_forward_reference)

    cfg, plan, flat, cts = _stack_problem(c, b, p, cuda_device)
    feats, g = _stacks_vjp(plan, flat, cts)
    want_feats, acts = stacks_forward_reference(plan, flat)
    want = stacks_backward_reference(plan, flat, acts, cts[:2])
    want[:, 0] = cts[2].float()
    torch.cuda.synchronize()
    for got_f, want_f in zip(feats, want_feats):
        assert got_f.dtype == torch.bfloat16 and got_f.shape == want_f.shape
        diff = (got_f.float() - want_f.float()).norm() / want_f.float().norm()
        assert diff < 2e-3, diff.item()
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    err = ((g - want).norm(dim=1) / want.norm(dim=1)).max().item()
    assert err < 5e-3, err


def test_field_stacks_are_deterministic_and_count_launches(cuda_device):
    """Two calls on the same input give bit-equal features and gradients (the
    weight gradients are summed in a fixed order, no float atomics); a call
    launches pack + forward, then one backward kernel per layer (nine), and
    counts ``field.stacks.fused`` twice (once per stack); a non-contiguous
    batch or an f32 cotangent raises before any launch."""
    cfg, plan, flat, cts = _stack_problem(48, 1000, 10201, cuda_device, seed=22)
    n0, k0 = counter("field_stacks.launches"), counter("field.stacks.fused")
    a = _stacks_vjp(plan, flat, cts)
    torch.cuda.synchronize()
    assert counter("field_stacks.launches") - n0 == 2 + max(cfg.depth_branch, cfg.depth_trunk)
    assert counter("field.stacks.fused") - k0 == 2
    b = _stacks_vjp(plan, flat, cts)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])
    from vihmc_torch.ops.field_stacks import _backward_launch, _forward_launch

    n1 = counter("field_stacks.launches")
    with pytest.raises(ValueError):
        _forward_launch(plan, flat.t().contiguous().t())
    _, saved = _forward_launch(plan, flat)
    with pytest.raises(ValueError):
        _backward_launch(plan, saved, [cts[0].float(), cts[1]])
    assert counter("field_stacks.launches") == n1 + 2


def test_bf16_field_on_the_card_takes_the_fused_stacks(cuda_device):
    """make_gram_grad_full in bf16 on the card (C 4, 200 functions x 1001
    points) launches the fused stacks and agrees with the same field on the
    CPU (the plain version) within 1e-2 of each chain's norm; the f32 field
    launches none."""
    from vihmc_torch.models.deeponet import DeepONetConfig
    from vihmc_torch.ops.gram_merge import make_gram_grad_full

    cfg = DeepONetConfig()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(23)
    bx = torch.randn(200, 101, generator=gen, device=cuda_device)
    tx = torch.rand(1001, 2, generator=gen, device=cuda_device)
    y = torch.randn(200, 1001, generator=gen, device=cuda_device)
    _, _, flat, _ = _stack_problem(4, 8, 8, cuda_device, seed=23)
    n0 = counter("field_stacks.launches")
    got = make_gram_grad_full(cfg, bx, tx, y, 0.7, compute_dtype=torch.bfloat16)(flat)
    torch.cuda.synchronize()
    assert counter("field_stacks.launches") == n0 + 11
    want = make_gram_grad_full(cfg, bx.cpu(), tx.cpu(), y.cpu(), 0.7,
                               compute_dtype=torch.bfloat16)(flat.cpu())
    err = ((got.cpu() - want).norm(dim=1) / want.norm(dim=1)).max().item()
    assert err < 1e-2, err
    make_gram_grad_full(cfg, bx, tx, y, 0.7)(flat)
    torch.cuda.synchronize()
    assert counter("field_stacks.launches") == n0 + 11


# -- the FNO2d's fused bf16 projection (csrc/fno_project.cu) --

def _projection_problem(c, w, f, n, device, seed=31, s=101, pad=9):
    """The last Fourier layer's output ``x`` (C, W, n, s + pad, s + pad) (the
    pad points hold values, as in the model), a flat (C, D) batch whose
    slices are the projection's weights (chain stride D, as ``unravel_fno``
    gives them) at the init's scale, and a cotangent of ``out``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(c, w, n, s + pad, s + pad, generator=gen, device=device)
    leaf = (torch.rand(c, f * w + 2 * f + 4, generator=gen, device=device) * 2 - 1) / w ** 0.5
    g = torch.randn(c, n, s, s, generator=gen, device=device)
    return x, leaf, g


def _projection_weights(leaf, c, f, w):
    return (leaf[:, :f * w].view(c, f, w), leaf[:, f * w:f * w + f],
            leaf[:, f * w + f:f * w + 2 * f].view(c, 1, f),
            leaf[:, f * w + 2 * f:f * w + 2 * f + 1])


def _projection_vjp(fn, x, leaf, g, c, f, w):
    """``(out, dx, dw1, db1, dw2, db2)`` of ``fn(x, *weights)`` by autograd."""
    xl, ll = x.clone().requires_grad_(True), leaf.clone().requires_grad_(True)
    with torch.enable_grad():
        out = fn(xl, *_projection_weights(ll, c, f, w))
        dx, dl = torch.autograd.grad(out, (xl, ll), g)
    return (out.detach(), dx, *(t.detach() for t in _projection_weights(dl, c, f, w)))


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("w,f", [(32, 128), (32, 100), (20, 200)])
def test_fno_project_kernels_match_plain_project(cuda_device, w, f):
    """The kernels (C 4, 8 functions, the 110 x 110 padded grid) against the
    plain bf16 ``_Project`` (cuBLAS products) and against the plain version of
    the kernels' arithmetic: out and all five gradients within bf16-product
    tolerance (the same roundings; only the f32 sums' order differs, so a
    rounding to bf16 may land one unit apart); dx exactly 0 at the pad points;
    the published widths, and an fc_dim and a width that need padding."""
    from vihmc_torch.models.fno import _Project
    from vihmc_torch.ops.fno_project import (FusedProject, project_backward_reference,
                                             project_reference)

    c, n, s = 4, 8, 101
    x, leaf, g = _projection_problem(c, w, f, n, cuda_device)
    n0, k0 = counter("fno_project.launches"), counter("fno.project.fused")
    got = _projection_vjp(lambda *a: FusedProject.apply(*a, s, s, False), x, leaf, g, c, f, w)
    torch.cuda.synchronize()
    assert counter("fno_project.launches") - n0 == 2
    assert counter("fno.project.fused") - k0 == 2
    plain = _projection_vjp(lambda *a: _Project.apply(*a, s, s, torch.bfloat16, False),
                            x, leaf, g, c, f, w)
    weights = _projection_weights(leaf, c, f, w)
    ref = (project_reference(x, *weights, s, s),
           *project_backward_reference(x, g, *weights, s, s))
    names = ("out", "dx", "dw1", "db1", "dw2", "db2")
    for name, a, p, r in zip(names, got, plain, ref):
        assert a.shape == p.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
        assert _rel(a, p) < 1e-3, (name, _rel(a, p))
        assert _rel(a, r) < 1e-3, (name, _rel(a, r))
    dx = got[1]
    assert (dx[..., s:, :] == 0).all() and (dx[..., :, s:] == 0).all()


def test_fno_project_kernels_are_deterministic(cuda_device):
    """Two calls give bit-equal outputs and gradients (the weight gradients
    are summed in slot order, no float atomics); one chain (the warm start)
    and a ragged function count take the same kernels."""
    from vihmc_torch.ops.fno_project import FusedProject

    for c, n in ((4, 8), (1, 3)):
        x, leaf, g = _projection_problem(c, 32, 128, n, cuda_device, seed=32)
        fn = lambda *a: FusedProject.apply(*a, 101, 101, False)  # noqa: E731
        a = _projection_vjp(fn, x, leaf, g, c, 128, 32)
        b = _projection_vjp(fn, x, leaf, g, c, 128, 32)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_bf16_fno_field_on_the_card_takes_the_fused_projection(cuda_device):
    """make_fno_grad_full in bf16 on the card (the published widths, C 2, 24
    functions in 3 chunks on a 20 x 20 grid) counts ``fno.project.fused`` 2
    per chunk and one kernel launch each, and agrees with the same field on
    the CPU (``_Project``) within 1e-2 of each chain's norm; the f32 field,
    the f32 density and the probe scores launch none."""
    from vihmc_torch.bench_fno import fno_probe_scores
    from vihmc_torch.models.fno import FNO2dConfig, fno_field_bytes, init_fno
    from vihmc_torch.pipelines.common import (fno_chunks, make_fno_grad_full,
                                              make_fno_nll_log_likelihood)

    cfg, c, b, nt = FNO2dConfig(), 2, 24, 20
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(33)
    u0 = torch.randn(b, nt, generator=gen, device=cuda_device)
    y = torch.randn(b, nt * nt, generator=gen, device=cuda_device)
    flat = torch.stack([init_fno(cfg, device=cuda_device) for _ in range(c)])
    max_bytes = 8 * c * fno_field_bytes(cfg, nt, nt)
    assert len(fno_chunks(cfg, b, c, nt, nt, max_bytes)) == 3
    n0, k0 = counter("fno_project.launches"), counter("fno.project.fused")
    got = make_fno_grad_full(cfg, u0, y, 0.5, torch.bfloat16, max_bytes)(flat)
    torch.cuda.synchronize()
    assert counter("fno.project.fused") - k0 == 6
    assert counter("fno_project.launches") - n0 == 6
    want = make_fno_grad_full(cfg, u0.cpu(), y.cpu(), 0.5, torch.bfloat16, max_bytes)(flat.cpu())
    err = ((got.cpu() - want).norm(dim=1) / want.norm(dim=1)).max().item()
    assert err < 1e-2, err
    make_fno_grad_full(cfg, u0, y, 0.5, None, max_bytes)(flat)
    make_fno_nll_log_likelihood(cfg, u0, y, 0.5, max_bytes)(flat)
    fno_probe_scores(cfg, flat[0], torch.full_like(flat[0], 0.01), u0, nt, 4, 2, seed=3)
    torch.cuda.synchronize()
    assert counter("fno.project.fused") - k0 == 6
    assert counter("fno_project.launches") - n0 == 6
