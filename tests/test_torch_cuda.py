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

from vihmc_torch.ops.deeponet_merge import (close_paired_sums, fused_merge_nll,
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
    n = paired_sums.launches
    d_k, lp_k = fused_paired_delta(bout1, tout1, bias1, bout0, tout0, bias0, y, 0.7)
    torch.cuda.synchronize()
    assert paired_sums.launches == n + 1
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
    n = paired_sums.launches
    bad = feats[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        paired_sums(feats[0], bad, *feats[2:])
    with pytest.raises(ValueError):
        paired_sums(feats[0], feats[1], feats[2], feats[3], feats[4].cpu())
    with pytest.raises(TypeError):
        paired_sums(feats[0].half(), *feats[1:])
    with pytest.raises(ValueError):
        paired_sums(feats[0], feats[1], feats[2][:, :-1].contiguous(), *feats[3:])
    assert paired_sums.launches == n


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
    n = merge_sums.launches
    got = merge_sums(*feats)
    torch.cuda.synchronize()
    assert merge_sums.launches == n + 1
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
    n = merge_sums.launches
    with pytest.raises(TypeError):
        merge_sums(feats[0].double(), *feats[1:])
    with pytest.raises(ValueError):
        merge_sums(feats[0], feats[1][:, :, :-1].contiguous(), feats[2])
    with pytest.raises(ValueError):
        merge_sums(feats[0], feats[1], feats[2].cpu())
    assert merge_sums.launches == n


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
    n = fused_leapfrog_update.launches
    qk, pk = fused_leapfrog_update(q, p, g, 3e-3, im)
    torch.cuda.synchronize()
    assert fused_leapfrog_update.launches == n + 1
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
    n = merge_sums.launches
    out = run_operator(cfg, cfg_d, arts, data=(split(12), split(5)), use_fused=True,
                       segment_size=3, device=cuda_device)
    torch.cuda.synchronize()
    assert merge_sums.launches - n == 1 + 2 * cfg.num_samples
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
        n = merge_sums.launches
        out = vi_hmc.run_operator(cfg, cfg_d, arts, data=data, use_fused=True,
                                  segment_size=3, device=cuda_device)
        torch.cuda.synchronize()
    finally:
        vi_hmc.make_gram_grad_full = real
    assert merge_sums.launches - n == 1 + 2 * cfg.num_samples
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
    n = merge_sums.launches
    out = hmc_nuts.run(cfg, data=data, num_chains=3, use_fused=True, inits=inits,
                       device=cuda_device)
    torch.cuda.synchronize()
    assert merge_sums.launches - n == 1 + 2 * cfg.num_samples
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
    n = merge_sums.launches
    out = run_operator(cfg, cfg_d, arts, data=data, use_fused=True, use_gram=True,
                       segment_size=5, device=cuda_device)
    torch.cuda.synchronize()
    per_draw = 7 if algorithm == "nuts" else 1
    assert merge_sums.launches - n == 1 + per_draw * cfg.num_samples
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
        n = merge_sums.launches
        out = fn()
        torch.cuda.synchronize()
        return out, merge_sums.launches - n

    full, n_full = launches(lambda: run_operator(cfg, cfg_d, arts, **kw))
    assert n_full == 1 + 2 * 12

    class Stop(Exception):
        pass

    def stop(seg, n_seg, state):
        raise Stop

    ck = str(tmp_path / "ck")
    n0 = merge_sums.launches
    with pytest.raises(Stop):
        run_operator(cfg, cfg_d, arts, checkpoint_dir=ck, progress=stop, **kw)
    torch.cuda.synchronize()
    assert merge_sums.launches - n0 == 1 + 2 * 4
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
