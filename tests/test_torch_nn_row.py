"""PyTorch port parity: the NN bench row, its post-processing, and stage 3
of the NN pipeline under NUTS, ChEES and the 'auto' probe.

The row's log-density and clipped trajectory field against JAX's on the
exported training points and frozen draw; ``function_space_diagnostics`` and
``stack_runs`` against JAX's numpy output; the row's JSON keys against
JAX's; ``vi_hmc.run_nn`` with each algorithm on the CPU, and the 'auto'
probe's eigenvalue and choice against JAX's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)

import bench
from vihmc_tpu.dists.likelihoods import get_likelihood as j_like
from vihmc_tpu.dists.priors import DiagonalGaussianPrior as JPrior
from vihmc_tpu.hmc import FrozenPolicy as JPolicy
from vihmc_tpu.hmc import SubspaceSpec as JSpec
from vihmc_tpu.hmc import clipped_grad_fn as j_clip
from vihmc_tpu.hmc import make_subspace_log_prob as j_sub_lp
from vihmc_tpu.hmc.metric import lanczos_eigs as j_lanczos
from vihmc_tpu.hmc.metric import preconditioned_hvp as j_hvp
from vihmc_tpu.io.artifacts import RunStore as JRunStore
from vihmc_tpu.pipelines import configs as JC
from vihmc_tpu.pipelines import postprocess as jpost
from vihmc_tpu.pipelines import vi_hmc as jv
from vihmc_torch import bench_nn
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.pipelines import postprocess as tpost
from vihmc_torch.pipelines import vi_hmc as tv
from vihmc_torch.pipelines.configs import VIHMCRunConfig


@pytest.fixture(scope="module")
def jax_nn_problem():
    """JAX's NN row problem (bench.py:1030-1072) and its DRAW log-density."""
    mlp, apply_flat, x, y, mu, sigma, idx = bench.build_nn_problem(False)
    spec = JSpec(idx=tuple(int(i) for i in idx), mu=mu, sigma=sigma)
    like = j_like("NLL")
    lp_like, aux0, _ = j_sub_lp(lambda f: like(apply_flat(f, x), y, 5e-2 ** 2), spec,
                                JPolicy.DRAW, init_key=jax.random.key(0))
    prior = JPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())

    def log_prob(q, aux):
        return lp_like(q, aux) + prior.log_prob(q)

    return dict(x=x, y=y, idx=idx, spec=spec, aux0=aux0, log_prob=log_prob,
                apply_flat=apply_flat)


def test_nn_row_density_and_field_match_jax(jax_nn_problem):
    """The exported data and frozen draw are JAX's exactly; the row's
    log-density (rtol 1e-5) and its clipped autodiff field at 13 sqrt(d)
    and the raw autodiff gradient (rtol 1e-4, atol 1e-4 of the largest
    entry: near the mode the field is the small difference of likelihood and
    prior terms, summed in f32) agree at the VI mean, around it and at the
    warm-started mode."""
    jp = jax_nn_problem
    log_prob, aux0, refresh, spec, *_ = bench_nn.build_nn_problem("cpu")
    np.testing.assert_array_equal(aux0.numpy(), np.asarray(jp["aux0"]))
    with np.load(bench_nn.NN_PORT_INPUTS) as z:
        np.testing.assert_array_equal(z["x_train"], np.asarray(jp["x"]))
        np.testing.assert_array_equal(z["y_train"], np.asarray(jp["y"]))
    assert refresh is None and spec.subspace_dim == 73
    d = spec.subspace_dim
    rng = np.random.default_rng(4)
    sig = np.asarray(jp["spec"].sub_sigma())
    from vihmc_torch.hmc.kernel import clipped_grad_fn
    from vihmc_torch.pipelines.common import conditional_warm_start

    tfield = clipped_grad_fn(log_prob, 13.0 * d ** 0.5, inv_mass=spec.sub_sigma() ** 2,
                             is_grad=False)
    mode = conditional_warm_start(tfield, aux0, spec.sub_mu(), spec.sub_sigma() ** 2, 400, 1,
                                  torch.Generator().manual_seed(0), spread=0.0)[0].numpy()
    qs = np.stack([np.asarray(jp["spec"].sub_mu()) + a * sig * rng.normal(size=d)
                   for a in (0.0, 0.3, 3.0)] + [mode]).astype(np.float32)
    jlp = [float(jp["log_prob"](jnp.asarray(q), jp["aux0"])) for q in qs]
    tlp = log_prob(torch.as_tensor(qs), aux0)
    np.testing.assert_allclose(tlp.numpy(), jlp, rtol=1e-5)
    for clip in (13.0 * d ** 0.5, 1e12):  # the row's clip, and none binding
        jfield = j_clip(jp["log_prob"], clip, inv_mass=jp["spec"].sub_sigma() ** 2,
                        is_grad=False)
        tfield = clipped_grad_fn(log_prob, clip, inv_mass=spec.sub_sigma() ** 2,
                                 is_grad=False)
        jg = np.stack([np.asarray(jfield(jnp.asarray(q), jp["aux0"])) for q in qs])
        tg = tfield(torch.as_tensor(qs), aux0).numpy()
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())
        norms = np.sqrt((sig ** 2 * jg ** 2).sum(-1))
        if clip < 1e12:
            # the DRAW conditional is far sharper than the VI sigmas: it binds
            np.testing.assert_allclose(norms, clip, rtol=1e-4)
        else:
            assert (norms > 13.0 * d ** 0.5).all()


def test_function_space_diagnostics_and_stack_runs_match_jax(tmp_path):
    """function_space_diagnostics on a synthetic (4, 30, 3) trace through a
    fixed linear probe map: the probes (rtol 1e-6) and every diagnostic of
    the battery (rtol 1e-5) are JAX's; stack_runs of two run stores (one
    single-chain, one multi-chain, burn 5) equals JAX's exactly."""
    rng = np.random.default_rng(9)
    trace = np.cumsum(rng.normal(size=(4, 30, 3)), axis=1).astype(np.float32)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    # a probe map that does not saturate (tied probe values would make the
    # rank-normalized diagnostics hinge on the last bit)
    jd = jpost.function_space_diagnostics(
        trace, lambda q: jnp.tanh(0.05 * q @ jnp.asarray(w)), thin=2)
    td = tpost.function_space_diagnostics(
        trace, lambda q: torch.tanh(0.05 * q @ torch.as_tensor(w)), thin=2, chunk=7,
        device="cpu")
    assert set(td) == set(jd)
    np.testing.assert_allclose(td["probes"], jd["probes"], rtol=1e-6, atol=1e-7)
    for k in jd:
        np.testing.assert_allclose(np.asarray(td[k], np.float64), np.asarray(jd[k], np.float64),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    a = rng.normal(size=(12, 3)).astype(np.float32)
    b = rng.normal(size=(2, 9, 3)).astype(np.float32)
    jstores = [JRunStore(str(tmp_path / "j"), uid=u) for u in ("a", "b")]
    tstores = [RunStore(str(tmp_path / "t"), uid=u) for u in ("a", "b")]
    for js, ts, arr in zip(jstores, tstores, (a, b)):
        js.save_array("hmc_params", arr)
        ts.save_array("hmc_params", arr)
    np.testing.assert_array_equal(tpost.stack_runs(tstores, burn=5),
                                  jpost.stack_runs(jstores, burn=5))
    assert tpost.stack_runs(tstores, burn=5).shape == (7 + 2 * 4, 3)


def test_bench_nn_prints_every_key_of_jax_row(capsys, one_torch_thread):
    """The port's row at 8 chains x 40 draws (L 8, one key) prints one JSON
    line with every key of JAX's row, the ``mfu`` block with JAX's field
    names (no peak and no ``mfu`` on the CPU) and the CPU baseline's
    ``vs_baseline``, finite headline numbers, and the provenance of the
    committed asset."""
    jrow = bench.bench_nn(True, skip_baseline=True)
    jax_keys = set(jrow)
    bench_nn.main(["--device", "cpu", "--chains", "8", "--draws", "40", "--segment", "40",
                   "--thin", "8", "--L", "8", "--keys", "2", "--baseline-seconds", "5"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    row = json.loads(line)
    assert jax_keys <= set(row), sorted(jax_keys - set(row))
    assert row["chains"] == 8 and row["draws"] == 40 and row["subspace_dim"] == 73
    assert row["ess_kind"] == "function_space_probes" and row["step"] == "coupled-da"
    for k in ("ess_per_s", "ess_median", "draws_per_s", "acceptance", "adapted_step"):
        assert np.isfinite(row[k]) and row[k] > 0, k
    assert row["posterior_provenance"]["assets"] == "nn_stage12.npz"
    assert set(row["mfu"]) == set(jrow["mfu"])
    assert row["mfu"]["mfu"] is None and row["mfu"]["model_flops_total"] > 0
    assert row["vs_baseline"] > 0 and row["torch_cpu_samples_per_s"] > 0
    # the fixed-step mode, momentum persistence and one sample_chains call
    st = bench_nn.bench_nn(device="cpu", chains=4, draws=10, segment=10, thin=1, L=4,
                           step=0.05, persist=0.5, keys=(3,))
    assert st["step"] == 0.05 and st["draws"] == 10 and np.isfinite(st["acceptance"])


@pytest.fixture(scope="module")
def nn_stage3_inputs():
    with np.load(bench_nn.NN_STAGE12_ASSET) as z:
        arts = {k: z[k] for k in ("mu", "sigma", "indices")}
    with np.load(bench_nn.NN_PORT_INPUTS) as z:
        x, y = z["x_train"], z["y_train"]
    x_val = np.linspace(-1.2, 1.2, 30, dtype=np.float32)[:, None]
    y_val = (4 * np.sin(4 * x_val) + 5 * np.cos(12 * x_val)).astype(np.float32)
    return arts, {"x_train": x, "y_train": y, "x_val": x_val, "y_val": y_val}


@pytest.mark.parametrize("algorithm", ["nuts", "chees"])
def test_run_nn_with_nuts_and_chees_on_cpu(algorithm, nn_stage3_inputs, one_torch_thread):
    """Stage 3 of the NN pipeline under NUTS (depth 3) and ChEES (at most 8
    steps) on the CPU, REFRESH and DRAW: finite samples of the configured
    shape, acceptance in (0, 1], the evaluation's metrics finite, and the
    sampler's extras (tree leaves, step counts)."""
    arts, data = nn_stage3_inputs
    for policy in ("refresh", "draw"):
        cfg = VIHMCRunConfig(algorithm=algorithm, num_samples=8, num_chains=3, num_leapfrog=4,
                             frozen_policy=policy, nuts_max_depth=3, chees_max_steps=8,
                             vi_mass=True)
        out = tv.run_nn(cfg, MLPConfig(), arts, data=data, seed=1, device="cpu",
                        segment_size=4, sample_thin=2)
        res = out["result"]
        assert out["algorithm"] == algorithm
        assert res.samples.shape == (3, 4, 73) and np.isfinite(res.samples).all()
        assert 0.0 < res.acceptance_rate <= 1.0
        assert all(np.isfinite(np.asarray(v)).all() for v in out["metrics"].values())
        if algorithm == "nuts":
            assert res.aux_trace["tree_leaves"].shape == (3, 8)
            assert res.aux_trace["tree_leaves"].max() <= 7
        else:
            assert res.step_sizes.shape == (8,)
            assert 1 <= res.aux_trace["n_steps"].min() <= res.aux_trace["n_steps"].max() <= 8
        if policy == "refresh":
            assert tuple(res.final_state.aux.shape) == (3, 141)


@pytest.mark.parametrize("threshold", [100.0, 1e6])
def test_auto_probe_matches_jax(threshold, nn_stage3_inputs, one_torch_thread):
    """The 'auto' stiffness probe on the NN posterior (MEAN policy, VI
    metric) from JAX's Lanczos start vector: the largest preconditioned
    eigenvalue (rtol 1e-3) and the algorithm it picks are JAX's, at a
    threshold below it (NUTS) and above it (HMC); the run then samples with
    that algorithm."""
    arts, data = nn_stage3_inputs
    kw = dict(algorithm="auto", num_samples=3, num_chains=2, num_leapfrog=3,
              frozen_policy="mean", nuts_max_depth=2, vi_mass=True, step_size=0.02,
              auto_stiffness_threshold=threshold)
    jcfg = JC.VIHMCRunConfig(**kw)
    from vihmc_tpu.pipelines.common import make_flat_mlp as j_make_flat_mlp
    from vihmc_tpu.models import MLPConfig as JMLP

    apply_flat, _, _ = j_make_flat_mlp(JMLP())
    x, y = jnp.asarray(data["x_train"]), jnp.asarray(data["y_train"])
    key = jax.random.key(0)
    _, ks = jax.random.split(key)
    k_frozen = jax.random.split(ks, 4)[0]
    jlp, aux0, _, spec, _, inv_mass = jv.build_subspace_posterior(
        jcfg, lambda f: apply_flat(f, x), y, arts, k_frozen)
    d = spec.subspace_dim
    probe_key = jax.random.fold_in(k_frozen, 0xA0)
    mv = j_hvp(jlp, spec.sub_mu(), inv_mass * jnp.ones(d), aux=aux0)
    vals, _ = j_lanczos(mv, d, 1, num_iters=min(8, d), key=probe_key)
    j_lam = float(vals[0])
    j_choice = "nuts" if (j_lam > threshold and not jcfg.lowrank_rank) else "hmc"
    v0 = torch.as_tensor(np.asarray(jax.random.normal(probe_key, (d,))))
    out = tv.run_nn(VIHMCRunConfig(**kw), MLPConfig(), arts, data=data, seed=0,
                    device="cpu", probe_v0=v0)
    probe = out["auto_probe"]
    np.testing.assert_allclose(probe["lambda_max"], j_lam, rtol=1e-3)
    assert probe["algorithm"] == j_choice == out["algorithm"]
    assert j_choice == ("nuts" if threshold == 100.0 else "hmc")
    assert np.isfinite(out["result"].samples).all()


def test_stage3_rejects_what_jax_rejects():
    """The combinations JAX raises ValueError on, before any sampling."""
    arts = {"mu": np.zeros(141, np.float32), "sigma": np.ones(141, np.float32),
            "indices": np.arange(5)}
    data = {"x_train": np.zeros((4, 1), np.float32), "y_train": np.zeros((4, 1), np.float32),
            "x_val": np.zeros((3, 1), np.float32), "y_val": np.zeros((3, 1), np.float32)}
    base = VIHMCRunConfig(frozen_policy="mean", num_samples=2, num_chains=2, num_leapfrog=2)
    for kw, match in (({"algorithm": "nuts", "lowrank_rank": 2}, "lowrank_rank"),
                      ({"algorithm": "chees", "gauss_field_auto": True}, "gauss_field_auto"),
                      ({"algorithm": "chees", "adapt_mass": True}, "adapt_mass"),
                      ({"algorithm": "bogus"}, "algorithm")):
        with pytest.raises(ValueError, match=match):
            tv.run_nn(dataclasses.replace(base, **kw), MLPConfig(), arts, data=data,
                      device="cpu")


@pytest.mark.parametrize("floor", [0.0, 1.1])
def test_gauss_field_auto_keeps_or_falls_back(floor, nn_stage3_inputs, one_torch_thread):
    """gauss_field_auto (vi_hmc.py:408-431): a 3-draw probe on the VI-Gaussian
    field, kept when its mean acceptance reaches the floor (floor 0: always)
    and else replaced by the configured field (floor 1.1: never reached)."""
    arts, data = nn_stage3_inputs
    cfg = VIHMCRunConfig(num_samples=4, num_chains=2, num_leapfrog=3, frozen_policy="draw",
                         vi_mass=True, gauss_field_auto=True, gauss_field_probe_draws=3,
                         gauss_field_floor=floor, clip_grad=13.0 * 73 ** 0.5)
    out = tv.run_nn(cfg, MLPConfig(), arts, data=data, seed=2, device="cpu")
    acc = out["gauss_field_probe_acceptance"]
    assert 0.0 <= acc <= 1.0 and out["gauss_field_used"] == (acc >= floor)
    assert out["gauss_field_used"] == (floor == 0.0)
    # the kept field is the clipped Gaussian score, the fallback the clipped autodiff
    q = torch.as_tensor(np.asarray(arts["mu"])[arts["indices"]])[None]
    g = out["grad_fn"](q, out["frozen"])
    assert (g.abs().max() < 1e-4) == (floor == 0.0)  # the Gaussian score is 0 at its mean
    assert np.isfinite(out["result"].samples).all()


def _hand_nn_flops(chains, draws, L, refresh=False, n_points=20,
                   dims=((1, 10), (10, 10), (10, 1))):
    """The NN row's matmul FLOPs reckoned by hand: a forward is 2 N d_in d_out
    per layer; a gradient is the forward, the weight gradients (the same
    again) and the input gradients of every layer but the first (the data
    needs none); a transition pays L gradients and two forwards (lp0
    recomputed, lp1 at the proposal: the unpaired MH test), and under
    REFRESH one more gradient (the field at q0 under the new frozen
    vector)."""
    fwd = sum(2 * n_points * i * o for i, o in dims)
    grad = 2 * fwd + sum(2 * n_points * i * o for i, o in dims[1:])
    return chains * draws * ((L + refresh) * grad + 2 * fwd)


def test_nn_row_flops_reckoned_by_hand(jax_nn_problem, capsys):
    """The port's FLOP count of the NN row at the row's shapes (1024 chains,
    L 96, 2880 draws, the coupled recipe and the clipped autodiff field)
    equals the hand count exactly, and so do a row with trajectory-length
    jitter (the masked steps are computed, so all L count) and one under
    REFRESH. Its ratio to
    JAX's ``bench._sampling_flops`` (XLA's HLO cost analysis, which also
    counts the elementwise work) is printed and lies in (0.5, 1]."""
    from vihmc_torch.bench_mfu import sampling_flops
    from vihmc_torch.hmc.kernel import clipped_grad_fn
    from vihmc_tpu.hmc import HMCConfig as JConfig

    chains, L, draws = 1024, 96, 2880
    log_prob, aux0, refresh, spec, *_ = bench_nn.build_nn_problem("cpu")
    inv_mass = spec.sub_sigma() ** 2
    field = clipped_grad_fn(log_prob, 13.0 * spec.subspace_dim ** 0.5, inv_mass=inv_mass,
                            is_grad=False)
    inits = spec.sub_mu().expand(chains, -1).clone()
    got = sampling_flops(log_prob, bench_nn.nn_config(draws, L, 0.1, False), inits,
                         inv_mass, aux0, draws, grad_fn=field)
    assert got == _hand_nn_flops(chains, draws, L)
    got_l = sampling_flops(log_prob, bench_nn.nn_config(40, 8, 0.1, True), inits[:4],
                           inv_mass, aux0, 40, grad_fn=field)
    assert got_l == _hand_nn_flops(4, 40, 8)
    r_lp, r_aux, r_refresh, r_spec, *_ = bench_nn.build_nn_problem("cpu", "refresh")
    got_r = sampling_flops(r_lp, bench_nn.nn_config(40, 8, 0.1, False), inits[:4], inv_mass,
                           r_aux, 40, grad_fn=clipped_grad_fn(
                               r_lp, 13.0 * r_spec.subspace_dim ** 0.5, inv_mass=inv_mass,
                               is_grad=False), aux_refresh=r_refresh)
    assert r_refresh is not None and got_r == _hand_nn_flops(4, 40, 8, refresh=True)
    jp = jax_nn_problem
    jfield = j_clip(jp["log_prob"], 13.0 * len(jp["idx"]) ** 0.5,
                    inv_mass=jp["spec"].sub_sigma() ** 2, is_grad=False)
    jcfg = JConfig(num_samples=draws, num_leapfrog=L, step_size=0.1, burn=draws // 5,
                   sampler="hmc_nuts", target_accept=0.65, da_axis="chains",
                   adapt_forever=True, jitter_eps=True, jitter_low_frac=0.5)
    want = bench._sampling_flops(jp["log_prob"], jcfg, draws, None, jfield, None,
                                 jnp.tile(jp["spec"].sub_mu()[None], (chains, 1)), jp["aux0"],
                                 jp["spec"].sub_sigma() ** 2, draws)
    with capsys.disabled():
        print(f"\nNN row FLOPs at 1024 chains x 2880 draws, L 96: port {got:.6g}, JAX "
              f"{want:.6g}, ratio {got / want:.4f}")
    assert 0.5 < got / want <= 1.0


def test_mfu_stats_has_jax_fields():
    """mfu_stats returns JAX's ``_mfu_stats`` field names with the same
    arithmetic off the card (no peak, no mfu; ``achieved_tflops`` unrounded,
    within JAX's 4-place rounding), and the H100's dense bf16 peak (989
    TFLOP/s) for a device name with "H100"."""
    from vihmc_torch import bench_mfu

    got = bench_mfu.mfu_stats(3.3e11, 137.0, 1024, 240, "cpu")
    want = bench._mfu_stats(3.3e11, 137.0, 1024, 240)
    assert set(got) == set(want)
    for k in ("model_flops_total", "flops_per_draw_per_chain"):
        assert got[k] == want[k]
    assert abs(got["achieved_tflops"] - want["achieved_tflops"]) <= 5e-5
    assert got["mfu"] is None and got["peak_tflops_bf16"] is None
    assert dict(bench_mfu.PEAK_FLOPS)["h100"] == 989e12


def test_cpu_baseline_matches_jax_and_keeps_its_cap():
    """The port's CPU torch baseline runs JAX's loop: with the same inputs
    and torch's seed, the same chain draw for draw (120 draws at L 8) and
    the same keys; at a cut ``max_seconds`` it stops early."""
    with np.load(bench_nn.NN_STAGE12_ASSET) as z:
        mu, sigma, idx = z["mu"], z["sigma"], z["indices"]
    with np.load(bench_nn.NN_PORT_INPUTS) as z:
        x, y, frozen = z["x_train"], z["y_train"], z["frozen_draw"]
    kw = dict(collect=True, jitter_low_frac=0.5, frozen_policy="draw", init=mu[idx],
              frozen_vec=frozen)
    got = bench_nn.bench_torch_baseline_nn(x, y, mu, sigma, idx, 8, 0.05, 120,
                                           max_seconds=60.0, **kw)
    want = bench.bench_torch_baseline_nn(x, y, mu, sigma, idx, 8, 0.05, 120,
                                         max_seconds=60.0, **kw)
    assert set(got) == set(want) and got["draws"] == want["draws"] == 120
    np.testing.assert_array_equal(got["samples"], want["samples"])
    cut = bench_nn.bench_torch_baseline_nn(x, y, mu, sigma, idx, 8, 0.05, 10 ** 6,
                                           max_seconds=0.3, **kw)
    assert 0 < cut["draws"] < 10 ** 6 and cut["elapsed_s"] < 5.0
