"""PyTorch port parity: ``bench.py``'s operator row and command line.

``python -m vihmc_torch.bench`` against the root ``bench.py``: the flags
(read from bench.py's source), the recipe each invocation resolves (bench.py's
``main`` run with its row, baseline and NN row replaced by recorders), the
posterior (index sets, frozen vector, Laplace diagonal, the quick problem's
density and trajectory fields, captured from ``bench_jax`` where it hands
them to the sampler), the headline over keys, ``--extras``' gradients, the
CPU baseline's layout and a quick end-to-end run on the CPU.
"""

from __future__ import annotations

import ast
import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from torch_parity_helpers import assert_shared_fields_equal, one_torch_thread  # noqa: F401
from vihmc_torch import bench as tbench
from vihmc_torch import bench_operator as bop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    """Raised by a recorder to end ``bench_jax`` where it hands over."""


# ---------------------------------------------------------------------------
# flags and recipes
# ---------------------------------------------------------------------------

def _bench_flags() -> dict:
    """``{flag: default}`` of every ``ap.add_argument`` in bench.py's main."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw else (
                False if "action" in kw and ast.literal_eval(kw["action"]) == "store_true"
                else None)
            flags[ast.literal_eval(node.args[0])] = default
    return flags


BENCH_FLAGS = _bench_flags()


def test_bench_flags_read_from_source():
    assert len(BENCH_FLAGS) == 36 and "--gauss-field" in BENCH_FLAGS


@pytest.mark.parametrize("flag", sorted(BENCH_FLAGS))
def test_port_accepts_every_bench_flag_with_its_default(flag):
    actions = {s: a for a in tbench.build_parser()._actions for s in a.option_strings}
    assert flag in actions, flag
    assert actions[flag].default == BENCH_FLAGS[flag], flag


def _jax_recipe(monkeypatch, capsys, argv):
    """Run bench.py's main on ``argv`` with its row, grad path, baseline and
    NN row recorded; returns ``(calls, printed line)``."""
    calls = {"bench_jax": [], "bench_nn": [], "baseline": []}
    stub = {"ess_per_s": 1.5, "samples_per_s": 40.0, "acceptance": 0.3,
            "step_quartiles": [0.01, 0.02, 0.03, 0.04]}

    def rec(name, fn, out):
        def f(*a, **kw):
            b = inspect.signature(fn).bind(*a, **kw)
            b.apply_defaults()
            calls[name].append(dict(b.arguments))
            return out
        return f

    monkeypatch.setattr(bench, "bench_jax", rec("bench_jax", bench.bench_jax, (dict(stub), None)))
    monkeypatch.setattr(bench, "bench_nn", rec("bench_nn", bench.bench_nn,
                                               {"ess_per_s": 2.0, "vs_baseline": 3.0}))
    monkeypatch.setattr(bench, "bench_torch_baseline",
                        rec("baseline", bench.bench_torch_baseline,
                            {"samples_per_s": 0.5, "draws": 3}))
    monkeypatch.setattr(bench, "bench_grad_path", lambda quick: {})
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    bench.main()
    return calls, json.loads(capsys.readouterr().out.strip().splitlines()[-1]), stub


def _jax_nn_as_port(kw):
    """bench.py's bench_nn arguments as bench_nn.bench_nn's (bench.py:1136-1146)."""
    quick = kw["quick"]
    draws = kw["draws"] if kw["draws"] is not None else (20 if quick else 2880)
    return dict(frozen_policy=kw["frozen_policy"], step=kw["step"],
                L=kw["L"] if kw["L"] is not None else (8 if quick else 96),
                chains=kw["chains"] if kw["chains"] is not None else (4 if quick else 1024),
                rank=kw["lowrank_rank"], draws=draws,
                thin=kw["thin"] if kw["thin"] is not None else (1 if quick else 24),
                segment=kw["segment"] if kw["segment"] is not None else (
                    draws if quick else 480),
                persist=kw["persist"], keys=(2,) if quick else bench.BENCH_KEYS,
                skip_baseline=kw["skip_baseline"])


INVOCATIONS = [
    [], ["--subspace", "90pct"], ["--asset", "stress"],
    ["--coupled", "--stride", "5", "--fn-stride", "5"], ["--gauss-field"], ["--no-gram"],
    ["--adaptive"], ["--frozen-policy", "refresh"], ["--windowed-mass"],
    ["--workload", "nn"], ["--quick", "--skip-baseline"], ["--quick", "--extras"],
    ["--fused-delta", "--no-paired-delta", "--hutch-diag", "4", "--eigen-two-sided"],
    ["--subspace", "512", "--keys", "2", "--draws", "240", "--density-precision", "default"],
]


@pytest.mark.parametrize("argv", INVOCATIONS, ids=lambda a: " ".join(a) or "no-args")
def test_recipe_matches_bench_main(argv, monkeypatch, capsys):
    calls, line, stub = _jax_recipe(monkeypatch, capsys, argv)
    args = tbench.parse_args(argv + ["--device", "cpu"])
    recipe = tbench.resolve(args)
    if "--workload" in argv:
        assert _jax_nn_as_port(calls["bench_nn"][0]) == recipe["nn"]
        assert not calls["bench_jax"]
        return
    jrow = calls["bench_jax"][0]
    port = dict(recipe["operator"])
    assert port.pop("fused_delta") is True          # the port's fused default
    assert jrow.pop("fused_delta") is ("--fused-delta" in argv)
    assert jrow.pop("compute_dtype") is None and jrow.pop("use_fused") is False
    assert port == jrow
    # the NN row of the default invocation
    if recipe["nn_row"] is None:
        assert not calls["bench_nn"]
    else:
        assert _jax_nn_as_port(calls["bench_nn"][0]) == recipe["nn_row"]
    # --extras' bf16 row: bench_jax with its defaults and compute_dtype
    if "--extras" in argv:
        assert calls["bench_jax"][1]["compute_dtype"] is jnp.bfloat16
    # the baseline's arguments and the ratio's fields
    if "--skip-baseline" in argv:
        assert not calls["baseline"] and line["vs_baseline"] is None
        return
    jbase = {k: v for k, v in calls["baseline"][0].items()}
    want = tbench.baseline_kwargs(args, stub)
    assert {k: jbase[k] for k in want} == want
    fields = tbench.vs_baseline_fields(args, stub["samples_per_s"], 0.5)
    assert round(fields.pop("vs_baseline"), 2) == line["vs_baseline"]
    for k, v in fields.items():
        assert line["extras"][k] == v, k


ERRORS = [["--windowed-mass", "--no-gram"], ["--windowed-mass", "--adaptive"],
          ["--windowed-mass", "--gauss-field"], ["--no-gram", "--stride", "5"],
          ["--gauss-field", "--no-gram"], ["--gauss-field", "--fn-stride", "3"],
          ["--coupled", "--no-gram"], ["--coupled", "--adaptive"]]


@pytest.mark.parametrize("argv", ERRORS, ids=" ".join)
def test_argument_errors_match_bench_main(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    with pytest.raises(SystemExit) as jexit:
        bench.main()
    with pytest.raises(SystemExit) as texit:
        tbench.parse_args(argv)
    assert jexit.value.code == texit.value.code == 2
    jerr, terr = (e.strip().splitlines()[-1].split("error: ")[-1]
                  for e in capsys.readouterr().err.strip().split("usage:")[1:])
    assert jerr.split()[0] == terr.split()[0]


# ---------------------------------------------------------------------------
# the posterior
# ---------------------------------------------------------------------------

def _fake_burgers(monkeypatch):
    """Replace both packages' Burgers data by zeros of the real shapes (the
    tests below use the bundles, not the data)."""
    def jfake(key, n_train, n_valid, nx=101, nt=101, **_):
        split = {"branch_in": jnp.zeros((n_train, nx), jnp.float32),
                 "trunk_in": jnp.zeros((nx * nt, 2), jnp.float32),
                 "solution": jnp.zeros((n_train, nx * nt), jnp.float32)}
        return split, split

    def tfake(device):
        return {"branch_in": torch.zeros((1000, 101)), "trunk_in": torch.zeros((10201, 2)),
                "solution": torch.zeros((1000, 10201))}

    import vihmc_tpu.data
    monkeypatch.setattr(vihmc_tpu.data, "get_burgers", jfake)
    monkeypatch.setattr(bop, "get_burgers_train", tfake)


def _jax_handover(monkeypatch, quick, **kw):
    """``bench_jax``'s posterior where it hands over: at the warm start when
    ``init_opt`` is set, else at the sampler call. Returns the captured
    keyword arguments."""
    import vihmc_tpu.chains
    import vihmc_tpu.chains.resume

    got = {}

    def warm(log_prob, aux0, q0, inv_mass_diag, grad_fn, n_steps, n_chains, key):
        got.update(log_prob=log_prob, aux=aux0, inv_mass=inv_mass_diag, grad_fn=grad_fn)
        raise _Stop

    def sampler(log_prob, inits, key, cfg, **skw):
        got.update(log_prob=log_prob, config=cfg, **skw)
        raise _Stop

    monkeypatch.setattr(bench, "_conditional_warm_start", warm)
    monkeypatch.setattr(vihmc_tpu.chains, "sample_chains", sampler)
    monkeypatch.setattr(vihmc_tpu.chains.resume, "sample_chains_resumable",
                        lambda lp, inits, key, cfg, segment_size=None, **skw:
                        sampler(lp, inits, key, cfg, **skw))
    with pytest.raises(_Stop):
        bench.bench_jax(quick, **kw)
    return got


@pytest.mark.parametrize("asset,sub_dim", [("prod", None), ("prod", "90pct"),
                                           ("stress", 512), ("stress", "90pct")])
def test_bundle_problem_matches_jax(asset, sub_dim, monkeypatch):
    """Index set, chain and draw counts, frozen vector (to 1e-6 relative) and
    the conditional-Laplace diagonal (to 1e-6 relative) on the bundles."""
    _fake_burgers(monkeypatch)
    *_, mu, sigma, idx, n_chains, n_samples = bench.build_problem(False, sub_dim=sub_dim,
                                                                  asset=asset)
    prob = bop.build_problem(False, sub_dim=sub_dim, asset=asset, device="cpu")
    np.testing.assert_array_equal(prob.idx, idx)
    assert (prob.n_chains, prob.n_samples) == (n_chains, n_samples)
    assert prob.provenance["assets"] == bench.LAST_PROBLEM_PROVENANCE["assets"]
    assert prob.provenance["subspace"] == bench.LAST_PROBLEM_PROVENANCE["subspace"]
    spec = bench_spec(mu, sigma, idx)
    from vihmc_tpu.hmc.subspace import draw_full
    want = np.asarray(draw_full(jax.random.key(0), spec))
    np.testing.assert_allclose(prob.frozen.numpy(), want, rtol=1e-6, atol=0)
    got = _jax_handover(monkeypatch, False, sub_dim=sub_dim, asset=asset, laplace_mass=True,
                        init_opt=1)
    np.testing.assert_allclose(bop.problem_laplace_inv_mass(prob).numpy(),
                               np.asarray(got["inv_mass"]), rtol=1e-6)
    np.testing.assert_allclose(prob.frozen.numpy(), np.asarray(got["aux"]), rtol=1e-6)


def bench_spec(mu, sigma, idx):
    from vihmc_tpu.hmc import SubspaceSpec
    return SubspaceSpec(idx=tuple(int(i) for i in idx), mu=mu, sigma=sigma)


def test_quick_problem_matches_jax():
    cfg, _, (bx, tx, y), mu, sigma, idx, n_chains, n_samples = bench.build_problem(True)
    prob = bop.build_problem(True, device="cpu")
    for a, b in ((prob.branch_x, bx), (prob.trunk_x, tx), (prob.y, y),
                 (prob.spec.mu, mu), (prob.spec.sigma, sigma)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(prob.idx, idx)
    assert (prob.n_chains, prob.n_samples) == (n_chains, n_samples)
    assert prob.cfg.num_params == mu.shape[0]
    with pytest.raises(FileNotFoundError, match="90pct"):
        bop.build_problem(True, sub_dim="90pct", device="cpu")


FIELDS = {
    "gram-stride": dict(),
    "gram-full": dict(stride=1, fn_stride=1),
    "gram-bf16": dict(stride=1, fn_stride=1, grad_dtype="bfloat16"),
    "gauss": dict(gauss_alpha=1.0),
    "autograd": dict(use_gram=False),
    "mean-laplace-free": dict(frozen_policy="mean", stride=3, fn_stride=4),
}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_quick_density_field_and_delta_match_jax(name, monkeypatch, one_torch_thread):
    """The quick problem's subspace log density, trajectory field (each at
    the VI mean and at a point one VI sigma away) and paired MH delta against
    the ones bench_jax hands its sampler, to 1e-5 relative (the bf16 field to
    2e-2 of its norm: bf16 rounding differs between XLA and torch), and the
    sampler configuration."""
    kw = FIELDS[name]
    got = _jax_handover(monkeypatch, True, coupled=True, **kw)
    stats_kw = dict(kw)
    policy = stats_kw.pop("frozen_policy", "draw")
    prob = bop.build_problem(True, device="cpu")
    spec = prob.spec
    lp_like, aux0 = bop.make_subspace_log_prob(bop.density_log_likelihood(prob), spec,
                                               prob.frozen, bop.FrozenPolicy(policy))
    prior = bop.DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())
    inv_mass = spec.sub_sigma() ** 2
    field = bop.trajectory_field(prob, prior, inv_mass, quick=True, **{
        k: v for k, v in stats_kw.items() if k in ("use_gram", "stride", "fn_stride",
                                                 "gauss_alpha", "grad_dtype")})
    np.testing.assert_allclose(aux0.numpy(), np.asarray(got["aux"]), rtol=1e-6)
    rng = np.random.default_rng(1)
    q0 = spec.sub_mu().numpy()
    q1 = q0 + spec.sub_sigma().numpy() * rng.normal(size=q0.shape).astype(np.float32)
    for q in (q0, q1):
        lp = (lp_like(torch.as_tensor(q)[None], aux0) + prior.log_prob(torch.as_tensor(q)[None]))
        want = float(got["log_prob"](jnp.asarray(q), got["aux"]))
        assert abs(float(lp[0]) - want) <= 1e-5 * abs(want), (float(lp[0]), want)
        jg = (got["grad_fn"](jnp.asarray(q), got["aux"]) if got["grad_fn"] is not None
              else jax.grad(got["log_prob"])(jnp.asarray(q), got["aux"]))
        jg = np.asarray(jg)
        if field is None:
            tq = torch.as_tensor(q)[None].requires_grad_(True)
            (tg,) = torch.autograd.grad((lp_like(tq, aux0) + prior.log_prob(tq)).sum(), tq)
        else:
            tg = field(torch.as_tensor(q)[None], aux0)
        tol = 2e-2 if kw.get("grad_dtype") == "bfloat16" else 1e-5
        assert np.linalg.norm(tg[0].numpy() - jg) <= tol * np.linalg.norm(jg), name
    # the paired delta: the port's fused form (its plain version here) and
    # JAX's composed form agree on (dlp, lp1)
    delta = bop.mh_delta(prob, prior)
    dlp, lp1 = delta(torch.as_tensor(q1)[None], torch.as_tensor(q0)[None], aux0)
    jd, jlp1 = got["delta_fn"](jnp.asarray(q1), jnp.asarray(q0), got["aux"])
    assert abs(float(dlp[0]) - float(jd)) <= 1e-3 + 1e-5 * abs(float(jd))
    assert abs(float(lp1[0]) - float(jlp1)) <= 1e-5 * abs(float(jlp1))
    cfg = bop.sampler_config(20, 4, bench.BENCH_L, coupled=True)
    assert_shared_fields_equal(cfg, got["config"])


def test_default_density_precision_rounds_matmul_operands():
    """'default': bf16-rounded operands, f32 accumulation -- within bf16
    rounding of the f32 forward, not equal to it, and equal to a float64
    forward of the rounded operands to f32 accuracy."""
    prob = bop.build_problem(True, device="cpu")
    flat = prob.frozen[None]
    f32 = bop.make_flat_deeponet(prob.cfg)(flat, prob.branch_x, prob.trunk_x)
    dflt = bop.default_precision_apply(prob.cfg)(flat, prob.branch_x, prob.trunk_x)
    err = (dflt - f32).abs().max() / f32.abs().max()
    assert 1e-5 < err < 2e-2
    lp_f32 = bop.density_log_likelihood(prob, "float32")(flat)
    lp_def = bop.density_log_likelihood(prob, "default")(flat)
    assert lp_f32 != lp_def and torch.isfinite(lp_def).all()
    with pytest.raises(ValueError):
        bop.density_log_likelihood(prob, "tf32")


# ---------------------------------------------------------------------------
# the headline, --extras' gradient and the baseline
# ---------------------------------------------------------------------------

def test_headline_aggregates_keys_as_bench_py():
    """bench.py:830-858 on fixed per-key statistics: the representative key
    is the one of median ESS, value = median ESS / median wall."""
    per_key = [
        {"key": 2, "ess_median": 30.0, "elapsed_s": 10.0, "ess_min": 3.0, "rhat_max": 1.2,
         "ess_per_s": 3.0},
        {"key": 3, "ess_median": 10.0, "elapsed_s": 12.0, "ess_min": 1.0, "rhat_max": 1.5,
         "ess_per_s": 10.0 / 12.0},
        {"key": 4, "ess_median": 20.0, "elapsed_s": 8.0, "ess_min": 2.0, "rhat_max": None,
         "ess_per_s": 2.5},
    ]
    st = bop.aggregate_keys(per_key)
    assert st["key"] == 4
    assert st["ess_per_s"] == 20.0 / 10.0
    assert st["ess_median_by_key"] == [10.0, 20.0, 30.0]
    assert st["wall_s_by_key"] == [8.0, 10.0, 12.0] and st["wall_s_median"] == 10.0
    assert st["wall_spread_frac"] == 0.4
    assert st["ess_min_per_s"] == 0.2 and st["rhat_max"] == 1.5
    assert st["ess_per_s_by_key"] == [0.833, 2.5, 3.0]
    one = bop.aggregate_keys([next(dict(k) for k in per_key if k["key"] == 2)])
    assert one["wall_spread_frac"] == 0.0 and one["ess_per_s"] == 3.0


def test_extras_fused_gradient_equals_composed(one_torch_thread):
    """--extras' gradient of the full log posterior: through fused_merge_nll
    (merge_sums' plain version on the CPU) equal to the composed one, to
    1e-5 relative; both rates measured."""
    prob = bop.build_problem(True, device="cpu")
    composed, fused, flat0 = bop.grad_path_log_posteriors(prob)
    assert flat0.shape == (1, prob.cfg.num_params)
    gc = bop.log_posterior_grad(composed, flat0)
    gf = bop.log_posterior_grad(fused, flat0)
    assert torch.linalg.vector_norm(gf - gc) <= 1e-5 * torch.linalg.vector_norm(gc)
    np.testing.assert_allclose(float(fused(flat0)), float(composed(flat0)), rtol=1e-5)
    rates = bop.bench_grad_path(True, iters=2, device="cpu", problem=prob)
    assert sorted(rates) == ["grad_evals_per_s_composed", "grad_evals_per_s_fused"]
    assert all(r > 0 for r in rates.values())


def test_cpu_baseline_uses_the_port_layout_not_bench_py(monkeypatch, one_torch_thread):
    """The deliberate difference: bench.py's torch baseline reads each weight
    before its bias (bench.py:1545-1556) while ravel_pytree stores the bias
    first, so its density is another posterior's. The port's baseline density
    equals JAX's own density of the problem; JAX's torch one does not."""
    got = {}

    def timing(log_prob, draw_frozen, q0, inv_mass, step, L, n_samples, max_seconds, **kw):
        got.update(log_prob=log_prob, q0=q0)
        return {"samples_per_s": 1.0, "draws": 0}

    monkeypatch.setattr(bench, "_torch_hmc_timing", timing)
    bench.bench_torch_baseline(True)
    cfg, apply_flat, (bx, tx, y), mu, sigma, idx, *_ = bench.build_problem(True)
    prob = bop.build_problem(True, device="cpu")
    frozen = prob.frozen
    q = frozen[prob.spec.idx] + 0.5 * prob.spec.sub_sigma()
    full = frozen.clone()
    full[prob.spec.idx] = q
    from vihmc_tpu.dists.likelihoods import get_likelihood
    from vihmc_tpu.dists.priors import DiagonalGaussianPrior
    jprior = DiagonalGaussianPrior(loc=mu[np.asarray(idx)], scale=sigma[np.asarray(idx)])
    want = float(get_likelihood("NLL")(apply_flat(jnp.asarray(full.numpy()), bx, tx), y, 1.0)
                 + jprior.log_prob(jnp.asarray(q.numpy())))
    port = float(bop.baseline_log_prob(prob)(q, frozen))
    jax_torch = float(got["log_prob"](q, frozen))
    assert abs(port - want) <= 1e-5 * abs(want)
    # the scrambled weights move the density by over 100x the port's tolerance
    assert abs(jax_torch - want) > 100 * 1e-5 * abs(want)
    assert float(bop.baseline_log_prob(prob)(q * float("nan"), frozen)) == float("-inf")
    out = bop.bench_torch_baseline(True, max_seconds=1.0, L=4)
    assert out["draws"] >= 1 and out["samples_per_s"] > 0


def test_quick_end_to_end_line(capsys, one_torch_thread):
    """python -m vihmc_torch.bench --quick --device cpu --skip-baseline: one
    JSON line with bench.py's top-level keys, JAX's extras keys (bench.py:
    796-876) and the port's, finite samples."""
    tbench.main(["--quick", "--device", "cpu", "--skip-baseline"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert sorted(line) == ["extras", "metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == "ess_per_sec_vihmc_deeponet" and line["vs_baseline"] is None
    ex = line["extras"]
    jax_keys = {"key", "elapsed_s", "step_quartiles", "samples_per_s", "ess_median",
                "ess_bulk_median", "ess_min", "ess_median_half1", "ess_median_half2",
                "rhat_max", "tau_floor_frac", "ess_per_s", "acceptance", "grad_evals_per_s",
                "ess_median_by_key", "wall_s_by_key", "wall_s_median", "wall_spread_frac",
                "ess_min_per_s", "subspace_dim", "chains", "draws", "burn",
                "ess_per_s_by_key", "frozen_policy", "density_precision", "grad_dtype",
                "paired_delta", "fused_delta", "init_opt", "warm_start_s",
                "posterior_provenance", "mfu"}
    assert jax_keys <= set(ex), sorted(jax_keys - set(ex))
    assert {"draws_per_s", "phases_s", "device"} <= set(ex)
    assert ex["samples_finite"] and ex["chains"] == 4 and ex["draws"] == 20
    assert ex["ess_median_by_key"] and np.isfinite(line["value"]) and line["value"] > 0
    assert ex["fused_delta"] and ex["paired_delta"]


def test_torch_ess_line(one_torch_thread):
    out = tbench.run(["--quick", "--torch-ess", "2", "--device", "cpu"])
    assert out["metric"] == "torch_cpu_ess_per_sec_fullgrid" and out["draws"] >= 1
    assert "ess_per_s" in out or "error" in out


def test_row_options_run_on_cpu(one_torch_thread, monkeypatch, tmp_path):
    """The options the quick end-to-end run leaves out, at a tiny depth: thin
    over segments, REFRESH, the composed and unpaired deltas, the windowed
    metric, Hutchinson + two-sided eigen metric, the adaptive and fixed
    recipes; every run finite. The Lanczos cache goes to a temporary
    directory and is read back by a second run."""
    monkeypatch.setattr(bop, "CACHE_DIR", str(tmp_path))
    runs = [
        dict(coupled=True, draws=24, burn=6, thin=3, segment=12, frozen_policy="refresh",
             fused_delta=False, lowrank_rank=4, eigen_two_sided=True, hutch_diag=2),
        dict(coupled=True, windowed_mass=True, draws=16, burn=8, paired_delta=False,
             density_precision="default", num_leapfrog=4, gauss_alpha=1.0),
        dict(adaptive=True, draws=12, num_leapfrog=4, use_gram=False, init_opt=5),
        dict(draws=12, num_leapfrog=4, persist=0.5, keys=(2, 3)),
    ]
    for kw in runs:
        st, _ = bop.bench_operator(True, device="cpu", **kw)
        assert st["samples_finite"] and 0.0 <= st["acceptance"] <= 1.0, kw
    assert st["ess_median_by_key"] and len(st["ess_per_s_by_key"]) == 2
    again, _ = bop.bench_operator(True, device="cpu", **runs[0])
    assert again["lowrank_metric"]["cached"] and len(list(tmp_path.iterdir())) == 1
    with pytest.raises(ValueError, match="thin"):
        bop.bench_operator(True, device="cpu", draws=12, thin=3)
    with pytest.raises(ValueError, match="asset posterior"):
        bop.bench_operator(True, device="cpu", draws=12, laplace_mass=True)
