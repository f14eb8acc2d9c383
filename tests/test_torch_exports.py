"""The port's packages export what the JAX packages export.

For each subpackage, every public name of ``vihmc_tpu.<sub>.__all__`` must
import from ``vihmc_torch.<sub>``, or stand on ``NOT_PORTED``. A name on that
list that the port has gained fails the test too, so the list shrinks as the
port grows.
"""

from __future__ import annotations

import importlib
import inspect

import numpy as np
import pytest
import torch

#: names a JAX package exports that the port does not have yet (ROADMAP Queue 1)
NOT_PORTED = {
    "core": set(),
    "models": set(),
    "dists": set(),
    "hmc": set(),
    "chains": set(),
    "ops": set(),
    "pipelines": set(),
    "vi": set(),
    "sensitivity": set(),
    "data": set(),
    "io": set(),
}

#: ported in this slice or repaired: none may stand on NOT_PORTED
MUST_EXPORT = {
    "hmc": {"NUTSConfig", "nuts_sample", "ChEESConfig", "chees_sample", "EigenMetric",
            "eigen_metric_from_eigs", "sample", "SampleResult", "find_reasonable_step_size",
            "sample_model", "predict_model"},
    "chains": {"sample_chains", "sample_chains_nuts", "sample_chains_chees", "ChainSampler",
               "potential_scale_reduction_np", "effective_sample_size",
               "potential_scale_reduction", "summarize", "make_chain_mesh", "shard_batch",
               "shard_query", "initialize_distributed", "global_chain_mesh",
               "chains_per_host"},
    "dists": {"LIKELIHOODS", "normal_logpdf", "diag_normal_logpdf_sum"},
    "ops": {"grid_stride_subset", "infer_grid_shape"},
    "pipelines": {"configs", "make_flat_deeponet", "make_flat_mlp", "make_log_posterior",
                  "mlp_vi_apply", "deeponet_vi_apply", "posterior_predictive",
                  "predictive_metrics"},
    "core": {"per_segment_vector", "ravel_pytree", "segment_sizes", "segment_slices",
             "split_like", "fold_in_str", "matmul_precision", "LogProbError",
             "has_nan_or_inf", "gradient", "jacobian", "hessian"},
    "models": {"get_activation", "VariationalParams", "mean_params", "bbb_linear_apply",
               "lrt_linear_apply", "bbb_conv2d_apply", "lrt_conv2d_apply",
               "canonicalize_mlp", "canonicalize_deeponet"},
    "io": {"save_checkpoint", "load_checkpoint", "latest_step"},
    "vi": {"accuracy", "VITrainState", "init_train_state", "make_train_step",
           "make_eval_fn", "train"},
    "data": {"generate_burgers_dataset", "load_burgers_mat", "load_reference_regression_data",
             "CONE_STATS", "ConeStats", "cone_to_operator_splits", "generate_cone_dataset",
             "get_cone", "load_cone", "normalize_cone", "normalize_cone_inputs"},
}


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_port_exports_every_ported_jax_name(sub):
    """Each JAX export imports from the port, or stands on NOT_PORTED (and
    then the port must not have it)."""
    jax_mod = importlib.import_module(f"vihmc_tpu.{sub}")
    port = importlib.import_module(f"vihmc_torch.{sub}")
    names = set(jax_mod.__all__)
    missing = sorted(n for n in names - NOT_PORTED[sub] if not hasattr(port, n))
    assert not missing, f"vihmc_torch.{sub} lacks {missing}"
    stale = sorted(n for n in NOT_PORTED[sub] if hasattr(port, n))
    assert not stale, f"vihmc_torch.{sub} now has {stale}: drop them from NOT_PORTED"
    assert NOT_PORTED[sub] <= names
    assert not MUST_EXPORT.get(sub, set()) & NOT_PORTED[sub]
    for n in MUST_EXPORT.get(sub, ()):
        assert n in getattr(port, "__all__", dir(port)), f"{sub}.{n} not in __all__"


# ---------------------------------------------------------------------------
# keyword names: every exported function and public method
# ---------------------------------------------------------------------------

#: JAX keyword names no port function takes, and why
KEYWORD_EXCEPTIONS = {
    "key": "JAX PRNG keys: the port takes integer seeds or torch.Generator streams",
    "init_key": "a JAX PRNG key: the port takes the initial frozen draw itself",
    "interpret": "Pallas interpret mode: CPU tensors take the kernels' plain versions",
    "force_pallas": "Pallas dispatch: CUDA tensors always launch the port's kernel",
    "optimizer": "an optax optimizer: the port's VI trainer runs its own Adam",
    "params_template": "a JAX parameter tree: the port's parameters are one flat vector",
}
#: JAX methods of exported classes with no port counterpart, and why
METHOD_EXCEPTIONS = {
    "tree_flatten": "JAX pytree registration",
    "tree_unflatten": "JAX pytree registration",
    "replace": "flax.struct's copy with changes: the port uses dataclasses.replace",
}
#: per function, JAX keyword names the port's counterpart names otherwise, and why
FUNCTION_EXCEPTIONS = {
    ("core", "ravel_pytree"): {"pytree": "an alias of ravel_tree, whose argument is 'tree'"},
    ("models", "mlp_apply"): {"params": "takes the flat (C, D) vector 'flat'"},
    ("vi", "predictive_samples"): {
        "apply_fn": "takes one BayesianFlat model in place of apply_fn and vp",
        "vp": "takes one BayesianFlat model in place of apply_fn and vp"},
    ("sensitivity", "sensitivity_scores"): {"apply_flat": "takes 'apply_one' (one example)"},
    ("sensitivity", "mean_squared_jacobian"): {"apply_flat": "takes 'apply_one' (one example)"},
    ("hmc", "lanczos_eigs"): {"dtype": "the port's Lanczos runs in float32 only"},
    ("data", "get_burgers"): {
        "nx": "the exported initial conditions fix the grid",
        "nt": "the exported initial conditions fix the grid",
        "nu": "the exported solutions fix the viscosity"},
}


def _keywords(fn):
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    return [p.name for p in params if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _callables(jax_mod, port, name):
    """``[(qualified name, JAX callable, port callable or None), ...]`` of an
    exported function, or of an exported class's public methods."""
    jo, to = getattr(jax_mod, name), getattr(port, name, None)
    if inspect.isclass(jo):
        return [(f"{name}.{m}", getattr(jo, m), getattr(to, m, None))
                for m, f in vars(jo).items()
                if not m.startswith("_") and m not in METHOD_EXCEPTIONS and (callable(f) or isinstance(f, (staticmethod,
                                                                          classmethod)))]
    return [(name, jo, to)] if callable(jo) else []


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_port_keywords_cover_jax_keywords(sub):
    """Every exported function and public method of an exported class takes
    every keyword name of its JAX counterpart, apart from the exceptions
    named above (each of which must still be one)."""
    jax_mod = importlib.import_module(f"vihmc_tpu.{sub}")
    port = importlib.import_module(f"vihmc_torch.{sub}")
    gaps, used = [], set()
    for name in sorted(set(jax_mod.__all__) - NOT_PORTED[sub]):
        for qual, jfn, tfn in _callables(jax_mod, port, name):
            if tfn is None:
                gaps.append(f"{qual}: missing")
                continue
            jkw, tkw = _keywords(jfn), _keywords(tfn)
            if jkw is None or tkw is None:
                continue
            allowed = FUNCTION_EXCEPTIONS.get((sub, qual), {})
            for kw in jkw:
                if kw in tkw:
                    continue
                if kw in allowed:
                    used.add((qual, kw))
                elif kw not in KEYWORD_EXCEPTIONS:
                    gaps.append(f"{qual}: {kw}")
    assert not gaps, f"vihmc_torch.{sub} lacks JAX keywords: {gaps}"
    stale = {(q, kw) for (s, q), kws in FUNCTION_EXCEPTIONS.items() if s == sub
             for kw in kws} - used
    assert not stale, f"exceptions no longer needed: {sorted(stale)}"


# ---------------------------------------------------------------------------
# the repairs the walk found, each against JAX on the same inputs
# ---------------------------------------------------------------------------

def test_run_store_arrays_and_runs_read_across_packages(tmp_path):
    from vihmc_torch.io.artifacts import RunStore
    from vihmc_tpu.io.artifacts import RunStore as JRunStore

    a = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    b = np.array([1, 2, 3])
    JRunStore(str(tmp_path), "j1").save_arrays("pair", a=a, b=b)
    RunStore(str(tmp_path), "t1").save_arrays("pair", a=a, b=torch.as_tensor(b).numpy())
    for uid in ("j1", "t1"):
        got = RunStore.open(str(tmp_path), uid).load_arrays("pair")
        want = JRunStore.open(str(tmp_path), uid).load_arrays("pair")
        assert sorted(got) == sorted(want) == ["a", "b"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["a"], a)
    (tmp_path / "not_a_run.txt").write_text("x")
    assert RunStore.list_runs(str(tmp_path)) == JRunStore.list_runs(str(tmp_path)) == ["j1", "t1"]
    assert RunStore.list_runs(str(tmp_path / "absent")) == []


@pytest.mark.parametrize("full", [False, True])
def test_gaussian_nll_full_matches_jax(full):
    import jax.numpy as jnp

    from vihmc_torch.dists.likelihoods import gaussian_nll
    from vihmc_tpu.dists.likelihoods import gaussian_nll as jgaussian_nll

    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2))
    for var in (0.3, 1e-9):
        got = gaussian_nll(torch.as_tensor(pred), torch.as_tensor(target), var, full=full)
        want = jgaussian_nll(jnp.asarray(pred), jnp.asarray(target), var, full=full)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        loss = torch.nn.functional.gaussian_nll_loss(
            torch.as_tensor(pred), torch.as_tensor(target), torch.full((3, 5), max(var, 1e-6)),
            full=full, reduction="none")
        np.testing.assert_allclose(got.numpy(), loss.numpy(), rtol=1e-6, atol=1e-6)


class _Stop(Exception):
    pass


def test_mat_path_reaches_get_burgers(tmp_path, monkeypatch):
    """``mat_path`` on hmc_nuts.run and reevaluate and on hmc_split.run
    reaches get_burgers with the config's row counts, as in JAX."""
    import vihmc_torch.pipelines.hmc_nuts as tnuts
    import vihmc_torch.pipelines.hmc_split as tsplit
    import vihmc_tpu.pipelines.hmc_nuts as jnuts
    import vihmc_tpu.pipelines.hmc_split as jsplit
    from vihmc_torch.io.artifacts import RunStore
    from vihmc_tpu.pipelines.configs import OperatorHMCRunConfig, SplitHMCRunConfig

    seen = {"jax": [], "port": []}

    def jrec(key, n_train, n_valid, mat_path=None, **_):
        seen["jax"].append((n_train, n_valid, mat_path))
        raise _Stop

    def trec(device, n_train=None, n_valid=None, mat_path=None, **_):
        seen["port"].append((n_train, n_valid, mat_path))
        raise _Stop

    monkeypatch.setattr(jnuts, "get_burgers", jrec)
    monkeypatch.setattr(jsplit, "get_burgers", jrec)
    monkeypatch.setattr(tnuts, "get_burgers", trec)
    mat = str(tmp_path / "DeepOnet_data.mat")
    store = RunStore(str(tmp_path), "r")
    from vihmc_tpu.io.artifacts import RunStore as JRunStore
    jstore = JRunStore(str(tmp_path), "r")
    for cfg, jcall, tcall in (
            (OperatorHMCRunConfig(), lambda c: jnuts.run(c, mat_path=mat),
             lambda c: tnuts.run(c, mat_path=mat, device="cpu")),
            (OperatorHMCRunConfig(), lambda c: jnuts.reevaluate(c, jstore, mat_path=mat),
             lambda c: tnuts.reevaluate(c, store, mat_path=mat, device="cpu")),
            (SplitHMCRunConfig(), lambda c: jsplit.run(c, mat_path=mat),
             lambda c: tsplit.run(c, mat_path=mat, device="cpu"))):
        for call in (jcall, tcall):
            with pytest.raises(_Stop):
                call(cfg)
    assert seen["port"] == seen["jax"] and len(seen["jax"]) == 3
    assert all(m == mat for *_, m in seen["jax"])
