"""The port's packages export what the JAX packages export.

For each subpackage, every public name of ``vihmc_tpu.<sub>.__all__`` must
import from ``vihmc_torch.<sub>``, or stand on ``NOT_PORTED``. A name on that
list that the port has gained fails the test too, so the list shrinks as the
port grows.
"""

from __future__ import annotations

import importlib

import pytest

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
