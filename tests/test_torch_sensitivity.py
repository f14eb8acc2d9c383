"""PyTorch port parity: stage 2 of the method (sensitivity and the subspace cut).

The mean squared Jacobian and the scores on the MLP and on the small
DeepONet (the same trunk subsample injected on both sides), chunked and
unchunked, the cut (verbatim numpy copies), the flat mean/std, the
``nn_stage12_r2`` bundle's scores and its 77 indices, the per-example trunk
subsample, and the stage's artifacts. Inputs are numpy arrays handed to both
sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from vihmc_tpu.models import DeepONetConfig as JDCfg
from vihmc_tpu.models import MLPConfig as JMCfg
from vihmc_tpu.pipelines import sensitivity as jsens
from vihmc_tpu.pipelines.common import make_flat_deeponet as j_make_flat_deeponet
from vihmc_tpu.pipelines.common import make_flat_mlp as j_make_flat_mlp
from vihmc_tpu.pipelines.configs import SensitivityRunConfig as JSensCfg
from vihmc_tpu.sensitivity import scores as jscores
from vihmc_torch.data.burgers import ASSETS, subsample_trunk
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.pipelines import sensitivity as tsens
from vihmc_torch.pipelines.common import make_flat_mlp
from vihmc_torch.pipelines.configs import SensitivityRunConfig
from vihmc_torch.sensitivity import scores as tscores

SMALL_DEEPONET_KW = dict(in_branch=17, in_trunk=5, width_branch=16, width_trunk=16,
                         depth_branch=3, depth_trunk=3)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _mlp_case(seed, n=13):
    rng = np.random.default_rng(seed)
    cfg = MLPConfig()
    mu = (0.7 * rng.normal(size=cfg.num_params)).astype(np.float32)
    sigma = (0.02 + 0.1 * rng.random(cfg.num_params)).astype(np.float32)
    x = np.linspace(-1.2, 1.2, n, dtype=np.float32)[:, None]
    return cfg, mu, sigma, x


@pytest.mark.parametrize("chunk", [0, 4])
def test_mlp_mean_squared_jacobian_and_scores_match_jax(chunk):
    """E[(dy/dw)^2] of the default MLP over 13 inputs (rtol 1e-5 of the
    largest entry), the scores and the 90 % indices (equal), chunked in 4s
    or all at once."""
    cfg, mu, sigma, x = _mlp_case(1)
    j_apply, _, _ = j_make_flat_mlp(JMCfg())
    want = jscores.mean_squared_jacobian(lambda f, xx: j_apply(f, xx[None, :])[0],
                                         jnp.asarray(mu), jnp.asarray(x), chunk)
    apply_flat = make_flat_mlp(cfg)
    got = tscores.mean_squared_jacobian(lambda f, xx: apply_flat(f[None], xx[None, :])[0, 0],
                                        torch.as_tensor(mu), torch.as_tensor(x), chunk)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * want.max())
    jout = jsens.run_nn_flat(jnp.asarray(mu), jnp.asarray(sigma), JMCfg(), jnp.asarray(x),
                             JSensCfg(batch_chunk=chunk))
    tout = tsens.run_nn_flat(mu, sigma, cfg, torch.as_tensor(x),
                             SensitivityRunConfig(batch_chunk=chunk))
    np.testing.assert_allclose(tout["scores"], np.asarray(jout["scores"]), rtol=1e-5,
                               atol=1e-5 * np.asarray(jout["scores"]).max())
    np.testing.assert_array_equal(tout["indices"], jout["indices"])
    assert tout["num_sensitive"] == jout["num_sensitive"]
    assert tout["captured_count"] == jout["captured_count"]


def _operator_case(seed, b=6, nt=5, nx=7, p=9):
    rng = np.random.default_rng(seed)
    cfg = DeepONetConfig(**SMALL_DEEPONET_KW)
    d = cfg.num_params
    mu = (0.3 * rng.normal(size=d)).astype(np.float32)
    sigma = (0.01 + 0.05 * rng.random(d)).astype(np.float32)
    t = np.linspace(0, 1, nt, dtype=np.float32)
    xs = np.linspace(0, 1, nx, dtype=np.float32)
    tt, xx = np.meshgrid(t, xs, indexing="ij")
    split = {"branch_in": rng.normal(size=(b, 17)).astype(np.float32),
             "trunk_in": np.stack([tt.ravel(), xx.ravel()], -1).astype(np.float32),
             "solution": rng.normal(size=(b, nt * nx)).astype(np.float32)}
    idx = np.stack([rng.choice(nt * nx, size=p, replace=False) for _ in range(b)])
    return cfg, mu, sigma, split, idx


@pytest.mark.parametrize("chunk", [0, 4])
def test_operator_scores_match_jax_with_injected_trunk_subsample(chunk):
    """The small DeepONet's scores over 6 examples x 9 subsampled points (the
    same indices on both sides; rtol 1e-4 of the largest score) and the 90 %
    index set (equal), chunked (a ragged last chunk of 2) or not."""
    cfg, mu, sigma, split, idx = _operator_case(2)
    jcfg = JDCfg(**SMALL_DEEPONET_KW)
    j_apply, _, _ = j_make_flat_deeponet(jcfg)
    inputs = {"branch": jnp.asarray(split["branch_in"]),
              "trunk": jnp.asarray(split["trunk_in"][idx])}
    want = np.asarray(jscores.sensitivity_scores(
        lambda f, x: j_apply(f, x["branch"][None, :], x["trunk"][None, :, :])[0],
        jnp.asarray(mu), jnp.asarray(sigma), inputs, chunk))
    tsplit = {k: torch.as_tensor(v) for k, v in split.items()}
    got = tsens.run_operator_flat(mu, sigma, cfg, tsplit,
                                  SensitivityRunConfig(batch_chunk=chunk, p_subsample=9),
                                  trunk_idx=torch.as_tensor(idx))
    np.testing.assert_allclose(got["scores"], want, rtol=1e-4, atol=1e-4 * want.max())
    np.testing.assert_array_equal(got["indices"], jscores.select_sensitive_indices(want))
    assert got["scores"].dtype == np.float32


def test_nn_bundle_gives_its_scores_and_77_indices():
    """``assets/nn_stage12_r2.npz``'s mu and sigma on x_val = linspace(-1.2,
    1.2, 300): the bundle's scores to rtol 1e-4 of the largest (they were
    computed on a TPU) and exactly its 77 indices."""
    with np.load(f"{ASSETS}/nn_stage12_r2.npz") as z:
        bundle = {k: z[k] for k in ("mu", "sigma", "indices", "scores")}
    x = torch.linspace(-1.2, 1.2, 300)[:, None]
    out = tsens.run_nn_flat(bundle["mu"], bundle["sigma"], MLPConfig(), x)
    np.testing.assert_allclose(out["scores"], bundle["scores"], rtol=1e-4,
                               atol=1e-4 * bundle["scores"].max())
    assert out["num_sensitive"] == len(bundle["indices"]) == 77
    np.testing.assert_array_equal(out["indices"], bundle["indices"])


def test_cut_functions_are_the_jax_copies():
    """captured_variance_count and select_sensitive_indices on float32
    scores with ties and a cut near the threshold: equal to the JAX
    functions' results."""
    rng = np.random.default_rng(3)
    for trial in range(20):
        s = rng.random(200).astype(np.float32) ** 4
        s[rng.choice(200, 30)] = s[0]                      # ties
        for thr in (0.5, 0.9, 0.999):
            assert tscores.captured_variance_count(s, thr) == \
                jscores.captured_variance_count(s, thr)
            np.testing.assert_array_equal(tscores.select_sensitive_indices(s, thr),
                                          jscores.select_sensitive_indices(s, thr))


def test_flatten_mean_std_matches_jax():
    """The flat (mu, softplus(rho)) of a variational tree (rtol 1e-6)."""
    from torch_convert import vp_from_jax

    rng = np.random.default_rng(4)
    tree = {"mu": [{"w": rng.normal(size=(3, 2)), "b": rng.normal(size=3)}],
            "rho": [{"w": rng.normal(size=(3, 2)) - 4, "b": rng.normal(size=3) * 30}]}
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    jmu, jsig = jscores.flatten_mean_std(jtree)
    tmu, tsig = tscores.flatten_mean_std(vp_from_jax(tree))
    np.testing.assert_array_equal(tmu.numpy(), np.asarray(jmu))
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), rtol=1e-6)


def test_subsample_trunk_picks_distinct_points_per_example():
    """Each row's p indices are distinct and in range; the trunk points and
    targets are gathered at them; the same generator seed repeats them; an
    injected index set is used as given."""
    rng = np.random.default_rng(5)
    split = {"trunk_in": torch.as_tensor(rng.random((50, 2)), dtype=torch.float32),
             "solution": torch.as_tensor(rng.normal(size=(7, 50)), dtype=torch.float32)}
    gen = torch.Generator().manual_seed(1)
    trunk, y = subsample_trunk(split, 12, generator=gen)
    assert trunk.shape == (7, 12, 2) and y.shape == (7, 12)
    for r in range(7):
        cols = [int(np.flatnonzero((split["trunk_in"].numpy() == t).all(-1))[0])
                for t in trunk[r].numpy()]
        assert len(set(cols)) == 12
        np.testing.assert_array_equal(y[r].numpy(), split["solution"][r, cols].numpy())
    again, _ = subsample_trunk(split, 12, generator=torch.Generator().manual_seed(1))
    assert torch.equal(trunk, again)
    idx = torch.as_tensor(np.stack([rng.choice(50, 12, replace=False) for _ in range(7)]))
    t2, y2 = subsample_trunk(split, 12, idx=idx)
    assert torch.equal(t2, split["trunk_in"][idx])
    assert torch.equal(y2, torch.gather(split["solution"], 1, idx))


def test_stage_artifacts_have_the_jax_names(tmp_path):
    """run_nn (from a variational dict) writes the JAX stage's artifacts --
    config_sens, means_flattened, stds_flattened, gradient_indices,
    sensitivity_scores -- with the same contents as JAX's run on the same
    inputs (indices equal, scores rtol 1e-5 of the largest)."""
    cfg, mu, sigma, x = _mlp_case(6, n=21)
    rho = np.log(np.expm1(sigma.astype(np.float64))).astype(np.float32)
    tstore = RunStore(str(tmp_path), uid="torch")
    tsens.run_nn({"mu": torch.as_tensor(mu), "rho": torch.as_tensor(rho)}, cfg,
                 torch.as_tensor(x), store=tstore)
    from vihmc_tpu.io import RunStore as JStore

    jstore = JStore(str(tmp_path), uid="jax")
    j_apply_tree = j_make_flat_mlp(JMCfg())[2]
    jsens.run_nn({"mu": j_apply_tree(jnp.asarray(mu)), "rho": j_apply_tree(jnp.asarray(rho))},
                 JMCfg(), jnp.asarray(x), store=jstore)
    import os

    assert sorted(os.listdir(tstore.path)) == sorted(os.listdir(jstore.path))
    np.testing.assert_array_equal(tstore.load_array("gradient_indices"),
                                  jstore.load_array("gradient_indices"))
    js = jstore.load_array("sensitivity_scores")
    np.testing.assert_allclose(tstore.load_array("sensitivity_scores"), js, rtol=1e-5,
                               atol=1e-5 * js.max())
    np.testing.assert_allclose(tstore.load_array("stds_flattened"),
                               jstore.load_array("stds_flattened"), rtol=1e-6)
    assert tstore.load_config("config_sens") == jstore.load_config("config_sens")
