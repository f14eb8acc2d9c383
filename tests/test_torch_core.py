"""PyTorch port parity: flat layout, DeepONet forward, densities, diagnostics,
and the port's import and device rules.

Every parity test feeds numpy inputs made from a seed to the JAX function and
to its ``vihmc_torch`` counterpart on the CPU; tolerances are stated per test.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from torch_parity_helpers import tiny_problem

from vihmc_tpu.chains import diagnostics as jdiag
from vihmc_tpu.core.ravel import gather_subspace as j_gather
from vihmc_tpu.core.ravel import scatter_subspace as j_scatter
from vihmc_tpu.dists.likelihoods import get_likelihood
from vihmc_tpu.models.deeponet import deeponet_features as j_features
from vihmc_tpu.models.deeponet import init_deeponet
from vihmc_tpu.pipelines.common import make_flat_deeponet as j_make_flat
from vihmc_torch.chains import diagnostics as tdiag
from vihmc_torch.core.convert import params_from_flat
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import gather_subspace, scatter_subspace
from vihmc_torch.dists.likelihoods import nll_log_likelihood
from vihmc_torch.models.deeponet import (DeepONetConfig, deeponet_features,
                                         unravel_deeponet)
from vihmc_torch.pipelines.common import make_flat_deeponet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cfg_kw", [
    dict(in_branch=7, in_trunk=5, width_branch=12, width_trunk=10,
         depth_branch=3, depth_trunk=4),
    dict(),  # the reference-scale DeepONet: 172,401 params
])
def test_flat_layout_matches_ravel_pytree(cfg_kw):
    """Exact: every layer's (w, b) view of the flat vector equals the JAX
    pytree leaf that ravel_pytree put there (sorted keys: b before w)."""
    from vihmc_tpu.models import DeepONetConfig as JCfg

    jcfg, tcfg = JCfg(**cfg_kw), DeepONetConfig(**cfg_kw)
    params = init_deeponet(jax.random.key(3), jcfg)
    flat, _ = ravel_pytree(params)
    assert tcfg.num_params == flat.shape[0] == jcfg.num_params
    tp = params_from_flat(np.asarray(flat), tcfg)
    assert float(tp["b"][0]) == float(params["b"])
    for stack in ("branch", "trunk"):
        assert len(tp[stack]) == len(params[stack])
        for (w, b), layer in zip(tp[stack], params[stack]):
            np.testing.assert_array_equal(w[0].numpy(), np.asarray(layer["w"]))
            np.testing.assert_array_equal(b[0].numpy(), np.asarray(layer["b"]))


def test_scatter_gather_match_jax():
    """Exact: scatter of 3 chains into the frozen vector, and the gather."""
    rng = np.random.default_rng(1)
    frozen = rng.normal(size=50).astype(np.float32)
    idx = np.sort(rng.choice(50, size=9, replace=False))
    sub = rng.normal(size=(3, 9)).astype(np.float32)
    got = scatter_subspace(torch.as_tensor(frozen), torch.as_tensor(sub),
                           torch.as_tensor(idx))
    for c in range(3):
        want = j_scatter(jnp.asarray(frozen), jnp.asarray(sub[c]), jnp.asarray(idx))
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            gather_subspace(got, torch.as_tensor(idx))[c].numpy(),
            np.asarray(j_gather(want, jnp.asarray(idx))))


def test_deeponet_forward_and_features_match_jax():
    """f32, rtol 1e-5: features and the (C, B, P) forward of 3 chains against
    make_flat_deeponet / deeponet_features on the same flat vectors."""
    tp = tiny_problem(seed=2)
    rng = np.random.default_rng(2)
    flats = (tp.mu[None, :] + tp.sigma[None, :]
             * rng.normal(size=(3, tp.mu.shape[0]))).astype(np.float32)
    j_apply, _, unravel = j_make_flat(tp.jcfg)
    apply_flat = make_flat_deeponet(tp.tcfg)
    with true_f32():
        pred = apply_flat(torch.as_tensor(flats), tp.t("bx"), tp.t("tx"))
        bout, tout = deeponet_features(tp.tcfg, unravel_deeponet(
            tp.tcfg, torch.as_tensor(flats)), tp.t("bx"), tp.t("tx"))
    for c in range(3):
        want = j_apply(jnp.asarray(flats[c]), jnp.asarray(tp.bx), jnp.asarray(tp.tx))
        np.testing.assert_allclose(pred[c].numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        jb, jt = j_features(tp.jcfg, unravel(jnp.asarray(flats[c])),
                            jnp.asarray(tp.bx), jnp.asarray(tp.tx))
        np.testing.assert_allclose(bout[c].numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tout[c].numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)


def test_nll_and_prior_match_jax():
    """f32, rtol 1e-6: -sum GaussianNLL (variance clamp, no 2 pi) and the
    diagonal Gaussian prior, per chain."""
    tp = tiny_problem(seed=3)
    rng = np.random.default_rng(3)
    pred = rng.normal(size=(2, 9, 20)).astype(np.float32)
    like = get_likelihood("NLL")
    got = nll_log_likelihood(torch.as_tensor(pred), tp.t("y"), 0.7)
    q = (tp.mu[tp.idx] + rng.normal(size=(2, len(tp.idx))) * 0.1).astype(np.float32)
    lp = tp.tprior.log_prob(torch.as_tensor(q))
    g = tp.tprior.grad(torch.as_tensor(q))
    for c in range(2):
        np.testing.assert_allclose(float(got[c]),
                                   float(like(jnp.asarray(pred[c]), jnp.asarray(tp.y), 0.7)),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(lp[c]), float(tp.jprior.log_prob(jnp.asarray(q[c]))),
                                   rtol=1e-6)
        np.testing.assert_allclose(g[c].numpy(),
                                   np.asarray(jax.grad(tp.jprior.log_prob)(jnp.asarray(q[c]))),
                                   rtol=1e-5)
    # the variance clamp of torch.nn.GaussianNLLLoss
    tiny = nll_log_likelihood(torch.as_tensor(pred), tp.t("y"), 1e-9)
    np.testing.assert_allclose(float(tiny[0]),
                               float(like(jnp.asarray(pred[0]), jnp.asarray(tp.y), 1e-9)),
                               rtol=1e-6)


def test_diagnostics_copies_are_bit_equal():
    """Exact: the numpy diagnostics copies return identical arrays."""
    rng = np.random.default_rng(4)
    x = np.cumsum(rng.normal(size=(4, 60, 7)), axis=1)
    x[:, :, 3] = 1.0  # a constant dimension
    a, at, af = jdiag.effective_sample_size_np(x, return_tau=True)
    b, bt, bf = tdiag.effective_sample_size_np(x, return_tau=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(at, bt)
    assert af == bf
    np.testing.assert_array_equal(jdiag.ess_bulk_np(x), tdiag.ess_bulk_np(x))
    np.testing.assert_array_equal(jdiag.rhat_rank_np(x), tdiag.rhat_rank_np(x))
    np.testing.assert_array_equal(jdiag.potential_scale_reduction_np(x),
                                  tdiag.potential_scale_reduction_np(x))


def test_true_f32_context_sets_and_restores():
    """Density matmuls run with TF32 off; the previous setting comes back."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with true_f32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def test_port_imports_no_jax():
    """Every vihmc_torch module and chip_smoke.py import with jax, flax,
    optax, orbax and vihmc_tpu blocked."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "vihmc_tpu"):
    sys.modules[name] = None
import vihmc_torch
mods = [m.name for m in pkgutil.walk_packages(vihmc_torch.__path__, "vihmc_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "optax", "orbax", "vihmc_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok", len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 20


def test_entry_points_default_to_cuda_and_raise_without_it():
    from vihmc_torch.bench_operator import bench_operator
    from vihmc_torch.data.burgers import get_burgers, get_burgers_train
    from vihmc_torch.models.deeponet import DeepONetConfig
    from vihmc_torch.pipelines.configs import VIHMCRunConfig
    from vihmc_torch.pipelines.vi_hmc import main, run_operator, run_stage3

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_operator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_burgers_train()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_burgers()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_operator(VIHMCRunConfig(frozen_policy="draw"), DeepONetConfig(), {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_stage3()
    for argv in ([], ["--no-gram", "--draws", "3"]):  # the stage-3 entry's CLI
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _deeponet_tree(seed):
    from vihmc_tpu.models import DeepONetConfig as JDCfg

    cfg = JDCfg(in_branch=5, in_trunk=5, width_branch=4, width_trunk=4, depth_branch=3,
                depth_trunk=3)
    rng = np.random.default_rng(seed)

    def layers(dims):
        return [{"w": rng.normal(size=(o, i)).astype(np.float32),
                 "b": rng.normal(size=o).astype(np.float32)} for i, o in dims]

    return {"b": np.float32(rng.normal()), "branch": layers(cfg.branch_dims),
            "trunk": layers(cfg.trunk_dims)}


def test_ravel_pytree_and_segments_match_jax():
    """ravel_pytree, segment_sizes and segment_slices on a DeepONet params
    tree and on the MLP's (dicts of b and w, in JAX's leaf order: sorted
    keys, b before w) equal JAX's; unravel rebuilds the tree exactly."""
    from vihmc_tpu.core import ravel as jr
    from vihmc_tpu.models import MLPConfig as JMCfg
    from vihmc_torch.core import ravel_pytree as t_ravel
    from vihmc_torch.core import segment_sizes, segment_slices

    rng = np.random.default_rng(40)
    mlp = [{"w": rng.normal(size=(o, i)).astype(np.float32),
            "b": rng.normal(size=o).astype(np.float32)} for i, o in JMCfg().layer_dims]
    for tree in (_deeponet_tree(41), mlp):
        jflat, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
        tflat, unravel = t_ravel(jax.tree_util.tree_map(torch.as_tensor, tree))
        np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
        assert segment_sizes(tree) == jr.segment_sizes(tree)
        assert segment_slices(tree) == jr.segment_slices(tree)
        back = unravel(tflat)
        for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, back)),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)


def test_gradient_jacobian_hessian_match_jax():
    """gradient, jacobian and hessian of one function of a params tree (a
    scalar loss of a tanh layer, and its vector output) against JAX's
    (rtol 1e-5, atol 1e-6 of the largest entry); has_nan_or_inf on trees."""
    from vihmc_tpu.core import calculus as jc
    from vihmc_torch.core import (LogProbError, gradient, has_nan_or_inf, hessian,
                                  jacobian)

    rng = np.random.default_rng(42)
    tree = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=3).astype(np.float32)}
    x = rng.normal(size=(5, 4)).astype(np.float32)

    def out(p, lib):
        return lib.tanh(lib.asarray(x) @ p["w"].T + p["b"]) if lib is jnp else \
            torch.tanh(torch.as_tensor(x) @ p["w"].T + p["b"])

    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = jax.tree_util.tree_map(torch.as_tensor, tree)
    pairs = [(jc.gradient(lambda p: jnp.sum(out(p, jnp) ** 3), jtree),
              gradient(lambda p: torch.sum(out(p, torch) ** 3), ttree)),
             (jc.jacobian(lambda p: out(p, jnp), jtree),
              jacobian(lambda p: out(p, torch), ttree)),
             (jc.hessian(lambda p: jnp.sum(out(p, jnp) ** 3), jtree),
              hessian(lambda p: torch.sum(out(p, torch) ** 3), ttree))]
    for want, got in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert not has_nan_or_inf(ttree) and not jc.has_nan_or_inf(jtree)
    bad = {"a": [torch.ones(2), torch.tensor([1.0, float("inf")])]}
    assert has_nan_or_inf(bad) and has_nan_or_inf(float("nan"))
    assert issubclass(LogProbError, RuntimeError)


def test_seed_derivations_are_stable_across_processes():
    """fold_in_str gives the same seed in another interpreter (with another
    hash salt); different names and seeds give different seeds, above the
    numbered streams; split_like gives one distinct seed per leaf of a tree
    of its structure."""
    from vihmc_torch.core import fold_in_str, split_like
    from vihmc_torch.core.prng import NAMED_OFFSET

    code = "from vihmc_torch.core import fold_in_str; print(fold_in_str(7, 'chains'))"
    seeds = {subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                            text=True, timeout=120,
                            env=dict(os.environ, PYTHONHASHSEED=str(h))).stdout.strip()
             for h in (1, 2)}
    assert seeds == {str(fold_in_str(7, "chains"))}
    assert fold_in_str(7, "chains") != fold_in_str(7, "data") != fold_in_str(8, "data")
    assert fold_in_str(0, "x") >= NAMED_OFFSET
    tree = {"b": 0.0, "a": [1.0, 2.0]}
    out = split_like(3, tree)
    assert set(out) == {"a", "b"} and len(out["a"]) == 2
    leaves = [out["a"][0], out["a"][1], out["b"]]
    assert len(set(leaves)) == 3 and split_like(3, tree) == out
    torch.Generator().manual_seed(leaves[0])   # a usable torch seed


def test_matmul_precision_restores_the_state():
    """matmul_precision maps JAX's names onto torch's float32 matmul
    precision (and TF32), restores both on exit, also on an error, and
    refuses an unknown name."""
    from vihmc_torch.core import matmul_precision

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        for mode, want in (("float32", "highest"), ("tensorfloat32", "high"),
                           ("bfloat16", "medium"), ("highest", "highest")):
            with matmul_precision(mode):
                assert torch.get_float32_matmul_precision() == want
                assert torch.backends.cuda.matmul.allow_tf32 is (want != "highest")
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.get_float32_matmul_precision()) == prev
        with pytest.raises(KeyError):
            with matmul_precision("tensorfloat32"):
                raise KeyError("inside")
        assert torch.get_float32_matmul_precision() == prev[1]
        with pytest.raises(ValueError, match="matmul precision"):
            with matmul_precision("fp8"):
                pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def test_normal_logpdf_matches_jax():
    """normal_logpdf elementwise and diag_normal_logpdf_sum (rtol 1e-6)
    against JAX's, with array and scalar locations and scales."""
    from vihmc_tpu.dists import diag_normal_logpdf_sum as j_sum
    from vihmc_tpu.dists import normal_logpdf as j_lp
    from vihmc_torch.dists import diag_normal_logpdf_sum, normal_logpdf

    rng = np.random.default_rng(43)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    loc = rng.normal(size=6).astype(np.float32)
    scale = (0.1 + rng.random(6)).astype(np.float32)
    for lo, sc in ((loc, scale), (0.0, 0.3)):
        t_lo = torch.as_tensor(lo) if isinstance(lo, np.ndarray) else lo
        t_sc = torch.as_tensor(sc) if isinstance(sc, np.ndarray) else sc
        np.testing.assert_allclose(normal_logpdf(torch.as_tensor(x), t_lo, t_sc).numpy(),
                                   np.asarray(j_lp(jnp.asarray(x), lo, sc)), rtol=1e-6)
        np.testing.assert_allclose(float(diag_normal_logpdf_sum(torch.as_tensor(x), t_lo, t_sc)),
                                   float(j_sum(jnp.asarray(x), lo, sc)), rtol=1e-6)


def test_load_reference_regression_data_reads_torch_files(tmp_path):
    """load_reference_regression_data reads the four tensors the test writes
    with torch.save (the reference's file names), as float32 on the CPU,
    the same values JAX's loader reads from them."""
    from vihmc_tpu.data import load_reference_regression_data as j_load
    from vihmc_torch.data import load_reference_regression_data

    rng = np.random.default_rng(44)
    shapes = {"x_train": (20, 1), "y_train": (20, 1), "x_val": (300, 1), "y_val": (300, 1)}
    for name, shape in shapes.items():
        torch.save(torch.as_tensor(rng.normal(size=shape)), tmp_path / name)
    got = load_reference_regression_data(str(tmp_path), device="cpu")
    want = j_load(str(tmp_path))
    assert set(got) == set(shapes)
    for name, shape in shapes.items():
        assert tuple(got[name].shape) == shape and got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_profiling_helpers_match_jax(tmp_path):
    """sampler_throughput on a port SampleResult equals JAX's on the same
    arrays; ProgressPrinter writes JAX's lines; Timer times a block;
    device_trace writes a Chrome trace of the block (CPU activity here)."""
    import io
    import json
    import types

    from vihmc_tpu.core import profiling as jprof
    from vihmc_torch.core import profiling as tprof
    from vihmc_torch.hmc.kernel import SampleResult

    rng = np.random.default_rng(45)
    accepted = rng.random((3, 10)) < 0.6
    res = SampleResult(samples=rng.normal(size=(3, 10, 4)), log_probs=np.zeros((3, 10)),
                       accept_probs=np.zeros((3, 10)), accepted=accepted,
                       step_sizes=np.zeros((3, 10)), divergent=rng.random((3, 10)) < 0.1,
                       final_state=None)
    jres = types.SimpleNamespace(samples=res.samples, acceptance_rate=res.acceptance_rate,
                                 num_divergent=res.num_divergent)
    ess = rng.random(4) * 30
    assert tprof.sampler_throughput(res, 2.5, 8, ess) == jprof.sampler_throughput(jres, 2.5, 8,
                                                                                   ess)
    streams = []
    for mod in (tprof, jprof):
        buf = io.StringIO()
        printer = mod.ProgressPrinter(120, stream=buf)
        printer.t0 = 0.0   # the same clock origin on both sides
        for seg in (1, 2, 3):
            printer(seg, 3, None)
        streams.append(buf.getvalue().split("draws/s")[0])
    assert streams[0] == streams[1] and "120/120" in buf.getvalue()
    with tprof.Timer() as t:
        torch.ones(8).sum()
    assert t.elapsed >= 0.0
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
