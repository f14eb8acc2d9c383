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
    from vihmc_torch.bench_operator import run_operator_row
    from vihmc_torch.data.burgers import get_burgers_train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_operator_row()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_burgers_train()


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
