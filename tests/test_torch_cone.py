"""PyTorch port parity: the Cone dataset and the per-example query path of
stages 1-3.

The normalization, the ``.npz`` loader and its error, the operator layout
and the generated data against ``vihmc_tpu.data.cone``; one stage-1 epoch on
Cone data from JAX's initial parameters with JAX's ensemble normals
injected; sensitivity scores on per-example points; one stage-3 transition
on the per-example composed density with JAX's draws injected; and a tiny
three-stage run (the sizes of ``tests/test_cone.py``). Inputs are made with
numpy or from JAX's draws and handed to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_convert import flat_from_tree, vp_from_jax
from torch_parity_helpers import (jax_deeponet_eps, jax_transition_draws,  # noqa: F401
                                  one_torch_thread)
from vihmc_tpu.data import cone as jcone
from vihmc_tpu.hmc import HMCConfig as JConfig
from vihmc_tpu.hmc.kernel import init_state as j_init_state
from vihmc_tpu.hmc.kernel import make_kernel as j_make_kernel
from vihmc_tpu.models import DeepONetConfig as JDCfg
from vihmc_tpu.models.bayesian import init_variational as j_init_variational
from vihmc_tpu.models.deeponet import init_deeponet as j_init_deeponet
from vihmc_tpu.pipelines import configs as JC
from vihmc_tpu.pipelines import sensitivity as jsens
from vihmc_tpu.pipelines import vi_hmc as jv
from vihmc_tpu.pipelines import vi_train as jvt
from vihmc_tpu.pipelines.common import make_flat_deeponet as j_make_flat
from vihmc_tpu.vi import VIConfig as JVIConfig
from vihmc_tpu.vi.elbo import ELBOConfig as JELBO
from vihmc_torch.data import cone as tcone
from vihmc_torch.hmc.kernel import HMCConfig, TransitionNoise, init_state, make_kernel
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.pipelines import configs as TC
from vihmc_torch.pipelines import sensitivity as tsens
from vihmc_torch.pipelines import vi_hmc as tv
from vihmc_torch.pipelines import vi_train as tvt
from vihmc_torch.pipelines.common import make_flat_deeponet
from vihmc_torch.pipelines.configs import VIHMCRunConfig
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import VIConfig, VITrainer

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_cone.py's tiny DeepONet: the 2 query features enter the trunk as they are
CONE_KW = dict(in_branch=9, in_trunk=2, width_branch=8, width_trunk=8, depth_branch=3,
               depth_trunk=3, impose_bc=False)


def _np_split(split):
    return {k: np.asarray(v) for k, v in split.items()}


def jax_cone_draws(key, n):
    """The draws of JAX's ``generate_cone_dataset(key, n)`` (cone.py:96-120)."""
    kf, kf2, kp, ky = jax.random.split(key, 4)
    return {"amp": np.asarray(jax.random.normal(kf, (n, 6))),
            "phase": np.asarray(jax.random.uniform(kf2, (n, 6), minval=0.0,
                                                   maxval=2 * jnp.pi)),
            "u": np.asarray(jax.random.uniform(kp, (n, 2))),
            "noise": np.asarray(jax.random.normal(ky, (n,)))}


def test_normalization_loader_and_error_match_jax(tmp_path):
    """normalize_cone and normalize_cone_inputs on numpy inputs, and the
    ``.npz`` round trip of load_cone, equal JAX's exactly; load_cone(None)
    raises JAX's error with the same text."""
    rng = np.random.default_rng(0)
    feat = {"Xf": rng.normal(size=(20, 9)).astype(np.float32),
            "Xp": np.stack([0.241 + 0.075 * rng.random(20), 50 + 450 * rng.random(20)],
                           -1).astype(np.float32),
            "Y": rng.normal(size=20).astype(np.float32)}
    want, got = jcone.normalize_cone(feat), tcone.normalize_cone(feat)
    for k in feat:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for g, w in zip(tcone.normalize_cone_inputs(feat["Xf"], feat["Xp"]),
                    jcone.normalize_cone_inputs(feat["Xf"], feat["Xp"])):
        np.testing.assert_array_equal(g, np.asarray(w))
    # tensors normalize to the same float32 values
    tt = tcone.normalize_cone({k: torch.as_tensor(v) for k, v in feat.items()})
    for k in feat:
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(want[k]))
    path = tmp_path / "cone.npz"
    np.savez(path, **feat)
    for g, w in zip(tcone.load_cone(str(path), 12, 8), jcone.load_cone(str(path), 12, 8)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(NotImplementedError) as te:
        tcone.load_cone(None, 10, 10)
    with pytest.raises(NotImplementedError) as je:
        jcone.load_cone(None, 10, 10)
    assert str(te.value) == str(je.value) == "Cone dataset is not available"
    assert tcone.CONE_STATS == tcone.ConeStats(**dataclasses.asdict(jcone.CONE_STATS))


def test_generated_data_and_operator_layout_match_jax():
    """generate_cone_dataset with JAX's draws injected: every array within
    f32 rounding of JAX's (atol 2e-6 on values up to ~3.4); get_cone's two
    splits, normalized in both packages, within 1e-6; the layout
    ``branch_in`` (N, F), ``trunk_in`` (N, 1, 2), ``solution`` (N, 1)."""
    key = jax.random.key(3)
    want = jcone.generate_cone_dataset(key, 40, in_branch=17)
    got = tcone.generate_cone_dataset(None, 40, 17, draws=jax_cone_draws(key, 40))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=2e-6)
    jtrain, jvalid = jcone.get_cone(key, 24, 16, in_branch=17)
    ttrain, tvalid = tcone.get_cone(None, 24, 16, in_branch=17, device="cpu",
                                    draws=jax_cone_draws(key, 40))
    for g, w in ((ttrain, jtrain), (tvalid, jvalid)):
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape)
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), rtol=0, atol=1e-6)
    assert ttrain["trunk_in"].shape == (24, 1, 2) and ttrain["solution"].shape == (24, 1)
    split = tcone.cone_to_operator_splits(_np_split(jcone.generate_cone_dataset(key, 5, 7)))
    want = jcone.cone_to_operator_splits(jcone.generate_cone_dataset(key, 5, 7))
    for k in want:
        np.testing.assert_array_equal(split[k].numpy(), np.asarray(want[k]))
    # the port's own stream: a fresh generator of one seed gives the same data
    a = tcone.get_cone(torch.Generator().manual_seed(5), 4, 2, in_branch=7, device="cpu")
    b = tcone.get_cone(torch.Generator().manual_seed(5), 4, 2, in_branch=7, device="cpu")
    assert torch.equal(a[0]["branch_in"], b[0]["branch_in"])


def _jax_cone_data(n_train=24, n_valid=16):
    return jcone.get_cone(jax.random.key(0), n_train, n_valid, in_branch=9)


@pytest.mark.parametrize("learn_noise", [False, True])
def test_one_vi_epoch_on_cone_matches_jax(learn_noise, monkeypatch):
    """One epoch of ``vi_train.run_operator`` on Cone data (16 examples, one
    batch of 16, per-example query points, no subsampling) from JAX's
    initial variational parameters, with the ensemble normals of JAX's
    epoch key injected (cone epoch: vi_train.py:120-151): the epoch's train
    loss (rtol 1e-5), the mean-weight train and valid MSEs (rtol 1e-5),
    ``exp(noise_param)`` under ``learn_noise`` (rtol 1e-6) and the updated
    ``mu`` and ``rho`` (rtol 1e-6, atol 1e-4 of ``lr_start``: Adam's
    ``g / (|g| + eps)`` step, as the port's three-step Adam test). The batch
    is the whole training set in another order, so the loss differs only in
    summation order."""
    data = _jax_cone_data(16, 8)
    jcfg = JDCfg(**CONE_KW)
    elbo_kw = dict(reduction="mean_x_n", fixed_noise_var=0.1, learn_noise=learn_noise)
    vi_kw = dict(epochs=1, lr_start=1e-2, num_ens=3, beta_type=1.0, prior_sigma=0.5)
    cfg_kw = dict(dataset="Cone", n_train=16, n_valid=8, batch_size=16)
    key = jax.random.key(7)
    kd, kp, kt = jax.random.split(key, 3)
    vp0 = j_init_variational(kp, j_init_deeponet(kp, jcfg), (0.0, 0.1), (-5.0, 0.1))
    jout = jvt.run_operator(JC.OperatorVIRunConfig(
        model=jcfg, vi=JVIConfig(elbo=JELBO(**elbo_kw), **vi_kw), **cfg_kw), key=key,
        data=data)
    # the epoch's one step key: split(kt, 4)[1] -> (kperm, kbatch), split(kbatch, 1)[0]
    _, ek, _, _ = jax.random.split(kt, 4)
    kstep = jax.random.split(jax.random.split(ek)[1], 1)[0]
    eps = torch.as_tensor(np.asarray(jax.jit(jax_deeponet_eps, static_argnums=(1, 2))(
        kstep, jcfg, 3), np.float32))
    real_step = VITrainer.step
    monkeypatch.setattr(VITrainer, "step", lambda self, batch, e=None: real_step(self, batch,
                                                                                  eps))
    tcfg = TC.OperatorVIRunConfig(model=DeepONetConfig(**CONE_KW),
                                  vi=VIConfig(elbo=ELBOConfig(**elbo_kw), **vi_kw), **cfg_kw)
    tout = tvt.run_operator(tcfg, data=tuple(_np_split(s) for s in data),
                            init_vp=vp_from_jax(jax.tree_util.tree_map(np.asarray, vp0)),
                            device="cpu")
    jm, tm = np.asarray(jout["metrics"]), tout["metrics"]
    assert tm.shape == jm.shape == (1, 5 if learn_noise else 4)
    np.testing.assert_allclose(tm[:, [0, 2, 3]], jm[:, [0, 2, 3]], rtol=1e-5)
    if learn_noise:
        np.testing.assert_allclose(tm[:, 4], jm[:, 4], rtol=1e-6)
        assert tm[0, 4] != 1.0
    jvp = jax.tree_util.tree_map(np.asarray, jout["state"].vp)
    for name in ("mu", "rho"):
        np.testing.assert_allclose(tout["state"].vp[name].numpy(), flat_from_tree(jvp[name]),
                                   rtol=1e-6, atol=1e-4 * vi_kw["lr_start"])


def test_sensitivity_on_per_example_points_matches_jax():
    """Operator sensitivity on Cone's per-example query points (no trunk
    subsampling in either package): the scores (rtol 1e-4, atol 1e-6 of the
    largest), the selected index set and the flat mu/sigma."""
    data = _jax_cone_data()
    jcfg, tcfg = JDCfg(**CONE_KW), DeepONetConfig(**CONE_KW)
    rng = np.random.default_rng(9)
    mu = (0.4 * rng.normal(size=tcfg.num_params)).astype(np.float32)
    sigma = (0.01 + 0.05 * rng.random(tcfg.num_params)).astype(np.float32)
    scfg = JC.SensitivityRunConfig(importance_threshold=0.9, batch_chunk=5)
    want = jsens.run_operator_flat(jnp.asarray(mu), jnp.asarray(sigma), jcfg, data[1], scfg)
    got = tsens.run_operator_flat(mu, sigma, tcfg,
                                  {k: torch.as_tensor(np.asarray(v)) for k, v in data[1].items()},
                                  TC.SensitivityRunConfig(importance_threshold=0.9,
                                                          batch_chunk=5))
    ws = np.asarray(want["scores"])
    np.testing.assert_allclose(got["scores"], ws, rtol=1e-4, atol=1e-6 * ws.max())
    np.testing.assert_array_equal(got["indices"], np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["sigma"], np.asarray(want["sigma"]))


def test_stage3_transition_on_per_example_density_matches_jax():
    """Two fixed-step transitions of 3 chains on the per-example composed
    density (the einsum merge of (B, 1, 2) points, autograd leapfrog, the
    unpaired MH test, step jitter) against JAX's kernel with its draws
    injected: the initial log-density (rtol 1e-5), the accept decisions, the
    accept probabilities (rtol 1e-3, atol 1e-4) and the positions (rtol 1e-4,
    atol 5e-5)."""
    data = _jax_cone_data()
    jcfg, tcfg = JDCfg(**CONE_KW), DeepONetConfig(**CONE_KW)
    rng = np.random.default_rng(11)
    d_full = tcfg.num_params
    arts = {"mu": (0.4 * rng.normal(size=d_full)).astype(np.float32),
            "sigma": (0.01 + 0.02 * rng.random(d_full)).astype(np.float32),
            "indices": np.sort(rng.choice(d_full, 10, replace=False))}
    cfg_kw = dict(frozen_policy="draw", loss="NLL", tau_out=0.1, vi_mass=True)
    train = data[0]
    bx, tx, y = (jnp.asarray(train[k]) for k in ("branch_in", "trunk_in", "solution"))
    j_apply, _, _ = j_make_flat(jcfg)
    jlp, jaux, _, _, _, jim = jv.build_subspace_posterior(
        JC.VIHMCRunConfig(**cfg_kw), lambda f: j_apply(f, bx, tx), y, arts,
        jax.random.key(3))
    t_apply = make_flat_deeponet(tcfg)
    tb, tt, ty = (torch.as_tensor(np.asarray(train[k]))
                  for k in ("branch_in", "trunk_in", "solution"))
    tlp, taux, _, _, tim = tv.build_subspace_posterior(
        VIHMCRunConfig(**cfg_kw), lambda f: t_apply(f, tb, tt), ty, arts,
        frozen=np.asarray(jaux), device="cpu")
    d, c = len(arts["indices"]), 3
    inits = (arts["mu"][arts["indices"]][None] + 0.5 * arts["sigma"][arts["indices"]][None]
             * rng.normal(size=(c, d))).astype(np.float32)
    kw = dict(num_samples=2, num_leapfrog=4, step_size=0.5, sampler="hmc", jitter_eps=True,
              jitter_low_frac=0.5)
    jk = j_make_kernel(jlp, JConfig(**kw), inv_mass=jim)
    jstate = jax.vmap(lambda q: j_init_state(jlp, q, JConfig(**kw), aux=jaux,
                                             inv_mass=jim))(jnp.asarray(inits))
    tstate = init_state(tlp, torch.as_tensor(inits), HMCConfig(**kw), taux, inv_mass=tim)
    np.testing.assert_allclose(tstate.log_prob.numpy(), np.asarray(jstate.log_prob), rtol=1e-5)
    tk = make_kernel(HMCConfig(**kw), tim, None, None, tlp)
    step = jax.jit(jax.vmap(jk, in_axes=(0, 0, None)))
    n_accept = 0
    for it in range(2):
        keys = jax.random.split(jax.random.key(300 + it), c)
        draws = [jax_transition_draws(k, d) for k in keys]
        noise = TransitionNoise(z1=torch.as_tensor(np.stack([x[0] for x in draws])), z2=None,
                                u_jitter=torch.tensor([x[1] for x in draws]),
                                u_accept=torch.tensor([x[2] for x in draws]))
        jstate, jinfo = step(jstate, keys, it)
        tstate, tinfo = tk(tstate, noise)
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
        np.testing.assert_allclose(tinfo["accept_prob"].numpy(), np.asarray(jinfo["accept_prob"]),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(tstate.position.numpy(), np.asarray(jstate.position),
                                   rtol=1e-4, atol=5e-5)
        n_accept += int(tinfo["accepted"].sum())
    assert n_accept > 0


def test_three_stage_cone_run_on_cpu():
    """VI -> sensitivity -> VI-HMC on Cone at tests/test_cone.py's sizes (24
    training and 16 validation examples, 10 epochs, the top-8 subspace, 2
    chains x 30 draws): finite draws of the expected shape, no kernel
    launch, finite validation metrics on the (16, 1) outputs."""
    from vihmc_torch.core.profiling import counter

    model = DeepONetConfig(**CONE_KW)
    data = tcone.get_cone(torch.Generator().manual_seed(0), 24, 16, in_branch=9, device="cpu")
    vi_cfg = TC.OperatorVIRunConfig(
        model=model, dataset="Cone", n_train=24, n_valid=16, batch_size=8,
        vi=VIConfig(epochs=10, lr_start=1e-2, num_ens=2, beta_type=1.0,
                    elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=0.1)))
    vi_out = tvt.run_operator(vi_cfg, seed=6, data=data, device="cpu")
    assert np.isfinite(vi_out["metrics"]).all()
    sens = tsens.run_operator(vi_out["best_state"].vp, model, data[1],
                              TC.SensitivityRunConfig(importance_threshold=0.9))
    assert np.isfinite(sens["scores"]).all() and sens["scores"].max() > 0
    indices = np.sort(np.argsort(-sens["scores"])[:8])
    launches = counter("merge_sums.launches") + counter("paired_sums.launches")
    out = tv.run_operator(VIHMCRunConfig(num_samples=30, num_chains=2, step_size=1e-3,
                                         tau_out=0.1, sample_data=False), model,
                          {"mu": sens["mu"], "sigma": sens["sigma"], "indices": indices},
                          data=data, device="cpu")
    samples = out["result"].samples
    assert samples.shape == (2, 30, 8) and np.isfinite(samples).all()
    assert counter("merge_sums.launches") + counter("paired_sums.launches") == launches
    assert np.asarray(out["predictions"]).shape[1:] == (16, 1)
    assert np.isfinite(out["metrics"]["expected_mse_of_mean"])
