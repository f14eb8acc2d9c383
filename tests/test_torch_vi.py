"""PyTorch port parity: stage 1 of the method (Bayes-by-Backprop VI training).

The ELBO in both reductions, every KL-annealing schedule, the KL in both
directions, the Bayesian forward of the MLP and the DeepONet (shared grid and
per-example points) at the mean weights and at injected weight draws, three
Adam steps with JAX's own ensemble draws injected (loss, gradients, Adam
moments, parameters, the plateau scale), the plateau rule, the data and
parameter helpers, the configs, and a short NN VI run held to a band set by
two JAX keys. Inputs are numpy arrays handed to both sides.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)
from vihmc_tpu.data.synthetic import regression_data as j_regression_data
from vihmc_tpu.models import DeepONetConfig as JDCfg
from vihmc_tpu.models import MLPConfig as JMCfg
from vihmc_tpu.models.bayesian import bayesian_deeponet_apply as j_bdeeponet
from vihmc_tpu.models.bayesian import bayesian_mlp_apply as j_bmlp
from vihmc_tpu.models.bayesian import init_variational as j_init_variational
from vihmc_tpu.models.bayesian import kl_divergence as j_kl
from vihmc_tpu.models.deeponet import init_deeponet as j_init_deeponet
from vihmc_tpu.models.mlp import init_mlp as j_init_mlp
from vihmc_tpu.pipelines import configs as JC
from vihmc_tpu.pipelines import vi_train as jvt
from vihmc_tpu.pipelines.common import deeponet_vi_apply as j_deeponet_vi_apply
from vihmc_tpu.pipelines.common import make_flat_mlp as j_make_flat_mlp
from vihmc_tpu.pipelines.common import mlp_vi_apply as j_mlp_vi_apply
from vihmc_tpu.vi import elbo as jelbo
from vihmc_torch.core.convert import flat_from_tree, vp_from_jax
from vihmc_torch.data.synthetic import regression_data
from vihmc_torch.models.bayesian import (BayesianFlat, bayesian_deeponet_apply,
                                         bayesian_mlp_apply, kl_divergence)
from vihmc_torch.models.deeponet import DeepONetConfig, init_deeponet, param_slices
from vihmc_torch.models.mlp import MLPConfig, init_mlp, mlp_slices
from vihmc_torch.pipelines import configs as TC
from vihmc_torch.pipelines import vi_train as tvt
from vihmc_torch.pipelines.common import deeponet_vi_apply, make_flat_mlp, mlp_vi_apply
from vihmc_torch.vi import elbo as telbo
from vihmc_torch.vi.train import (VIConfig, VITrainer, plateau_init, plateau_update,
                                  predictive_samples)

jtrain = importlib.import_module("vihmc_tpu.vi.train")  # the package exports a `train` function

# the --small DeepONet of scripts/run_operator_stage12.py
SMALL_DEEPONET_KW = dict(in_branch=17, in_trunk=5, width_branch=16, width_trunk=16,
                         depth_branch=3, depth_trunk=3)
TINY_MLP_KW = dict(in_dim=1, widths=(6, 5), out_dim=1)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("reduction", ["sum", "mean_x_n"])
def test_elbo_loss_matches_jax(reduction):
    """Each ensemble member's negative ELBO (rtol 1e-6) for both reductions,
    at a fixed noise variance off 1."""
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(3, 4, 7)).astype(np.float32)
    target = rng.normal(size=(4, 7)).astype(np.float32)
    jcfg = jelbo.ELBOConfig(reduction=reduction, fixed_noise_var=0.3)
    tcfg = telbo.ELBOConfig(reduction=reduction, fixed_noise_var=0.3)
    got = telbo.elbo_loss(tcfg, torch.as_tensor(pred), torch.as_tensor(target), 12.5, 0.7,
                          28_000)
    for e in range(3):
        want = jelbo.elbo_loss(jcfg, jnp.asarray(pred[e]), jnp.asarray(target), 12.5, 0.7,
                               28_000)
        np.testing.assert_allclose(float(got[e]), float(want), rtol=1e-6)


def test_get_beta_matches_jax_for_every_schedule():
    """Every schedule (float, Blundell, linear, step, Soenderby, Standard, an
    unknown name) over a grid of batch indices and epochs: exactly equal."""
    for beta_type in (0.25, "Blundell", "linear", "step", "Soenderby", "Standard", "none"):
        for m in (1, 3, 7):
            for batch_idx in range(m):
                for epoch in (0, 3, 17, 40):
                    args = (batch_idx, m, beta_type, epoch, 40)
                    assert telbo.get_beta(*args) == jelbo.get_beta(*args), args
    with pytest.raises(ValueError):
        telbo.get_beta(0, 1, "Soenderby")


@pytest.mark.parametrize("direction", ["reference", "standard"])
def test_kl_divergence_matches_jax(direction):
    """KL of a DeepONet-shaped variational tree against N(0.05, 0.3) in both
    directions (rtol 2e-6: one flat sum here, per-leaf sums in JAX)."""
    _, vp = _deeponet_vp(2)
    want = float(j_kl(vp, 0.05, 0.3, direction))
    got = float(kl_divergence(vp_from_jax(_np_tree(vp)), 0.05, 0.3, direction))
    np.testing.assert_allclose(got, want, rtol=2e-6)
    with pytest.raises(ValueError):
        kl_divergence(vp_from_jax(_np_tree(vp)), direction="sideways")


def _np_layers(rng, dims, scale):
    return [{"w": jnp.asarray(scale * rng.normal(size=(o, i)), jnp.float32),
             "b": jnp.asarray(scale * rng.normal(size=(o,)), jnp.float32)} for i, o in dims]


def _np_vp(rng, make_tree, mu_init, rho_init):
    """A variational tree ``{'mu', 'rho'}`` of normals drawn with numpy (no
    JAX random calls to compile)."""
    mu = jax.tree_util.tree_map(lambda a: a * mu_init[1] / 0.5 + mu_init[0],
                                make_tree(rng, 0.5))
    rho = jax.tree_util.tree_map(lambda a: a * rho_init[1] / 0.5 + rho_init[0],
                                 make_tree(rng, 0.5))
    return {"mu": mu, "rho": rho}


def _mlp_vp(seed, mu_init=(0.0, 0.3), rho_init=(-2.0, 0.3), kw=TINY_MLP_KW):
    cfg = JMCfg(**kw)
    return cfg, _np_vp(np.random.default_rng(seed),
                       lambda rng, sc: _np_layers(rng, cfg.layer_dims, sc), mu_init, rho_init)


def _deeponet_vp(seed):
    cfg = JDCfg(**SMALL_DEEPONET_KW)

    def tree(rng, sc):
        return {"b": jnp.asarray(sc * rng.normal(), jnp.float32),
                "branch": _np_layers(rng, cfg.branch_dims, sc),
                "trunk": _np_layers(rng, cfg.trunk_dims, sc)}

    return cfg, _np_vp(np.random.default_rng(seed), tree, (0.0, 0.1), (-5.0, 0.1))


def _softplus(x):
    return np.log1p(np.exp(x.astype(np.float64))).astype(np.float32)


@pytest.mark.parametrize("model", ["mlp", "deeponet_grid", "deeponet_points"])
def test_bayesian_forward_matches_jax(model):
    """The Bayesian forward at the mean weights (sample=False) and at an
    injected draw ``mu + sigma eps`` of 2 ensemble members, against JAX's
    apply at the same weights (passed as ``mu`` with sample=False): rtol 1e-5,
    atol 1e-5. The DeepONet on a shared (P, 2) grid and on per-example
    (B, p, 2) points."""
    rng = np.random.default_rng(3)
    if model == "mlp":
        jcfg, vp = _mlp_vp(3)
        tcfg = MLPConfig(**TINY_MLP_KW)
        x = rng.normal(size=(9, 1)).astype(np.float32)

        def japply(tree):
            return j_bmlp(jcfg, {"mu": tree, "rho": tree}, jnp.asarray(x), jax.random.key(0),
                          sample=False)

        def tapply(tvp, eps, sample):
            return bayesian_mlp_apply(tcfg, tvp, torch.as_tensor(x), eps, sample)
    else:
        jcfg, vp = _deeponet_vp(3)
        tcfg = DeepONetConfig(**SMALL_DEEPONET_KW)
        bx = rng.normal(size=(5, 17)).astype(np.float32)
        tx = (rng.random(size=(11, 2)) if model == "deeponet_grid"
              else rng.random(size=(5, 11, 2))).astype(np.float32)

        def japply(tree):
            return j_bdeeponet(jcfg, {"mu": tree, "rho": tree}, jnp.asarray(bx), jnp.asarray(tx),
                               jax.random.key(0), sample=False)

        def tapply(tvp, eps, sample):
            return bayesian_deeponet_apply(tcfg, tvp, torch.as_tensor(bx), torch.as_tensor(tx),
                                           eps, sample)
    tvp = vp_from_jax(_np_tree(vp))
    _, unravel = ravel_pytree(vp["mu"])
    got = tapply(tvp, None, False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(japply(vp["mu"])), rtol=1e-5,
                               atol=1e-5)
    eps = rng.normal(size=(2, tvp["mu"].shape[0])).astype(np.float32)
    got = tapply(tvp, torch.as_tensor(eps), True)
    w = tvp["mu"].numpy() + eps * _softplus(tvp["rho"].numpy())
    for e in range(2):
        np.testing.assert_allclose(got[e].numpy(), np.asarray(japply(unravel(jnp.asarray(w[e])))),
                                   rtol=1e-5, atol=1e-5)


def _jax_mlp_eps(key, cfg, num_ens):
    """The normals the JAX MLP loss draws from ``key``: ``split(key,
    num_ens)`` (train.py:115), ``split(k, n_layers)`` (bayesian.py:209), then
    ``kw, kb = split`` per layer (bayesian.py:128), in the flat order b, w."""
    rows = []
    for ke in jax.random.split(key, num_ens):
        parts = []
        for kl, (d_in, d_out) in zip(jax.random.split(ke, len(cfg.layer_dims)), cfg.layer_dims):
            kw, kb = jax.random.split(kl)
            parts += [jax.random.normal(kb, (d_out,)), jax.random.normal(kw, (d_out, d_in)).ravel()]
        rows.append(jnp.concatenate(parts))
    return jnp.stack(rows)


def _jax_deeponet_eps(key, cfg, num_ens):
    """The DeepONet's: ``kb, kt, kbias = split(k, 3)`` (bayesian.py:235), each
    stack's layer keys, and the merge bias's normal (coordinate 0)."""
    rows = []
    for ke in jax.random.split(key, num_ens):
        kb, kt, kbias = jax.random.split(ke, 3)
        parts = [jax.random.normal(kbias, ())[None]]
        for kstack, dims in ((kb, cfg.branch_dims), (kt, cfg.trunk_dims)):
            for kl, (d_in, d_out) in zip(jax.random.split(kstack, len(dims)), dims):
                kw, kbb = jax.random.split(kl)
                parts += [jax.random.normal(kbb, (d_out,)),
                          jax.random.normal(kw, (d_out, d_in)).ravel()]
        rows.append(jnp.concatenate(parts))
    return jnp.stack(rows)


def _jitted(fn):
    f = jax.jit(fn, static_argnums=(1, 2))
    return lambda key, cfg, n: np.asarray(f(key, cfg, n), np.float32)


_jax_mlp_eps_jit = _jitted(_jax_mlp_eps)
_jax_deeponet_eps_jit = _jitted(_jax_deeponet_eps)


def test_jax_draw_reconstruction_reproduces_the_jax_forward():
    """The reconstructed normals give JAX's own sampled forward (sample=True
    with the ensemble key) through the port: rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(4)
    key = jax.random.key(11)
    jcfg, vp = _deeponet_vp(4)
    bx = rng.normal(size=(3, 17)).astype(np.float32)
    tx = rng.random(size=(3, 6, 2)).astype(np.float32)
    eps = _jax_deeponet_eps_jit(key, jcfg, 2)
    got = bayesian_deeponet_apply(DeepONetConfig(**SMALL_DEEPONET_KW), vp_from_jax(_np_tree(vp)),
                                  torch.as_tensor(bx), torch.as_tensor(tx), torch.as_tensor(eps))
    for e, ke in enumerate(jax.random.split(key, 2)):
        want = j_bdeeponet(jcfg, vp, jnp.asarray(bx), jnp.asarray(tx), ke)
        np.testing.assert_allclose(got[e].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jmcfg, mvp = _mlp_vp(5)
    x = rng.normal(size=(7, 1)).astype(np.float32)
    eps = _jax_mlp_eps_jit(key, jmcfg, 2)
    got = bayesian_mlp_apply(MLPConfig(**TINY_MLP_KW), vp_from_jax(_np_tree(mvp)),
                             torch.as_tensor(x), torch.as_tensor(eps))
    for e, ke in enumerate(jax.random.split(key, 2)):
        np.testing.assert_allclose(got[e].numpy(), np.asarray(j_bmlp(jmcfg, mvp, jnp.asarray(x), ke)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["mlp", "deeponet"])
def test_three_adam_steps_match_jax(model):
    """Three optimizer steps from the same variational parameters, the port
    fed JAX's own ensemble draws: the loss (rtol 1e-5), the gradients with
    respect to mu and rho (rtol 1e-4 of their scale), Adam's two moments
    (rtol 1e-4 of their scale), the parameters after each step (within 1e-4
    of a first step's size, ``lr_start``: where a gradient is near 0, Adam's
    ``g / (|g| + eps)`` turns its rounding into a visible share of the step;
    plus rtol 1e-6, a few units in the last place of rho ~ -5) and the
    plateau scale. The plateau reads a validation sequence
    that reduces the scale and then hits the ``min_lr`` floor (patience 0,
    factor 0.1, floor 0.05), so the second and third steps run at 0.1 and
    0.05 of ``lr_start``."""
    rng = np.random.default_rng(5)
    if model == "mlp":
        jcfg, vp = _mlp_vp(6)
        tcfg = MLPConfig(**TINY_MLP_KW)
        x = rng.normal(size=(9, 1)).astype(np.float32)
        y = rng.normal(size=(9, 1)).astype(np.float32)
        jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        tbatch = {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
        japply, tapply, jeps = j_mlp_vi_apply(jcfg), mlp_vi_apply(tcfg), _jax_mlp_eps_jit
        elbo_kw = dict(reduction="sum", fixed_noise_var=0.05 ** 2)
        train_size = 9
    else:
        jcfg, vp = _deeponet_vp(6)
        tcfg = DeepONetConfig(**SMALL_DEEPONET_KW)
        bx = rng.normal(size=(4, 17)).astype(np.float32)
        tx = rng.random(size=(4, 8, 2)).astype(np.float32)
        y = rng.normal(size=(4, 8)).astype(np.float32)
        jbatch = {"branch": jnp.asarray(bx), "trunk": jnp.asarray(tx), "y": jnp.asarray(y)}
        tbatch = {"branch": torch.as_tensor(bx), "trunk": torch.as_tensor(tx),
                  "y": torch.as_tensor(y)}
        japply, tapply, jeps = (j_deeponet_vi_apply(jcfg), deeponet_vi_apply(tcfg),
                                _jax_deeponet_eps_jit)
        elbo_kw = dict(reduction="mean_x_n", fixed_noise_var=1.0)
        train_size = 4 * 121
    vi_kw = dict(lr_start=1e-2, min_lr=5e-4, patience=0, plateau_factor=0.1, num_ens=3,
                 prior_sigma=0.5)
    jvi = jtrain.VIConfig(elbo=jelbo.ELBOConfig(**elbo_kw), **vi_kw)
    tvi = VIConfig(elbo=telbo.ELBOConfig(**elbo_kw), **vi_kw)
    jstate = jtrain.init_train_state(vp, jvi)
    jstep = jtrain.make_train_step(japply, jvi, train_size)
    jloss_fn = jtrain.make_loss_fn(japply, jvi, train_size)
    jgrad = jax.jit(jax.grad(lambda v, k: jloss_fn(v, jnp.zeros(()), jbatch, k, 1.0)))
    tvp = vp_from_jax(_np_tree(vp))
    trainer = VITrainer(BayesianFlat(tapply, tvp["mu"], tvp["rho"]), tvi, train_size)
    valid_seq = [3.0, 3.0, 3.0]
    for it in range(3):
        key = jax.random.key(40 + it)
        jgrads = jgrad(jstate.vp, key)
        jstate, jloss = jstep(jstate, jbatch, key, 1.0)
        tloss = trainer.step(tbatch, eps=torch.as_tensor(jeps(key, jcfg, 3)))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        adam = jstate.opt_state[0]
        for name, param in (("mu", trainer.model.mu), ("rho", trainer.model.rho)):
            g = flat_from_tree(_np_tree(jgrads[name]))
            scale = np.abs(g).max()
            np.testing.assert_allclose(param.grad.numpy(), g, rtol=1e-4, atol=1e-4 * scale)
            st = trainer.opt.state[param]
            for t_key, j_mom in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                want = flat_from_tree(_np_tree(j_mom[0][name]))
                np.testing.assert_allclose(st[t_key].numpy(), want, rtol=1e-4,
                                           atol=1e-4 * np.abs(want).max())
            np.testing.assert_allclose(param.detach().numpy(),
                                       flat_from_tree(_np_tree(jstate.vp[name])),
                                       rtol=1e-6, atol=1e-4 * jvi.lr_start)
        jstate = jstate.replace(plateau=jtrain.plateau_update(
            jstate.plateau, valid_seq[it], jvi.patience, jvi.plateau_factor,
            jvi.min_lr / jvi.lr_start))
        trainer.end_epoch(valid_seq[it])
        assert np.float32(trainer.plateau.scale) == np.float32(jstate.plateau.scale)
    assert np.isclose(float(trainer.plateau.scale), 0.05)
    assert isinstance(jstate.opt_state[0], optax.ScaleByAdamState)


def test_plateau_rule_matches_jax():
    """A validation sequence with improvements, relative-threshold ties and
    long plateaus, patience 2: best, num_bad and scale equal to the JAX rule's
    at every step (the scale reaches its floor)."""
    rng = np.random.default_rng(7)
    seq = list(np.float32(10.0 - np.cumsum(rng.random(8))))
    seq += [seq[-1] * (1 - 5e-5)] * 3 + [seq[-1] * 0.5] + [100.0] * 12
    jst, tst = jtrain.plateau_init(), plateau_init()
    for v in seq:
        jst = jtrain.plateau_update(jst, jnp.float32(v), 2, 0.1, 0.003)
        tst = plateau_update(tst, v, 2, 0.1, 0.003)
        assert (float(tst.best), tst.num_bad, float(tst.scale)) == \
            (float(jst.best), int(jst.num_bad), float(jst.scale)), v
    assert np.isclose(float(tst.scale), 0.003)


@pytest.mark.parametrize("name", ["NNVIRunConfig", "SensitivityRunConfig",
                                  "OperatorVIRunConfig", "VIConfig", "ELBOConfig",
                                  "MLPConfig"])
def test_stage12_configs_match_jax(name):
    """Every field and default (nested configs included) of the stage-1/2
    configs, and the MLP's parameter count."""
    from vihmc_tpu.vi import VIConfig as JVIConfig

    jcls = {"VIConfig": JVIConfig, "ELBOConfig": jelbo.ELBOConfig, "MLPConfig": JMCfg}.get(
        name) or getattr(JC, name)
    tcls = {"VIConfig": VIConfig, "ELBOConfig": telbo.ELBOConfig, "MLPConfig": MLPConfig}.get(
        name) or getattr(TC, name)
    assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    if name == "MLPConfig":
        for kw in ({}, TINY_MLP_KW, {"last_bias": False, "widths": (3,)}):
            assert MLPConfig(**kw).num_params == JMCfg(**kw).num_params


@pytest.mark.parametrize("last_bias", [True, False])
def test_flat_mlp_and_inits_match_jax_layout(last_bias):
    """The chain-batched flat MLP forward on 3 flat vectors in
    ``ravel_pytree`` order against JAX's ``make_flat_mlp`` (rtol 1e-5); the
    inits' layout (sizes, ``U(-1/sqrt(fan_in), ...)`` bounds per layer, a zero
    merge bias) and the converter of parameter trees."""
    kw = dict(TINY_MLP_KW, last_bias=last_bias)
    jcfg, tcfg = JMCfg(**kw), MLPConfig(**kw)
    j_apply, flat0, unravel = j_make_flat_mlp(jcfg)
    np.testing.assert_array_equal(flat_from_tree(_np_tree(unravel(flat0))), np.asarray(flat0))
    rng = np.random.default_rng(8)
    flats = rng.normal(size=(3, tcfg.num_params)).astype(np.float32)
    x = rng.normal(size=(6, 1)).astype(np.float32)
    got = make_flat_mlp(tcfg)(torch.as_tensor(flats), torch.as_tensor(x))
    for c in range(3):
        np.testing.assert_allclose(got[c].numpy(), np.asarray(j_apply(jnp.asarray(flats[c]),
                                                                      jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    flat = init_mlp(tcfg, gen)
    slices, size = mlp_slices(tcfg)
    assert flat.shape == (size,) == (flat0.shape[0],)
    for s in slices:
        seg = flat[s.b:s.end].abs()
        assert seg.max() <= 1.0 / s.d_in ** 0.5 and seg.max() > 0.5 / s.d_in ** 0.5
    dcfg = DeepONetConfig(**SMALL_DEEPONET_KW)
    dflat = init_deeponet(dcfg, gen)
    jd = flat_from_tree(_np_tree(j_init_deeponet(jax.random.key(0), JDCfg(**SMALL_DEEPONET_KW))))
    assert dflat.shape == jd.shape and float(dflat[0]) == 0.0 == jd[0]
    for s in param_slices(dcfg)["branch"] + param_slices(dcfg)["trunk"]:
        assert float(dflat[s.b:s.end].abs().max()) <= 1.0 / s.d_in ** 0.5


def test_regression_data_matches_jax_with_injected_noise():
    """The grids (atol 2.5e-7, two units in the last place at |x| ~ 1: XLA's
    compiled linspace may round the last bit differently) and the targets
    with JAX's own noise normals injected (atol 2e-5: |f'| <= 76 times the
    grids' difference)."""
    key = jax.random.key(3)
    want = j_regression_data(key, 20, 300, noise_std=0.05)
    n_train = want["x_train"].shape
    noise = np.asarray(jax.random.normal(key, n_train))
    got = regression_data(20, 300, 0.05, noise=torch.as_tensor(noise), device="cpu")
    for k in want:
        atol = 2.5e-7 if k.startswith("x") else 2e-5
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol)
    gen = torch.Generator().manual_seed(1)
    again = regression_data(20, 300, 0.05, generator=gen, device="cpu")
    assert again["y_train"].shape == (20, 1) and again["x_val"].shape == (300, 1)


@pytest.mark.parametrize("setting", ["learn_noise", "noise_type", "cone"])
def test_unported_stage1_settings_raise(setting):
    """The features no configured pipeline uses raise NotImplementedError
    before any training."""
    with pytest.raises(NotImplementedError, match="not ported"):
        if setting == "cone":
            tvt.run_operator(TC.OperatorVIRunConfig(dataset="Cone"), device="cpu")
        else:
            vi = {"learn_noise": VIConfig(elbo=telbo.ELBOConfig(learn_noise=True)),
                  "noise_type": VIConfig(elbo=telbo.ELBOConfig(noise_type=1))}[setting]
            tvt.run_nn(TC.NNVIRunConfig(vi=vi), device="cpu")


def test_predictive_samples_and_module_forward():
    """``predictive_samples`` draws n members from a generator (one batched
    forward, reproducible from the seed) and equals the forward at the same
    normals."""
    cfg = MLPConfig(**TINY_MLP_KW)
    gen = torch.Generator().manual_seed(3)
    model = BayesianFlat(mlp_vi_apply(cfg), 0.1 * torch.randn(cfg.num_params, generator=gen),
                         torch.full((cfg.num_params,), -3.0))
    x = {"x": torch.linspace(-1, 1, 5)[:, None]}
    a = predictive_samples(model, x, 4, generator=torch.Generator().manual_seed(9))
    eps = torch.randn((4, cfg.num_params), generator=torch.Generator().manual_seed(9))
    b = predictive_samples(model, x, 4, eps=eps)
    assert a.shape == (4, 5, 1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_short_nn_vi_run_lies_in_the_jax_band():
    """400 full-batch epochs of the NN VI stage (MLPConfig(), Adam 1e-2,
    num_ens 10, 'sum', noise 0.05^2) from JAX's initial variational
    parameters and data, with the port's own random draws: the final valid
    MSE lies within the band of four JAX training keys widened by their
    spread on each side (16 keys against 16 port seeds gave 12.28 +- 1.71 and
    13.04 +- 1.66), the train loss falls by more than 2x and the valid MSE
    by more than 10 %."""
    data = j_regression_data(jax.random.key(0), 20, 300, noise_std=0.05)
    cfg_kw = dict(epochs=400, lr_start=1e-2, patience=5000, num_ens=10, beta_type=1.0,
                  prior_mu=0.0, prior_sigma=1.0)
    jcfg = JC.NNVIRunConfig(vi=jtrain.VIConfig(
        elbo=jelbo.ELBOConfig(reduction="sum", fixed_noise_var=0.05 ** 2), **cfg_kw))
    tcfg = TC.NNVIRunConfig(vi=VIConfig(
        elbo=telbo.ELBOConfig(reduction="sum", fixed_noise_var=0.05 ** 2), **cfg_kw))
    vp = j_init_variational(jax.random.key(1), j_init_mlp(jax.random.key(1), jcfg.model),
                            jcfg.posterior_mu_initial, jcfg.posterior_rho_initial)
    finals = [float(jvt.run_nn(jcfg, key=jax.random.key(k), data=data, init_vp=vp)["metrics"][-1, 3])
              for k in (10, 11, 12, 13)]
    lo, hi = min(finals), max(finals)
    spread = hi - lo
    out = tvt.run_nn(tcfg, seed=0, data=_np_tree(data), init_vp=vp_from_jax(_np_tree(vp)),
                     device="cpu")
    m = out["metrics"]
    assert m.shape == (400, 4) and np.isfinite(m).all()
    assert lo - spread <= m[-1, 3] <= hi + spread, (m[-1, 3], finals)
    assert m[-1, 0] < 0.5 * m[0, 0] and m[-1, 3] < 0.9 * m[0, 3]
    assert out["best_state"].epoch == int(np.argmin(m[:, 1])) + 1


def test_stage12_entry_points_default_to_cuda_and_keep_assets():
    """run_nn, run_operator and the stage-1/2 CLI default to the card and
    raise without one; the CLI refuses an output directory inside assets/."""
    from vihmc_torch.data.burgers import ASSETS

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvt.run_nn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvt.run_operator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvt.main(["--epochs", "2"])
    with pytest.raises(ValueError, match="never into assets"):
        tvt.main(["--out", ASSETS + "/x", "--device", "cpu"])


def test_run_nn_store_has_the_jax_layout(tmp_path):
    """A run store written by the port's run_nn holds the files JAX's does
    (the config, one metrics line of four numbers per epoch, the best
    posterior's flat mu and sigma), and the config loads identically."""
    from vihmc_tpu.io import RunStore as JStore
    from vihmc_torch.io.artifacts import RunStore

    vi_kw = dict(epochs=5, lr_start=1e-2, patience=50, num_ens=4)
    tstore = RunStore(str(tmp_path), uid="torch")
    out = tvt.run_nn(TC.NNVIRunConfig(vi=VIConfig(**vi_kw)), store=tstore, device="cpu")
    jstore = JStore(str(tmp_path), uid="jax")
    jvt.run_nn(JC.NNVIRunConfig(vi=jtrain.VIConfig(**vi_kw)), key=jax.random.key(0),
               store=jstore)
    import os

    assert sorted(os.listdir(tstore.path)) == sorted(os.listdir(jstore.path))
    rows = np.loadtxt(os.path.join(tstore.path, "output.txt"))
    np.testing.assert_allclose(rows, out["metrics"], rtol=1e-7)
    assert rows.shape == np.loadtxt(os.path.join(jstore.path, "output.txt")).shape == (5, 4)
    np.testing.assert_array_equal(tstore.load_array("vi_mu_flattened"),
                                  out["best_state"].vp["mu"].numpy())
    assert tstore.load_config() == jstore.load_config()


def test_run_operator_epoch_loop_on_cpu(monkeypatch):
    """The operator VI loop on tiny Burgers data (20 functions, batch 8, 12
    trunk points of 45 per example): 2 steps per epoch (the trailing partial
    batch dropped), each on a fresh shuffle and per-example subsample of
    distinct points; metric rows of JAX's shape, finite, the best state the
    lowest valid loss; evaluation on the first min(batch, n_valid)
    functions at the full grid."""
    from vihmc_tpu.data import get_burgers as j_get_burgers

    data = j_get_burgers(jax.random.key(0), 20, 6, nx=9, nt=5)
    np_data = tuple({k: np.asarray(v) for k, v in split.items()} for split in data)
    vi_kw = dict(epochs=3, lr_start=1e-3, patience=50, num_ens=2, prior_sigma=0.1,
                 elbo=telbo.ELBOConfig(reduction="mean_x_n", fixed_noise_var=1.0))
    cfg_kw = dict(model=DeepONetConfig(**dict(SMALL_DEEPONET_KW, in_branch=9)), n_train=20,
                  n_valid=6, batch_size=8, p=12)
    seen = []
    real_step = VITrainer.step

    def step(self, batch, eps=None):
        seen.append(batch)
        return real_step(self, batch, eps)

    monkeypatch.setattr(VITrainer, "step", step)
    out = tvt.run_operator(TC.OperatorVIRunConfig(vi=VIConfig(**vi_kw), **cfg_kw),
                           data=np_data, device="cpu")
    m = out["metrics"]
    assert m.shape == (3, 4) and np.isfinite(m).all()
    assert len(seen) == 3 * 2
    for batch in seen:
        assert batch["branch"].shape == (8, 9) and batch["trunk"].shape == (8, 12, 2)
        assert batch["y"].shape == (8, 12)
        for row in batch["trunk"]:
            assert len({tuple(p) for p in row.tolist()}) == 12
    assert not torch.equal(seen[0]["branch"], seen[2]["branch"])  # reshuffled
    assert out["best_state"].epoch == int(np.argmin(m[:, 1])) + 1
    jcfg = JC.OperatorVIRunConfig(
        vi=jtrain.VIConfig(**dict(vi_kw, elbo=jelbo.ELBOConfig(reduction="mean_x_n",
                                                                fixed_noise_var=1.0))),
        **dict(cfg_kw, model=JDCfg(**dict(SMALL_DEEPONET_KW, in_branch=9))))
    jm = np.asarray(jvt.run_operator(jcfg, key=jax.random.key(1), data=data)["metrics"])
    assert jm.shape == m.shape


def _jax_normals(key, shape):
    return np.asarray(jax.random.normal(key, shape), np.float32)


def _t_layer(layer):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in layer.items()}


@pytest.mark.parametrize("case", ["bbb_linear", "lrt_linear", "bbb_conv_same_s2",
                                  "lrt_conv_same", "lrt_conv_valid_s2"])
def test_layer_applies_match_jax(case):
    """The layer-level Bayesian applies with JAX's normals injected (``kw, kb
    = split(key)`` for the weight-space layers, one normal per output for the
    local-reparameterization ones; bayesian.py:123-193): rtol 1e-5, atol
    1e-5. The conv layers take NCHW inputs and OIHW weights on both sides,
    with XLA's 'SAME' split of the padding."""
    from vihmc_tpu.models import bayesian as jb
    from vihmc_torch.models import bayesian as tb

    rng = np.random.default_rng(11)
    key = jax.random.key(12)
    conv = "conv" in case
    w_shape = (4, 3, 3, 2) if conv else (5, 3)
    lmu = {"w": jnp.asarray(0.4 * rng.normal(size=w_shape), jnp.float32),
           "b": jnp.asarray(0.2 * rng.normal(size=(w_shape[0],)), jnp.float32)}
    lrho = {"w": jnp.asarray(-1.5 + 0.3 * rng.normal(size=w_shape), jnp.float32),
            "b": jnp.asarray(-2.0 + 0.3 * rng.normal(size=(w_shape[0],)), jnp.float32)}
    x = jnp.asarray(rng.normal(size=(2, 3, 7, 6) if conv else (6, 3)), jnp.float32)
    stride = 2 if "s2" in case else 1
    padding = "VALID" if "valid" in case else "SAME"
    kw = dict(stride=stride, padding=padding) if conv else {}
    name = case.split("_")[0] + ("_conv2d_apply" if conv else "_linear_apply")
    want = np.asarray(getattr(jb, name)(key, lmu, lrho, x, sample=True, **kw))
    if case.startswith("bbb"):
        k_w, k_b = jax.random.split(key)
        eps = (torch.as_tensor(_jax_normals(k_w, w_shape)),
               torch.as_tensor(_jax_normals(k_b, (w_shape[0],))))
    else:
        eps = torch.as_tensor(_jax_normals(key, want.shape))
    fn = getattr(tb, name)
    got = fn(_t_layer(lmu), _t_layer(lrho), torch.as_tensor(np.asarray(x)), eps=eps, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    mean = fn(_t_layer(lmu), _t_layer(lrho), torch.as_tensor(np.asarray(x)), sample=False, **kw)
    np.testing.assert_allclose(mean.numpy(), np.asarray(getattr(jb, name)(
        key, lmu, lrho, x, sample=False, **kw)), rtol=1e-5, atol=1e-5)
    drawn = fn(_t_layer(lmu), _t_layer(lrho), torch.as_tensor(np.asarray(x)),
               generator=torch.Generator().manual_seed(0), **kw)
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()


def _jax_lrt_eps(key, num_ens, stacks, bias=False):
    """The activation normals JAX's 'lrt' forward draws from ``key``: per
    member ``split(key, num_ens)`` (train.py:115); the MLP splits the member
    key over its layers (bayesian.py:209), the DeepONet into ``kb, kt,
    kbias`` and each stack over its layers (bayesian.py:235-240), each layer
    one normal per output activation. ``stacks``: a list of per-layer output
    shapes (MLP), or ``{'branch': [...], 'trunk': [...]}``."""
    members = []
    for ke in jax.random.split(key, num_ens):
        if not bias:
            members.append([_jax_normals(k, s) for k, s in
                            zip(jax.random.split(ke, len(stacks)), stacks)])
            continue
        kb, kt, kbias = jax.random.split(ke, 3)
        members.append({
            "branch": [_jax_normals(k, s) for k, s in
                       zip(jax.random.split(kb, len(stacks["branch"])), stacks["branch"])],
            "trunk": [_jax_normals(k, s) for k, s in
                      zip(jax.random.split(kt, len(stacks["trunk"])), stacks["trunk"])],
            "b": _jax_normals(kbias, ())})
    if not bias:
        return [torch.as_tensor(np.stack([m[i] for m in members])) for i in range(len(stacks))]
    return {"branch": [torch.as_tensor(np.stack([m["branch"][i] for m in members]))
                       for i in range(len(stacks["branch"]))],
            "trunk": [torch.as_tensor(np.stack([m["trunk"][i] for m in members]))
                      for i in range(len(stacks["trunk"]))],
            "b": torch.as_tensor(np.stack([m["b"] for m in members]))}


@pytest.mark.parametrize("model", ["mlp", "deeponet"])
def test_lrt_elbo_and_gradient_match_jax(model):
    """The 'lrt' negative ELBO (ensemble mean, rtol 1e-5) and its gradients
    with respect to mu and rho (rtol 1e-4 of their scale) with JAX's
    activation normals injected; the mean forward equals 'bbb''s."""
    from vihmc_torch.vi.train import make_loss_fn

    rng = np.random.default_rng(13)
    key = jax.random.key(14)
    e = 3
    if model == "mlp":
        jcfg, vp = _mlp_vp(15)
        tcfg = MLPConfig(**TINY_MLP_KW)
        x = rng.normal(size=(9, 1)).astype(np.float32)
        y = rng.normal(size=(9, 1)).astype(np.float32)
        jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        tbatch = {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
        japply, tapply = j_mlp_vi_apply(jcfg, "lrt"), mlp_vi_apply(tcfg, "lrt")
        eps = _jax_lrt_eps(key, e, [(9, o) for _, o in jcfg.layer_dims])
        elbo_kw, train_size = dict(reduction="sum", fixed_noise_var=0.05 ** 2), 9
        t_bbb = mlp_vi_apply(tcfg)
    else:
        jcfg, vp = _deeponet_vp(15)
        tcfg = DeepONetConfig(**SMALL_DEEPONET_KW)
        bx = rng.normal(size=(4, 17)).astype(np.float32)
        tx = rng.random(size=(4, 8, 2)).astype(np.float32)
        y = rng.normal(size=(4, 8)).astype(np.float32)
        jbatch = {"branch": jnp.asarray(bx), "trunk": jnp.asarray(tx), "y": jnp.asarray(y)}
        tbatch = {"branch": torch.as_tensor(bx), "trunk": torch.as_tensor(tx),
                  "y": torch.as_tensor(y)}
        japply, tapply = j_deeponet_vi_apply(jcfg, "lrt"), deeponet_vi_apply(tcfg, "lrt")
        eps = _jax_lrt_eps(key, e, {"branch": [(4, o) for _, o in jcfg.branch_dims],
                                    "trunk": [(4, 8, o) for _, o in jcfg.trunk_dims]},
                           bias=True)
        elbo_kw, train_size = dict(reduction="mean_x_n", fixed_noise_var=1.0), 4 * 121
        t_bbb = deeponet_vi_apply(tcfg)
    vi_kw = dict(num_ens=e, prior_sigma=0.5)
    jvi = jtrain.VIConfig(elbo=jelbo.ELBOConfig(**elbo_kw), **vi_kw)
    tvi = VIConfig(elbo=telbo.ELBOConfig(**elbo_kw), **vi_kw)
    jloss_fn = jtrain.make_loss_fn(japply, jvi, train_size)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda v: jloss_fn(v, jnp.zeros(()), jbatch, key, 0.7)))(vp)
    tvp = {k: v.requires_grad_(True) for k, v in vp_from_jax(_np_tree(vp)).items()}
    tl = make_loss_fn(tapply, tvi, train_size)(tvp, tbatch, eps, 0.7)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    g_mu, g_rho = torch.autograd.grad(tl, [tvp["mu"], tvp["rho"]])
    for name, g in (("mu", g_mu), ("rho", g_rho)):
        want = flat_from_tree(_np_tree(jg[name]))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    with torch.no_grad():
        np.testing.assert_array_equal(tapply(tvp, tbatch, None, False).numpy(),
                                      t_bbb(tvp, tbatch, None, False).numpy())
        drawn = tapply(tvp, tbatch, None, True, 2, torch.Generator().manual_seed(1))
    assert drawn.shape[0] == 2 and torch.isfinite(drawn).all()


def test_python_loop_train_matches_jax():
    """Three epochs of the Python-loop trainer with a string beta schedule
    ('Blundell' over two minibatches per epoch), the same batches, JAX's
    ensemble normals injected (rebuilt from its key chain, train.py:301-306)
    and the port started from JAX's initial state (core.convert): every
    metrics row (rtol 1e-5), then the final variational parameters (rtol
    1e-6, atol 1e-4 of ``lr_start``, as the three-step Adam test), Adam's
    moments (rtol 1e-4 of their scale), the step count, the plateau state
    and the epoch."""
    from vihmc_torch.core.convert import vi_train_state_from_jax
    from vihmc_torch.vi.train import train

    rng = np.random.default_rng(16)
    jcfg, vp = _mlp_vp(17)
    tcfg = MLPConfig(**TINY_MLP_KW)
    xs = [rng.normal(size=(6, 1)).astype(np.float32) for _ in range(3)]
    ys = [rng.normal(size=(6, 1)).astype(np.float32) for _ in range(3)]
    jb = [{"x": jnp.asarray(x), "y": jnp.asarray(y)} for x, y in zip(xs, ys)]
    tb = [{"x": torch.as_tensor(x), "y": torch.as_tensor(y)} for x, y in zip(xs, ys)]
    vi_kw = dict(epochs=3, lr_start=1e-2, min_lr=1e-3, patience=0, num_ens=2,
                 beta_type="Blundell", prior_sigma=0.5)
    elbo_kw = dict(reduction="sum", fixed_noise_var=0.1)
    jvi = jtrain.VIConfig(elbo=jelbo.ELBOConfig(**elbo_kw), **vi_kw)
    tvi = VIConfig(elbo=telbo.ELBOConfig(**elbo_kw), **vi_kw)
    key = jax.random.key(18)
    jstate0 = jtrain.init_train_state(vp, jvi)
    jfinal, _, jrows = jtrain.train(j_mlp_vi_apply(jcfg), jstate0, jvi,
                                    lambda k, e: jb[:2], jb[2], jb[0], 12, key)
    eps = {}
    k = key
    for epoch in range(3):
        k, ek, vk, _ = jax.random.split(k, 4)
        for i in range(2):
            ek, sk = jax.random.split(ek)
            eps[epoch, "train", i] = torch.as_tensor(_jax_mlp_eps_jit(sk, jcfg, 2))
        eps[epoch, "valid", 0] = torch.as_tensor(_jax_mlp_eps_jit(vk, jcfg, 2))
    adam0 = jstate0.opt_state[0]
    tstate0 = vi_train_state_from_jax(
        _np_tree(vp), adam0.count, _np_tree(adam0.mu[0]), _np_tree(adam0.nu[0]),
        jstate0.plateau.best, jstate0.plateau.num_bad, jstate0.plateau.scale, jstate0.epoch)
    tfinal, _, trows = train(mlp_vi_apply(tcfg), tstate0, tvi, lambda g, e: tb[:2], tb[2],
                             tb[0], 12, eps_fn=lambda e, kind, i: eps[e, kind, i])
    assert trows.shape == (3, 4)
    np.testing.assert_allclose(trows, np.asarray(jrows), rtol=1e-5)
    adam = jfinal.opt_state[0]
    assert tfinal.opt_state.count == int(adam.count) == 6
    for name in ("mu", "rho"):
        np.testing.assert_allclose(tfinal.vp[name].numpy(),
                                   flat_from_tree(_np_tree(jfinal.vp[name])),
                                   rtol=1e-6, atol=1e-4 * jvi.lr_start)
        for t_mom, j_mom in ((tfinal.opt_state.mu, adam.mu), (tfinal.opt_state.nu, adam.nu)):
            want = flat_from_tree(_np_tree(j_mom[0][name]))
            np.testing.assert_allclose(t_mom[name].numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
    assert np.float32(tfinal.plateau.scale) == np.float32(jfinal.plateau.scale)
    assert tfinal.plateau.num_bad == int(jfinal.plateau.num_bad)
    assert tfinal.epoch == int(jfinal.epoch) == 3


def test_accuracy_matches_jax():
    """accuracy: argmax over the last axis against integer targets, equal."""
    from vihmc_torch.vi import accuracy

    rng = np.random.default_rng(19)
    out, tgt = rng.normal(size=(50, 4)), rng.integers(0, 4, size=50)
    assert accuracy(out, tgt) == jelbo.accuracy(out, tgt)
