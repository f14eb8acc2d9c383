"""PyTorch port parity: the learned noise (``learn_noise``) and the
DeepONet's heteroscedastic head (``noise_neurons``, ``noise_type=1``).

The ELBO under both noise types, the head's forward on a shared grid and on
per-example points (from JAX's parameters), three Adam steps with a learned
noise, the operator VI runs of ``tests/test_noise_and_subsample.py``, a
resumed VI run with a learned noise, and where the head is refused or
accepted downstream (the Gram field, stage 3, sensitivity) as in JAX.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_convert import flat_from_tree, vp_from_jax
from torch_parity_helpers import jax_deeponet_eps, one_torch_thread  # noqa: F401
from vihmc_tpu.data import get_burgers as j_get_burgers
from vihmc_tpu.models import DeepONetConfig as JDCfg
from vihmc_tpu.models.bayesian import bayesian_deeponet_apply as j_bdeeponet
from vihmc_tpu.models.deeponet import deeponet_apply as j_deeponet_apply
from vihmc_tpu.ops.gram_merge import make_gram_grad_full as j_gram
from vihmc_tpu.pipelines import configs as JC
from vihmc_tpu.pipelines import sensitivity as jsens
from vihmc_tpu.pipelines import vi_hmc as jv
from vihmc_tpu.pipelines.common import deeponet_vi_apply as j_vi_apply
from vihmc_tpu.vi import elbo as jelbo
from vihmc_torch.models.bayesian import BayesianFlat, bayesian_deeponet_apply
from vihmc_torch.models.deeponet import DeepONetConfig, deeponet_apply, unravel_deeponet
from vihmc_torch.ops.gram_merge import make_gram_grad_full
from vihmc_torch.pipelines import configs as TC
from vihmc_torch.pipelines import sensitivity as tsens
from vihmc_torch.pipelines import vi_hmc as tv
from vihmc_torch.pipelines import vi_train as tvt
from vihmc_torch.pipelines.common import deeponet_vi_apply
from vihmc_torch.pipelines.configs import VIHMCRunConfig
from vihmc_torch.vi import elbo as telbo
from vihmc_torch.vi.train import VIConfig, VITrainer, init_train_state, train

jtrain = importlib.import_module("vihmc_tpu.vi.train")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_noise_and_subsample.py's tiny DeepONets
TINY_KW = dict(in_branch=9, in_trunk=5, width_branch=8, width_trunk=8, depth_branch=3,
               depth_trunk=3)
HETERO_KW = dict(TINY_KW, noise_neurons=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layers(rng, dims, scale, shift=0.0):
    return [{"w": jnp.asarray(shift + scale * rng.normal(size=(o, i)), jnp.float32),
             "b": jnp.asarray(shift + scale * rng.normal(size=(o,)), jnp.float32)}
            for i, o in dims]


def _deeponet_tree(cfg, rng, scale, shift=0.0):
    return {"b": jnp.asarray(shift + scale * rng.normal(), jnp.float32),
            "branch": _layers(rng, cfg.branch_dims, scale, shift),
            "trunk": _layers(rng, cfg.trunk_dims, scale, shift)}


def _vp(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"mu": _deeponet_tree(cfg, rng, 0.4), "rho": _deeponet_tree(cfg, rng, 0.1, -4.0)}


@pytest.mark.parametrize("noise_type,reduction", [(0, "sum"), (0, "mean_x_n"),
                                                  (1, "mean_x_n")])
def test_elbo_loss_with_learned_noise_matches_jax(noise_type, reduction):
    """Each member's negative ELBO (rtol 1e-6) with ``learn_noise``: a scalar
    log-variance (``noise_type=0``) or a per-point one (``noise_type=1``,
    the head's output, one per member); learn_noise without a noise raises
    in both."""
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(3, 4, 7)).astype(np.float32)
    target = rng.normal(size=(4, 7)).astype(np.float32)
    noise = (0.3 * rng.normal(size=(3, 4, 7)) if noise_type else
             np.full((3,), -0.7)).astype(np.float32)
    kw = dict(reduction=reduction, learn_noise=True, noise_type=noise_type)
    jcfg, tcfg = jelbo.ELBOConfig(**kw), telbo.ELBOConfig(**kw)
    t_noise = torch.as_tensor(noise) if noise_type else torch.tensor(-0.7)
    got = telbo.elbo_loss(tcfg, torch.as_tensor(pred), torch.as_tensor(target), 12.5, 0.7,
                          28_000, t_noise)
    for e in range(3):
        want = jelbo.elbo_loss(jcfg, jnp.asarray(pred[e]), jnp.asarray(target), 12.5, 0.7,
                               28_000, jnp.asarray(noise[e]))
        np.testing.assert_allclose(float(got[e]), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="learn_noise requires noise_param"):
        telbo.elbo_loss(tcfg, torch.as_tensor(pred), torch.as_tensor(target), 1.0, 1.0, 1)
    with pytest.raises(ValueError, match="learn_noise requires noise_param"):
        jelbo.elbo_loss(jcfg, jnp.asarray(pred[0]), jnp.asarray(target), 1.0, 1.0, 1)


@pytest.mark.parametrize("grid", ["shared", "per_example"])
def test_noise_head_forward_matches_jax(grid):
    """With ``noise_neurons=2`` the forward returns ``(y, noise)``: the mean
    head over the first K - 2 channels plus the bias, the noise head over the
    last 2 without it. From JAX's parameters (``torch_convert``), on a shared
    grid and on per-example points, the plain forward and the Bayesian one
    with JAX's weight normals: both outputs within rtol 1e-5, atol 1e-5.
    The flat layout is the one without the head."""
    jcfg, tcfg = JDCfg(**HETERO_KW), DeepONetConfig(**HETERO_KW)
    assert tcfg.num_params == DeepONetConfig(**TINY_KW).num_params == jcfg.num_params
    rng = np.random.default_rng(3)
    vp = _vp(jcfg, 3)
    bx = rng.normal(size=(3, 9)).astype(np.float32)
    tx = (rng.random(size=(6, 2)) if grid == "shared" else rng.random(size=(3, 6, 2))
          ).astype(np.float32)
    flat = torch.as_tensor(flat_from_tree(_np_tree(vp["mu"])))[None]
    got = deeponet_apply(tcfg, unravel_deeponet(tcfg, flat), torch.as_tensor(bx),
                         torch.as_tensor(tx))
    want = j_deeponet_apply(jcfg, vp["mu"], jnp.asarray(bx), jnp.asarray(tx))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    key = jax.random.key(4)
    eps = np.asarray(jax_deeponet_eps(key, jcfg, 2), np.float32)
    got = bayesian_deeponet_apply(tcfg, vp_from_jax(_np_tree(vp)), torch.as_tensor(bx),
                                  torch.as_tensor(tx), torch.as_tensor(eps))
    for e, ke in enumerate(jax.random.split(key, 2)):
        want = j_bdeeponet(jcfg, vp, jnp.asarray(bx), jnp.asarray(tx), ke)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[e].numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,noise_type", [(TINY_KW, 0), (HETERO_KW, 1)])
def test_three_adam_steps_with_learned_noise_match_jax(kw, noise_type):
    """Three VI steps with ``learn_noise`` on per-example points, JAX's
    ensemble normals injected: the loss (rtol 1e-5), ``noise_param`` (rtol
    1e-5, atol 1e-4 of ``lr_start``) and ``mu``/``rho`` (rtol 1e-6, atol
    1e-4 of ``lr_start``, as the port's three-step Adam test). Under
    ``noise_type=1`` the head's output is the variance and the scalar
    ``noise_param`` stays 0, as in JAX."""
    jcfg, tcfg = JDCfg(**kw), DeepONetConfig(**kw)
    vp = _vp(jcfg, 5)
    rng = np.random.default_rng(5)
    bx = rng.normal(size=(4, 9)).astype(np.float32)
    tx = rng.random(size=(4, 6, 2)).astype(np.float32)
    y = rng.normal(size=(4, 6)).astype(np.float32)
    jb = {"branch": jnp.asarray(bx), "trunk": jnp.asarray(tx), "y": jnp.asarray(y)}
    tb = {"branch": torch.as_tensor(bx), "trunk": torch.as_tensor(tx), "y": torch.as_tensor(y)}
    elbo_kw = dict(reduction="mean_x_n", learn_noise=True, noise_type=noise_type)
    vi_kw = dict(lr_start=1e-2, num_ens=2, prior_sigma=0.5)
    jvi = jtrain.VIConfig(elbo=jelbo.ELBOConfig(**elbo_kw), **vi_kw)
    tvi = VIConfig(elbo=telbo.ELBOConfig(**elbo_kw), **vi_kw)
    jstate = jtrain.init_train_state(vp, jvi)
    jstep = jtrain.make_train_step(j_vi_apply(jcfg), jvi, 96)
    tvp = vp_from_jax(_np_tree(vp))
    trainer = VITrainer(BayesianFlat(deeponet_vi_apply(tcfg), tvp["mu"], tvp["rho"]), tvi, 96)
    eps_fn = jax.jit(jax_deeponet_eps, static_argnums=(1, 2))
    for it in range(3):
        key = jax.random.key(60 + it)
        jstate, jloss = jstep(jstate, jb, key, 1.0)
        tloss = trainer.step(tb, eps=torch.as_tensor(np.asarray(eps_fn(key, jcfg, 2))))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(trainer.noise_param), float(jstate.noise_param),
                                   rtol=1e-5, atol=1e-4 * vi_kw["lr_start"])
        for name, param in (("mu", trainer.model.mu), ("rho", trainer.model.rho)):
            np.testing.assert_allclose(param.detach().numpy(),
                                       flat_from_tree(_np_tree(jstate.vp[name])),
                                       rtol=1e-6, atol=1e-4 * vi_kw["lr_start"])
    assert (float(trainer.noise_param) == 0.0) == (noise_type == 1)
    assert trainer.snapshot().noise_param == trainer.noise_param


def _burgers():
    data = j_get_burgers(jax.random.key(0), 8, 4, nx=9, nt=5)
    return tuple({k: np.asarray(v) for k, v in s.items()} for s in data)


@pytest.mark.parametrize("kw,noise_type", [(TINY_KW, 0), (HETERO_KW, 1)])
def test_operator_vi_with_learned_noise(kw, noise_type):
    """tests/test_noise_and_subsample.py:24-46 on the port: 3 epochs of
    operator VI with ``learn_noise`` (8 Burgers functions, 20 of 45 query
    points): the metric rows gain the ``exp(noise_param)`` column, every
    entry finite; the homoscedastic ``noise_param`` moved from 0 and the best
    state keeps the noise of its own epoch; the head's run trains too."""
    cfg = TC.OperatorVIRunConfig(
        model=DeepONetConfig(**kw), n_train=8, n_valid=4, batch_size=4, p=20,
        vi=VIConfig(epochs=3, lr_start=1e-3, num_ens=2, prior_sigma=0.1,
                    elbo=telbo.ELBOConfig(reduction="mean_x_n", learn_noise=True,
                                          noise_type=noise_type)))
    seen = []
    out = tvt.run_operator(cfg, seed=1, data=_burgers(), device="cpu",
                           callback=lambda e, row, t: seen.append(float(t.noise_param)))
    m = out["metrics"]
    assert m.shape == (3, 5) and np.isfinite(m).all()
    np.testing.assert_allclose(m[:, 4], np.exp(seen), rtol=1e-6)
    best = int(np.argmin(m[:, 1]))
    assert float(out["best_state"].noise_param) == seen[best]
    if noise_type == 0:
        assert float(out["state"].noise_param) != 0.0


def test_resumed_vi_with_learned_noise_equals_uninterrupted(tmp_path):
    """The functional trainer with ``learn_noise`` (the 'Blundell' KL
    schedule, per-example batches): 2 epochs into a checkpoint directory, then a
    restart to 4 epochs, equals 4 uninterrupted epochs exactly -- the
    variational parameters, ``noise_param`` and its Adam moments, the
    metric rows of epochs 2-3 with their noise column."""
    tcfg = DeepONetConfig(**TINY_KW)
    rng = np.random.default_rng(7)
    bx = torch.as_tensor(rng.normal(size=(8, 9)).astype(np.float32))
    tx = torch.as_tensor(rng.random(size=(8, 5, 2)).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=(8, 5)).astype(np.float32))

    def batches(gen, epoch):
        order = torch.randperm(8, generator=gen)
        return [{"branch": bx[i], "trunk": tx[i], "y": y[i]} for i in order.view(2, 4)]

    valid = {"branch": bx[:4], "trunk": tx[:4], "y": y[:4]}
    vp = vp_from_jax(_np_tree(_vp(JDCfg(**TINY_KW), 7)))

    def run(epochs, ckpt=None, restart=False):
        vi = VIConfig(epochs=epochs, lr_start=1e-2, num_ens=2, beta_type="Blundell",
                      elbo=telbo.ELBOConfig(reduction="mean_x_n", learn_noise=True))
        return train(deeponet_vi_apply(tcfg), init_train_state(vp, vi), vi, batches, valid,
                     valid, 40, generator=torch.Generator().manual_seed(3), ckpt_dir=ckpt,
                     restart=restart)

    full, _, rows = run(4)
    ckpt = str(tmp_path / "ck")
    run(2, ckpt)
    resumed, _, rows_r = run(4, ckpt, restart=True)
    assert rows.shape == (4, 5) and rows_r.shape == (2, 5)
    np.testing.assert_array_equal(rows_r, rows[2:])
    for k in ("mu", "rho"):
        assert torch.equal(resumed.vp[k], full.vp[k])
    assert torch.equal(resumed.noise_param, full.noise_param) and float(full.noise_param) != 0
    for a, b in ((resumed.opt_state.mu, full.opt_state.mu),
                 (resumed.opt_state.nu, full.opt_state.nu)):
        assert set(a) == {"mu", "rho", "noise"} and all(torch.equal(a[k], b[k]) for k in a)


def test_head_downstream_follows_jax():
    """Where JAX accepts or refuses a DeepONet with the head, the port does
    the same: the Gram field refuses it (ValueError in both); stage 3
    refuses it (JAX fails on the (y, noise) output, the port raises
    ValueError before sampling); sensitivity accepts it and scores the mean
    head (scores rtol 1e-4, atol 1e-6 of the largest)."""
    jcfg, tcfg = JDCfg(**HETERO_KW), DeepONetConfig(**HETERO_KW)
    train_np, valid_np = _burgers()
    d = tcfg.num_params
    with pytest.raises(ValueError, match="homoscedastic"):
        j_gram(jcfg, jnp.asarray(train_np["branch_in"]), jnp.asarray(train_np["trunk_in"]),
               jnp.asarray(train_np["solution"]), 1.0)
    with pytest.raises(ValueError, match="homoscedastic"):
        make_gram_grad_full(tcfg, torch.as_tensor(train_np["branch_in"]),
                            torch.as_tensor(train_np["trunk_in"]),
                            torch.as_tensor(train_np["solution"]), 1.0)
    rng = np.random.default_rng(8)
    mu = (0.05 * rng.normal(size=d)).astype(np.float32)
    sigma = (0.02 + 0.02 * rng.random(d)).astype(np.float32)
    arts = {"mu": mu, "sigma": sigma, "indices": np.sort(rng.choice(d, 12, replace=False))}
    kw = dict(num_samples=4, num_chains=1, step_size=1e-3)
    with pytest.raises(AttributeError):
        jv.run_operator(JC.VIHMCRunConfig(**kw), jcfg, arts, key=jax.random.key(1),
                        data=tuple({k: jnp.asarray(v) for k, v in s.items()}
                                   for s in (train_np, valid_np)))
    with pytest.raises(ValueError, match="heteroscedastic head"):
        tv.run_operator(VIHMCRunConfig(**kw), tcfg, arts, data=(train_np, valid_np),
                        device="cpu")
    idx = np.tile(np.arange(10)[None], (4, 1))   # the first 10 points of each example
    jsplit = {k: jnp.asarray(v) for k, v in valid_np.items()}
    jsplit_sub = dict(jsplit, trunk_in=jsplit["trunk_in"][idx],
                      solution=jnp.take_along_axis(jsplit["solution"], jnp.asarray(idx), 1))
    want = jsens.run_operator_flat(jnp.asarray(mu), jnp.asarray(sigma), jcfg, jsplit_sub,
                                   JC.SensitivityRunConfig(batch_chunk=2))
    got = tsens.run_operator_flat(mu, sigma, tcfg,
                                  {k: torch.as_tensor(v) for k, v in valid_np.items()},
                                  TC.SensitivityRunConfig(batch_chunk=2), trunk_idx=idx)
    ws = np.asarray(want["scores"])
    np.testing.assert_allclose(got["scores"], ws, rtol=1e-4, atol=1e-6 * ws.max())
    assert dataclasses.asdict(tcfg)["noise_neurons"] == 2
