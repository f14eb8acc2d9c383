"""PyTorch port parity: the stage-3 operator VI-HMC pipeline.

The subspace posterior (log-density, inverse mass, prior), one unpaired HMC
transition with JAX's own draws injected (lp0 recomputed in-step), the
posterior-predictive evaluation and its diagnostics, the run store and the
config, and ``run_operator`` end to end on the CPU at a tiny size in both
trajectory modes. Inputs are numpy arrays handed to both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import (assert_shared_fields_equal, one_torch_thread,  # noqa: F401
                                  tiny_problem)

import vihmc_torch.ops.deeponet_merge as tmerge
from vihmc_tpu.chains.diagnostics import summarize_np as j_summarize
from vihmc_tpu.hmc import HMCConfig as JConfig
from vihmc_tpu.hmc import clipped_grad_fn as j_clip
from vihmc_tpu.hmc import make_subspace_grad as j_sub_grad
from vihmc_tpu.hmc.kernel import init_state as j_init_state
from vihmc_tpu.hmc.kernel import make_kernel as j_make_kernel
from vihmc_tpu.io import RunStore as JStore
from vihmc_tpu.ops.gram_merge import make_gram_grad_full as j_gram
from vihmc_tpu.pipelines import configs as JC
from vihmc_tpu.pipelines import postprocess as jpost
from vihmc_tpu.pipelines import vi_hmc as jv
from vihmc_tpu.pipelines.common import make_deeponet_nll_log_posterior as j_make_lp
from vihmc_tpu.pipelines.common import make_flat_deeponet as j_make_flat
from vihmc_torch.chains.diagnostics import summarize_np
from vihmc_torch.chains.resume import sample_chains_resumable, segment_generator
from vihmc_torch.hmc.kernel import (HMCConfig, TransitionNoise, clipped_grad_fn,
                                    draw_noise, init_state, make_kernel)
from vihmc_torch.hmc.subspace import FrozenPolicy, make_aux_refresh, make_subspace_grad
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.ops.gram_merge import make_gram_grad_full
from vihmc_torch.pipelines import postprocess as tpost
from vihmc_torch.pipelines import vi_hmc as tv
from vihmc_torch.pipelines.common import (make_deeponet_nll_log_posterior,
                                          make_flat_deeponet)
from vihmc_torch.pipelines.configs import VIHMCRunConfig

TINY_DEEPONET_KW = dict(in_branch=9, in_trunk=5, width_branch=8, width_trunk=8,
                        depth_branch=3, depth_trunk=3)


def _artifacts(tp, seed):
    scores = (np.random.default_rng(seed).random(tp.mu.size) * 1e-4).astype(np.float32)
    return {"mu": tp.mu, "sigma": tp.sigma, "indices": tp.idx, "scores": scores}


def _posteriors(tp, cfg_kw, fused=True):
    """The subspace posterior on both sides; the port takes JAX's frozen draw."""
    arts = _artifacts(tp, 1)
    jcfg, tcfg = JC.VIHMCRunConfig(**cfg_kw), VIHMCRunConfig(**cfg_kw)
    bx, tx, y = jnp.asarray(tp.bx), jnp.asarray(tp.tx), jnp.asarray(tp.y)
    j_apply, _, _ = j_make_flat(tp.jcfg)
    j_ll = j_make_lp(tp.jcfg, bx, tx, y, tp.tau)[0] if fused else None
    jpost_ = jv.build_subspace_posterior(jcfg, lambda f: j_apply(f, bx, tx), y, arts,
                                         jax.random.key(3), full_ll=j_ll)
    t_apply = make_flat_deeponet(tp.tcfg)
    t_ll = (make_deeponet_nll_log_posterior(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau)
            if fused else None)
    tpost_ = tv.build_subspace_posterior(
        tcfg, lambda f: t_apply(f, tp.t("bx"), tp.t("tx")), tp.t("y"), arts,
        frozen=np.asarray(jpost_[1]), full_ll=t_ll, device="cpu")
    return jpost_, tpost_


@pytest.mark.parametrize("mass,fused", [("vi", True), ("laplace", True), ("unit", False)])
def test_build_subspace_posterior_matches_jax(mass, fused):
    """log_prob of 3 chains (rtol 1e-5), the inverse mass (VI variances,
    conditional Laplace, or 1; rtol 1e-6) and the prior (the VI posterior, or
    N(0, prior_var) when load_prior is off; rtol 1e-6), with the fused and
    the composed likelihood."""
    tp = tiny_problem(seed=20)
    cfg_kw = dict(frozen_policy="draw", loss="NLL", tau_out=tp.tau,
                  vi_mass=mass == "vi", laplace_mass=mass == "laplace",
                  laplace_n_data=tp.y.size, load_prior=mass != "unit", prior_var=0.3)
    (jlp, jaux, _, _, jprior, jim), (tlp, taux, spec, tprior, tim) = _posteriors(
        tp, cfg_kw, fused)
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    rng = np.random.default_rng(20)
    q = (tp.mu[tp.idx][None] + tp.sigma[tp.idx][None] * rng.normal(size=(3, len(tp.idx)))
         ).astype(np.float32)
    got = tlp(torch.as_tensor(q), taux)
    got_prior = tprior.log_prob(torch.as_tensor(q))
    for c in range(3):
        np.testing.assert_allclose(float(got[c]), float(jlp(jnp.asarray(q[c]), jaux)),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got_prior[c]), float(jprior.log_prob(jnp.asarray(q[c]))),
                                   rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tim, np.float32) * np.ones(len(tp.idx)),
                               np.asarray(jim) * np.ones(len(tp.idx)), rtol=1e-6)
    assert spec.subspace_dim == len(tp.idx)


def _jax_draws(key, d, aux_dim=None):
    """One JAX transition's draws with a diagonal metric: the split of
    kernel.py:494, the momentum normals of metric.py:216, the jitter
    (kernel.py:552) and accept (kernel.py:649) uniforms, and with ``aux_dim``
    the REFRESH hook's normals (``draw_full``, subspace.py:74)."""
    key_mom, key_u, key_aux, key_jit = jax.random.split(key, 4)
    out = (np.asarray(jax.random.normal(key_mom, (d,), jnp.float32)),
           float(jax.random.uniform(key_jit, ())), float(jax.random.uniform(key_u)))
    if aux_dim is not None:
        out += (np.asarray(jax.random.normal(key_aux, (aux_dim,), jnp.float32)),)
    return out


@pytest.mark.parametrize("field", ["gram_clipped", "autodiff"])
def test_unpaired_transition_with_injected_jax_draws(field):
    """Three fixed-step transitions of 4 chains on the fused density (the
    stage-3 path: sampler 'hmc', jitter_eps, the unpaired MH test) against the
    JAX kernel with its own draws injected: the same accept decisions, steps
    (rtol 1e-6), accept probabilities (atol 1e-4) and positions (rtol 1e-4,
    atol 5e-5). The trajectory runs on the clipped f32 Gram field, or on
    autograd of the density (value-and-grad leapfrog). The port's carried
    log_prob is poisoned before each step: lp0 must be recomputed in-step."""
    tp = tiny_problem(seed=21)
    d, c = len(tp.idx), 4
    cfg_kw = dict(frozen_policy="draw", loss="NLL", tau_out=tp.tau, vi_mass=True)
    (jlp, jaux, _, jspec, jprior, jim), (tlp, taux, spec, tprior, tim) = _posteriors(tp, cfg_kw)
    jfield = tfield = None
    if field == "gram_clipped":
        jg, _, _ = j_gram(tp.jcfg, jnp.asarray(tp.bx), jnp.asarray(tp.tx), jnp.asarray(tp.y),
                          tp.tau)
        jfield = j_clip(j_sub_grad(jg, jspec, prior=jprior), 40.0, inv_mass=jim)
        tg = make_gram_grad_full(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau)
        tfield = clipped_grad_fn(make_subspace_grad(tg, spec, prior=tprior), 40.0,
                                 inv_mass=tim)
    jcfg = JConfig(num_samples=3, num_leapfrog=4, step_size=1.5, sampler="hmc",
                   jitter_eps=True, jitter_low_frac=0.5)
    tcfg = HMCConfig(num_samples=3, num_leapfrog=4, step_size=1.5, sampler="hmc",
                     jitter_eps=True, jitter_low_frac=0.5)
    rng = np.random.default_rng(21)
    inits = (tp.mu[tp.idx][None] + 0.5 * tp.sigma[tp.idx][None]
             * rng.normal(size=(c, d))).astype(np.float32)
    jkernel = j_make_kernel(jlp, jcfg, inv_mass=jim, grad_fn=jfield)
    jstate = jax.vmap(lambda q: j_init_state(jlp, q, jcfg, aux=jaux, inv_mass=jim,
                                             grad_fn=jfield))(jnp.asarray(inits))
    tstate = init_state(tlp, torch.as_tensor(inits), tcfg, taux, tfield)
    np.testing.assert_allclose(tstate.log_prob.numpy(), np.asarray(jstate.log_prob), rtol=1e-5)
    np.testing.assert_allclose(tstate.grad.numpy(), np.asarray(jstate.grad), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(jstate.grad)).max()))
    tkernel = make_kernel(tcfg, tim, tfield, None, tlp)
    step = jax.vmap(jkernel, in_axes=(0, 0, None))
    n_accept = 0
    for it in range(3):
        keys = jax.random.split(jax.random.key(200 + it), c)
        draws = [_jax_draws(k, d) for k in keys]
        noise = TransitionNoise(z1=torch.as_tensor(np.stack([x[0] for x in draws])), z2=None,
                                u_jitter=torch.tensor([x[1] for x in draws]),
                                u_accept=torch.tensor([x[2] for x in draws]))
        jstate, jinfo = step(jstate, keys, it)
        tstate = dataclasses.replace(tstate, log_prob=tstate.log_prob + 1e3)  # poison
        tstate, tinfo = tkernel(tstate, noise)
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
        np.testing.assert_allclose(tinfo["step_size"].numpy(), np.asarray(jinfo["step_size"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tinfo["accept_prob"].numpy(),
                                   np.asarray(jinfo["accept_prob"]), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(tstate.position.numpy(), np.asarray(jstate.position),
                                   rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(tinfo["log_prob"].numpy(), np.asarray(jinfo["log_prob"]),
                                   rtol=1e-5)
        n_accept += int(tinfo["accepted"].sum())
    assert 0 < n_accept < 3 * c  # both branches of the MH test were taken


@pytest.mark.parametrize("field", ["gram_clipped", "autodiff"])
def test_refresh_transition_with_injected_jax_draws(field, one_torch_thread):
    """Three REFRESH transitions of 4 chains on the fused density against the
    JAX kernel vmapped over chains with its own draws injected (momenta,
    uniforms and the refresh normals): each chain's new frozen vector (rtol
    1e-7: the same ``mu + sigma z`` in f32), the accept decisions, steps (rtol
    1e-6), accept probabilities (atol 1e-4), positions (rtol 1e-4, atol 5e-5)
    and log-densities (rtol 1e-5). The port's carried log_prob and gradient
    are poisoned before each step: both must be recomputed at the new frozen
    vectors."""
    tp = tiny_problem(seed=26)
    d, c, big_d = len(tp.idx), 4, tp.mu.size
    cfg_kw = dict(frozen_policy="refresh", loss="NLL", tau_out=tp.tau, vi_mass=True)
    (jlp, jaux, jrefresh, jspec, jprior, jim), (tlp, taux, spec, tprior, tim) = _posteriors(
        tp, cfg_kw)
    assert jrefresh is not None
    jfield = tfield = None
    if field == "gram_clipped":
        jg, _, _ = j_gram(tp.jcfg, jnp.asarray(tp.bx), jnp.asarray(tp.tx), jnp.asarray(tp.y),
                          tp.tau)
        jfield = j_clip(j_sub_grad(jg, jspec, prior=jprior), 40.0, inv_mass=jim)
        tg = make_gram_grad_full(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau)
        tfield = clipped_grad_fn(make_subspace_grad(tg, spec, prior=tprior), 40.0,
                                 inv_mass=tim)
    jcfg = JConfig(num_samples=3, num_leapfrog=4, step_size=1.5, sampler="hmc",
                   jitter_eps=True, jitter_low_frac=0.5)
    tcfg = HMCConfig(num_samples=3, num_leapfrog=4, step_size=1.5, sampler="hmc",
                     jitter_eps=True, jitter_low_frac=0.5)
    rng = np.random.default_rng(26)
    inits = (tp.mu[tp.idx][None] + 0.5 * tp.sigma[tp.idx][None]
             * rng.normal(size=(c, d))).astype(np.float32)
    jkernel = j_make_kernel(jlp, jcfg, inv_mass=jim, aux_refresh=jrefresh, grad_fn=jfield)
    jstate = jax.vmap(lambda q: j_init_state(jlp, q, jcfg, aux=jaux, inv_mass=jim,
                                             grad_fn=jfield))(jnp.asarray(inits))
    tstate = init_state(tlp, torch.as_tensor(inits), tcfg, taux, tfield)
    tkernel = make_kernel(tcfg, tim, tfield, None, tlp,
                          aux_refresh=make_aux_refresh(spec, FrozenPolicy.REFRESH))
    step = jax.vmap(jkernel, in_axes=(0, 0, None))
    n_accept = 0
    for it in range(3):
        keys = jax.random.split(jax.random.key(300 + it), c)
        draws = [_jax_draws(k, d, big_d) for k in keys]
        noise = TransitionNoise(z1=torch.as_tensor(np.stack([x[0] for x in draws])), z2=None,
                                u_jitter=torch.tensor([x[1] for x in draws]),
                                u_accept=torch.tensor([x[2] for x in draws]),
                                z_aux=torch.as_tensor(np.stack([x[3] for x in draws])))
        jstate, jinfo = step(jstate, keys, it)
        tstate = dataclasses.replace(tstate, log_prob=tstate.log_prob + 1e3,
                                     grad=tstate.grad * 7.0 + 1.0)  # poison
        tstate, tinfo = tkernel(tstate, noise)
        assert tstate.aux.shape == (c, big_d)
        np.testing.assert_allclose(tstate.aux.numpy(), np.asarray(jstate.aux), rtol=1e-7)
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
        np.testing.assert_allclose(tinfo["step_size"].numpy(), np.asarray(jinfo["step_size"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tinfo["accept_prob"].numpy(),
                                   np.asarray(jinfo["accept_prob"]), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(tstate.position.numpy(), np.asarray(jstate.position),
                                   rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(tinfo["log_prob"].numpy(), np.asarray(jinfo["log_prob"]),
                                   rtol=1e-5)
        n_accept += int(tinfo["accepted"].sum())
    assert 0 < n_accept < 3 * c
    assert not torch.equal(tstate.aux[0], tstate.aux[1])  # each chain its own


def test_refresh_normals_come_after_the_transition_draws():
    """draw_noise without a refresh consumes the generator as the DRAW path
    always has (the momentum normals, then the two uniforms); with a refresh
    hook it gives the same draws and then the hook's. A DRAW run of
    sample_chains_resumable equals a transition loop fed exactly those
    draws, so the REFRESH code leaves DRAW and MEAN streams as they were; a
    REFRESH run equals one fed those draws and then (C, D) normals."""
    c, d, big_d = 3, 5, 11
    im = torch.linspace(0.5, 2.0, d)
    plain = draw_noise(torch.Generator().manual_seed(4), im, c, d, "cpu")
    gen = torch.Generator().manual_seed(4)
    z1, u = torch.randn((c, d), generator=gen), torch.rand((2, c), generator=gen)
    z_aux = torch.randn((c, big_d), generator=gen)
    with_aux = draw_noise(torch.Generator().manual_seed(4), im, c, d, "cpu",
                          aux_draw=lambda g: torch.randn((c, big_d), generator=g))
    for nz in (plain, with_aux):
        assert torch.equal(nz.z1, z1) and torch.equal(nz.u_jitter, u[0])
        assert torch.equal(nz.u_accept, u[1])
    assert plain.z_aux is None and torch.equal(with_aux.z_aux, z_aux)

    def log_prob(q, aux):
        return -0.5 * ((q - aux[..., :d]) ** 2 / im).sum(-1)

    cfg = HMCConfig(num_samples=6, num_leapfrog=3, step_size=0.4, sampler="hmc",
                    jitter_eps=True)
    aux = torch.linspace(-1, 1, big_d)
    q0 = torch.zeros((c, d))
    res = sample_chains_resumable(log_prob, q0, cfg, 3, im, aux, seed=9)
    kernel = make_kernel(cfg, im, None, None, log_prob)
    state = init_state(log_prob, q0, cfg, aux)
    kept = []
    for seg in range(2):
        gen = segment_generator("cpu", 9, seg)
        for _ in range(3):
            z1, u = torch.randn((c, d), generator=gen), torch.rand((2, c), generator=gen)
            state, _ = kernel(state, TransitionNoise(z1=z1, z2=None, u_jitter=u[0],
                                                     u_accept=u[1]))
            kept.append(state.position)
    np.testing.assert_array_equal(res.samples, torch.stack(kept, 1).numpy())
    assert torch.equal(res.final_state.aux, aux)

    # REFRESH: the default refresh draw is (C, D) normals after those draws
    def refresh(z):
        return z

    res = sample_chains_resumable(log_prob, q0, cfg, 3, im, aux, seed=9, aux_refresh=refresh)
    kernel = make_kernel(cfg, im, None, None, log_prob, aux_refresh=refresh)
    state = init_state(log_prob, q0, cfg, aux)
    kept = []
    for seg in range(2):
        gen = segment_generator("cpu", 9, seg)
        for _ in range(3):
            z1, u = torch.randn((c, d), generator=gen), torch.rand((2, c), generator=gen)
            z_aux = torch.randn((c, big_d), generator=gen)
            state, _ = kernel(state, TransitionNoise(z1=z1, z2=None, u_jitter=u[0],
                                                     u_accept=u[1], z_aux=z_aux))
            kept.append(state.position)
    np.testing.assert_array_equal(res.samples, torch.stack(kept, 1).numpy())
    assert torch.equal(res.final_state.aux, z_aux)


@pytest.mark.parametrize("policy", ["mean", "draw", "refresh"])
def test_frozen_policies_initial_vectors_match_jax(policy):
    """The initial frozen vector: the VI mean under MEAN (as JAX), the given
    draw under DRAW and REFRESH; a refresh hook only under REFRESH."""
    tp = tiny_problem(seed=27)
    cfg_kw = dict(frozen_policy=policy, loss="NLL", tau_out=tp.tau)
    (_, jaux, jrefresh, _, _, _), (_, taux, spec, _, _) = _posteriors(tp, cfg_kw)
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    if policy == "mean":
        np.testing.assert_array_equal(taux.numpy(), tp.mu)
    hook = make_aux_refresh(spec, FrozenPolicy(policy))
    assert (hook is None) == (jrefresh is None)


@pytest.mark.parametrize("base", ["shared", "per_chain"])
def test_evaluate_samples_matches_jax(base):
    """The same (C, S, d) samples and frozen base on both sides: every metric
    (rtol 1e-5), the kept predictions and the mean prediction (rtol 1e-5,
    atol 1e-6), with the pooled-sample cap thinning; summarize_np bit-equal
    to the JAX copy on the same samples."""
    tp = tiny_problem(seed=22)
    cfg_kw = dict(num_samples=6, burn=2, frozen_policy="draw", loss="NLL", tau_out=tp.tau)
    jcfg, tcfg = JC.VIHMCRunConfig(**cfg_kw), VIHMCRunConfig(**cfg_kw)
    rng = np.random.default_rng(22)
    c, s, d = 3, 6, len(tp.idx)
    samples = (tp.mu[tp.idx] + tp.sigma[tp.idx] * rng.normal(size=(c, s, d))).astype(np.float32)
    frozen = tp.frozen if base == "shared" else (
        tp.frozen[None] + 0.01 * rng.normal(size=(c, tp.mu.size))).astype(np.float32)
    j_apply, _, _ = j_make_flat(tp.jcfg)
    t_apply = make_flat_deeponet(tp.tcfg)
    want = jv.evaluate_samples(jcfg, tp.jspec, tp.jprior,
                               lambda f: j_apply(f, jnp.asarray(tp.bx), jnp.asarray(tp.tx)),
                               jnp.asarray(tp.y), samples, keep_predictions=5,
                               max_metric_samples=10, frozen_base=jnp.asarray(frozen))
    got = tv.evaluate_samples(tcfg, tp.tspec, tp.tprior,
                              lambda f: t_apply(f, tp.t("bx"), tp.t("tx")), tp.t("y"),
                              samples, keep_predictions=5, max_metric_samples=10,
                              frozen_base=torch.as_tensor(frozen))
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(np.asarray(got["metrics"][k]), np.asarray(v), rtol=1e-5)
    for k in ("predictions", "mean_prediction"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6)
    assert got["predictions"].shape == (5, *tp.y.shape)
    assert sorted(got["diagnostics"]) == sorted(want["diagnostics"])
    for k, v in want["diagnostics"].items():
        np.testing.assert_array_equal(np.asarray(got["diagnostics"][k]), np.asarray(v))


def test_summarize_np_and_error_metrics_are_bit_equal():
    """summarize_np (with the rank-dim subset) and the stage-3 error metrics
    give the JAX package's exact numbers on the same arrays."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(3, 40, 30)).cumsum(1)
    for kw in ({}, {"rank_dims": 12}, {"rank_normalized": False}):
        want, got = j_summarize(x, **kw), summarize_np(x, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    preds = rng.normal(size=(6, 4, 5 * 9))
    truth = rng.normal(size=(4, 5 * 9))
    lp = rng.normal(size=6)
    for fn, args in ((lambda m: m.error_report(preds, truth, log_probs=lp), ()),
                     (lambda m: m.error_sigma_correlation(preds, truth, nt=5, nx=9), ())):
        want, got = fn(jpost), fn(tpost)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    np.testing.assert_array_equal(tpost.l2_relative_error(preds, truth[None]),
                                  jpost.l2_relative_error(preds, truth[None]))


def test_predictive_metrics_match_jax():
    """predictive_metrics over stacked predictions (with and without
    log-probs) and posterior_predictive in chunks: rtol 1e-6 of the JAX
    functions on the same arrays."""
    from vihmc_tpu.pipelines import predict as jpred
    from vihmc_torch.pipelines import predict as tpred

    rng = np.random.default_rng(25)
    preds = rng.normal(size=(7, 4, 9)).astype(np.float32)
    y = rng.normal(size=(4, 9)).astype(np.float32)
    lps = rng.normal(size=7).astype(np.float32)
    for lp in (None, lps):
        want = jpred.predictive_metrics(jnp.asarray(preds), jnp.asarray(y),
                                        None if lp is None else jnp.asarray(lp))
        got = tpred.predictive_metrics(torch.as_tensor(preds), torch.as_tensor(y),
                                       None if lp is None else torch.as_tensor(lp))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    rows = rng.normal(size=(7, 3)).astype(np.float32)
    w = rng.normal(size=(3, 5)).astype(np.float32)
    j_lp, j_pred = jpred.posterior_predictive(
        lambda r: (jnp.sum(r), r @ jnp.asarray(w)), jnp.asarray(rows), chunk_size=3)
    t_lp, t_pred = tpred.posterior_predictive(
        lambda r: (r.sum(-1), r @ torch.as_tensor(w)), torch.as_tensor(rows), chunk_size=3)
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=1e-6)
    np.testing.assert_allclose(t_pred.numpy(), np.asarray(j_pred), rtol=1e-6)


def test_run_store_layout_matches_jax(tmp_path):
    """A run directory written by either package loads in the other: arrays
    as .npy, the config as JSON."""
    cfg = VIHMCRunConfig(num_samples=7, clip_grad=3.5)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    st = RunStore(str(tmp_path), uid="port_run")
    st.save_array("hmc_params", a)
    st.save_config(cfg)
    js = JStore.open(str(tmp_path), "port_run")
    np.testing.assert_array_equal(js.load_array("hmc_params"), a)
    assert js.load_config() == dataclasses.asdict(cfg)
    js2 = JStore(str(tmp_path), uid="jax_run")
    js2.save_array("sample_mse", a[0])
    js2.save_config(JC.VIHMCRunConfig(num_samples=7, clip_grad=3.5))
    back = RunStore.open(str(tmp_path), "jax_run")
    np.testing.assert_array_equal(back.load_array("sample_mse"), a[0])
    assert back.load_config() == dataclasses.asdict(cfg)
    with pytest.raises(FileNotFoundError):
        RunStore.open(str(tmp_path), "missing")


def test_vihmc_config_matches_jax():
    """Every field and default of VIHMCRunConfig, and the derived L and burn."""
    jf = {f.name: f.default for f in dataclasses.fields(JC.VIHMCRunConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(VIHMCRunConfig)}
    assert tf == jf
    for kw in ({}, {"num_leapfrog": 31}, {"burn": 7, "step_size": 1e-4, "post_std": 0.0214}):
        j, t = JC.VIHMCRunConfig(**kw), VIHMCRunConfig(**kw)
        assert (t.L, t.burn_) == (j.L, j.burn_)


@pytest.mark.parametrize("field,value", [("sample_data", True), ("save_vi_trace", True)])
def test_run_operator_raises_on_unported_settings(field, value):
    """Settings the port does not run yet raise NotImplementedError before
    any data is touched."""
    cfg = dataclasses.replace(VIHMCRunConfig(frozen_policy="draw"), **{field: value})
    with pytest.raises(NotImplementedError, match="not ported"):
        tv.run_operator(cfg, DeepONetConfig(), {}, device="cpu")


@pytest.fixture(scope="module")
def tiny_burgers_run():
    """The tiny Burgers data of tests/test_pipelines.py:35-39 and JAX's
    run_operator on it with the fused density (for its metric keys)."""
    from vihmc_tpu.data import get_burgers
    from vihmc_tpu.models import DeepONetConfig as JCfg

    data = get_burgers(jax.random.key(0), 8, 4, nx=9, nt=5)
    d = DeepONetConfig(**TINY_DEEPONET_KW).num_params
    rng = np.random.default_rng(24)
    arts = {"mu": (0.05 * rng.normal(size=d)).astype(np.float32),
            "sigma": (0.02 + 0.05 * rng.random(d)).astype(np.float32),
            "indices": np.sort(rng.choice(d, size=12, replace=False))}
    cfg_kw = dict(num_samples=12, step_size=1e-3, post_std=0.02, num_chains=2,
                  num_leapfrog=4, loss="NLL", tau_out=1.0, frozen_policy="draw",
                  vi_mass=True, clip_grad=13.0 * 12 ** 0.5, jitter_eps=True,
                  jitter_low_frac=0.5)
    jout = jv.run_operator(JC.VIHMCRunConfig(**cfg_kw), JCfg(**TINY_DEEPONET_KW), arts,
                           key=jax.random.key(1), data=data, use_fused=True,
                           segment_size=6, sample_thin=3)
    np_data = tuple({k: np.asarray(v) for k, v in s.items()} for s in data)
    return np_data, arts, cfg_kw, jout


@pytest.mark.parametrize("use_gram", [None, False])
def test_run_operator_end_to_end_on_cpu(tiny_burgers_run, use_gram, monkeypatch, tmp_path,
                                        one_torch_thread):
    """run_operator(device='cpu', use_fused=True) on the tiny Burgers data,
    with the Gram field (use_gram None resolves to it) and with autograd
    through the fused density: finite samples and metrics with JAX's metric
    keys and sample shape; the fused density is evaluated 1 + 2 * draws times
    on the Gram path (init, then lp0 and lp1 per draw) and
    2 + draws * (L + 2) times on the autograd path (each clipped trajectory
    gradient runs the forward too); the store holds the samples."""
    data, arts, cfg_kw, jout = tiny_burgers_run
    calls = []
    real = tmerge.merge_sums_reference

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tmerge, "merge_sums_reference", counted)
    cfg = VIHMCRunConfig(**cfg_kw)
    store = RunStore(str(tmp_path), uid="run")
    out = tv.run_operator(cfg, DeepONetConfig(**TINY_DEEPONET_KW), arts, data=data,
                          store=store, use_fused=True, use_gram=use_gram, segment_size=6,
                          sample_thin=3, device="cpu")
    draws, n_lf = cfg.num_samples, cfg.L
    want_calls = 1 + 2 * draws if use_gram is None else 2 + draws * (n_lf + 2)
    n_eval = len(calls)
    assert n_eval == want_calls, (n_eval, want_calls)
    res = out["result"]
    assert res.samples.shape == np.asarray(jout["result"].samples).shape == (2, 4, 12)
    assert np.isfinite(res.samples).all()
    assert 0.0 < res.acceptance_rate <= 1.0
    assert sorted(out["metrics"]) == sorted(jout["metrics"])
    assert all(np.isfinite(v).all() for v in out["metrics"].values())
    assert out["predictions"].shape[1:] == np.asarray(jout["predictions"]).shape[1:]
    assert np.isfinite(out["ess"]).all()
    assert set(out["phases_s"]) == {"data_s", "setup_s", "sampling_s", "evaluate_s"}
    np.testing.assert_array_equal(store.load_array("hmc_params"), res.samples)
    assert store.load_config()["num_samples"] == draws


@pytest.mark.parametrize("policy", ["refresh", "mean"])
def test_run_operator_frozen_policies_on_cpu(tiny_burgers_run, policy, monkeypatch,
                                            one_torch_thread):
    """run_operator(device='cpu', use_fused=True) on the tiny Burgers data
    under REFRESH and MEAN with the Gram field: finite samples and metrics
    with JAX's metric keys; the fused density still runs 1 + 2 x draws times
    (under REFRESH the recompute at the new frozen vectors replaces the
    unpaired recompute) and the Gram field 1 + draws x (L + 1) times under
    REFRESH, 1 + draws x L under MEAN; REFRESH leaves every chain its own
    final frozen vector, MEAN the VI mean."""
    data, arts, cfg_kw, jout = tiny_burgers_run
    calls, grads = [], []
    real = tmerge.merge_sums_reference

    def counted(*a):
        calls.append(1)
        return real(*a)

    real_gram = tv.make_gram_grad_full

    def counted_gram(*a, **kw):
        field = real_gram(*a, **kw)

        def wrapped(full):
            grads.append(1)
            return field(full)

        return wrapped

    monkeypatch.setattr(tmerge, "merge_sums_reference", counted)
    monkeypatch.setattr(tv, "make_gram_grad_full", counted_gram)
    cfg = VIHMCRunConfig(**dict(cfg_kw, frozen_policy=policy))
    out = tv.run_operator(cfg, DeepONetConfig(**TINY_DEEPONET_KW), arts, data=data,
                          use_fused=True, segment_size=6, sample_thin=3, device="cpu")
    draws, n_lf = cfg.num_samples, cfg.L
    assert len(calls) == 1 + 2 * draws
    assert len(grads) == 1 + draws * (n_lf + (policy == "refresh"))
    res = out["result"]
    assert res.samples.shape == (2, 4, 12) and np.isfinite(res.samples).all()
    assert 0.0 < res.acceptance_rate <= 1.0
    assert sorted(out["metrics"]) == sorted(jout["metrics"])
    assert all(np.isfinite(v).all() for v in out["metrics"].values())
    aux = res.final_state.aux
    if policy == "refresh":
        assert aux.shape == (2, arts["mu"].size) and not torch.equal(aux[0], aux[1])
    else:
        np.testing.assert_array_equal(aux.numpy(), arts["mu"])


def test_run_nn_end_to_end_on_cpu(tiny_burgers_run, one_torch_thread):
    """The NN stage 3 on the nn_stage12_r2 bundle with the default config's
    REFRESH policy and analytic L = 196 (draws and chains cut): JAX's metric
    keys (``evaluate_samples`` is shared by both workloads), finite samples
    and metrics, per-chain frozen vectors, the data of regression_data, and
    JAX's ValueError for the operator-only Gram settings."""
    from vihmc_torch.data.burgers import ASSETS
    from vihmc_torch.models.mlp import MLPConfig

    jout = tiny_burgers_run[3]
    with np.load(f"{ASSETS}/nn_stage12_r2.npz") as z:
        arts = {k: z[k] for k in ("mu", "sigma", "indices")}
    cfg_kw = dict(num_samples=6, num_chains=3)
    assert VIHMCRunConfig(**cfg_kw).L == JC.VIHMCRunConfig(**cfg_kw).L == 196
    assert VIHMCRunConfig().frozen_policy == "refresh"
    out = tv.run_nn(VIHMCRunConfig(**cfg_kw), MLPConfig(), arts, seed=2, device="cpu")
    res = out["result"]
    assert res.samples.shape == (3, 6, 77)
    assert np.isfinite(res.samples).all() and 0.0 <= res.acceptance_rate <= 1.0
    assert sorted(out["metrics"]) == sorted(jout["metrics"])
    assert all(np.isfinite(v).all() for v in out["metrics"].values())
    assert res.final_state.aux.shape == (3, 141)
    assert out["data"]["x_train"].shape == (20, 1) and out["data"]["y_val"].shape == (300, 1)
    with pytest.raises(ValueError):
        tv.run_nn(VIHMCRunConfig(coarse_stride=2), MLPConfig(), arts, device="cpu")


def test_grid_stride_subset_and_grid_shape_match_jax():
    """infer_grid_shape of t-major grids (and its errors) and
    grid_stride_subset for several strides: equal to JAX's."""
    from vihmc_tpu.ops.gram_merge import grid_stride_subset as j_sub
    from vihmc_tpu.ops.gram_merge import infer_grid_shape as j_shape
    from vihmc_torch.ops.gram_merge import grid_stride_subset, infer_grid_shape

    for nt, nx in ((5, 9), (101, 101), (4, 1)):
        tp = tiny_problem(seed=50, nt=nt, nx=nx)
        want = (nt, nx)
        assert infer_grid_shape(tp.t("tx")) == infer_grid_shape(tp.tx) == j_shape(tp.tx) == want
        for stride in (1, 2, 3, 7):
            np.testing.assert_array_equal(grid_stride_subset(nt, nx, stride),
                                          np.asarray(j_sub(nt, nx, stride)))
    assert len(grid_stride_subset(101, 101, 3)) == 34 * 34
    bad = np.array([[0.0, 0.0], [0.0, 0.5], [0.5, 0.0], [0.6, 0.5]], np.float32)
    for grid in (bad, bad[:3]):
        with pytest.raises(ValueError):
            infer_grid_shape(grid)
        with pytest.raises(ValueError):
            j_shape(grid)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 5e-2)])
def test_stride_gram_field_with_prior_matches_jax(dtype, tol):
    """make_gram_grad_full on query and function subsets with the rescale and
    a full-vector prior's gradient, on 2 chains, against JAX's (relative to
    the gradient's max-abs scale: f32 2e-4; bf16 stacks round every
    activation to 8 bits, 5e-2 and cosine > 0.999); in f32 it is also the
    autograd gradient of the rescaled likelihood on the subsets."""
    from vihmc_tpu.dists.priors import IsotropicGaussianPrior as JIso
    from vihmc_torch.dists.priors import IsotropicGaussianPrior
    from vihmc_torch.ops.gram_merge import grid_stride_subset

    tp = tiny_problem(seed=51, n_fn=9, nt=5, nx=7)
    sub = grid_stride_subset(5, 7, 2)
    fns = np.arange(0, 9, 3)
    rng = np.random.default_rng(51)
    flats = (tp.mu[None] + tp.sigma[None] * rng.normal(size=(2, tp.mu.size))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    jg, _, _ = j_gram(tp.jcfg, jnp.asarray(tp.bx), jnp.asarray(tp.tx), jnp.asarray(tp.y), tp.tau,
                      prior=JIso(scale=0.7), query_subset=sub, fn_subset=fns, compute_dtype=jdt)
    tg = make_gram_grad_full(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau,
                             compute_dtype=tdt, query_subset=sub, fn_subset=fns,
                             prior=IsotropicGaussianPrior(scale=0.7))
    got = tg(torch.as_tensor(flats))
    assert got.dtype == torch.float32 and got.shape == flats.shape
    for c in range(2):
        want = np.asarray(jg(jnp.asarray(flats[c])))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[c].numpy() / scale, want / scale, rtol=tol, atol=tol)
        cos = np.dot(got[c].numpy(), want) / (np.linalg.norm(want) * np.linalg.norm(got[c].numpy()))
        assert cos > 0.999
    if dtype == "float32":
        from vihmc_torch.dists.likelihoods import nll_log_likelihood

        flat = torch.as_tensor(flats).requires_grad_(True)
        bx, tx, y = tp.t("bx")[fns], tp.t("tx")[sub], tp.t("y")[fns][:, sub]
        pred = make_flat_deeponet(tp.tcfg)(flat, bx, tx)
        scale_ll = (tp.y.shape[0] / len(fns)) * (tp.y.shape[1] / len(sub))
        lp = scale_ll * nll_log_likelihood(pred, y, tp.tau) - 0.5 * (flat ** 2).sum(-1) / 0.49
        (auto,) = torch.autograd.grad(lp.sum(), flat)
        m = auto.abs().max()
        np.testing.assert_allclose((got / m).numpy(), (auto / m).numpy(), rtol=1e-4, atol=1e-4)


def test_gaussian_field_grad_matches_jax():
    """The VI-Gaussian score field (alpha 1 and 0.5) on 3 chains: rtol 1e-6."""
    from vihmc_tpu.hmc import gaussian_field_grad as j_gauss
    from vihmc_torch.hmc.kernel import gaussian_field_grad

    rng = np.random.default_rng(52)
    mu = rng.normal(size=11).astype(np.float32)
    sigma = (0.1 + rng.random(11)).astype(np.float32)
    q = rng.normal(size=(3, 11)).astype(np.float32)
    for alpha in (1.0, 0.5):
        got = gaussian_field_grad(torch.as_tensor(mu), torch.as_tensor(sigma), alpha)(
            torch.as_tensor(q), None)
        jf = j_gauss(jnp.asarray(mu), jnp.asarray(sigma), alpha)
        for c in range(3):
            np.testing.assert_allclose(got[c].numpy(), np.asarray(jf(jnp.asarray(q[c]))),
                                       rtol=1e-6)


class _Captured(Exception):
    """Stops a pipeline at its sampler call once the arguments are recorded."""


PORTED_SETTINGS = {
    "gauss_field": dict(gauss_field=1.0),
    "lowrank_rank": dict(lowrank_rank=3),
    "coarse_stride": dict(coarse_stride=2),
    "fn_stride": dict(fn_stride=2),
    "jitter_l": dict(jitter_l=True, jitter_eps=False),
    "adapt_step_size": dict(adapt_step_size=True, target_accept=0.7, max_step=0.01,
                            da_axis="chains", adapt_forever=True),
    "loss": dict(loss="regression"),
}


@pytest.mark.parametrize("setting", sorted(PORTED_SETTINGS))
def test_run_operator_ported_settings_match_jax(tiny_burgers_run, setting, monkeypatch,
                                                one_torch_thread):
    """Each stage-3 setting the port now runs, on the tiny Burgers data with
    the fused density: both pipelines are stopped at their sampler call and
    hand it the same HMCConfig (every shared field), the same inits, frozen vector,
    log-density (rtol 1e-5) and trajectory field (rtol 2e-4 of its scale) at
    the inits, and the same metric (a low-rank one from JAX's Lanczos start
    vector: U U^T to 2e-3 of its scale). Then the port runs the setting to
    the end: finite samples and metrics with JAX's keys."""
    import vihmc_tpu.chains as jchains

    data, arts, cfg_kw, jout = tiny_burgers_run
    kw = dict(cfg_kw, **PORTED_SETTINGS[setting])
    seen = {}

    def capture(side):
        def fake(*args, **kwargs):
            seen[side] = (args, kwargs)
            raise _Captured

        return fake

    from vihmc_tpu.models import DeepONetConfig as JCfg

    jdata = tuple({k: jnp.asarray(v) for k, v in s.items()} for s in data)
    monkeypatch.setattr(jchains, "sample_chains_resumable", capture("jax"))
    with pytest.raises(_Captured):
        jv.run_operator(JC.VIHMCRunConfig(**kw), JCfg(**TINY_DEEPONET_KW), arts,
                        key=jax.random.key(1), data=jdata, use_fused=True, segment_size=6,
                        sample_thin=3)
    (jlp, jinits, _, jcfg), jkw = seen["jax"]
    _, ks = jax.random.split(jax.random.key(1))
    k_frozen = jax.random.split(ks, 4)[0]
    d = len(arts["indices"])
    v0 = np.asarray(jax.random.normal(jax.random.fold_in(k_frozen, 0x10E), (d,)))
    monkeypatch.setattr(tv, "sample_chains_resumable", capture("torch"))
    cfg = VIHMCRunConfig(**kw)
    with pytest.raises(_Captured):
        tv.run_operator(cfg, DeepONetConfig(**TINY_DEEPONET_KW), arts, data=data,
                        use_fused=True, segment_size=6, sample_thin=3,
                        frozen=np.asarray(jkw["aux"]), lanczos_v0=torch.as_tensor(v0),
                        device="cpu")
    (tlp, tinits, tcfg, seg, tim, taux), tkw = seen["torch"]
    assert_shared_fields_equal(tcfg, jcfg)
    assert seg == jkw["segment_size"] and tkw["thin"] == jkw["thin"]
    np.testing.assert_array_equal(tinits.numpy(), np.asarray(jinits))
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jkw["aux"]))
    jim = jkw["inv_mass"]
    if setting == "lowrank_rank":
        np.testing.assert_allclose(tim.diag_mass.numpy(), np.asarray(jim.diag_mass), rtol=1e-6)
        uu_j = np.asarray(jim.u) @ np.asarray(jim.u).T
        uu_t = (tim.u @ tim.u.T).numpy()
        np.testing.assert_allclose(uu_t / np.abs(uu_j).max(), uu_j / np.abs(uu_j).max(),
                                   rtol=0, atol=2e-3)
    else:
        np.testing.assert_allclose(np.asarray(tim) * np.ones(d), np.asarray(jim) * np.ones(d),
                                   rtol=1e-6)
    lp_t = tlp(tinits, taux)
    g_t = tkw["grad_fn"](tinits, taux)
    for c in range(tinits.shape[0]):
        q = jnp.asarray(np.asarray(jinits)[c])
        np.testing.assert_allclose(float(lp_t[c]), float(jlp(q, jkw["aux"])), rtol=1e-5)
        want = np.asarray(jkw["grad_fn"](q, jkw["aux"]))
        scale = np.abs(want).max()
        np.testing.assert_allclose(g_t[c].numpy() / scale, want / scale, rtol=2e-4, atol=2e-4)
    monkeypatch.undo()
    out = tv.run_operator(cfg, DeepONetConfig(**TINY_DEEPONET_KW), arts, data=data,
                          use_fused=True, segment_size=6, sample_thin=3, device="cpu")
    res = out["result"]
    assert res.samples.shape == (2, 4, 12) and np.isfinite(res.samples).all()
    assert sorted(out["metrics"]) == sorted(jout["metrics"])
    assert all(np.isfinite(v).all() for v in out["metrics"].values())
    if setting == "lowrank_rank":
        assert "lanczos_s" in out["phases_s"] and out["inv_mass"].u.shape == (12, 3)


def test_stage3_variants_config_and_entry_point():
    """stage3_config follows run_operator_stage3.py per variant (stride 3/3 by
    default, gauss with alpha 1 and step 0.8 d^-1/4 unless given, autodiff on
    the full grid; --jitter, --adapt, --da-axis, --clip-scale), and the entry
    point parses the script's flags with stride as the default variant."""
    d, n = 81_131, 1000 * 101 * 101
    st = tv.stage3_config(d, n)
    assert (st.coarse_stride, st.fn_stride, st.gauss_field) == (3, 3, None)
    assert st.step_size == 1e-4 and st.jitter_eps and st.jitter_low_frac == 0.5
    assert st.clip_grad == pytest.approx(13.0 * d ** 0.5) and st.frozen_policy == "draw"
    g = tv.stage3_config(d, n, variant="gauss")
    assert g.gauss_field == 1.0 and g.coarse_stride is None
    assert g.step_size == pytest.approx(0.8 * d ** -0.25)
    assert tv.stage3_config(d, n, variant="gauss", step=0.01).step_size == 0.01
    a = tv.stage3_config(d, n, variant="autodiff", jitter="l", adapt=True, da_axis=True,
                         adapt_forever=True, max_step=0.1, clip_scale=0)
    assert (a.coarse_stride, a.gauss_field, a.clip_grad) == (None, None, None)
    assert a.jitter_l and not a.jitter_eps and a.adapt_step_size and a.da_axis == "chains"
    assert tv.stage3_config(d, n, jitter="none").jitter_low_frac == 0.0
    assert tv.trajectory_field_name(st) == "gram_stride_3x3_f32"
    assert tv.trajectory_field_name(g) == "gauss_alpha_1"
    assert tv.trajectory_field_name(a, use_gram=False) == "autograd"
    with pytest.raises(ValueError):
        tv.stage3_config(d, n, variant="nuts")
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"ok": 1}, None

    import unittest.mock as mock

    with mock.patch.object(tv, "run_stage3", fake), mock.patch("builtins.print"):
        tv.main(["--device", "cpu", "--draws", "6"])
        assert seen["variant"] == "stride" and seen["stride"] == 3 and seen["fn_stride"] == 3
        assert seen["jitter"] == "eps" and seen["step"] is None and seen["clip_scale"] == 13.0
        tv.main(["--device", "cpu", "--variant", "gauss", "--adapt", "--da-axis",
                 "--target-accept", "0.7", "--jitter", "l", "--laplace-mass",
                 "--init-optimize", "5", "--max-step", "0.2"])
        assert seen["variant"] == "gauss" and seen["adapt"] and seen["da_axis"]
        assert seen["target_accept"] == 0.7 and seen["laplace_mass"]
        assert seen["init_optimize"] == 5 and seen["max_step"] == 0.2
