"""PyTorch port parity: metric algebra, Lanczos, dual averaging, leapfrog, the
warm start, one full HMC transition with JAX's own random draws injected, a
distributional check of whole chains, and the operator row's control flow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread, tiny_problem  # noqa: F401 (a fixture)

import vihmc_tpu.hmc.metric as jm
from vihmc_tpu.dists.likelihoods import get_likelihood
from vihmc_tpu.hmc import HMCConfig as JConfig
from vihmc_tpu.hmc import FrozenPolicy as JPolicy
from vihmc_tpu.hmc import clipped_grad_fn as j_clip
from vihmc_tpu.hmc import make_subspace_grad as j_sub_grad
from vihmc_tpu.hmc import make_subspace_log_prob as j_sub_lp
from vihmc_tpu.hmc.adaptation import da_init as j_da_init
from vihmc_tpu.hmc.adaptation import da_update as j_da_update
from vihmc_tpu.hmc.integrators import leapfrog_grad_only as j_leapfrog
from vihmc_tpu.hmc.kernel import init_state as j_init_state
from vihmc_tpu.hmc.kernel import make_kernel as j_make_kernel
from vihmc_tpu.ops.gram_merge import make_gram_grad_full as j_gram
from vihmc_tpu.pipelines.common import make_flat_deeponet as j_make_flat
from vihmc_tpu.pipelines.common import make_paired_subspace_delta as j_make_delta
import vihmc_torch.hmc.metric as tm
from vihmc_torch.core.convert import metric_from_jax, state_from_jax
from vihmc_torch.hmc.adaptation import da_init, da_update
from vihmc_torch.hmc.integrators import leapfrog_grad_only
from vihmc_torch.hmc.kernel import (HMCConfig, TransitionNoise, clipped_grad_fn,
                                    make_kernel)
from vihmc_torch.hmc.subspace import make_subspace_grad, make_subspace_log_prob
from vihmc_torch.ops.gram_merge import make_gram_grad_full
from vihmc_torch.pipelines.common import (make_fused_paired_subspace_delta,
                                          make_nll_log_likelihood)

CLIP = 600.0 * (16 / 2048.0) ** 0.5


def _lowrank_pair(d, k, seed):
    """The same low-rank metric on both sides (JAX builds it; the port takes its fields)."""
    rng = np.random.default_rng(seed)
    diag = (1.0 / (0.05 + 0.05 * rng.random(d)) ** 2).astype(np.float32)
    u = (rng.normal(size=(d, k)) * np.sqrt(diag)[:, None] * 0.4).astype(np.float32)
    jmet = jm.make_lowrank_metric(jnp.asarray(diag), jnp.asarray(u))
    tmet = metric_from_jax(jmet.diag_mass, jmet.u, jmet.chol_cap)
    return jmet, tmet


def test_lowrank_metric_algebra_matches_jax():
    """Velocity, kinetic energy (rtol 1e-5) and the momentum draw from
    injected normals (the split/normal calls of metric.py:207-211; rtol 1e-5).
    The port's own Cholesky of the capacitance agrees to rtol 1e-5."""
    jmet, tmet = _lowrank_pair(30, 4, seed=1)
    own = tm.make_lowrank_metric(tmet.diag_mass, tmet.u)
    np.testing.assert_allclose(own.chol_cap.numpy(), np.asarray(jmet.chol_cap), rtol=1e-5,
                               atol=1e-6)
    rng = np.random.default_rng(1)
    p = (rng.normal(size=(3, 30)) * 10).astype(np.float32)
    vel = tm.mass_velocity(tmet, torch.as_tensor(p))
    ke = tm.mass_kinetic_energy(tmet, torch.as_tensor(p))
    keys = jax.random.split(jax.random.key(4), 3)
    for c in range(3):
        np.testing.assert_allclose(vel[c].numpy(), np.asarray(jm.mass_velocity(jmet, jnp.asarray(p[c]))),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(ke[c]),
                                   float(jm.mass_kinetic_energy(jmet, jnp.asarray(p[c]))), rtol=1e-5)
        want = jm.mass_sample_momentum(jmet, keys[c], jnp.zeros(30))
        k1, k2 = jax.random.split(keys[c])
        z1 = np.asarray(jax.random.normal(k1, (30,)))[None]
        z2 = np.asarray(jax.random.normal(k2, (4,)))[None]
        got = tm.mass_sample_momentum(tmet, torch.as_tensor(z1), torch.as_tensor(z2))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    # the dense mass inverts the velocity map
    dense = tmet.dense().double()
    np.testing.assert_allclose((vel.double() @ dense).numpy(), p, rtol=1e-4, atol=1e-3)


def test_lanczos_eigs_same_start_vector():
    """Top-5 Ritz pairs of a fixed SPD operator from JAX's start vector
    (key 0x10E): eigenvalues rtol 1e-4, eigenvectors |cos| > 1 - 1e-4."""
    rng = np.random.default_rng(2)
    dim = 40
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    ev = np.concatenate([[300.0, 120.0, 60.0, 30.0, 15.0], 1 + rng.random(dim - 5)])
    a = ((q * ev) @ q.T).astype(np.float32)
    key = jax.random.key(0x10E)
    jv, jvec = jm.lanczos_eigs(lambda v: jnp.asarray(a) @ v, dim, 5, num_iters=20, key=key)
    v0 = torch.as_tensor(np.asarray(jax.random.normal(key, (dim,))))
    at = torch.as_tensor(a)
    tv, tvec = tm.lanczos_eigs(lambda v: at @ v, dim, 5, num_iters=20, v0=v0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4)
    cos = np.abs(np.sum(tvec.numpy() * np.asarray(jvec), axis=0))
    assert np.all(cos > 1 - 1e-4), cos


def _jax_side(tp, grad_dtype=None):
    j_apply, _, _ = j_make_flat(tp.jcfg)
    like = get_likelihood("NLL")
    bx, tx, y = jnp.asarray(tp.bx), jnp.asarray(tp.tx), jnp.asarray(tp.y)

    def full_ll(flat):
        return like(j_apply(flat, bx, tx), y, tp.tau)

    lp_like, _, _ = j_sub_lp(full_ll, tp.jspec, JPolicy.MEAN)

    def log_prob(q, aux):
        return lp_like(q, aux) + tp.jprior.log_prob(q)

    gfull, _, _ = j_gram(tp.jcfg, bx, tx, y, tp.tau, compute_dtype=grad_dtype)
    return log_prob, gfull, j_make_delta(j_apply, bx, tx, y, tp.tau, tp.jspec, tp.jprior)


def _torch_side(tp, grad_dtype=None):
    lp_like, _ = make_subspace_log_prob(
        make_nll_log_likelihood(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau),
        tp.tspec, tp.t("frozen"))

    def log_prob(q, aux):
        return lp_like(q, aux) + tp.tprior.log_prob(q)

    gfull = make_gram_grad_full(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau,
                                compute_dtype=grad_dtype)
    delta = make_fused_paired_subspace_delta(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"),
                                             tp.tau, tp.tspec.idx, tp.tprior)
    return log_prob, gfull, delta


def test_hvp_and_preconditioned_lanczos_match_jax():
    """HVP of the composed f32 subspace log-density (rtol 1e-4 of its scale),
    and rank-4 preconditioned Lanczos from JAX's start vector (eigenvalues
    rtol 1e-3: f32 HVP rounding differs between frameworks)."""
    tp = tiny_problem(seed=3)
    jlp, _, _ = _jax_side(tp)
    tlp, _, _ = _torch_side(tp)
    q0 = tp.mu[tp.idx]
    aux = jnp.asarray(tp.frozen)
    diag = (tp.sigma[tp.idx] ** 2).astype(np.float32)
    jh = jm.hvp_fn(jlp, jnp.asarray(q0), aux=aux)
    th = tm.hvp_fn(tlp, torch.as_tensor(q0), aux=tp.t("frozen"))
    rng = np.random.default_rng(3)
    for _ in range(2):
        v = rng.normal(size=len(q0)).astype(np.float32)
        want = np.asarray(jh(jnp.asarray(v)))
        got = th(torch.as_tensor(v)).numpy()
        np.testing.assert_allclose(got / np.abs(want).max(), want / np.abs(want).max(),
                                   rtol=1e-4, atol=1e-4)
    key = jax.random.key(0x10E)
    jv, _ = jm.lanczos_eigs(jm.preconditioned_hvp(jlp, jnp.asarray(q0), jnp.asarray(diag), aux=aux),
                            len(q0), 4, num_iters=12, key=key)
    tv, _ = tm.lanczos_eigs(tm.preconditioned_hvp(tlp, torch.as_tensor(q0), torch.as_tensor(diag),
                                                  aux=tp.t("frozen")),
                            len(q0), 4, num_iters=12,
                            v0=torch.as_tensor(np.asarray(jax.random.normal(key, (len(q0),)))))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-3)


def test_dual_averaging_matches_jax():
    """Exact constants; rtol 1e-6 over 5 updates from step 0.1."""
    js = j_da_init(0.1)
    ts = da_init(0.1, shape=(1,))
    for a in (0.9, 0.1, 0.3, 0.0, 0.7):
        js = j_da_update(js, jnp.float32(a), 0.25)
        ts = da_update(ts, torch.tensor([a]), 0.25)
        for f in ("log_step", "log_step_avg", "h_bar", "mu", "t"):
            np.testing.assert_allclose(float(getattr(ts, f)[0]), float(getattr(js, f)),
                                       rtol=1e-6, atol=1e-7)


def test_leapfrog_and_clip_match_jax():
    """4 leapfrog steps of the clipped Gram field (f32) with a low-rank
    metric and a per-chain step: rtol 1e-4 of the scale."""
    tp = tiny_problem(seed=4)
    _, jg, _ = _jax_side(tp)
    _, tg, _ = _torch_side(tp)
    d = len(tp.idx)
    diag = (tp.sigma[tp.idx] ** 2).astype(np.float32)
    # a tight clip so that it binds on some chain
    jfield = j_clip(j_sub_grad(jg, tp.jspec, prior=tp.jprior), 5.0, inv_mass=jnp.asarray(diag))
    tfield = clipped_grad_fn(make_subspace_grad(tg, tp.tspec, prior=tp.tprior), 5.0,
                             inv_mass=torch.as_tensor(diag))
    jmet, tmet = _lowrank_pair(d, 3, seed=4)
    rng = np.random.default_rng(4)
    q = (tp.mu[tp.idx][None] + 0.05 * rng.normal(size=(2, d))).astype(np.float32)
    p = (rng.normal(size=(2, d)) * 20).astype(np.float32)
    eps = np.array([0.004, 0.006], np.float32)
    aux_t, aux_j = tp.t("frozen"), jnp.asarray(tp.frozen)
    g0 = tfield(torch.as_tensor(q), aux_t)
    q1, p1, g1 = leapfrog_grad_only(lambda x: tfield(x, aux_t), torch.as_tensor(q),
                                    torch.as_tensor(p), g0, torch.as_tensor(eps), 4, tmet)
    for c in range(2):
        jg0 = jfield(jnp.asarray(q[c]), aux_j)
        np.testing.assert_allclose(g0[c].numpy(), np.asarray(jg0), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jg0).max()))
        jq, jp, _ = j_leapfrog(lambda x: jfield(x, aux_j), jnp.asarray(q[c]), jnp.asarray(p[c]),
                               jg0, float(eps[c]), 4, jmet)
        np.testing.assert_allclose(q1[c].numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p1[c].numpy(), np.asarray(jp), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jp).max()))


def test_warm_start_matches_optax_adam():
    """50 preconditioned Adam steps (optax defaults, lr 0.1) on the f32 Gram
    field with no jitter: the optimum agrees to rtol 1e-4."""
    import bench
    from vihmc_torch.pipelines.common import conditional_warm_start

    tp = tiny_problem(seed=5)
    _, jg, _ = _jax_side(tp)
    _, tg, _ = _torch_side(tp)
    diag = (tp.sigma[tp.idx] ** 2).astype(np.float32)
    jfield = j_clip(j_sub_grad(jg, tp.jspec, prior=tp.jprior), CLIP, inv_mass=jnp.asarray(diag))
    tfield = clipped_grad_fn(make_subspace_grad(tg, tp.tspec, prior=tp.tprior), CLIP,
                             inv_mass=torch.as_tensor(diag))
    want, _ = bench._conditional_warm_start(None, jnp.asarray(tp.frozen),
                                            jnp.asarray(tp.mu[tp.idx]), jnp.asarray(diag),
                                            jfield, 50, 1, jax.random.key(0), spread=0.0)
    got = conditional_warm_start(tfield, tp.t("frozen"), torch.as_tensor(tp.mu[tp.idx]),
                                 torch.as_tensor(diag), 50, 1, torch.Generator(), spread=0.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-5)


def _jax_draws(key, d, rank):
    """The random numbers one JAX transition draws from ``key``: the split of
    kernel.py:494, the momentum normals of metric.py:207-211, and the jitter
    (kernel.py:552) and accept (kernel.py:649) uniforms on [0, 1)."""
    key_mom, key_u, _key_aux, key_jit = jax.random.split(key, 4)
    k1, k2 = jax.random.split(key_mom)
    return (np.asarray(jax.random.normal(k1, (d,), jnp.float32)),
            np.asarray(jax.random.normal(k2, (rank,), jnp.float32)),
            float(jax.random.uniform(key_jit, ())), float(jax.random.uniform(key_u)))


def test_full_transition_with_injected_jax_draws(one_torch_thread):
    """Three coupled-DA transitions of 4 chains (the recipe's path: clipped
    f32 Gram field, paired delta, low-rank metric, jitter_eps, adapt_forever,
    accept statistic averaged over chains) with JAX's own draws injected: the
    same accept decisions, steps (rtol 1e-4) and positions (atol 5e-5, about
    1e-3 of a posterior standard deviation)."""
    tp = tiny_problem(seed=6)
    d, c, rank = len(tp.idx), 4, 3
    jlp, jg, jdelta = _jax_side(tp)
    tlp, tg, tdelta = _torch_side(tp)
    diag = (tp.sigma[tp.idx] ** 2).astype(np.float32)
    jfield = j_clip(j_sub_grad(jg, tp.jspec, prior=tp.jprior), CLIP, inv_mass=jnp.asarray(diag))
    tfield = clipped_grad_fn(make_subspace_grad(tg, tp.tspec, prior=tp.tprior), CLIP,
                             inv_mass=torch.as_tensor(diag))
    jmet, tmet = _lowrank_pair(d, rank, seed=6)
    jcfg = JConfig(num_samples=3, num_leapfrog=4, step_size=0.03, sampler="hmc_nuts",
                   target_accept=0.25, da_axis="chains", adapt_forever=True,
                   jitter_eps=True, jitter_low_frac=0.5)
    tcfg = HMCConfig(num_samples=3, num_leapfrog=4, step_size=0.03, sampler="hmc_nuts",
                     target_accept=0.25, da_axis="chains", adapt_forever=True,
                     jitter_eps=True, jitter_low_frac=0.5)
    rng = np.random.default_rng(6)
    inits = (tp.mu[tp.idx][None] + 0.3 * tp.sigma[tp.idx][None]
             * rng.normal(size=(c, d))).astype(np.float32)
    aux = jnp.asarray(tp.frozen)
    jkernel = j_make_kernel(jlp, jcfg, inv_mass=jmet, grad_fn=jfield, delta_fn=jdelta)
    jstate = jax.vmap(lambda q: j_init_state(jlp, q, jcfg, aux=aux, inv_mass=jmet,
                                             grad_fn=jfield))(jnp.asarray(inits))
    tstate = state_from_jax(jstate.position, jstate.log_prob, jstate.grad, jstate.aux,
                            jstate.da.log_step, jstate.da.log_step_avg, jstate.da.h_bar,
                            jstate.da.mu, jstate.da.t)
    tkernel = make_kernel(tcfg, tmet, tfield, tdelta)
    step = jax.vmap(jkernel, in_axes=(0, 0, None), axis_name="chains")
    n_accept = 0
    for it in range(3):
        keys = jax.random.split(jax.random.key(100 + it), c)
        draws = [_jax_draws(k, d, rank) for k in keys]
        noise = TransitionNoise(
            z1=torch.as_tensor(np.stack([x[0] for x in draws])),
            z2=torch.as_tensor(np.stack([x[1] for x in draws])),
            u_jitter=torch.tensor([x[2] for x in draws]),
            u_accept=torch.tensor([x[3] for x in draws]))
        jstate, jinfo = step(jstate, keys, it)
        tstate, tinfo = tkernel(tstate, noise)
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
        np.testing.assert_allclose(tinfo["step_size"].numpy(), np.asarray(jinfo["step_size"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tinfo["accept_prob"].numpy(),
                                   np.asarray(jinfo["accept_prob"]), rtol=1e-3, atol=1e-4)
        # positions inherit the step's relative error times the displacement
        np.testing.assert_allclose(tstate.position.numpy(), np.asarray(jstate.position),
                                   rtol=1e-4, atol=5e-5)
        # the accept statistic carries the paired delta's f32 rounding
        # (~1e-5 nats); dual averaging scales it by sqrt(t)/gamma/(t+t0) ~ 2
        np.testing.assert_allclose(tstate.da.log_step.numpy(), np.asarray(jstate.da.log_step),
                                   rtol=0, atol=1e-4)
        n_accept += int(tinfo["accepted"].sum())
    assert 0 < n_accept < 3 * c  # both branches of the MH test were taken


def test_chains_agree_in_distribution_with_jax(one_torch_thread):
    """Whole chains of both samplers on the same posterior (recipe path,
    own random streams): post-burn means and standard deviations of every
    coordinate agree within 4.5 Monte-Carlo standard errors (ESS-based)."""
    from vihmc_tpu.chains.resume import sample_chains_resumable as j_sample
    from vihmc_torch.chains.diagnostics import effective_sample_size_np
    from vihmc_torch.chains.resume import sample_chains_resumable

    tp = tiny_problem(seed=9, sub_dim=8)
    d, c, n, burn = 8, 4, 600, 100
    jlp, jg, jdelta = _jax_side(tp)
    tlp, tg, tdelta = _torch_side(tp)
    diag = (tp.sigma[tp.idx] ** 2).astype(np.float32)
    jfield = j_clip(j_sub_grad(jg, tp.jspec, prior=tp.jprior), CLIP, inv_mass=jnp.asarray(diag))
    tfield = clipped_grad_fn(make_subspace_grad(tg, tp.tspec, prior=tp.tprior), CLIP,
                             inv_mass=torch.as_tensor(diag))
    vecs, _ = np.linalg.qr(np.random.default_rng(9).normal(size=(d, 2)))
    jmet = jm.lowrank_from_eigs(jnp.asarray(diag), jnp.asarray([3.0, 2.0]), jnp.asarray(vecs))
    tmet = metric_from_jax(jmet.diag_mass, jmet.u, jmet.chol_cap)
    inits = np.tile(tp.mu[tp.idx][None], (c, 1)).astype(np.float32)
    jcfg = JConfig(num_samples=n, num_leapfrog=4, step_size=0.1, sampler="hmc_nuts",
                   target_accept=0.65, da_axis="chains", adapt_forever=True,
                   jitter_eps=True, jitter_low_frac=0.5)
    jres = j_sample(jlp, jnp.asarray(inits), jax.random.key(1), jcfg, segment_size=150,
                    inv_mass=jmet, aux=jnp.asarray(tp.frozen), grad_fn=jfield,
                    delta_fn=jdelta)
    tres = sample_chains_resumable(tlp, torch.as_tensor(inits),
                                   HMCConfig(num_samples=n, num_leapfrog=4, step_size=0.1,
                                             sampler="hmc_nuts", target_accept=0.65,
                                             da_axis="chains", adapt_forever=True,
                                             jitter_eps=True, jitter_low_frac=0.5),
                                   150, tmet, tp.t("frozen"), tfield, tdelta, seed=1)
    a = np.asarray(jres.samples)[:, burn:]
    b = tres.samples[:, burn:]
    assert tres.acceptance_rate > 0.3 and float(jres.acceptance_rate) > 0.3
    ess_a, ess_b = effective_sample_size_np(a), effective_sample_size_np(b)
    ma, mb = a.mean((0, 1)), b.mean((0, 1))
    sa, sb = a.std((0, 1)), b.std((0, 1))
    z_mean = np.abs(ma - mb) / np.sqrt(sa ** 2 / ess_a + sb ** 2 / ess_b)
    z_std = np.abs(sa - sb) / np.sqrt(sa ** 2 / (2 * ess_a) + sb ** 2 / (2 * ess_b))
    assert z_mean.max() < 4.5, z_mean
    assert z_std.max() < 4.5, z_std


def test_operator_row_control_flow_on_cpu():
    """The operator row's recipe end to end at a tiny size on the CPU
    (bench_operator on a posterior given to it): warm start, Lanczos
    metric, segmented sampling with thinning, diagnostics."""
    from vihmc_torch.bench_operator import BenchProblem, bench_operator
    from vihmc_torch.ops.deeponet_merge import paired_sums

    tp = tiny_problem(seed=10, sub_dim=12)
    scores = (np.random.default_rng(10).random(tp.mu.shape[0]) * 1e-5).astype(np.float32)
    prob = BenchProblem(
        cfg=tp.tcfg, branch_x=tp.t("bx"), trunk_x=tp.t("tx"), y=tp.t("y"), spec=tp.tspec,
        eps=torch.as_tensor((tp.frozen - tp.mu) / tp.sigma), n_chains=3, n_samples=24,
        provenance={"posterior": "vi_fit"}, scores=scores)
    recipe = dict(coupled=True, stride=1, fn_stride=1, laplace_mass=True, grad_dtype="bfloat16",
                  num_leapfrog=4, target_accept=0.25, burn=6, thin=3, segment=12, keys=(0,),
                  init_opt=20, lowrank_rank=4)
    launches = paired_sums.launches
    st, _ = bench_operator(device="cpu", problem=prob, **recipe)
    assert paired_sums.launches == launches  # CPU tensors take the plain version
    assert st["samples_shape"] == [3, 8, 12] and st["samples_finite"]
    assert 0.0 <= st["acceptance"] <= 1.0
    assert len(st["step_quartiles"]) == 4 and all(np.isfinite(st["step_quartiles"]))
    assert np.isfinite(st["ess_median"]) and st["device"] == "cpu"
    assert st["lowrank_metric"]["rank"] == 4
    with pytest.raises(ValueError, match="thin"):
        bench_operator(device="cpu", problem=prob, **dict(recipe, burn=5))


def test_hmc_config_fields_and_defaults_match_jax():
    """Every field of the port's HMCConfig is one of JAX's, with JAX's
    default; every option is accepted (store_aux_trace too), and the
    settings JAX rejects raise ValueError."""
    from torch_parity_helpers import assert_shared_fields_equal
    from vihmc_torch.hmc.kernel import check_config

    assert_shared_fields_equal(HMCConfig(), JConfig())
    for field, value in (("store_aux_trace", True), ("adapt_mass", True),
                         ("mass_schedule", "windowed"),
                         ("refresh_during_burn", False), ("init_step_search", True),
                         ("momentum_persistence", 0.5), ("metric_axis", "chains")):
        check_config(HMCConfig(**{field: value}))
    for kw in ({"jitter_l": True, "jitter_eps": True}, {"sampler": "nuts"},
               {"integrator": "verlet"}, {"da_axis": "data"}, {"metric_axis": "data"}):
        with pytest.raises(ValueError):
            check_config(HMCConfig(**kw))


def _diag_draws(key, d, low, high):
    """One JAX transition's draws with a diagonal metric (kernel.py:494):
    the momentum normals, the jitter uniform, the accept uniform and the
    ``jitter_l`` length ``randint(key_jit, low, high)`` (kernel.py:598)."""
    key_mom, key_u, _key_aux, key_jit = jax.random.split(key, 4)
    return (np.asarray(jax.random.normal(key_mom, (d,), jnp.float32)),
            float(jax.random.uniform(key_jit, ())), float(jax.random.uniform(key_u)),
            int(jax.random.randint(key_jit, (), low, high)))


ADAPT_MODES = {
    # per-chain dual averaging in burn, the averaged step after (kernel.py:537-546)
    "per_chain_burn": dict(sampler="hmc_nuts", burn=2, target_accept=0.6),
    "adapt_forever": dict(sampler="hmc_nuts", burn=1, adapt_forever=True, target_accept=0.6),
    "step_clamps": dict(sampler="hmc_nuts", burn=3, target_accept=0.6, max_step=0.045,
                        min_step=0.035),
    "jitter_l_gram": dict(sampler="hmc", jitter_l=True, jitter_low_frac=0.5),
    "jitter_l_autodiff": dict(sampler="hmc", jitter_l=True, jitter_low_frac=0.5),
}


@pytest.mark.parametrize("mode", sorted(ADAPT_MODES))
def test_adaptation_and_jitter_modes_with_injected_jax_draws(mode, one_torch_thread):
    """Five transitions of 4 chains in each step mode against the JAX kernel
    vmapped over chains (per-chain statistics, da_axis None) with its draws
    injected, the iteration crossing the burn boundary: the same accept
    decisions, steps (rtol 1e-4), dual-averaging state (atol 1e-4: the accept
    statistic's f32 rounding, scaled by the update) and positions (rtol
    1e-4, atol 5e-5). After burn the step is the frozen exp(log_step_avg)
    unless adapt_forever; under jitter_l each chain's drawn length masks the
    tail of its L = 4 steps, on the Gram field or the value-and-grad path."""
    from vihmc_torch.hmc.kernel import init_state, jitter_l_range

    tp = tiny_problem(seed=40)
    d, c, n_lf, n_it = len(tp.idx), 4, 4, 5
    kw = ADAPT_MODES[mode]
    jlp, jg, _ = _jax_side(tp)
    tlp, tg, _ = _torch_side(tp)
    diag = (tp.sigma[tp.idx] ** 2).astype(np.float32)
    jfield = tfield = None
    if mode != "jitter_l_autodiff":
        jfield = j_clip(j_sub_grad(jg, tp.jspec, prior=tp.jprior), CLIP,
                        inv_mass=jnp.asarray(diag))
        tfield = clipped_grad_fn(make_subspace_grad(tg, tp.tspec, prior=tp.tprior), CLIP,
                                 inv_mass=torch.as_tensor(diag))
    jcfg = JConfig(num_samples=n_it, num_leapfrog=n_lf, step_size=0.04, **kw)
    tcfg = HMCConfig(num_samples=n_it, num_leapfrog=n_lf, step_size=0.04, **kw)
    rng = np.random.default_rng(40)
    inits = (tp.mu[tp.idx][None] + 0.3 * tp.sigma[tp.idx][None]
             * rng.normal(size=(c, d))).astype(np.float32)
    aux = jnp.asarray(tp.frozen)
    jkernel = j_make_kernel(jlp, jcfg, inv_mass=jnp.asarray(diag), grad_fn=jfield)
    jstate = jax.vmap(lambda q: j_init_state(jlp, q, jcfg, aux=aux, inv_mass=jnp.asarray(diag),
                                             grad_fn=jfield))(jnp.asarray(inits))
    tstate = init_state(tlp, torch.as_tensor(inits), tcfg, tp.t("frozen"), tfield)
    tkernel = make_kernel(tcfg, torch.as_tensor(diag), tfield, None, tlp)
    step = jax.vmap(jkernel, in_axes=(0, 0, None))
    rng_l = jitter_l_range(tcfg) or (1, n_lf + 1)
    lengths = []
    for it in range(n_it):
        keys = jax.random.split(jax.random.key(400 + it), c)
        draws = [_diag_draws(k, d, *rng_l) for k in keys]
        noise = TransitionNoise(z1=torch.as_tensor(np.stack([x[0] for x in draws])), z2=None,
                                u_jitter=torch.tensor([x[1] for x in draws]),
                                u_accept=torch.tensor([x[2] for x in draws]),
                                n_steps=torch.tensor([x[3] for x in draws]))
        lengths += [x[3] for x in draws]
        jstate, jinfo = step(jstate, keys, it)
        tstate, tinfo = tkernel(tstate, noise)
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
        # the step is exp of the dual-averaging state, so it carries that
        # state's error as a relative one
        np.testing.assert_allclose(tinfo["step_size"].numpy(), np.asarray(jinfo["step_size"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tstate.position.numpy(), np.asarray(jstate.position),
                                   rtol=1e-4, atol=5e-5)
        for f in ("log_step", "log_step_avg"):
            np.testing.assert_allclose(getattr(tstate.da, f).numpy(),
                                       np.asarray(getattr(jstate.da, f)), rtol=0, atol=1e-4)
        if mode in ("per_chain_burn", "step_clamps") and it >= tcfg.burn:
            want = np.clip(np.exp(getattr(tstate.da, "log_step_avg").numpy()),
                           tcfg.min_step or 0, tcfg.max_step or np.inf)
            np.testing.assert_allclose(tinfo["step_size"].numpy(), want, rtol=1e-6)
    assert tstate.iteration == n_it
    steps = tinfo["step_size"].numpy()
    if mode.startswith("jitter_l"):
        assert np.all(steps == np.float32(0.04)) and len(set(lengths)) > 1
        assert min(lengths) >= 2 and max(lengths) <= n_lf
    elif mode == "step_clamps":
        assert np.all((steps >= 0.035 - 1e-9) & (steps <= 0.045 + 1e-9))
    else:
        assert not np.allclose(steps, 0.04)  # dual averaging moved the step


def test_jitter_l_draw_comes_after_the_existing_draws():
    """draw_noise draws the jitter_l lengths only when asked, and after the
    momentum normals and the two uniforms: configurations without jitter_l
    keep their streams."""
    from vihmc_torch.hmc.kernel import draw_noise, jitter_l_range

    c, d = 3, 5
    plain = draw_noise(torch.Generator().manual_seed(8), 1.0, c, d, "cpu")
    rng_l = jitter_l_range(HMCConfig(num_leapfrog=7, jitter_l=True, jitter_low_frac=0.5))
    assert rng_l == (4, 8) and jitter_l_range(HMCConfig()) is None
    with_l = draw_noise(torch.Generator().manual_seed(8), 1.0, c, d, "cpu", n_steps_range=rng_l)
    gen = torch.Generator().manual_seed(8)
    z1, u = torch.randn((c, d), generator=gen), torch.rand((2, c), generator=gen)
    n = torch.randint(4, 8, (c,), generator=gen)
    for nz in (plain, with_l):
        assert torch.equal(nz.z1, z1) and torch.equal(nz.u_jitter, u[0])
        assert torch.equal(nz.u_accept, u[1])
    assert plain.n_steps is None and torch.equal(with_l.n_steps, n)


def _shard_problem(seed, n_shards=3, n_per=5, d=6):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_shards, n_per, d)).astype(np.float32)
    b = rng.normal(size=(n_shards, n_per)).astype(np.float32)
    return a, b


def test_split_leapfrog_matches_jax():
    """Three outer steps of the split integrator over 3 data shards of a
    tanh-regression potential with a diagonal mass, per-chain steps: q and p
    of 2 chains at rtol 1e-5 of JAX's (deterministic)."""
    from vihmc_tpu.hmc.integrators import split_leapfrog as j_split
    from vihmc_torch.hmc.integrators import split_leapfrog
    from vihmc_torch.hmc.kernel import value_and_grad

    a, b = _shard_problem(41)
    d = a.shape[-1]
    im = np.linspace(0.5, 1.5, d).astype(np.float32)

    def j_shard(q, shard):
        aa, bb = shard
        return -0.5 * jnp.sum((jnp.tanh(aa @ q) - bb) ** 2) - 0.05 * jnp.sum(q * q)

    def t_shard(q, shard, aux=None):
        aa, bb = shard
        return -0.5 * ((torch.tanh(q @ aa.T) - bb) ** 2).sum(-1) - 0.05 * (q * q).sum(-1)

    rng = np.random.default_rng(41)
    q = rng.normal(size=(2, d)).astype(np.float32)
    p = rng.normal(size=(2, d)).astype(np.float32)
    eps = np.array([0.1, 0.2], np.float32)
    shards_t = (torch.as_tensor(a), torch.as_tensor(b))
    tq, tp_ = split_leapfrog(lambda x, s: value_and_grad(lambda y, _: t_shard(y, s), x, None),
                             shards_t, torch.as_tensor(q), torch.as_tensor(p),
                             torch.as_tensor(eps), 3, torch.as_tensor(im))
    for c in range(2):
        jq, jp = j_split(jax.value_and_grad(j_shard), (jnp.asarray(a), jnp.asarray(b)),
                         jnp.asarray(q[c]), jnp.asarray(p[c]), float(eps[c]), 3, jnp.asarray(im))
        np.testing.assert_allclose(tq[c].numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tp_[c].numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)


def test_splitting_transition_with_injected_jax_draws():
    """Three transitions of the kernel's splitting integrator (3 shards,
    fixed step, the unpaired MH test on the full density) for 3 chains with
    JAX's draws injected: accept decisions, log-densities (rtol 1e-5) and
    positions (rtol 1e-5); and JAX's errors for a grad_fn or a delta_fn."""
    from vihmc_torch.hmc.kernel import init_state

    a, b = _shard_problem(42)
    d, c, n_shards = a.shape[-1], 3, a.shape[0]

    def j_shard(q, shard):
        aa, bb = shard
        return -0.5 * jnp.sum((jnp.tanh(aa @ q) - bb) ** 2) - 0.05 * jnp.sum(q * q) / n_shards

    def j_full(q):
        return sum(j_shard(q, (a[i], b[i])) for i in range(n_shards))

    def t_shard(q, shard, aux=None):
        aa, bb = shard
        return (-0.5 * ((torch.tanh(q @ aa.T) - bb) ** 2).sum(-1)
                - 0.05 * (q * q).sum(-1) / n_shards)

    ta, tb = torch.as_tensor(a), torch.as_tensor(b)

    def t_full(q, aux=None):
        return sum(t_shard(q, (ta[i], tb[i])) for i in range(n_shards))

    kw = dict(num_samples=3, num_leapfrog=3, step_size=0.35, integrator="splitting")
    jcfg, tcfg = JConfig(**kw), HMCConfig(**kw)
    jkernel = j_make_kernel(j_full, jcfg, shard_log_prob_fn=j_shard,
                            shard_data=(jnp.asarray(a), jnp.asarray(b)))
    tkernel = make_kernel(tcfg, 1.0, None, None, t_full, shard_log_prob_fn=t_shard,
                          shard_data=(ta, tb))
    q0 = np.random.default_rng(42).normal(size=(c, d)).astype(np.float32)
    jstate = jax.vmap(lambda q: j_init_state(j_full, q, jcfg))(jnp.asarray(q0))
    tstate = init_state(t_full, torch.as_tensor(q0), tcfg, None)
    step = jax.vmap(jkernel, in_axes=(0, 0, None))
    n_accept = 0
    for it in range(3):
        keys = jax.random.split(jax.random.key(420 + it), c)
        draws = [_diag_draws(k, d, 1, 2) for k in keys]
        noise = TransitionNoise(z1=torch.as_tensor(np.stack([x[0] for x in draws])), z2=None,
                                u_jitter=torch.tensor([x[1] for x in draws]),
                                u_accept=torch.tensor([x[2] for x in draws]))
        jstate, jinfo = step(jstate, keys, it)
        tstate, tinfo = tkernel(tstate, noise)
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
        np.testing.assert_allclose(tinfo["log_prob"].numpy(), np.asarray(jinfo["log_prob"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tstate.position.numpy(), np.asarray(jstate.position),
                                   rtol=1e-5, atol=1e-6)
        n_accept += int(tinfo["accepted"].sum())
    assert 0 < n_accept
    with pytest.raises(ValueError, match="grad_fn"):
        make_kernel(tcfg, 1.0, lambda q, a_: q, None, t_full, shard_log_prob_fn=t_shard,
                    shard_data=(ta, tb))
    with pytest.raises(ValueError, match="delta_fn"):
        make_kernel(tcfg, 1.0, None, lambda q1, q0_, a_: (q1, q1), t_full,
                    shard_log_prob_fn=t_shard, shard_data=(ta, tb))
    with pytest.raises(ValueError, match="shard_log_prob_fn"):
        make_kernel(tcfg, 1.0, None, None, t_full)


def test_estimate_lowrank_metric_matches_jax():
    """estimate_lowrank_metric on the composed subspace log-density from JAX's
    start vector: the diagonal mass (rtol 1e-6) and the low-rank term U U^T
    (rtol 2e-3 of its scale: the Ritz pairs carry the HVPs' f32 rounding)."""
    tp = tiny_problem(seed=43)
    jlp, _, _ = _jax_side(tp)
    tlp, _, _ = _torch_side(tp)
    q0 = tp.mu[tp.idx]
    diag = (tp.sigma[tp.idx] ** 2).astype(np.float32)
    key = jax.random.key(0x10E)
    want = jm.estimate_lowrank_metric(jlp, jnp.asarray(q0), jnp.asarray(diag), rank=3,
                                      num_iters=10, key=key, aux=jnp.asarray(tp.frozen))
    got = tm.estimate_lowrank_metric(
        tlp, torch.as_tensor(q0), torch.as_tensor(diag), 3, num_iters=10,
        v0=torch.as_tensor(np.asarray(jax.random.normal(key, (len(q0),)))), aux=tp.t("frozen"))
    np.testing.assert_allclose(got.diag_mass.numpy(), np.asarray(want.diag_mass), rtol=1e-6)
    uu_want = np.asarray(want.u) @ np.asarray(want.u).T
    uu_got = (got.u @ got.u.T).numpy()
    scale = np.abs(uu_want).max()
    assert scale > 0
    np.testing.assert_allclose(uu_got / scale, uu_want / scale, rtol=0, atol=2e-3)
