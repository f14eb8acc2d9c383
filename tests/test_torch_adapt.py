"""PyTorch port parity: the adaptive metric and the kernel's remaining options.

The windowed warmup schedule, the Welford moments and their chain pooling,
40-draw adaptive-mass runs under both schedules with JAX's draws injected,
the initial step search, the momentum-persistent transition, the eigen
metric and the Hutchinson diagonal, each against the JAX package on the same
inputs; then the windowed adaptation in distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_convert import state_from_jax, welford_from_jax
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)

import vihmc_tpu.hmc.metric as jm
from vihmc_tpu.hmc.adaptation import da_restart as j_da_restart
from vihmc_tpu.hmc.adaptation import da_init as j_da_init
from vihmc_tpu.hmc.adaptation import find_reasonable_step_size as j_find_step
from vihmc_tpu.hmc.kernel import HMCConfig as JConfig
from vihmc_tpu.hmc.kernel import WelfordState as JWelford
from vihmc_tpu.hmc.kernel import init_state as j_init_state
from vihmc_tpu.hmc.kernel import make_kernel as j_make_kernel
from vihmc_tpu.hmc.kernel import mass_window_schedule as j_schedule
from vihmc_tpu.hmc.kernel import pooled_variance as j_pooled
import vihmc_torch.hmc.metric as tm
from vihmc_torch.hmc.adaptation import (DualAveragingState, da_restart,
                                        find_reasonable_step_size)
from vihmc_torch.hmc.kernel import (HMCConfig, TransitionNoise, WelfordState, init_state,
                                    make_kernel, mass_window_schedule, pooled_variance,
                                    sample, value_and_grad)

#: an anisotropic Gaussian target, the same on both sides
D, C = 5, 4
LOC = np.array([0.3, -0.2, 0.0, 0.5, 0.1], np.float32)
SCALE = np.array([0.05, 0.3, 1.0, 0.1, 2.0], np.float32)


def j_lp(q, aux=None):
    return -0.5 * jnp.sum(((q - LOC) / SCALE) ** 2)


def t_lp(q, aux=None):
    return -0.5 * (((q - torch.as_tensor(LOC)) / torch.as_tensor(SCALE)) ** 2).sum(-1)


def _inits(seed, c=C):
    rng = np.random.default_rng(seed)
    return (LOC + SCALE * rng.normal(size=(c, D))).astype(np.float32)


def _draws(key):
    """One JAX transition's draws with a diagonal metric (kernel.py:494): the
    momentum normals, the jitter and the accept uniforms."""
    key_mom, key_u, _key_aux, key_jit = jax.random.split(key, 4)
    return (np.asarray(jax.random.normal(key_mom, (D,), jnp.float32)),
            float(jax.random.uniform(key_jit, ())), float(jax.random.uniform(key_u)))


def _noise(keys):
    draws = [_draws(k) for k in keys]
    return TransitionNoise(z1=torch.as_tensor(np.stack([x[0] for x in draws])), z2=None,
                           u_jitter=torch.tensor([x[1] for x in draws]),
                           u_accept=torch.tensor([x[2] for x in draws]))


@pytest.mark.parametrize("burn", [0, 10, 19, 20, 30, 40, 100, 576, 1000, 5000])
def test_mass_window_schedule_matches_jax(burn):
    """The windowed-warmup schedule is JAX's, window for window."""
    assert mass_window_schedule(burn) == j_schedule(burn)


@pytest.mark.parametrize("pooled", [False, True])
def test_welford_and_pooled_variance_match_jax(pooled):
    """Seven Welford updates of 4 chains, then the variance each chain's own
    or pooled over the chains (within plus between): the moments and the
    variance within 1e-6 relative, the effective count exact."""
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(7, C, D)).astype(np.float32) * SCALE + LOC
    jw = jax.vmap(lambda _: JWelford(mean=jnp.zeros(D), m2=jnp.zeros(D),
                                     count=jnp.zeros((), jnp.float32)))(jnp.arange(C))
    tw = WelfordState.zeros_like(torch.zeros(C, D))
    for x in xs:
        jw = jax.vmap(lambda w, xx: w.update(xx))(jw, jnp.asarray(x))
        tw = tw.update(torch.as_tensor(x))
    np.testing.assert_allclose(tw.mean.numpy(), np.asarray(jw.mean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tw.m2.numpy(), np.asarray(jw.m2), rtol=1e-6, atol=1e-7)
    axis = "chains" if pooled else None
    jvar, jn = jax.vmap(lambda w: j_pooled(w, axis), axis_name="chains")(jw)
    tvar, tn = pooled_variance(tw, axis)
    want = np.asarray(jvar)[0] if pooled else np.asarray(jvar)
    np.testing.assert_allclose(tvar.numpy(), want, rtol=1e-6)
    assert float(tn) == float(np.asarray(jn).ravel()[0]) == (7.0 * C if pooled else 7.0)
    # the converter carries JAX's state over
    conv = welford_from_jax(jw.mean, jw.m2, jw.count)
    assert torch.equal(conv.mean, tw.mean) and float(conv.count) == 7.0


ADAPT_CASES = {
    # the 'half' schedule: Welford over burn // 2 draws, then the shrunk estimate
    "half": dict(adapt_mass=True, mass_schedule="half"),
    # windows (4, (9, 27)) inside burn 30: metric updates and DA restarts
    "windowed": dict(adapt_mass=True, mass_schedule="windowed"),
    # the same, the moments pooled over the chains and the step coupled
    "windowed_pooled": dict(adapt_mass=True, mass_schedule="windowed",
                            metric_axis="chains", da_axis="chains"),
}


def _from_jax(jstate, iteration):
    """The port's state from JAX's, with its Welford moments and metric."""
    w = jstate.welford
    return state_from_jax(jstate.position, jstate.log_prob, jstate.grad, None,
                          jstate.da.log_step, jstate.da.log_step_avg, jstate.da.h_bar,
                          jstate.da.mu, jstate.da.t, welford=(w.mean, w.m2, w.count),
                          inv_mass=jstate.inv_mass, iteration=iteration)


@pytest.mark.parametrize("case", sorted(ADAPT_CASES))
def test_adapt_mass_run_with_injected_jax_draws(case, one_torch_thread):
    """40 draws of 4 chains with dual averaging (burn 30) and the adaptive
    metric: JAX's kernel vmapped over chains runs the chain, and at every
    draw the port's transition starts from JAX's state (converted, Welford
    moments and carried metric included) with JAX's draws injected. At each
    draw: the same accept decisions, the step (rtol 1e-4), the positions,
    the Welford moments and the carried inverse mass (rtol 1e-5, atol 1e-6)
    and the dual-averaging state (atol 1e-4: the accept statistic's f32
    rounding scaled by the update, as in tests/test_torch_hmc.py); under the
    windowed schedule
    dual averaging restarts at each window's last draw. (The free-running
    chains drift apart: per-chain dual averaging feeds each f32 rounding
    back through the step, so the trace is held draw by draw.)"""
    kw = ADAPT_CASES[case]
    n_it, burn = 40, 30
    jcfg = JConfig(num_samples=n_it, num_leapfrog=5, step_size=0.05, burn=burn,
                   sampler="hmc_nuts", target_accept=0.7, **kw)
    tcfg = HMCConfig(num_samples=n_it, num_leapfrog=5, step_size=0.05, burn=burn,
                     sampler="hmc_nuts", target_accept=0.7, **kw)
    base = (SCALE ** 2 * 2.0).astype(np.float32)
    inits = _inits(11)
    jkernel = j_make_kernel(j_lp, jcfg, inv_mass=jnp.asarray(base))
    jstate = jax.vmap(lambda q: j_init_state(j_lp, q, jcfg, inv_mass=jnp.asarray(base)))(
        jnp.asarray(inits))
    tstate = init_state(t_lp, torch.as_tensor(inits), tcfg, None, inv_mass=torch.as_tensor(base))
    np.testing.assert_allclose(tstate.log_prob.numpy(), np.asarray(jstate.log_prob), rtol=1e-6)
    if "windowed" in case:
        assert torch.equal(tstate.inv_mass, torch.as_tensor(np.asarray(jstate.inv_mass)))
    tkernel = make_kernel(tcfg, torch.as_tensor(base), log_prob_fn=t_lp)
    step = jax.jit(jax.vmap(jkernel, in_axes=(0, 0, None), axis_name="chains"))
    ends = set(e - 1 for e in mass_window_schedule(burn)[1])
    steps, n_accept = [], 0
    for it in range(n_it):
        keys = jax.random.split(jax.random.key(500 + it), C)
        tstate, tinfo = tkernel(_from_jax(jstate, it), _noise(keys))
        jstate, jinfo = step(jstate, keys, it)
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
        np.testing.assert_allclose(tinfo["step_size"].numpy(), np.asarray(jinfo["step_size"]),
                                   rtol=1e-4)
        for got, want in ((tstate.position, jstate.position),
                          (tstate.welford.mean, jstate.welford.mean),
                          (tstate.welford.m2, jstate.welford.m2)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        assert float(tstate.welford.count) == float(np.asarray(jstate.welford.count)[0])
        for f in ("log_step", "log_step_avg", "h_bar", "t"):
            np.testing.assert_allclose(getattr(tstate.da, f).numpy(),
                                       np.asarray(getattr(jstate.da, f)), rtol=0, atol=1e-4)
        if "windowed" in case:
            np.testing.assert_allclose(tstate.inv_mass.numpy(), np.asarray(jstate.inv_mass),
                                       rtol=1e-5, atol=1e-6)
            restarted = it in ends
            assert bool((tstate.da.t == 0).all()) == restarted
            if restarted:
                assert torch.equal(tstate.da.log_step_avg, tstate.da.log_step)
        steps.append(tinfo["step_size"].numpy())
        n_accept += int(tinfo["accepted"].sum())
    assert 0 < n_accept < n_it * C
    assert len(np.unique(np.round(np.concatenate(steps), 6))) > 10  # the step adapted
    if case == "half":
        # the shrunk estimate the kernel uses from burn // 2 on
        var, n = pooled_variance(tstate.welford, None)
        jvar, jn = jax.vmap(lambda w: j_pooled(w, None))(jstate.welford)
        np.testing.assert_allclose((n / (n + 5.0) * var).numpy(),
                                   np.asarray(jn[:, None] / (jn[:, None] + 5.0) * jvar),
                                   rtol=1e-5)
        assert float(n) == 15.0
    else:
        # the adapted metric moved away from the base toward the target's variances
        assert not np.allclose(tstate.inv_mass.numpy(), base)
    assert tstate.iteration == n_it


def test_find_reasonable_step_size_with_injected_momenta():
    """Algorithm 4 per chain from JAX's momentum draw: the same searched step
    for each chain (rtol 1e-6: powers of two of the start), and init_state's
    dual averaging starts there."""
    inits = _inits(5)
    base = (SCALE ** 2).astype(np.float32)
    keys = jax.random.split(jax.random.key(9), C)
    jsteps = [float(j_find_step(jax.value_and_grad(j_lp), jnp.asarray(q), k, init_step=0.3,
                                inv_mass=jnp.asarray(base))) for q, k in zip(inits, keys)]
    z = torch.as_tensor(np.stack([np.asarray(jax.random.normal(k, (D,))) for k in keys]))
    q = torch.as_tensor(inits)
    tsteps = find_reasonable_step_size(lambda x: value_and_grad(t_lp, x, None), q, z,
                                       init_step=0.3, inv_mass=torch.as_tensor(base))
    np.testing.assert_allclose(tsteps.numpy(), jsteps, rtol=1e-6)
    assert len(set(jsteps)) > 1  # the chains searched to different steps
    cfg = HMCConfig(sampler="hmc_nuts", step_size=0.3, init_step_search=True)
    st = init_state(t_lp, q, cfg, None, inv_mass=torch.as_tensor(base), step_noise=z)
    np.testing.assert_allclose(torch.exp(st.da.log_step).numpy(), jsteps, rtol=1e-6)
    with pytest.raises(ValueError, match="step_noise"):
        init_state(t_lp, q, cfg, None, inv_mass=torch.as_tensor(base))


def test_da_restart_matches_jax():
    """The restart keeps the adapting step and resets the statistics."""
    state = j_da_init(0.2)._replace(log_step=jnp.float32(-1.3), h_bar=jnp.float32(0.2),
                                    t=jnp.float32(7.0), log_step_avg=jnp.float32(-1.1)) \
        if hasattr(j_da_init(0.2), "_replace") else j_da_init(0.2).replace(
            log_step=jnp.float32(-1.3), h_bar=jnp.float32(0.2), t=jnp.float32(7.0),
            log_step_avg=jnp.float32(-1.1))
    jr = j_da_restart(state)
    tr = da_restart(DualAveragingState(*(torch.tensor(float(getattr(state, f)))
                                         for f in ("log_step", "log_step_avg", "h_bar",
                                                   "mu", "t"))))
    for f in ("log_step", "log_step_avg", "h_bar", "mu", "t"):
        np.testing.assert_allclose(float(getattr(tr, f)), float(getattr(jr, f)), rtol=1e-7)


@pytest.mark.parametrize("iteration", [0, 1])
def test_persistent_momentum_transition_matches_jax(iteration, one_torch_thread):
    """One Horowitz transition (alpha 0.6) of 8 chains from a carried
    momentum with JAX's draws injected: draw 0 refreshes fully, a later draw
    mixes; accepted chains carry the trajectory's end momentum, rejected ones
    the flipped start momentum; positions and momenta within f32 rounding."""
    c = 8
    jcfg = JConfig(num_leapfrog=3, step_size=1.7, momentum_persistence=0.6)
    tcfg = HMCConfig(num_leapfrog=3, step_size=1.7, momentum_persistence=0.6)
    inits = _inits(21, c)
    base = (SCALE ** 2).astype(np.float32)
    carried = np.random.default_rng(22).normal(size=(c, D)).astype(np.float32) / np.sqrt(base)
    jstate = jax.vmap(lambda q: j_init_state(j_lp, q, jcfg, inv_mass=jnp.asarray(base)))(
        jnp.asarray(inits))
    jstate = jstate.replace(momentum=jnp.asarray(carried))
    tstate = state_from_jax(jstate.position, jstate.log_prob, jstate.grad, None,
                            jstate.da.log_step, jstate.da.log_step_avg, jstate.da.h_bar,
                            jstate.da.mu, jstate.da.t, momentum=carried, iteration=iteration)
    keys = jax.random.split(jax.random.key(77), c)
    noise = _noise(keys)
    jkernel = j_make_kernel(j_lp, jcfg, inv_mass=jnp.asarray(base))
    jnew, jinfo = jax.vmap(jkernel, in_axes=(0, 0, None))(jstate, keys, iteration)
    tnew, tinfo = make_kernel(tcfg, torch.as_tensor(base), log_prob_fn=t_lp)(tstate, noise)
    acc = tinfo["accepted"].numpy()
    np.testing.assert_array_equal(acc, np.asarray(jinfo["accepted"]))
    assert acc.any() and not acc.all()  # both branches
    np.testing.assert_allclose(tnew.position.numpy(), np.asarray(jnew.position),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tnew.momentum.numpy(), np.asarray(jnew.momentum),
                               rtol=1e-5, atol=1e-5)
    fresh = noise.z1.numpy() / np.sqrt(base)
    p0 = fresh if iteration == 0 else 0.6 * carried + 0.8 * fresh
    np.testing.assert_allclose(tnew.momentum.numpy()[~acc], -p0[~acc], rtol=1e-6, atol=1e-6)


def test_momentum_survives_segments():
    """The carried momentum is part of the state: two segments of a
    persistent run equal one call of the same draws."""
    from vihmc_torch.chains.resume import run_segments
    from vihmc_torch.hmc.kernel import draw_noise

    cfg = HMCConfig(num_samples=6, num_leapfrog=3, step_size=0.3, momentum_persistence=0.8)
    q = torch.as_tensor(_inits(4))
    kern = make_kernel(cfg, 1.0, log_prob_fn=t_lp)

    def run(segment):
        # one stream for every draw, whatever the segmenting
        gen = torch.Generator().manual_seed(1)

        def step(st, _segment_gen):
            return kern(st, draw_noise(gen, 1.0, C, D, "cpu"))

        return run_segments(step, init_state(t_lp, q, cfg, None), 6, segment, 1, 0, "cpu")

    st1, s1, _ = run(3)
    st2, s2, _ = run(6)
    np.testing.assert_array_equal(s1, s2)
    assert torch.equal(st1.momentum, st2.momentum) and st1.iteration == 6
    assert not torch.equal(st1.momentum, torch.zeros_like(st1.momentum))


def test_eigen_metric_matches_jax():
    """EigenMetric from two-sided Ritz pairs: its dense mass, velocity,
    kinetic energy and momentum draw (rtol 1e-5), the diagonal view, and the
    'both' Lanczos selection; the Hutchinson diagonal from JAX's probes."""
    rng = np.random.default_rng(8)
    d, k = 12, 4
    diag = (0.5 + rng.random(d)).astype(np.float32)
    v, _ = np.linalg.qr(rng.normal(size=(d, k)))
    lam = np.array([40.0, 3.0, 0.3, 0.001], np.float32)
    jmet = jm.eigen_metric_from_eigs(diag, lam, v.astype(np.float32), min_eig=0.01)
    tmet = tm.eigen_metric_from_eigs(diag, lam, v.astype(np.float32), min_eig=0.01)
    np.testing.assert_allclose(tmet.eigvals.numpy(), np.asarray(jmet.eigvals))
    np.testing.assert_allclose(tmet.dense().numpy(), np.asarray(jmet.dense()), rtol=1e-5,
                               atol=1e-6)
    p = rng.normal(size=(3, d)).astype(np.float32)
    z = rng.normal(size=(3, d)).astype(np.float32)
    jvel = np.stack([np.asarray(jm.mass_velocity(jmet, jnp.asarray(x))) for x in p])
    np.testing.assert_allclose(tm.mass_velocity(tmet, torch.as_tensor(p)).numpy(), jvel,
                               rtol=1e-5, atol=1e-6)
    jke = [float(jm.mass_kinetic_energy(jmet, jnp.asarray(x))) for x in p]
    np.testing.assert_allclose(tm.mass_kinetic_energy(tmet, torch.as_tensor(p)).numpy(), jke,
                               rtol=1e-5)
    # the momentum draw from the same normals JAX draws
    keys = jax.random.split(jax.random.key(3), 3)
    zj = np.stack([np.asarray(jax.random.normal(kk, (d,))) for kk in keys])
    jp = np.stack([np.asarray(jm.mass_sample_momentum(jmet, kk, jnp.zeros(d))) for kk in keys])
    np.testing.assert_allclose(tm.mass_sample_momentum(tmet, torch.as_tensor(zj)).numpy(), jp,
                               rtol=1e-5, atol=1e-6)
    assert tm.momentum_normals_shape(tmet, 3, d) == ((3, d), None)
    # the velocity inverts the mass
    np.testing.assert_allclose(tmet.dense().numpy() @ tm.mass_velocity(
        tmet, torch.as_tensor(z)).numpy().T, z.T, rtol=1e-3, atol=1e-3)
    assert torch.equal(tm.mass_diag_inv(tmet), tmet.diag_inv_mass)
    np.testing.assert_allclose(tm.mass_diag_inv(2.0, torch.zeros(d)).numpy(), 2.0)
    assert tm.as_inv_mass(tmet) is tmet and tm.as_inv_mass(0.5).dtype == torch.float32
    # Lanczos 'both' and the Hutchinson diagonal on a fixed SPD matrix
    a = rng.normal(size=(d, d)).astype(np.float32)
    a = a @ a.T / d + np.diag(np.linspace(0.1, 5, d)).astype(np.float32)
    v0 = rng.normal(size=d).astype(np.float32)
    tv, _ = tm.lanczos_eigs(lambda x: torch.as_tensor(a) @ x, d, 4, num_iters=d,
                            v0=torch.as_tensor(v0), which="both")
    ev = np.linalg.eigvalsh(a.astype(np.float64))
    np.testing.assert_allclose(tv.numpy(), [ev[-1], ev[-2], ev[0], ev[1]], rtol=1e-3)
    hkeys = jax.random.split(jax.random.key(5), 6)
    probes = np.stack([np.asarray(jax.random.rademacher(kk, (d,), jnp.float32))
                       for kk in hkeys])
    jdiag = jm.hutchinson_diag(lambda x: jnp.asarray(a) @ x, d, 6, jax.random.key(5))
    tdiag = tm.hutchinson_diag(lambda x: torch.as_tensor(a) @ x, d, 6,
                               probes=torch.as_tensor(probes))
    np.testing.assert_allclose(tdiag.numpy(), np.asarray(jdiag), rtol=1e-5, atol=1e-6)


def test_windowed_adaptation_recovers_anisotropic_variances(one_torch_thread):
    """The counterpart of tests/test_mass_adaptation.py:88 (its config, 4
    chains): windowed warmup on a 100:1 Gaussian recovers each scale (rtol
    0.25) and ends with a carried inverse mass that separates the scales
    (ratio > 100, sqrt within rtol 0.5 of the scales)."""
    scale = torch.tensor([0.1, 10.0])

    def lp(q):
        return -0.5 * ((q / scale) ** 2).sum(-1)

    cfg = HMCConfig(num_samples=3000, num_leapfrog=10, step_size=0.05, burn=1000,
                    sampler="hmc_nuts", adapt_mass=True, mass_schedule="windowed")
    res = sample(lp, torch.zeros(4, 2), cfg, seed=0)
    post = res.samples[:, 1000:].reshape(-1, 2)
    np.testing.assert_allclose(post.std(0), scale.numpy(), rtol=0.25)
    assert 0.5 < float(np.mean(res.accept_probs[:, 1000:])) <= 1.0
    inv_mass = res.final_state.inv_mass.numpy()
    assert (inv_mass[:, 1] / inv_mass[:, 0] > 100.0).all()
    np.testing.assert_allclose(np.sqrt(inv_mass), np.broadcast_to(scale.numpy(), (4, 2)),
                               rtol=0.5)
    # one chain given as a (d,) position returns (S, ...) arrays
    one = sample(lp, torch.zeros(2), dataclasses.replace(cfg, num_samples=5, burn=0))
    assert one.samples.shape == (5, 2) and one.accepted.shape == (5,)
