"""PyTorch port parity: the chain-batched multinomial NUTS.

One NUTS transition of every chain against JAX's ``nuts_sample`` with JAX's
own directions, merge and swap uniforms and momenta injected (rebuilt here
from JAX's key splits), on the exact gradient and on a surrogate field; then
moment recovery on Gaussians (the counterparts of tests/test_nuts.py).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)

from vihmc_tpu.hmc.nuts import NUTSConfig as JNUTSConfig
from vihmc_tpu.hmc.nuts import nuts_sample as j_nuts_sample
from vihmc_torch.chains import sample_chains_nuts
from vihmc_torch.hmc.kernel import gaussian_field_grad
from vihmc_torch.hmc.nuts import (NUTSConfig, NUTSNoise, init_nuts_state, make_nuts_kernel,
                                  num_merges, nuts_sample)

C, D, DEPTH = 3, 5, 3
LOC = np.array([0.3, -0.2, 0.0, 0.5, 0.1], np.float32)
SCALE = np.array([0.05, 0.3, 1.0, 0.1, 2.0], np.float32)


def j_lp(q, aux=None):
    return -0.5 * jnp.sum(((q - LOC) / SCALE) ** 2)


def t_lp(q, aux=None):
    return -0.5 * (((q - torch.as_tensor(LOC)) / torch.as_tensor(SCALE)) ** 2).sum(-1)


def j_field(q, aux=None):
    """A surrogate trajectory field: the score of a 1.3x wider Gaussian."""
    return -(q - LOC) / (1.3 * SCALE ** 2)


@contextlib.contextmanager
def _capture_scan(store):
    """Record the outputs of the sampler's draw scan (its per-draw info,
    ``tree_leaves`` included, which the JAX result drops)."""
    real = jax.lax.scan

    def scan(f, init, xs, *a, **kw):
        out = real(f, init, xs, *a, **kw)
        store["outs"] = out[1]
        return out

    jax.lax.scan = scan
    try:
        yield
    finally:
        jax.lax.scan = real


def _merge_uniforms(key, depth):
    """The merge uniforms of one subtree in the order build_tree consumes
    them (nuts.py:157-169): the first half's, the second half's, its own."""
    if depth == 0:
        return []
    k1, k2, k3 = jax.random.split(key, 3)
    return (_merge_uniforms(k1, depth - 1) + _merge_uniforms(k2, depth - 1)
            + [float(jax.random.uniform(k3))])


def _jax_nuts_draws(key):
    """One chain's draws of its first transition (nuts.py:210, :261-269)."""
    (k,) = jax.random.split(key, 1)
    key_mom, key_dirs, key_tree, key_swap, _key_aux = jax.random.split(k, 5)
    z = np.asarray(jax.random.normal(key_mom, (D,)))
    dirs = np.asarray(jax.random.rademacher(key_dirs, (DEPTH,), dtype=jnp.float32))
    tree_keys = jax.random.split(key_tree, DEPTH)
    swap_keys = jax.random.split(key_swap, DEPTH)
    u_swap = [float(jax.random.uniform(sk)) for sk in swap_keys]
    u_merge = sum((_merge_uniforms(tree_keys[j], j) for j in range(DEPTH)), [])
    return z, dirs, u_swap, u_merge


CASES = {
    # the exact gradient, preconditioned: U-turns stop some trees early
    "autodiff": dict(step=0.9, field=False, inv_mass="scale"),
    # the surrogate field (exact densities at the leaves), preconditioned
    "field": dict(step=0.6, field=True, inv_mass="scale"),
    # a step past the stiff coordinate's stability limit: divergences
    "divergent": dict(step=0.4, field=False, inv_mass=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nuts_transition_with_injected_jax_draws(case, one_torch_thread):
    """One transition of 3 chains (depth 3, burn 1): the proposal (rtol 1e-5,
    atol 1e-6), the leaves merged before the tree stopped, the acceptance
    statistic (atol 1e-5), the divergence and moved flags and the adapted
    step (atol 1e-5) are JAX's."""
    kw = CASES[case]
    inv_mass = (SCALE ** 2).astype(np.float32) if kw["inv_mass"] == "scale" else \
        np.float32(kw["inv_mass"])
    rng = np.random.default_rng(12)
    inits = (LOC + 0.7 * SCALE * rng.normal(size=(C, D))).astype(np.float32)
    jcfg = JNUTSConfig(num_samples=1, max_depth=DEPTH, step_size=kw["step"], burn=1)
    keys = jax.random.split(jax.random.key(31), C)
    store = {}
    jfield = j_field if kw["field"] else None

    def one(k, q):
        res = j_nuts_sample(j_lp, q, k, jcfg, inv_mass=jnp.asarray(inv_mass), grad_fn=jfield)
        return res, store["outs"]["tree_leaves"], res.final_state.da.log_step

    with _capture_scan(store):
        jres, jleaves, jlog_step = jax.jit(jax.vmap(one))(keys, jnp.asarray(inits))
    draws = [_jax_nuts_draws(k) for k in keys]
    noise = NUTSNoise(z=torch.as_tensor(np.stack([d[0] for d in draws])),
                      directions=torch.as_tensor(np.stack([d[1] for d in draws])),
                      u_swap=torch.tensor([d[2] for d in draws]),
                      u_merge=torch.tensor([d[3] for d in draws]))
    assert noise.u_merge.shape == (C, num_merges(DEPTH)) == (C, 4)
    tcfg = NUTSConfig(num_samples=1, max_depth=DEPTH, step_size=kw["step"], burn=1)
    tfield = gaussian_field_grad(torch.as_tensor(LOC), torch.as_tensor(SCALE), 1.3) \
        if kw["field"] else None
    tim = torch.as_tensor(inv_mass)
    state = init_nuts_state(t_lp, torch.as_tensor(inits), tcfg, inv_mass=tim, grad_fn=tfield)
    new, info = make_nuts_kernel(t_lp, tcfg, tim, grad_fn=tfield)(state, noise)
    np.testing.assert_allclose(new.position.numpy(), np.asarray(jres.samples[:, 0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(info["tree_leaves"].numpy(), np.asarray(jleaves)[:, 0])
    np.testing.assert_allclose(info["accept_prob"].numpy(), np.asarray(jres.accept_probs[:, 0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(info["divergent"].numpy(), np.asarray(jres.divergent[:, 0]))
    np.testing.assert_array_equal(info["accepted"].numpy(), np.asarray(jres.accepted[:, 0]))
    np.testing.assert_allclose(new.da.log_step.numpy(), np.asarray(jlog_step), rtol=0,
                               atol=1e-5)
    leaves = info["tree_leaves"].numpy()
    if case == "divergent":
        assert info["divergent"].any()
    else:
        assert not info["divergent"].any()
    if case == "autodiff":
        assert (leaves < 2 ** DEPTH - 1).any()  # some tree stopped early (masked)
    assert (leaves <= 2 ** DEPTH - 1).all()


def test_nuts_standard_normal_moments(one_torch_thread):
    """The counterpart of tests/test_nuts.py:16: 64 chains x 200 post-burn
    draws recover N(0, I_3) (mean and std within 0.06, i.e. ~5 MC standard
    errors of the pooled draws), no divergence after adaptation, and the
    trees use at most 2^depth - 1 leaves."""
    cfg = NUTSConfig(num_samples=300, max_depth=4, step_size=0.5, burn=100)
    res = sample_chains_nuts(lambda q: -0.5 * (q * q).sum(-1), torch.zeros(64, 3), cfg, seed=0)
    post = res.samples[:, 100:].reshape(-1, 3)
    np.testing.assert_allclose(post.mean(0), 0.0, atol=0.06)
    np.testing.assert_allclose(post.std(0), 1.0, atol=0.06)
    assert int(res.divergent[:, 100:].sum()) == 0
    leaves = res.aux_trace["tree_leaves"]
    assert leaves.shape == (64, 300) and 1 <= leaves.min() and leaves.max() <= 15


def test_nuts_correlated_gaussian_with_adapted_mass(one_torch_thread):
    """The counterparts of tests/test_nuts.py:28 and :43: a 0.95-correlated
    Gaussian's covariance within 0.2, and with the windowed adaptive metric a
    100:1 anisotropic one's scales within 30 %."""
    cov = torch.tensor([[1.0, 0.95], [0.95, 1.0]])
    prec = torch.linalg.inv(cov)
    cfg = NUTSConfig(num_samples=300, max_depth=4, step_size=0.25, burn=100)
    res = nuts_sample(lambda q: -0.5 * ((q @ prec) * q).sum(-1), torch.zeros(32, 2), cfg,
                      seed=1)
    emp = np.cov(res.samples[:, 100:].reshape(-1, 2).T)
    np.testing.assert_allclose(emp, cov.numpy(), atol=0.2)
    scale = torch.tensor([0.05, 5.0])
    cfg = NUTSConfig(num_samples=260, max_depth=4, step_size=0.05, burn=160,
                     adapt_mass=True, mass_schedule="windowed", metric_axis="chains")
    res = nuts_sample(lambda q: -0.5 * ((q / scale) ** 2).sum(-1), torch.zeros(32, 2), cfg,
                      seed=2)
    np.testing.assert_allclose(res.samples[:, 160:].reshape(-1, 2).std(0), scale.numpy(),
                               rtol=0.3)
    inv_mass = res.final_state.inv_mass.numpy()
    assert (inv_mass[:, 1] / inv_mass[:, 0] > 100.0).all()
    # one chain as a (d,) position
    one = nuts_sample(lambda q: -0.5 * (q * q).sum(-1), torch.zeros(2),
                      NUTSConfig(num_samples=4, max_depth=2))
    assert one.samples.shape == (4, 2) and one.aux_trace["tree_leaves"].shape == (4,)
