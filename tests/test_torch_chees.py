"""PyTorch port parity: ChEES-HMC with cross-chain trajectory-length
adaptation.

A 6-draw run of coupled chains against JAX's ``chees_sample`` with JAX's
momentum normals and accept uniforms injected, on the exact gradient and on
a surrogate field; the Halton sequence; then moment recovery and trajectory
growth (the counterparts of tests/test_chees.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_convert import chees_state_from_jax
from torch_parity_helpers import one_torch_thread  # noqa: F401 (a fixture)

from vihmc_tpu.hmc.chees import ChEESConfig as JChEESConfig
from vihmc_tpu.hmc.chees import chees_sample as j_chees_sample
from vihmc_tpu.hmc.chees import halton_base2 as j_halton
from vihmc_torch.chains import sample_chains_chees
from vihmc_torch.hmc.chees import (ChEESConfig, ChEESNoise, chees_sample, halton_base2,
                                   init_chees_state, make_chees_kernel)
from vihmc_torch.hmc.kernel import gaussian_field_grad

C, D, S = 6, 4, 6
LOC = np.array([0.3, -0.2, 0.0, 0.5], np.float32)
SCALE = np.array([0.3, 1.0, 0.5, 2.0], np.float32)


def j_lp(q, aux=None):
    return -0.5 * jnp.sum(((q - LOC) / SCALE) ** 2)


def t_lp(q, aux=None):
    return -0.5 * (((q - torch.as_tensor(LOC)) / torch.as_tensor(SCALE)) ** 2).sum(-1)


def j_field(q, aux=None):
    """A surrogate trajectory field: the score of a 1.2x wider Gaussian."""
    return -(q - LOC) / (1.2 * SCALE ** 2)


def test_halton_base2_matches_jax():
    """The Van der Corput points, bit for bit, including the first values."""
    assert [halton_base2(i) for i in range(4)] == [0.5, 0.25, 0.75, 0.125]
    for i in (0, 1, 5, 17, 100, 575, 2879, 123456):
        assert halton_base2(i) == float(j_halton(jnp.asarray(i)))


@pytest.mark.parametrize("field", [False, True])
def test_chees_run_with_injected_jax_draws(field, one_torch_thread):
    """6 draws of 6 coupled chains in burn (step and log T adapting), JAX's
    draws injected: at every draw the same step count and accept decisions,
    the positions (rtol 1e-5, atol 1e-5), the shared step and trajectory
    length (rtol 1e-5); at the end log T, the Adam moments and the dual
    averaging (rtol 1e-5, atol 1e-5: the Adam moments sum cross-chain
    products of order 1 to 10)."""
    rng = np.random.default_rng(2)
    inits = (LOC + SCALE * rng.normal(size=(C, D))).astype(np.float32)
    inv_mass = (SCALE ** 2).astype(np.float32)
    kw = dict(num_samples=S, step_size=0.3, init_traj_length=1.2, burn=S, max_steps=32)
    key = jax.random.key(14)
    jres = jax.jit(lambda k: j_chees_sample(
        j_lp, jnp.asarray(inits), k, JChEESConfig(**kw), inv_mass=jnp.asarray(inv_mass),
        grad_fn=j_field if field else None))(key)
    cfg = ChEESConfig(**kw)
    tfield = gaussian_field_grad(torch.as_tensor(LOC), torch.as_tensor(SCALE), 1.2) \
        if field else None
    tim = torch.as_tensor(inv_mass)
    state = init_chees_state(t_lp, torch.as_tensor(inits), cfg, grad_fn=tfield)
    kernel = make_chees_kernel(t_lp, cfg, tim, grad_fn=tfield)
    n_accept = 0
    for i, k in enumerate(jax.random.split(key, S)):
        k_mom, k_u, _ = jax.random.split(k, 3)
        noise = ChEESNoise(z=torch.as_tensor(np.asarray(jax.random.normal(k_mom, (C, D)))),
                           u_accept=torch.as_tensor(np.asarray(jax.random.uniform(k_u, (C,)))))
        state, info = kernel(state, noise)
        assert info["n_steps"] == int(jres.aux_trace["n_steps"][i])
        np.testing.assert_array_equal(info["accepted"].numpy(), np.asarray(jres.accepted[:, i]))
        np.testing.assert_allclose(state.position.numpy(), np.asarray(jres.samples[:, i]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(info["step_size"][0]), float(jres.step_sizes[i]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(info["traj_length"]),
                                   float(jres.aux_trace["traj_length"][i]), rtol=1e-5)
        n_accept += int(info["accepted"].sum())
    assert 0 < n_accept < S * C
    assert len(set(int(n) for n in np.asarray(jres.aux_trace["n_steps"]))) > 1
    fs = jres.final_state
    for got, want in ((state.log_T, fs.log_T), (state.adam_m, fs.adam_m),
                      (state.adam_v, fs.adam_v), (state.da.log_step, fs.da.log_step),
                      (state.da.log_step_avg, fs.da.log_step_avg)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    assert float(state.adam_t) == float(fs.adam_t) == S
    # the converter carries JAX's final state over
    conv = chees_state_from_jax(fs.positions, fs.log_probs, fs.grads, fs.da.log_step,
                                fs.da.log_step_avg, fs.da.h_bar, fs.da.mu, fs.da.t, fs.log_T,
                                fs.adam_m, fs.adam_v, fs.adam_t, iteration=S)
    np.testing.assert_allclose(conv.position.numpy(), state.position.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert conv.iteration == S and conv.aux is None


def test_chees_recovers_standard_normal_moments(one_torch_thread):
    """The counterpart of tests/test_chees.py:17 (its config): 8 chains x 400
    post-burn draws recover N(0, I_3) within 0.1, acceptance near the 0.651
    target, no divergence; the step trace is shared (S,)."""
    cfg = ChEESConfig(num_samples=600, step_size=0.2, init_traj_length=0.4, burn=200,
                      max_steps=64)
    gen = torch.Generator().manual_seed(0)
    res = sample_chains_chees(lambda q: -0.5 * (q * q).sum(-1),
                              torch.randn((8, 3), generator=gen), cfg, seed=1)
    post = res.samples[:, 200:].reshape(-1, 3)
    np.testing.assert_allclose(post.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(post.std(0), 1.0, atol=0.1)
    assert 0.45 < res.accept_probs[:, 200:].mean() < 0.95
    assert not res.divergent.any() and res.step_sizes.shape == (600,)


def test_chees_grows_trajectory_on_wide_target(one_torch_thread):
    """The counterpart of tests/test_chees.py:36 (its config): on a std-10
    Gaussian from T = 1 the ChEES gradient pushes T above 5, the step counts
    stay within [1, max_steps], and the draws recover the std within 20 %."""
    cfg = ChEESConfig(num_samples=400, step_size=0.5, init_traj_length=1.0, burn=300,
                      max_steps=128)
    gen = torch.Generator().manual_seed(2)
    res = chees_sample(lambda q: -0.5 * ((q / 10.0) ** 2).sum(-1),
                       10.0 * torch.randn((16, 2), generator=gen), cfg, seed=3)
    assert float(torch.exp(res.final_state.log_T)) > 5.0
    n_steps = res.aux_trace["n_steps"]
    assert n_steps.min() >= 1 and n_steps.max() <= 128
    np.testing.assert_allclose(res.samples[:, 300:].reshape(-1, 2).std(0), 10.0, rtol=0.2)
