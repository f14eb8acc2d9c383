"""One tiny DeepONet subspace posterior, built identically in JAX and in the
PyTorch port, for the ``test_torch_*`` parity tests.

Inputs are made with numpy from a seed and handed to both sides; the flat
parameter layout is ``ravel_pytree`` order on both.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vihmc_tpu.dists.priors import DiagonalGaussianPrior as JPrior
from vihmc_tpu.hmc import SubspaceSpec as JSpec
from vihmc_tpu.models import DeepONetConfig as JCfg
from vihmc_torch.dists.priors import DiagonalGaussianPrior as TPrior
from vihmc_torch.hmc.subspace import SubspaceSpec as TSpec
from vihmc_torch.models.deeponet import DeepONetConfig as TCfg

# the --quick DeepONet of bench.py, narrowed
CFG_KW = dict(in_branch=7, in_trunk=5, width_branch=12, width_trunk=12,
              depth_branch=3, depth_trunk=3)


@dataclasses.dataclass
class Tiny:
    jcfg: object
    tcfg: object
    bx: np.ndarray
    tx: np.ndarray
    y: np.ndarray
    mu: np.ndarray
    sigma: np.ndarray
    idx: np.ndarray
    frozen: np.ndarray
    tau: float
    jspec: object
    jprior: object
    tspec: object
    tprior: object

    def t(self, name):
        return torch.as_tensor(getattr(self, name))


def tiny_problem(seed=0, n_fn=9, nt=5, nx=4, sub_dim=16, tau=0.5, y_scale=0.5):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = JCfg(**CFG_KW), TCfg(**CFG_KW)
    d = tcfg.num_params
    bx = rng.normal(size=(n_fn, CFG_KW["in_branch"])).astype(np.float32)
    t = np.linspace(0, 1, nt, dtype=np.float32)
    x = np.linspace(0, 1, nx, dtype=np.float32)
    tt, xx = np.meshgrid(t, x, indexing="ij")
    tx = np.stack([tt.ravel(), xx.ravel()], -1).astype(np.float32)
    y = (y_scale * rng.normal(size=(n_fn, nt * nx))).astype(np.float32)
    mu = (0.3 * rng.normal(size=d)).astype(np.float32)
    sigma = (0.05 + 0.05 * rng.random(d)).astype(np.float32)
    idx = np.sort(rng.choice(d, size=sub_dim, replace=False))
    frozen = (mu + sigma * rng.normal(size=d)).astype(np.float32)
    jspec = JSpec(idx=tuple(int(i) for i in idx), mu=jnp.asarray(mu),
                  sigma=jnp.asarray(sigma))
    jprior = JPrior(loc=jspec.sub_mu(), scale=jspec.sub_sigma())
    tspec = TSpec(idx=torch.as_tensor(idx, dtype=torch.int64),
                  mu=torch.as_tensor(mu), sigma=torch.as_tensor(sigma))
    tprior = TPrior(loc=tspec.sub_mu(), scale=tspec.sub_sigma())
    return Tiny(jcfg, tcfg, bx, tx, y, mu, sigma, idx, frozen, tau, jspec,
                jprior, tspec, tprior)


def assert_shared_fields_equal(tcfg, jcfg):
    """Every field of the port's config is one of the JAX config's and holds
    the same value (a JAX field with no effect anywhere has no counterpart)."""
    tf, jf = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert set(tf) <= set(jf), sorted(set(tf) - set(jf))
    assert tf == {k: jf[k] for k in tf}


@pytest.fixture
def one_torch_thread():
    """One CPU thread for torch: the port's tiny models run faster so, and the
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_transition_draws(key, d):
    """One JAX HMC transition's draws with a diagonal metric (kernel.py:494,
    metric.py:216, kernel.py:552, :649): the momentum normals, the jitter
    and the accept uniforms."""
    import jax

    key_mom, key_u, _, key_jit = jax.random.split(key, 4)
    return (np.asarray(jax.random.normal(key_mom, (d,), jnp.float32)),
            float(jax.random.uniform(key_jit, ())), float(jax.random.uniform(key_u)))


def jax_deeponet_eps(key, cfg, num_ens):
    """The weight normals JAX's Bayesian DeepONet loss draws from ``key``
    (train.py:115, bayesian.py:235): per member ``kb, kt, kbias``, each
    stack's layer keys split into ``kw, kb``; flat order (merge bias, then
    per layer b, w)."""
    import jax

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
