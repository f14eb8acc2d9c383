"""PyTorch port parity: the fused merge-NLL (``merge_sums`` and its closure,
the custom backward, the chain batch), the leapfrog update, and the fused
DeepONet log-posterior.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_ops.py`` does; the port's wrappers take their plain versions on
CPU tensors. The CUDA kernels themselves run only on a card: their tests are
in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import tiny_problem

import vihmc_torch.ops.deeponet_merge as tmerge
from vihmc_tpu.ops.deeponet_merge import fused_merge_nll as j_fused_nll
from vihmc_tpu.ops.leapfrog import fused_leapfrog_update as j_leapfrog_update
from vihmc_tpu.pipelines.common import make_deeponet_nll_log_posterior as j_make_lp
from vihmc_torch.core.profiling import counter
from vihmc_torch.ops.deeponet_merge import (fused_merge_nll, merge_nll_reference,
                                            merge_sums, merge_sums_reference)
from vihmc_torch.ops.leapfrog import (fused_leapfrog_update,
                                      leapfrog_update_reference)
from vihmc_torch.pipelines.common import make_deeponet_nll_log_posterior

SHAPES = {"tile_exact": (256, 256, 32), "ragged": (130, 301, 12)}


def _merge_inputs(seed, c, b, p, k):
    """Features, biases and data at the scale of tests/test_ops.py:36-98."""
    rng = np.random.default_rng(seed)
    bout = (0.1 * rng.normal(size=(c, b, k))).astype(np.float32)
    tout = (0.1 * rng.normal(size=(c, p, k))).astype(np.float32)
    bias = rng.uniform(-0.8, 0.8, size=c).astype(np.float32)
    y = (0.1 * rng.normal(size=(b, p))).astype(np.float32)
    return bout, tout, bias, y


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_merge_nll_forward_matches_interpret_kernel(shape):
    """One chain at a tile-exact and a ragged shape: the port's ll (plain
    sums, f64 closure) against JAX ``fused_merge_nll(interpret=True)`` and the
    JAX materialized reference, rtol 1e-5."""
    b, p, k = SHAPES[shape]
    bout, tout, bias, y = _merge_inputs(11, 1, b, p, k)
    tau = 0.8
    want = float(j_fused_nll(jnp.asarray(bout[0]), jnp.asarray(tout[0]),
                             jnp.asarray(bias[0]), jnp.asarray(y), tau, interpret=True))
    got = fused_merge_nll(*(torch.as_tensor(a) for a in (bout, tout, bias, y)), tau)
    assert got.shape == (1,) and got.dtype == torch.float32
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-5)
    ref = merge_nll_reference(*(torch.as_tensor(a) for a in (bout, tout, bias, y)), tau)
    np.testing.assert_allclose(float(ref[0]), want, rtol=1e-5)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_merge_nll_gradient_matches_jax_custom_vjp(shape):
    """d ll / d (bout, tout, bias) of the port's autograd.Function against
    ``jax.grad`` through the JAX custom VJP (interpret kernel): rtol 1e-4,
    atol 1e-4 of each gradient's scale. The bias gradient is the closed form
    -(sum(pred - b) - sum y + N b) / var on both sides."""
    b, p, k = SHAPES[shape]
    bout, tout, bias, y = _merge_inputs(12, 1, b, p, k)
    tau = 0.6
    jy = jnp.asarray(y)
    want = jax.grad(lambda bo, to, bi: j_fused_nll(bo, to, bi, jy, tau, interpret=True),
                    argnums=(0, 1, 2))(jnp.asarray(bout[0]), jnp.asarray(tout[0]),
                                       jnp.asarray(bias[0]))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (bout, tout, bias)]
    ll = fused_merge_nll(*leaves, torch.as_tensor(y), tau)
    got = torch.autograd.grad(ll.sum(), leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g[0].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-30))


def test_fused_merge_nll_chain_batch_matches_jax_vmap():
    """Three chains in one call (one merge_sums evaluation) against
    ``jax.vmap`` of the interpret kernel (its custom vmap rule runs the
    chain-batched Pallas kernel): ll rtol 1e-5; ``vmap(grad)`` rtol 1e-4."""
    bout, tout, bias, y = _merge_inputs(13, 3, 130, 301, 12)
    tau = 1.0
    jy = jnp.asarray(y)

    def one(bo, to, bi):
        return j_fused_nll(bo, to, bi, jy, tau, interpret=True)

    args_j = [jnp.asarray(a) for a in (bout, tout, bias)]
    want = np.asarray(jax.vmap(one)(*args_j))
    want_g = jax.vmap(jax.grad(one, argnums=(0, 1, 2)))(*args_j)
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (bout, tout, bias)]
    got = fused_merge_nll(*leaves, torch.as_tensor(y), tau)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    got_g = torch.autograd.grad(got.sum(), leaves)
    for g, w in zip(got_g, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_merge_sums_plain_version_and_wrapper_checks():
    """The plain sums against float64 (each within 1e-6 of the sum of its
    terms' magnitudes: f32 products, f64 sums); on CPU tensors the wrapper
    takes the plain version and counts no launch; a wrong dtype, shape,
    layout or device raises before any launch."""
    bout, tout, _, y = _merge_inputs(14, 2, 37, 53, 9)
    t = [torch.as_tensor(a) for a in (bout, tout, y)]
    got = merge_sums(*t)
    assert got.shape == (2, 2) and got.dtype == torch.float64
    b64, t64, y64 = (a.double() for a in t)
    m = b64 @ t64.transpose(-1, -2)
    want = torch.stack([(m * (m - 2 * y64)).sum((1, 2)), m.sum((1, 2))], -1)
    mag = torch.stack([(m * m + 2 * (m * y64).abs()).sum((1, 2)), m.abs().sum((1, 2))], -1)
    assert float(((got - want).abs() / mag).max()) < 1e-6
    assert torch.equal(got, merge_sums_reference(*t))
    n = counter("merge_sums.launches")
    with pytest.raises(TypeError):
        merge_sums(t[0].double(), t[1], t[2])
    with pytest.raises(ValueError):
        merge_sums(t[0], t[1][:, :-1], t[2])
    with pytest.raises(ValueError):
        merge_sums(t[0], t[1].transpose(1, 2).contiguous().transpose(1, 2), t[2])
    with pytest.raises(ValueError):
        merge_sums(t[0], t[1], t[2].to("meta"))
    assert counter("merge_sums.launches") == n


@pytest.mark.parametrize("mass", ["scalar", "diagonal", "identity"])
def test_leapfrog_update_matches_interpret_kernel(mass):
    """``(C, D)`` batch, D = 5000 (not a multiple of the Pallas block): the
    port's update (plain version on the CPU) against JAX's
    ``fused_leapfrog_update(interpret=True)`` row by row, atol 1e-6 on O(1)
    values (tests/test_ops.py:15-33; the two round each product and sum in
    the same order), and against ``leapfrog_update_reference``."""
    rng = np.random.default_rng(15)
    c, d = 3, 5000
    q, p, g = (rng.normal(size=(c, d)).astype(np.float32) for _ in range(3))
    im = {"scalar": 0.7, "diagonal": (0.5 + rng.random(d)).astype(np.float32),
          "identity": None}[mass]
    eps = 1e-2
    q_t, p_t = fused_leapfrog_update(*(torch.as_tensor(a) for a in (q, p, g)), eps, im)
    for r in range(c):
        jq, jp = j_leapfrog_update(jnp.asarray(q[r]), jnp.asarray(p[r]), jnp.asarray(g[r]),
                                   eps, None if im is None else jnp.asarray(im),
                                   interpret=True)
        np.testing.assert_allclose(q_t[r].numpy(), np.asarray(jq), rtol=0, atol=1e-6)
        np.testing.assert_allclose(p_t[r].numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    im_t = torch.as_tensor(1.0 if im is None else im, dtype=torch.float32)
    rq, rp = leapfrog_update_reference(*(torch.as_tensor(a) for a in (q, p, g)), eps, im_t)
    assert torch.equal(q_t, rq) and torch.equal(p_t, rp)


def test_leapfrog_update_wrapper_checks():
    """Mismatched shapes, a wrong mass shape, a non-float32 tensor or a
    non-contiguous one raise; CPU tensors count no launch."""
    q = torch.zeros(2, 7)
    n = counter("leapfrog_update.launches")
    with pytest.raises(ValueError):
        fused_leapfrog_update(q, torch.zeros(2, 6), q, 0.1)
    with pytest.raises(ValueError):
        fused_leapfrog_update(q, q, q, 0.1, torch.ones(6))
    with pytest.raises(TypeError):
        fused_leapfrog_update(q.double(), q, q, 0.1)
    with pytest.raises(ValueError):
        fused_leapfrog_update(torch.zeros(7, 2).T, q, q, 0.1)
    fused_leapfrog_update(q, q, q, 0.1, 2.0)
    assert counter("leapfrog_update.launches") == n


# the helpers' tiny DeepONet, and TINY_DEEPONET of tests/test_pipelines.py
@pytest.mark.parametrize("cfg_kw", [
    dict(in_branch=7, in_trunk=5, width_branch=12, width_trunk=12, depth_branch=3,
         depth_trunk=3),
    dict(in_branch=9, in_trunk=5, width_branch=8, width_trunk=8, depth_branch=3,
         depth_trunk=3),
])
def test_deeponet_nll_log_posterior_matches_jax(cfg_kw):
    """The fused log-posterior of the port (3 chains, f32 features, one sums
    evaluation) against JAX ``make_deeponet_nll_log_posterior`` per chain on
    a tiny DeepONet: ll rtol 1e-5, its gradient rtol 1e-4 of the scale;
    ``use_fused=False`` agrees with the fused form to rtol 1e-5."""
    from vihmc_tpu.models import DeepONetConfig as JCfg
    from vihmc_torch.models.deeponet import DeepONetConfig as TCfg

    jcfg, tcfg = JCfg(**cfg_kw), TCfg(**cfg_kw)
    rng = np.random.default_rng(16)
    d = tcfg.num_params
    bx = rng.normal(size=(9, cfg_kw["in_branch"])).astype(np.float32)
    tx = rng.uniform(size=(20, 2)).astype(np.float32)
    y = (0.5 * rng.normal(size=(9, 20))).astype(np.float32)
    tau = 0.5
    flats = (0.3 * rng.normal(size=(3, d))).astype(np.float32)
    jlp, _, _ = j_make_lp(jcfg, jnp.asarray(bx), jnp.asarray(tx), jnp.asarray(y), tau)
    t_in = [torch.as_tensor(a) for a in (bx, tx, y)]
    lp = make_deeponet_nll_log_posterior(tcfg, *t_in, tau)
    x = torch.as_tensor(flats).requires_grad_(True)
    got = lp(x)
    (g,) = torch.autograd.grad(got.sum(), x)
    got = got.detach()
    plain = make_deeponet_nll_log_posterior(tcfg, *t_in, tau,
                                            use_fused=False)(torch.as_tensor(flats))
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5)
    for c in range(3):
        want, want_g = jax.value_and_grad(jlp)(jnp.asarray(flats[c]))
        np.testing.assert_allclose(float(got[c]), float(want), rtol=1e-5)
        w = np.asarray(want_g)
        np.testing.assert_allclose(g[c].numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()))


def test_fused_density_counts_one_sums_evaluation_per_call(monkeypatch):
    """Every fused density evaluation, forward or under autograd, computes
    the merge sums once for all chains (the launch the card counts)."""
    calls = []
    real = tmerge.merge_sums_reference

    def counted(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(tmerge, "merge_sums_reference", counted)
    tp = tiny_problem(seed=17)
    lp = make_deeponet_nll_log_posterior(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau)
    x = tp.t("mu").expand(4, -1).clone().requires_grad_(True)
    torch.autograd.grad(lp(x).sum(), x)
    lp(x.detach())
    assert calls == [4, 4]
