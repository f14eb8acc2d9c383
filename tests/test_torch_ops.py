"""PyTorch port parity: the paired-sums kernel's plain version and closure,
the subspace paired deltas, and the Gram trajectory gradient.

The JAX side runs its Pallas kernel in interpret mode, as ``tests/test_ops.py``
does. The CUDA kernel itself runs only on a card: its tests are in
``tests/test_torch_cuda.py``, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import tiny_problem

from vihmc_tpu.ops.deeponet_merge import _make_paired_sums
from vihmc_tpu.ops.deeponet_merge import fused_paired_delta as j_fused
from vihmc_tpu.ops.deeponet_merge import paired_delta_reference as j_ref
from vihmc_torch.ops.deeponet_merge import (fused_paired_delta,
                                            paired_delta_reference, paired_sums,
                                            paired_sums_reference)


def _ragged(seed=5, b=130, p=301, k=12, c=1):
    """Features at q0 and at q1 one small step away (test_ops.py:101-123)."""
    rng = np.random.default_rng(seed)
    bout0 = rng.normal(size=(c, b, k)).astype(np.float32)
    tout0 = rng.normal(size=(c, p, k)).astype(np.float32)
    bout1 = (bout0 + 1e-3 * rng.normal(size=(c, b, k))).astype(np.float32)
    tout1 = (tout0 + 1e-3 * rng.normal(size=(c, p, k))).astype(np.float32)
    y = rng.normal(size=(b, p)).astype(np.float32)
    return bout1, tout1, bout0, tout0, y


def test_paired_delta_matches_interpret_kernel_ragged():
    """Ragged 130 x 301 x 12: the port's closed (dll, lp1) on the CPU path
    (plain sums) against the interpret-mode Pallas kernel and the JAX
    materialized reference. Tolerances of tests/test_ops.py:121-123:
    dll rtol 1e-4 / atol 1e-3, lp1 rtol 1e-5."""
    bout1, tout1, bout0, tout0, y = _ragged()
    b0, b1 = 0.31, 0.34
    args_j = [jnp.asarray(a[0]) for a in (bout1, tout1)]
    want_d, want_lp1 = j_ref(*args_j, b1, jnp.asarray(bout0[0]), jnp.asarray(tout0[0]),
                             b0, jnp.asarray(y), 0.7)
    kern_d, kern_lp1 = j_fused(*args_j, b1, jnp.asarray(bout0[0]),
                               jnp.asarray(tout0[0]), b0, jnp.asarray(y), 0.7,
                               interpret=True)
    t = [torch.as_tensor(a) for a in (bout1, tout1, bout0, tout0, y)]
    bias1, bias0 = torch.tensor([b1]), torch.tensor([b0])
    got_d, got_lp1 = fused_paired_delta(t[0], t[1], bias1, t[2], t[3], bias0, t[4], 0.7)
    ref_d, ref_lp1 = paired_delta_reference(t[0], t[1], bias1, t[2], t[3], bias0, t[4], 0.7)
    for want, lp in ((want_d, want_lp1), (kern_d, kern_lp1)):
        np.testing.assert_allclose(float(got_d[0]), float(want), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(float(got_lp1[0]), float(lp), rtol=1e-5)
    np.testing.assert_allclose(float(ref_d[0]), float(want_d), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(ref_lp1[0]), float(want_lp1), rtol=1e-5)


def test_paired_sums_chain_batched_match_interpret_kernel():
    """C = 3 chains, shared y (test_ops.py:126-150): the five plain sums per
    chain against the chain-batched interpret kernel. D and Bd sum small
    differences (atol 1e-2 on sums of 65k terms); Sm, Q1, C1 rtol 1e-5."""
    rng = np.random.default_rng(6)
    c, b, p, k = 3, 256, 256, 8
    bout0 = rng.normal(size=(c, b, k)).astype(np.float32)
    tout0 = rng.normal(size=(c, p, k)).astype(np.float32)
    bout1 = (bout0 + 1e-3).astype(np.float32)
    tout1 = (tout0 - 1e-3).astype(np.float32)
    y = rng.normal(size=(b, p)).astype(np.float32)
    paired = _make_paired_sums(True)
    outs = jax.vmap(lambda a1, t1, a0, t0: paired(a1, t1, a0, t0, jnp.asarray(y)))(
        jnp.asarray(bout1), jnp.asarray(tout1), jnp.asarray(bout0), jnp.asarray(tout0))
    got = paired_sums(*(torch.as_tensor(a) for a in (bout1, tout1, bout0, tout0, y)))
    assert got.shape == (c, 5) and got.dtype == torch.float32
    for i, (rtol, atol) in enumerate([(2e-4, 1e-2), (2e-4, 1e-2), (1e-5, 1e-2),
                                      (1e-5, 0), (1e-5, 1e-2)]):
        np.testing.assert_allclose(got[:, i].numpy(), np.asarray(outs[i]),
                                   rtol=rtol, atol=atol)


def test_paired_sums_wrapper_checks_inputs():
    bout1, tout1, bout0, tout0, y = (torch.as_tensor(a) for a in _ragged(b=9, p=7, k=3))
    with pytest.raises(TypeError):
        paired_sums(bout1.double(), tout1, bout0, tout0, y)
    with pytest.raises(ValueError):
        paired_sums(bout1, tout1, bout0[:, :5], tout0, y)
    with pytest.raises(ValueError):
        paired_sums(bout1, tout1, bout0, tout0, y.T.contiguous())
    with pytest.raises(ValueError):
        paired_sums(bout1, tout1, bout0, tout0.transpose(1, 2).contiguous().transpose(1, 2), y)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        paired_sums(*(t.to("meta") for t in (bout1, tout1, bout0, tout0, y)))
    n = paired_sums.launches
    out = paired_sums(bout1, tout1, bout0, tout0, y)
    assert paired_sums.launches == n  # the CPU path launches no kernel
    np.testing.assert_array_equal(out.numpy(),
                                  paired_sums_reference(bout1, tout1, bout0, tout0, y).numpy())


def test_subspace_paired_deltas_match_jax():
    """The fused (kernel path; plain sums on the CPU) and composed subspace
    deltas of 3 chains against JAX's fused (interpret) and composed
    evaluators on a tiny DeepONet posterior (test_ops.py:153-189):
    dll rtol 1e-4 / atol 1e-3, lp1 rtol 1e-4 / atol 1e-2."""
    from vihmc_tpu.pipelines.common import make_flat_deeponet as j_make_flat
    from vihmc_tpu.pipelines.common import \
        make_fused_paired_subspace_delta as j_make_fused
    from vihmc_tpu.pipelines.common import make_paired_subspace_delta as j_make
    from vihmc_torch.pipelines.common import (make_flat_deeponet,
                                              make_fused_paired_subspace_delta,
                                              make_paired_subspace_delta)

    tp = tiny_problem(seed=7, tau=0.9)
    rng = np.random.default_rng(7)
    j_apply, _, _ = j_make_flat(tp.jcfg)
    jargs = (jnp.asarray(tp.bx), jnp.asarray(tp.tx), jnp.asarray(tp.y), 0.9,
             tp.jspec, tp.jprior)
    j_comp = j_make(j_apply, *jargs)
    j_fuse = j_make_fused(tp.jcfg, *jargs, interpret=True)
    targs = (tp.t("bx"), tp.t("tx"), tp.t("y"), 0.9, tp.tspec.idx, tp.tprior)
    t_comp = make_paired_subspace_delta(make_flat_deeponet(tp.tcfg), *targs)
    t_fuse = make_fused_paired_subspace_delta(tp.tcfg, *targs)
    d = len(tp.idx)
    q0 = (tp.mu[tp.idx][None, :] + 0.02 * rng.normal(size=(3, d))).astype(np.float32)
    q1 = (q0 + 1e-2 * rng.normal(size=(3, d))).astype(np.float32)
    aux = torch.as_tensor(tp.frozen)
    results = [fn(torch.as_tensor(q1), torch.as_tensor(q0), aux) for fn in (t_comp, t_fuse)]
    for c in range(3):
        for jfn in (j_comp, j_fuse):
            want_d, want_lp1 = jfn(jnp.asarray(q1[c]), jnp.asarray(q0[c]),
                                   jnp.asarray(tp.frozen))
            for got_d, got_lp1 in results:
                np.testing.assert_allclose(float(got_d[c]), float(want_d),
                                           rtol=1e-4, atol=1e-3)
                np.testing.assert_allclose(float(got_lp1[c]), float(want_lp1),
                                           rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("dtype,rtol,atol", [
    ("float32", 2e-4, 2e-4),
    # bf16 stacks round every activation to 8 bits: the field agrees in
    # direction and scale, not digit by digit
    ("bfloat16", 5e-2, 5e-2),
])
def test_gram_gradient_matches_jax(dtype, rtol, atol):
    """make_gram_grad_full on 2 chains against JAX's, same flat vectors.
    Compared relative to the gradient's max-abs scale."""
    from vihmc_tpu.ops.gram_merge import make_gram_grad_full as j_make
    from vihmc_torch.ops.gram_merge import make_gram_grad_full

    tp = tiny_problem(seed=8)
    rng = np.random.default_rng(8)
    flats = (tp.mu[None, :] + tp.sigma[None, :]
             * rng.normal(size=(2, tp.mu.shape[0]))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    jgrad, _, _ = j_make(tp.jcfg, jnp.asarray(tp.bx), jnp.asarray(tp.tx),
                         jnp.asarray(tp.y), tp.tau, compute_dtype=jdt)
    tgrad = make_gram_grad_full(tp.tcfg, tp.t("bx"), tp.t("tx"), tp.t("y"), tp.tau,
                                compute_dtype=tdt)
    got = tgrad(torch.as_tensor(flats))
    assert got.dtype == torch.float32 and got.shape == flats.shape
    for c in range(2):
        want = np.asarray(jgrad(jnp.asarray(flats[c])))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[c].numpy() / scale, want / scale,
                                   rtol=rtol, atol=atol)
        if dtype == "bfloat16":
            cos = np.dot(got[c].numpy(), want) / (np.linalg.norm(want)
                                                   * np.linalg.norm(got[c].numpy()))
            assert cos > 0.999
    if dtype == "float32":
        # and the Gram form is the gradient of the composed likelihood
        from vihmc_torch.dists.likelihoods import nll_log_likelihood
        from vihmc_torch.pipelines.common import make_flat_deeponet

        flat = torch.as_tensor(flats).requires_grad_(True)
        pred = make_flat_deeponet(tp.tcfg)(flat, tp.t("bx"), tp.t("tx"))
        (auto,) = torch.autograd.grad(nll_log_likelihood(pred, tp.t("y"), tp.tau).sum(), flat)
        scale = auto.abs().max()
        np.testing.assert_allclose((got / scale).numpy(), (auto / scale).numpy(),
                                   rtol=1e-4, atol=1e-4)
