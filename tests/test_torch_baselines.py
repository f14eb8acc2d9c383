"""PyTorch port parity: the full-parameter HMC baselines and their pieces.

The likelihood switch, the per-tensor prior and its flat layout, the log
posterior, the three run configs, the data shards; one transition of each
baseline pipeline (``hmc_full``, ``hmc_nuts`` on the composed, fused-plain,
Gram and subsampled densities, ``hmc_split``) with JAX's own draws injected,
each pipeline end to end against JAX in distribution, and the
hamiltorch-style API. Inputs are numpy arrays handed to both sides; each
pipeline is stopped at its sampler call on both sides to take the pieces it
built.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_helpers import assert_shared_fields_equal, one_torch_thread  # noqa: F401

import vihmc_tpu.pipelines.hmc_full as jfull
import vihmc_tpu.pipelines.hmc_nuts as jnuts
import vihmc_tpu.pipelines.hmc_split as jsplit
from vihmc_tpu.core.ravel import per_segment_vector as j_per_segment
from vihmc_tpu.core.ravel import ravel_pytree
from vihmc_tpu.dists.likelihoods import get_likelihood as j_like
from vihmc_tpu.dists.priors import PerSegmentGaussianPrior as JSeg
from vihmc_tpu.hmc.kernel import init_state as j_init_state
from vihmc_tpu.hmc.kernel import make_kernel as j_make_kernel
from vihmc_tpu.models import DeepONetConfig as JCfg
from vihmc_tpu.pipelines import configs as JC
from vihmc_torch.chains.diagnostics import effective_sample_size_np
from vihmc_torch.core.ravel import per_segment_vector, ravel_tree
from vihmc_torch.dists.likelihoods import get_likelihood
from vihmc_torch.dists.priors import PerSegmentGaussianPrior
from vihmc_torch.hmc.kernel import TransitionNoise, init_state, make_kernel
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.pipelines import configs as TC
from vihmc_torch.pipelines import hmc_full, hmc_nuts, hmc_split

TINY_KW = dict(in_branch=9, in_trunk=5, width_branch=8, width_trunk=8, depth_branch=3,
               depth_trunk=3)


class _Captured(Exception):
    """Stops a pipeline at its sampler call once the arguments are recorded."""


def _capture(store, side):
    def fake(*args, **kwargs):
        store[side] = (args, kwargs)
        raise _Captured

    return fake


@pytest.fixture(scope="module")
def tiny_burgers():
    """The tiny Burgers data of tests/test_pipelines.py (8 train, 4 valid
    functions on a 5 x 9 grid), as numpy arrays."""
    from vihmc_tpu.data import get_burgers

    data = get_burgers(jax.random.key(0), 8, 4, nx=9, nt=5)
    return tuple({k: np.asarray(v) for k, v in s.items()} for s in data)


def _j(data):
    return tuple({k: jnp.asarray(v) for k, v in s.items()} for s in data)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

LOSSES = ["binary_class_linear_output", "multi_class_linear_output",
          "multi_class_log_softmax_output", "regression", "NLL", "custom"]


@pytest.mark.parametrize("loss", LOSSES)
def test_likelihoods_match_jax(loss):
    """Every named likelihood and a custom elementwise loss, per chain for 3
    chains of outputs: rtol 1e-6 of JAX's on each chain."""
    rng = np.random.default_rng(60)
    tau = 0.7
    if loss == "binary_class_linear_output":
        out = rng.normal(size=(3, 10, 1)) * 3
        y = (rng.random(size=(10, 1)) > 0.5).astype(np.float32)
    elif loss.startswith("multi_class"):
        out = rng.normal(size=(3, 10, 4))
        if loss == "multi_class_log_softmax_output":
            out = out - np.log(np.exp(out).sum(-1, keepdims=True))
        y = rng.integers(0, 4, size=10).astype(np.float32)
    else:
        out = rng.normal(size=(3, 10, 2))
        y = rng.normal(size=(10, 2)).astype(np.float32)
    out = out.astype(np.float32)
    if loss == "custom":
        jfn = j_like(lambda o, t: jnp.abs(o - t) ** 1.5)
        tfn = get_likelihood(lambda o, t: (o - t).abs() ** 1.5)
    else:
        jfn, tfn = j_like(loss), get_likelihood(loss)
    got = tfn(torch.as_tensor(out), torch.as_tensor(y), tau)
    assert got.shape == (3,)
    for c in range(3):
        np.testing.assert_allclose(float(got[c]), float(jfn(jnp.asarray(out[c]), jnp.asarray(y),
                                                            tau)), rtol=1e-6)
    if loss == "NLL":
        with pytest.raises(NotImplementedError):
            get_likelihood("bogus")


def test_per_segment_prior_and_flat_layout_match_jax():
    """ravel_tree lays a nested parameter tree out as ravel_pytree does (and
    unravels it back); per_segment_vector and PerSegmentGaussianPrior's
    log-density and gradient match JAX's (rtol 1e-6)."""
    rng = np.random.default_rng(61)
    tree = {"layers": [{"w": rng.normal(size=(3, 2)), "b": rng.normal(size=3)},
                       {"w": rng.normal(size=(1, 3))}],
            "a_scale": rng.normal(size=(2, 2))}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    jflat, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
    ttree = jax.tree_util.tree_map(torch.as_tensor, tree)
    tflat, unravel = ravel_tree(ttree)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = unravel(tflat)
    np.testing.assert_array_equal(back["layers"][0]["w"].numpy(), tree["layers"][0]["w"])
    np.testing.assert_array_equal(back["a_scale"].numpy(), tree["a_scale"])
    vals = [0.5, 1.5, 2.0, 3.0]
    jscales = j_per_segment(jax.tree_util.tree_map(jnp.asarray, tree), vals)
    tscales = per_segment_vector(ttree, vals)
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(jscales))
    with pytest.raises(ValueError):
        per_segment_vector(ttree, vals[:2])
    q = rng.normal(size=(3, tflat.numel())).astype(np.float32)
    tp = PerSegmentGaussianPrior(tscales)
    jp = JSeg(jscales)
    lp, g = tp.log_prob(torch.as_tensor(q)), tp.grad(torch.as_tensor(q))
    for c in range(3):
        np.testing.assert_allclose(float(lp[c]), float(jp.log_prob(jnp.asarray(q[c]))), rtol=1e-6)
        np.testing.assert_allclose(g[c].numpy(), np.asarray(jax.grad(jp.log_prob)(jnp.asarray(q[c]))),
                                   rtol=1e-6)


def test_make_log_posterior_matches_jax():
    """make_log_posterior with an output that takes y's shape, a prior and the
    splitting prior_scale: rtol 1e-6 per chain."""
    from vihmc_tpu.dists.priors import IsotropicGaussianPrior as JIso
    from vihmc_tpu.pipelines.common import make_log_posterior as j_make
    from vihmc_torch.dists.priors import IsotropicGaussianPrior
    from vihmc_torch.pipelines.common import make_log_posterior

    rng = np.random.default_rng(62)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    y = rng.normal(size=(6,)).astype(np.float32)
    flats = rng.normal(size=(3, 4)).astype(np.float32)
    jlp = j_make(lambda f: (f @ jnp.asarray(w))[:, None], jnp.asarray(y), "regression", 2.0,
                 JIso(0.5), prior_scale=3.0)
    tlp = make_log_posterior(lambda f: (f @ torch.as_tensor(w))[:, :, None], torch.as_tensor(y),
                             "regression", 2.0, IsotropicGaussianPrior(0.5), prior_scale=3.0)
    got = tlp(torch.as_tensor(flats))
    for c in range(3):
        np.testing.assert_allclose(float(got[c]), float(jlp(jnp.asarray(flats[c]))), rtol=1e-6)


@pytest.mark.parametrize("name", ["NNHMCRunConfig", "OperatorHMCRunConfig",
                                  "SplitHMCRunConfig"])
def test_baseline_configs_match_jax(name):
    """Every field and default of the three baseline configs, and the
    derived L and burn (also at other steps and draw counts)."""
    jc, tc = getattr(JC, name), getattr(TC, name)
    jf = {f.name: f.default for f in dataclasses.fields(jc)}
    tf = {f.name: f.default for f in dataclasses.fields(tc)}
    assert sorted(tf) == sorted(jf)
    assert {k: v for k, v in tf.items() if k != "model"} == \
        {k: v for k, v in jf.items() if k != "model"}
    assert dataclasses.asdict(tc().model) == dataclasses.asdict(jc().model)
    for kw in ({}, {"num_samples": 7}, {"num_samples": 1001, "step_size": 1e-3}):
        j, t = jc(**kw), tc(**kw)
        assert (t.L, t.burn) == (j.L, j.burn)
    assert (TC.NNHMCRunConfig().L, TC.OperatorHMCRunConfig().L, TC.SplitHMCRunConfig().L) \
        == (643, 7, 2)


def test_split_shards_match_jax(tiny_burgers):
    """split_shards: the same shards as JAX's; unequal shards raise."""
    from vihmc_tpu.data.burgers import split_shards as j_split
    from vihmc_torch.data.burgers import split_shards

    train = tiny_burgers[0]
    want = j_split({k: jnp.asarray(v) for k, v in train.items()}, 2)
    got = split_shards({k: torch.as_tensor(v) for k, v in train.items()}, 2)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        split_shards({k: torch.as_tensor(v) for k, v in train.items()}, 3)


def test_baseline_data_rows(monkeypatch):
    """get_burgers_baseline takes training rows from the front of the export
    and validation rows from its row n_train on, capping n_valid at the
    exported validation rows."""
    import vihmc_torch.data.burgers as tb

    rng = np.random.default_rng(63)
    fake = {"u0": rng.normal(size=(14, 8)).astype(np.float32), "nx": np.array(9),
            "nt": np.array(5), "n_train": np.array(10), "n_valid": np.array(4)}
    monkeypatch.setattr(tb, "load_port_inputs", lambda path=None: fake)
    train, valid, used = tb.get_burgers_baseline("cpu", n_train=3, n_valid=9)
    assert used == 4 and train["branch_in"].shape == (3, 9) and valid["branch_in"].shape == (4, 9)
    np.testing.assert_allclose(train["branch_in"][:, :8].numpy(), fake["u0"][:3], atol=1e-6)
    np.testing.assert_allclose(valid["branch_in"][:, :8].numpy(), fake["u0"][10:14], atol=1e-6)
    with pytest.raises(ValueError):
        tb.get_burgers_baseline("cpu", n_train=11, n_valid=1)


# ---------------------------------------------------------------------------
# one transition of each pipeline with JAX's draws injected
# ---------------------------------------------------------------------------

def _jax_draws(key, d, aux_draw=None):
    """One JAX transition's draws (kernel.py:494): the momentum normals
    (diagonal metric), the jitter and accept uniforms, and ``aux_draw`` of
    the refresh key when given."""
    key_mom, key_u, key_aux, key_jit = jax.random.split(key, 4)
    out = [np.asarray(jax.random.normal(key_mom, (d,), jnp.float32)),
           float(jax.random.uniform(key_jit, ())), float(jax.random.uniform(key_u))]
    if aux_draw is not None:
        out.append(np.asarray(aux_draw(key_aux)))
    return out


def _compare_transitions(jparts, tparts, inits, n_it=3, seed=0, aux_draw=None, rtol=1e-4,
                         atol=5e-5, record=None):
    """Run ``n_it`` transitions of the JAX kernel vmapped over chains and of
    the port's kernel with JAX's draws; returns the number of acceptances
    (``record`` collects each draw's accept flags, divergences and steps)."""
    jkernel, jstate = jparts
    tkernel, tstate = tparts
    c, d = inits.shape
    step = jax.jit(jax.vmap(jkernel, in_axes=(0, 0, None)))  # one compile, not one per op
    n_accept = 0
    for it in range(n_it):
        keys = jax.random.split(jax.random.key(600 + seed + it), c)
        draws = [_jax_draws(k, d, aux_draw) for k in keys]
        noise = TransitionNoise(
            z1=torch.as_tensor(np.stack([x[0] for x in draws])), z2=None,
            u_jitter=torch.tensor([x[1] for x in draws]),
            u_accept=torch.tensor([x[2] for x in draws]),
            z_aux=None if aux_draw is None else torch.as_tensor(np.stack([x[3] for x in draws])))
        jstate, jinfo = step(jstate, keys, it)
        tstate, tinfo = tkernel(tstate, noise)
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), np.asarray(jinfo["accepted"]))
        np.testing.assert_allclose(tinfo["step_size"].numpy(), np.asarray(jinfo["step_size"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tinfo["log_prob"].numpy(), np.asarray(jinfo["log_prob"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tstate.position.numpy(), np.asarray(jstate.position),
                                   rtol=rtol, atol=atol)
        np.testing.assert_array_equal(tinfo["divergent"].numpy(), np.asarray(jinfo["divergent"]))
        n_accept += int(tinfo["accepted"].sum())
        if record is not None:
            record.append({k: tinfo[k].tolist() for k in ("accepted", "divergent", "step_size")})
    return n_accept


def test_hmc_full_transition_with_injected_jax_draws(monkeypatch, one_torch_thread):
    """hmc_full on the regression MLP (L = 3 at step 1e-3): both pipelines
    stopped at their sampler call give the same config, inits and log
    posterior; three transitions of 3 chains agree (accept decisions,
    log-densities rtol 1e-5, positions rtol 1e-4)."""
    from vihmc_tpu.data.synthetic import regression_data as j_data

    seen = {}
    jcfg_run = JC.NNHMCRunConfig(step_size=1e-3, post_std=0.05, num_chains=3, num_samples=3)
    tcfg_run = TC.NNHMCRunConfig(step_size=1e-3, post_std=0.05, num_chains=3, num_samples=3)
    jdata = j_data(jax.random.key(5), 20, 300, noise_std=0.05)
    monkeypatch.setattr(jfull, "sample_chains", _capture(seen, "jax"))
    with pytest.raises(_Captured):
        jfull.run(jcfg_run, key=jax.random.key(1), data=jdata)
    (jlp, jinits, _, jcfg), _ = seen["jax"]
    monkeypatch.setattr(hmc_full, "sample_chains_resumable", _capture(seen, "torch"))
    with pytest.raises(_Captured):
        hmc_full.run(tcfg_run, data={k: np.asarray(v) for k, v in jdata.items()},
                     inits=np.asarray(jinits), device="cpu")
    (tlp, tinits, tcfg, _, tim, taux), _ = seen["torch"]
    assert_shared_fields_equal(tcfg, jcfg)
    assert tcfg.num_leapfrog == 3
    assert tim == 1.0 and taux is None
    inits = np.asarray(jinits)
    jkernel = j_make_kernel(jlp, jcfg)
    jstate = jax.jit(jax.vmap(lambda q: j_init_state(jlp, q, jcfg)))(jnp.asarray(inits))
    tstate = init_state(tlp, torch.as_tensor(inits), tcfg, None)
    np.testing.assert_allclose(tstate.log_prob.numpy(), np.asarray(jstate.log_prob), rtol=1e-5)
    n = _compare_transitions((jkernel, jstate), (make_kernel(tcfg, 1.0, None, None, tlp), tstate),
                             inits)
    assert n > 0


NUTS_PATHS = {"composed": dict(use_fused=False, use_gram=False),
              "fused_plain": dict(use_fused=True, use_gram=False),
              "gram": dict(use_fused=True, use_gram=None),
              "sample_data": dict(use_fused=False, use_gram=None)}


@pytest.mark.parametrize("path", sorted(NUTS_PATHS))
def test_hmc_nuts_transition_with_injected_jax_draws(tiny_burgers, path, monkeypatch,
                                                     one_torch_thread):
    """hmc_nuts on the tiny Burgers data with per-chain dual averaging (burn
    2) on each path: the composed density, the fused merge-NLL (its plain
    version on the CPU) with autograd trajectories, the Gram field, and the
    trunk subsample (12 of 45 points, JAX's index sets injected: the initial
    one shared, then one per chain per draw). Both pipelines stopped at their
    sampler call give the same config and inits; four transitions of 3
    chains agree (accept decisions, steps rtol 1e-4, log-densities rtol
    1e-5, positions rtol 1e-4 and atol 1e-4)."""
    seen = {}
    kw = dict(model=JCfg(**TINY_KW), n_train=8, n_valid=4, step_size=2e-3, num_samples=4,
              post_std=0.1, sample_data=path == "sample_data", p=12, target_accept=0.7)
    jcfg_run = JC.OperatorHMCRunConfig(**kw)
    tcfg_run = TC.OperatorHMCRunConfig(**dict(kw, model=DeepONetConfig(**TINY_KW)))
    monkeypatch.setattr(jnuts, "sample_chains", _capture(seen, "jax"))
    with pytest.raises(_Captured):
        jnuts.run(jcfg_run, key=jax.random.key(2), data=_j(tiny_burgers), num_chains=3,
                  **NUTS_PATHS[path])
    (jlp, jinits, _, jcfg), jkw = seen["jax"]
    monkeypatch.setattr(hmc_nuts, "sample_chains_resumable", _capture(seen, "torch"))
    with pytest.raises(_Captured):
        hmc_nuts.run(tcfg_run, data=tiny_burgers, num_chains=3, inits=np.asarray(jinits),
                     tidx0=None if jkw["aux"] is None else np.asarray(jkw["aux"]), device="cpu",
                     **NUTS_PATHS[path])
    (tlp, tinits, tcfg, _, _, taux), tkw = seen["torch"]
    assert_shared_fields_equal(tcfg, jcfg)
    assert tcfg.sampler == "hmc_nuts" and tcfg.burn == 1 and tcfg.da_axis is None
    assert (tkw["grad_fn"] is None) == (jkw["grad_fn"] is None) == (path != "gram")
    inits = np.asarray(jinits)
    jaux = jkw["aux"]
    jkernel = j_make_kernel(jlp, dataclasses.replace(jcfg, burn=2), aux_refresh=jkw["aux_refresh"],
                            grad_fn=jkw["grad_fn"])
    jstate = jax.jit(jax.vmap(lambda q: j_init_state(jlp, q, jcfg, aux=jaux,
                                                     grad_fn=jkw["grad_fn"])))(jnp.asarray(inits))
    tcfg2 = dataclasses.replace(tcfg, burn=2)
    tstate = init_state(tlp, torch.as_tensor(inits), tcfg2, taux, tkw["grad_fn"])
    np.testing.assert_allclose(tstate.log_prob.numpy(), np.asarray(jstate.log_prob), rtol=1e-5)
    aux_draw = None
    if path == "sample_data":
        aux_draw = lambda k: jkw["aux_refresh"](k, None)  # noqa: E731
    tkernel = make_kernel(tcfg2, 1.0, tkw["grad_fn"], None, tlp,
                          aux_refresh=tkw["aux_refresh"])
    # the adapted steps (up to ~10x the first) carry the dual-averaging
    # state's f32 rounding into the displacement: positions to atol 1e-4,
    # ~1e-3 of the parameters' scale
    n = _compare_transitions((jkernel, jstate), (tkernel, tstate), inits, n_it=4, seed=10,
                             aux_draw=aux_draw, atol=1e-4)
    assert n > 0


def test_hmc_split_transition_with_injected_jax_draws(tiny_burgers, monkeypatch,
                                                      one_torch_thread):
    """hmc_split on the tiny Burgers data (2 shards of 4 functions, L = 2):
    both pipelines stopped at their sampler call give the same config, inits
    and shard data; three splitting transitions of 3 chains agree."""
    seen = {}
    kw = dict(n_train=8, n_valid=4, num_samples=3, step_size=2e-3, post_std=0.06)
    monkeypatch.setattr(jsplit, "sample_chains", _capture(seen, "jax"))
    with pytest.raises(_Captured):
        jsplit.run(JC.SplitHMCRunConfig(model=JCfg(**TINY_KW), **kw), key=jax.random.key(3),
                   data=_j(tiny_burgers), num_chains=3)
    (jlp, jinits, _, jcfg), jkw = seen["jax"]
    monkeypatch.setattr(hmc_split, "sample_chains_resumable", _capture(seen, "torch"))
    with pytest.raises(_Captured):
        hmc_split.run(TC.SplitHMCRunConfig(model=DeepONetConfig(**TINY_KW), **kw),
                      data=tiny_burgers, num_chains=3, inits=np.asarray(jinits), device="cpu")
    (tlp, tinits, tcfg, _, _, _), tkw = seen["torch"]
    assert_shared_fields_equal(tcfg, jcfg)
    assert tcfg.integrator == "splitting" and tcfg.num_leapfrog == 2
    for a, b in zip(tkw["shard_data"], jkw["shard_data"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    inits = np.asarray(jinits)
    jkernel = j_make_kernel(jlp, jcfg, shard_log_prob_fn=jkw["shard_log_prob_fn"],
                            shard_data=jkw["shard_data"])
    jstate = jax.jit(jax.vmap(lambda q: j_init_state(jlp, q, jcfg)))(jnp.asarray(inits))
    tstate = init_state(tlp, torch.as_tensor(inits), tcfg, None)
    tkernel = make_kernel(tcfg, 1.0, None, None, tlp, shard_log_prob_fn=tkw["shard_log_prob_fn"],
                          shard_data=tkw["shard_data"])
    n = _compare_transitions((jkernel, jstate), (tkernel, tstate), inits, seed=20)
    assert n > 0


# ---------------------------------------------------------------------------
# the configs' own width: the first draws on the exported Burgers data
# ---------------------------------------------------------------------------

#: training functions per pipeline in the test: the config's own 10 for
#: hmc_nuts, 20 of the config's 1000 for hmc_split
FULL_WIDTH = {"hmc_nuts": 10, "hmc_split": 20}


def full_width_witness(pipeline, n_train, n_it):
    """The config's first transition at full width (the reference DeepONet,
    172,401 parameters, on the 10,201-point grid of the exported data) in
    both packages, from JAX's init with JAX's momentum: its Hamiltonian
    error ``dH = (lp1 - K1) - (lp0 - K0)`` from each package's own
    trajectory pieces. Then ``n_it`` draws of both kernels with JAX's draws
    injected, each draw's accept decision, divergence, step, log-density and
    position held as in :func:`_compare_transitions`, and their flags
    returned."""
    from vihmc_tpu.hmc.integrators import leapfrog_grad_only as j_lf
    from vihmc_tpu.hmc.integrators import split_leapfrog as j_split_lf
    from vihmc_torch.data.burgers import get_burgers_baseline
    from vihmc_torch.hmc.integrators import leapfrog_grad_only, split_leapfrog
    from vihmc_torch.hmc.kernel import value_and_grad

    train, valid, _ = get_burgers_baseline("cpu", n_train, 2)
    data = tuple({k: v.numpy() for k, v in s.items()} for s in (train, valid))
    cfg_kw = dict(n_train=n_train, n_valid=2)
    if pipeline == "hmc_nuts":
        jmod, tmod, jc, tc = jnuts, hmc_nuts, JC.OperatorHMCRunConfig, TC.OperatorHMCRunConfig
        run_kw = dict(use_fused=True)
    else:
        jmod, tmod, jc, tc = jsplit, hmc_split, JC.SplitHMCRunConfig, TC.SplitHMCRunConfig
        run_kw = {}
    seen = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jmod, "sample_chains", _capture(seen, "jax"))
        with pytest.raises(_Captured):
            jmod.run(jc(**cfg_kw), key=jax.random.key(4), data=_j(data), **run_kw)
        (jlp, jinits, _, jcfg), jkw = seen["jax"]
        mp.setattr(tmod, "sample_chains_resumable", _capture(seen, "torch"))
        with pytest.raises(_Captured):
            tmod.run(tc(**cfg_kw), data=data, inits=np.asarray(jinits), device="cpu", **run_kw)
        (tlp, _, tcfg, _, _, _), tkw = seen["torch"]
    finally:
        mp.undo()
    assert_shared_fields_equal(tcfg, jcfg)
    inits = np.asarray(jinits)
    q0 = inits[0]
    p0 = _jax_draws(jax.random.split(jax.random.key(600 + 30), 1)[0], q0.size)[0]
    eps, n_lf = tcfg.step_size, tcfg.num_leapfrog
    # the first transition's trajectory from each package's own pieces
    if pipeline == "hmc_nuts":
        jq1, jp1, _ = jax.jit(lambda q, p: j_lf(jkw["grad_fn"], q, p, jkw["grad_fn"](q), eps,
                                                n_lf))(jnp.asarray(q0), jnp.asarray(p0))
        tq0 = torch.as_tensor(q0)[None]
        tq1, tp1, _ = leapfrog_grad_only(tkw["grad_fn"], tq0, torch.as_tensor(p0)[None],
                                         tkw["grad_fn"](tq0), eps, n_lf)
    else:
        jf = jkw["shard_log_prob_fn"]
        jq1, jp1 = jax.jit(lambda q, p: j_split_lf(
            lambda qq, sh: jax.value_and_grad(lambda x: jf(x, sh))(qq), jkw["shard_data"], q, p,
            eps, n_lf))(jnp.asarray(q0), jnp.asarray(p0))
        tf = tkw["shard_log_prob_fn"]
        tq1, tp1 = split_leapfrog(
            lambda q, sh: value_and_grad(lambda x, a: tf(x, sh, a), q, None),
            tkw["shard_data"], torch.as_tensor(q0)[None], torch.as_tensor(p0)[None], eps, n_lf)
    jlp_jit = jax.jit(jlp)
    j_dh = float((jlp_jit(jq1) - 0.5 * jnp.sum(jp1 ** 2))
                 - (jlp_jit(jnp.asarray(q0)) - 0.5 * np.sum(p0 ** 2)))
    t_dh = float((tlp(tq1, None) - 0.5 * (tp1 ** 2).sum())[0]
                 - (tlp(torch.as_tensor(q0)[None], None)[0] - 0.5 * float(np.sum(p0 ** 2))))
    flags = []
    if not n_it:
        return {"pipeline": pipeline, "n_train": n_train, "L": n_lf, "step": eps,
                "dH_jax": j_dh, "dH_port": t_dh, "draws": flags}
    # the kernels, draw by draw
    jkernel = j_make_kernel(jlp, jcfg, grad_fn=jkw.get("grad_fn"),
                            shard_log_prob_fn=jkw.get("shard_log_prob_fn"),
                            shard_data=jkw.get("shard_data"))
    jstate = jax.jit(jax.vmap(lambda q: j_init_state(jlp, q, jcfg, grad_fn=jkw.get("grad_fn"))))(
        jnp.asarray(inits))
    tkernel = make_kernel(tcfg, 1.0, tkw.get("grad_fn"), None, tlp,
                          shard_log_prob_fn=tkw.get("shard_log_prob_fn"),
                          shard_data=tkw.get("shard_data"))
    tstate = init_state(tlp, torch.as_tensor(inits), tcfg, None, tkw.get("grad_fn"))
    _compare_transitions((jkernel, jstate), (tkernel, tstate), inits, n_it=n_it, seed=30,
                         record=flags)
    return {"pipeline": pipeline, "n_train": n_train, "L": n_lf, "step": eps,
            "dH_jax": j_dh, "dH_port": t_dh, "draws": flags}


@pytest.mark.parametrize("pipeline", sorted(FULL_WIDTH))
def test_baselines_at_full_width_match_jax(pipeline):
    """A witness that the configs' own behaviour is JAX's: at full width on
    the exported data both packages give the first transition the same
    Hamiltonian error (rtol 1e-3). The draw-by-draw comparison runs as a
    script (the ``__main__`` block below)."""
    out = full_width_witness(pipeline, FULL_WIDTH[pipeline], 0)
    np.testing.assert_allclose(out["dH_port"], out["dH_jax"], rtol=1e-3)


# ---------------------------------------------------------------------------
# whole runs against JAX, in distribution
# ---------------------------------------------------------------------------

def _std_and_error(x):
    """Each coordinate's pooled std over (C, S) draws and its Monte-Carlo
    error, from the ESS of the squared deviations themselves: chains that
    settle in regions of different width lower it (the ESS counts the
    spread between chains), and near-antithetic draws, whose ESS for the
    mean exceeds the draw count, do not raise it."""
    sd = x.std((0, 1))
    sq = (x - x.mean((0, 1))) ** 2
    return sd, np.sqrt(sq.var((0, 1)) / effective_sample_size_np(sq)) / (2 * sd + 1e-30)


def _same_distribution(a, b, z_max=4.5, std_rtol=None, std_from_squares=False):
    """Post-burn samples (C, S, D) of both samplers: every coordinate's mean
    within ``z_max`` Monte-Carlo standard errors (ESS-based, the chains
    pooled); its standard deviation too, or within ``std_rtol`` of the other
    side's when given (one chain, where the ESS estimate does not describe
    the std's error). ``std_from_squares``: the std's error from
    :func:`_std_and_error` (a neural posterior), else ``std / sqrt(2 ESS)``."""
    ess_a, ess_b = effective_sample_size_np(a), effective_sample_size_np(b)
    ma, mb = a.mean((0, 1)), b.mean((0, 1))
    sa, sb = a.std((0, 1)), b.std((0, 1))
    z_mean = np.abs(ma - mb) / np.sqrt(sa ** 2 / ess_a + sb ** 2 / ess_b + 1e-30)
    assert z_mean.max() < z_max, z_mean.max()
    if std_from_squares:
        (sa, ea), (sb, eb) = _std_and_error(a), _std_and_error(b)
        z_std = np.abs(sa - sb) / np.sqrt(ea ** 2 + eb ** 2 + 1e-30)
        assert z_std.max() < z_max, z_std.max()
    elif std_rtol is None:
        z_std = np.abs(sa - sb) / np.sqrt(sa ** 2 / (2 * ess_a) + sb ** 2 / (2 * ess_b) + 1e-30)
        assert z_std.max() < z_max, z_std.max()
    else:
        np.testing.assert_allclose(sb, sa, rtol=std_rtol)


def test_hmc_full_runs_agree_in_distribution_with_jax(one_torch_thread):
    """hmc_full on the regression MLP (4 chains, 300 draws, L = 7) in both
    packages, own random streams and data noise from the same draw: every
    parameter's post-burn mean and std within 4.5 MC standard errors; the
    port's metrics carry JAX's keys and the store round-trips the samples."""
    from vihmc_tpu.data.synthetic import regression_data as j_data

    kw = dict(step_size=2e-3, post_std=0.1, num_chains=4, num_samples=300)
    jdata = j_data(jax.random.key(7), 20, 300, noise_std=0.05)
    jout = jfull.run(JC.NNHMCRunConfig(**kw), key=jax.random.key(8), data=jdata)
    tout = hmc_full.run(TC.NNHMCRunConfig(**kw), data={k: np.asarray(v) for k, v in jdata.items()},
                        seed=3, device="cpu")
    burn = TC.NNHMCRunConfig(**kw).burn
    assert tout["result"].samples.shape == np.asarray(jout["result"].samples).shape
    assert sorted(tout["metrics"]) == sorted(jout["metrics"])
    assert tout["result"].acceptance_rate > 0.3
    _same_distribution(np.asarray(jout["result"].samples)[:, burn:],
                       tout["result"].samples[:, burn:])


@pytest.mark.parametrize("pipeline", ["hmc_nuts", "hmc_split"])
def test_operator_baselines_agree_in_distribution_with_jax(tiny_burgers, pipeline,
                                                           one_torch_thread, tmp_path):
    """hmc_nuts (fused density, Gram field, dual averaging) and hmc_split on
    the tiny Burgers data, 6 chains x 100 draws in both packages with their
    own streams, from starts drawn from the same 0.1 N(0, 1) (the prior):
    every parameter's post-burn mean and std within 4.5 MC standard errors
    (the std's from the squared deviations' ESS; the step, 0.02 with
    L = 8, moves a chain about one prior std per draw, so the chains mix:
    ESS above half the draw count; the bias, whose posterior std is half the
    prior's, holds the likelihood); JAX's metric keys; reevaluate
    scores the stored samples as the live run did; hmc_nuts's steps after
    burn are exp(log_step_avg)."""
    from vihmc_torch.io.artifacts import RunStore

    kw = dict(n_train=8, n_valid=4, num_samples=100, step_size=0.02, post_std=0.32)
    if pipeline == "hmc_nuts":
        jout = jnuts.run(JC.OperatorHMCRunConfig(model=JCfg(**TINY_KW), **kw),
                         key=jax.random.key(9), data=_j(tiny_burgers), num_chains=6,
                         use_fused=True)
        tcfg = TC.OperatorHMCRunConfig(model=DeepONetConfig(**TINY_KW), **kw)
        store = RunStore(str(tmp_path), uid="nuts")
        tout = hmc_nuts.run(tcfg, data=tiny_burgers, num_chains=6, use_fused=True, seed=4,
                            store=store, device="cpu")
        again = hmc_nuts.reevaluate(tcfg, store, data=tiny_burgers, device="cpu")
    else:
        jout = jsplit.run(JC.SplitHMCRunConfig(model=JCfg(**TINY_KW), **kw),
                          key=jax.random.key(9), data=_j(tiny_burgers), num_chains=6)
        tcfg = TC.SplitHMCRunConfig(model=DeepONetConfig(**TINY_KW), **kw)
        store = RunStore(str(tmp_path), uid="split")
        tout = hmc_split.run(tcfg, data=tiny_burgers, num_chains=6, seed=4, store=store,
                             device="cpu")
        again = hmc_split.reevaluate(tcfg, store, data=tiny_burgers, device="cpu")
    burn = tcfg.burn
    res = tout["result"]
    assert res.samples.shape == np.asarray(jout["result"].samples).shape
    assert sorted(tout["metrics"]) == sorted(jout["metrics"])
    assert all(np.isfinite(v).all() for v in tout["metrics"].values())
    assert res.acceptance_rate > 0.6 and tcfg.L == 8
    np.testing.assert_allclose(again["metrics"]["expected_mse_of_mean"],
                               tout["metrics"]["expected_mse_of_mean"], rtol=1e-6)
    tail = res.samples[:, burn:]
    assert np.median(effective_sample_size_np(tail)) > 0.5 * tail.shape[0] * tail.shape[1]
    _same_distribution(np.asarray(jout["result"].samples)[:, burn:], tail, std_from_squares=True)
    if pipeline == "hmc_nuts":
        post = res.step_sizes[:, burn:]
        assert (post == post[:, :1]).all()
        np.testing.assert_allclose(post[:, 0], np.exp(res.final_state.da.log_step_avg.numpy()),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the hamiltorch-style API
# ---------------------------------------------------------------------------

def _api_model(rng):
    params = {"w": rng.normal(size=(1, 3)).astype(np.float32),
              "b": rng.normal(size=(1,)).astype(np.float32)}
    x = rng.normal(size=(12, 3)).astype(np.float32)
    y = (x @ np.array([[0.5], [-1.0], [2.0]], np.float32) + 0.3
         + 0.1 * rng.normal(size=(12, 1))).astype(np.float32)
    return params, x, y


def test_api_predict_model_and_sample_model_match_jax(one_torch_thread):
    """hmc.api on a linear regression model: predict_model on the same
    samples (predictions rtol 1e-6, log-densities rtol 1e-5, per-tensor
    precisions and normalizing_const's likelihood scale); sample_model from
    the same start, 800 draws each with its own stream: every parameter's
    post-burn mean within 4.5 MC standard errors of JAX's, its std within
    25 %."""
    from vihmc_tpu.hmc import api as japi
    from vihmc_torch.hmc import api as tapi

    rng = np.random.default_rng(64)
    params, x, y = _api_model(rng)

    def j_apply(p, xx):
        return xx @ p["w"].T + p["b"]

    def t_apply(p, xx):
        return xx @ p["w"].T + p["b"]

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    samples = rng.normal(size=(5, 4)).astype(np.float32)
    kw = dict(model_loss="regression", tau_out=4.0, tau_list=[2.0, 0.5])
    jpred, jlp = japi.predict_model(j_apply, jp, jnp.asarray(samples), jnp.asarray(x),
                                    jnp.asarray(y), **kw)
    tpred, tlp = tapi.predict_model(t_apply, params, samples, x, y, device="cpu", **kw)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5)
    jlp_n = japi._flat_posterior(j_apply, jp, jnp.asarray(x), jnp.asarray(y), "regression", 4.0,
                                 None, normalizing_const=24)[0]
    tlp_n = tapi._flat_posterior(t_apply, tapi._to(params, "cpu"), torch.as_tensor(x),
                                 torch.as_tensor(y), "regression", 4.0, None,
                                 normalizing_const=24)[0]
    np.testing.assert_allclose(float(tlp_n(torch.as_tensor(samples[:1]))[0]),
                               float(jlp_n(jnp.asarray(samples[0]))), rtol=1e-5)
    skw = dict(model_loss="regression", num_samples=800, num_steps_per_sample=8, step_size=0.05,
               burn=100, tau_out=4.0, tau_list=[1.0, 1.0])
    jres = japi.sample_model(j_apply, jp, jnp.asarray(x), jnp.asarray(y), key=jax.random.key(11),
                             **skw)
    tres = tapi.sample_model(t_apply, params, x, y, seed=2, device="cpu", **skw)
    assert tres.samples.shape == np.asarray(jres.samples).shape == (800, 4)
    assert tres.acceptance_rate > 0.5
    # one chain each: the stds to 25 % (seed-to-seed spread of either side ~12 %)
    _same_distribution(np.asarray(jres.samples)[None, 100:], tres.samples[None, 100:],
                       std_rtol=0.25)


if __name__ == "__main__":
    # the full-width witness over the configs' first draws (hmc_split also
    # at its own 1000 functions), one JSON line each:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_baselines.py
    import json

    for name, n_train, n in (("hmc_nuts", 10, 10), ("hmc_split", 20, 4), ("hmc_split", 1000, 4)):
        print(json.dumps(full_width_witness(name, n_train, n)), flush=True)
