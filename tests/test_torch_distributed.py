"""The port's multi-process chain and data sharding over ``torch.distributed``.

Counterparts of ``tests/test_distributed.py`` (the two-process launcher
against one process, the missing peer, the global mesh, the per-rank cost),
``tests/test_chains.py:42-107`` (chain-sharded samples, the data-sharded
likelihood, the query-sharded DeepONet posterior) and
``tests/test_chees.py:85-107`` (ChEES on a (2, 2) mesh), plus the couplings
torch must make explicit (coupled dual averaging, the pooled metric, NUTS),
the multi-chip dry run of ``__graft_entry__.py``, stage 3 on a chain mesh and
the baselines' ``mesh=``.

Each gloo world runs once per module: ``tests/torch_dist_worker.py`` ranks
(torch and numpy only, one thread each, a ``FileStore`` rendezvous) write
their results, and the tests hold them against the same scenario functions
run here without a mesh, and against JAX's ``shard_query`` on conftest's
8-device virtual CPU mesh. Every child has its own timeout and is killed at
teardown.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from vihmc_torch.chains import (chains_per_host, initialize_distributed, make_chain_mesh,
                                sample_chains, shard_query)
from vihmc_torch.chains.distributed import _check_one_rank_per_card, slurm_coordinator
from vihmc_torch.core.mesh import mesh_shape
from vihmc_torch.hmc import HMCConfig

# the module fixtures spawn every world once; keep the file on one xdist worker
# under --dist loadgroup too (--dist loadfile does so already)
pytestmark = pytest.mark.xdist_group("torch_distributed")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
CHILD_TIMEOUT_S = 240
MULTIHOST_ARGS = ["--chains", "8", "--num-samples", "40", "--subspace", "48", "--device", "cpu"]
JAX_SEGMENT_MESSAGE = ("segment_size (resumable sampling) does not compose with a mesh yet; "
                       "shard chains via separate per-host runs instead")


def _free_ports(n):
    """``n`` distinct free ports (all bound at once, then released)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _port_is_free(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("localhost", port))
        except OSError:
            return False
    return True


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)


class _Group:
    """Child processes with their logs in ``directory``."""

    def __init__(self, directory):
        self.dir = directory
        self.procs = []

    def spawn(self, name, cmd):
        log = open(os.path.join(self.dir, f"{name}.log"), "w")
        self.procs.append((name, subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=log,
                                                  stderr=subprocess.STDOUT), log))

    def wait(self):
        """Wait for every child (each with its own timeout); the logs by name."""
        out = {}
        for name, p, log in self.procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
            log.close()
            with open(log.name) as f:
                out[name] = (p.returncode, f.read())
        return out

    def kill(self):
        for _, p, log in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Start every world and launcher run at once; kill them all at the end."""
    groups = {}
    probe_port, port, lonely_port = _free_ports(3)
    try:
        for set_, world in (("pair", 2), ("quad", 4)):
            d = str(tmp_path_factory.mktemp(set_))
            g = groups[set_] = _Group(d)
            probe = ["--probe-port", str(probe_port)] if set_ == "pair" else []
            for r in range(world):
                g.spawn(f"rank{r}", [sys.executable, WORKER, "--set", set_, "--world",
                                     str(world), "--rank", str(r), "--store",
                                     os.path.join(d, "store"), "--out", d] + probe)
        g = groups["multihost"] = _Group(str(tmp_path_factory.mktemp("multihost")))
        mh = [sys.executable, "-m", "vihmc_torch.run_multihost"] + MULTIHOST_ARGS
        two = ["--coordinator", f"localhost:{port}", "--num-processes", "2",
               "--init-timeout", "120", "--backend", "gloo"]
        g.spawn("p0", mh + two + ["--process-id", "0"])
        g.spawn("p1", mh + two + ["--process-id", "1"])
        g.spawn("single", mh)
        g.spawn("lonely", mh + ["--coordinator", f"localhost:{lonely_port}",
                                "--num-processes", "2", "--process-id", "1",
                                "--init-timeout", "5"])
        yield groups
    finally:
        for g in groups.values():
            g.kill()


def _world(children, set_):
    g = children[set_]
    logs = g.wait()
    for name, (rc, text) in logs.items():
        err = os.path.join(g.dir, f"{name}.err")
        detail = open(err).read() if os.path.exists(err) else text[-3000:]
        assert rc == 0, f"{set_} {name}: rc {rc}\n{detail}"
    return [np.load(os.path.join(g.dir, f"rank{r}.npz")) for r in range(len(logs))]


@pytest.fixture(scope="module")
def pair(children):
    return _world(children, "pair")


@pytest.fixture(scope="module")
def quad(children):
    return _world(children, "quad")


@pytest.fixture(scope="module")
def multihost(children):
    out = {}
    for name, (rc, text) in children["multihost"].wait().items():
        assert rc == 0, f"{name}: rc {rc}\n{text[-3000:]}"
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        out[name] = json.loads(lines[-1][len("RESULT "):]) if lines else None
    return out


def _scenario(results, name):
    return {k.split("/", 1)[1]: results[k] for k in results.files if k.startswith(name + "/")}


def _reference(name, set_):
    """The scenario run here without a mesh, on one thread."""
    fn = dict((n, f) for n, _, f in W.SETS[set_])[name]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {k: np.asarray(v) for k, v in fn(None).items()}
    finally:
        torch.set_num_threads(threads)


def _ranks_agree(worlds, name):
    """Every rank holds the same gathered result."""
    first = _scenario(worlds[0], name)
    for other in worlds[1:]:
        for k, v in _scenario(other, name).items():
            np.testing.assert_array_equal(v, first[k], err_msg=f"{name}/{k}")
    return first


# --------------------------------------------------------------------------
# the launcher and the process group (tests/test_distributed.py)
# --------------------------------------------------------------------------

def test_two_process_run_multihost_matches_one_process(multihost):
    """``python -m vihmc_torch.run_multihost`` over two gloo processes against
    the same workload in one process, at JAX's tolerances (the chains' draws
    are sliced from the same blocks, so the two runs hold the same chains)."""
    res, ref = multihost["p0"], multihost["single"]
    assert res is not None and multihost["p1"] is None  # rank 1 prints no RESULT
    assert res["distributed"] is True
    assert res["processes"] == res["devices"] == 2
    assert res["mesh"] == {"chains": 2, "data": 1}
    assert ref["distributed"] is False and ref["processes"] == 1
    assert ref["mesh"] == {"chains": 1, "data": 1}
    assert res["acceptance"] == pytest.approx(ref["acceptance"], abs=1e-3)
    assert res["max_rhat"] == pytest.approx(ref["max_rhat"], rel=1e-2)
    assert res["median_ess"] == pytest.approx(ref["median_ess"], rel=5e-2)


def test_missing_peer_degrades_gracefully(multihost):
    """A lone rank 1 whose coordinator never answers within ``--init-timeout
    5`` comes back as a single-process run."""
    res = multihost["lonely"]
    assert res is not None and res["distributed"] is False
    assert res["processes"] == 1


def test_global_chain_mesh_on_a_world_of_four(quad):
    facts = _scenario(quad[0], "mesh_facts")
    assert facts["shape"].tolist() == [2, 2]
    coords = sorted(_scenario(w, "mesh_facts")["coord"].tolist() for w in quad)
    assert coords == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_chains_per_host(quad):
    """One process: every chain count is local; a world of 4 splits 8 chains
    2 per process and refuses 7 with JAX's message."""
    assert chains_per_host(8) == 8
    assert chains_per_host(7) == 7
    facts = _scenario(quad[0], "mesh_facts")
    assert int(facts["per_host"]) == 2
    assert str(facts["uneven"]) == "7 chains cannot split over 4 hosts"


def test_initialize_distributed_single_process_noop():
    assert initialize_distributed() is False


_LAUNCH_ENV = ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_STEP_NODELIST", "SLURM_JOB_ID",
               "SLURM_LOCALID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def launch_env(monkeypatch):
    """A clean launcher environment; the test sets what it needs."""
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("nodes,host", [("node001", "node001"), ("node001,host2", "node001"),
                                        ("node[001-015],host2", "node001"),
                                        ("node[001,007-015]", "node001")])
def test_slurm_coordinator_is_the_first_node(nodes, host):
    """JAX's SLURM cluster: the step's first host and 61440 + job id % 4096."""
    env = {"SLURM_STEP_NODELIST": nodes, "SLURM_JOB_ID": "4242"}
    assert slurm_coordinator(env) == f"{host}:{61440 + 4242 % 4096}"


def test_slurm_launch_without_coordinator(launch_env):
    """Under SLURM with no coordinator given, the coordinator comes from the
    step's node list: rank 1 probes it and, finding no rank 0 there within
    the timeout, runs alone. Without the node list it raises."""
    launch_env.setenv("SLURM_NTASKS", "2")
    launch_env.setenv("SLURM_PROCID", "1")
    with pytest.raises(ValueError, match="SLURM_STEP_NODELIST"):
        initialize_distributed(initialization_timeout=1.0, device="cpu")
    launch_env.setenv("SLURM_STEP_NODELIST", "localhost")
    job = next(j for j in range(4096) if _port_is_free(61440 + j))   # no rank 0 listens
    launch_env.setenv("SLURM_JOB_ID", str(4096 * 100 + job))
    assert slurm_coordinator() == f"localhost:{61440 + job}"
    assert initialize_distributed(initialization_timeout=1.0, device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_rank_zero_without_peers_raises(launch_env):
    """Process 0 whose peers never join raises at the handshake deadline
    (JAX aborts there); only a non-zero rank with no coordinator runs alone."""
    with pytest.raises(Exception, match="(?i)time"):
        initialize_distributed(f"localhost:{_free_ports(1)[0]}", 2, 0, 2.0,
                               backend="gloo", device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize_distributed("localhost:1", None, 1, device="cpu")


def test_nccl_refuses_two_ranks_on_one_device(pair):
    """NCCL takes one rank per card: two ranks placed on one device raise
    before the process group is made (both ranks of the world), and no
    backend is switched."""
    msg = str(pair[0]["nccl/message"])
    assert msg.startswith("NCCL takes one rank per card: ranks 0 and 1 are both on"), msg
    assert "backend='gloo'" in msg
    assert str(pair[1]["nccl/message"]) == msg
    with pytest.raises(RuntimeError, match="one rank per card"):
        _check_one_rank_per_card(["host/cuda:0", "host/cuda:1", "host/cuda:0"])
    _check_one_rank_per_card(["a/cuda:0", "b/cuda:0", "a/cuda:1"])


def test_per_rank_transition_flops_fall_as_one_over_n(pair):
    """The matmul FLOPs of one transition (``core.profiling.count_flops``)
    on each of two ranks are half the one-process count, within 5 %: the
    counterpart of JAX's compiled per-device cost."""
    full = float(_reference("flops", "pair")["flops"])
    for w in pair:
        efficiency = full / (2 * float(w["flops/flops"]))
        assert 0.95 < efficiency <= 1.05, (full, efficiency)


# --------------------------------------------------------------------------
# chain sharding (tests/test_chains.py, tests/test_chees.py)
# --------------------------------------------------------------------------

def test_trivial_mesh_equals_no_mesh():
    """With no process group, ``make_chain_mesh()`` is the 1 x 1 mesh and a
    run on it is the mesh-less run, bit for bit."""
    mesh = make_chain_mesh()
    assert mesh_shape(mesh) == {"chains": 1, "data": 1}
    cfg = HMCConfig(num_samples=30, num_leapfrog=5, step_size=0.3, burn=15,
                    sampler="hmc_nuts", da_axis="chains", adapt_mass=True,
                    metric_axis="chains")
    a = sample_chains(W.aniso, torch.zeros(4, 3), cfg, seed=1)
    b = sample_chains(W.aniso, torch.zeros(4, 3), cfg, seed=1, mesh=mesh)
    np.testing.assert_array_equal(a.samples, b.samples)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_chain_mesh(2, 1)


def test_mesh_sharded_chains_match_unsharded(pair):
    """8 chains over two ranks against one process: atol 1e-5 (JAX's)."""
    got = _ranks_agree(pair, "hmc_chains")
    ref = _reference("hmc_chains", "pair")
    np.testing.assert_allclose(got["samples"], ref["samples"], atol=1e-5)
    np.testing.assert_array_equal(got["accepted"], ref["accepted"])


@pytest.mark.parametrize("schedule", ["windowed", "half"])
def test_coupled_adaptation_across_ranks_matches_one_rank(pair, schedule):
    """``da_axis='chains'`` and ``metric_axis='chains'`` over two ranks: the
    chain-mean accept statistic and the pooled moments all-reduce over the
    'chains' group; samples, steps, the averaged step and the carried metric
    equal the one-process run within rtol 1e-5 (atol 1e-5: the sums over
    the shards add in another order)."""
    got = _ranks_agree(pair, f"coupled_{schedule}")
    ref = _reference(f"coupled_{schedule}", "pair")
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_nuts_sharded_matches_unsharded(pair):
    """NUTS with coupled dual averaging and the pooled windowed metric on a
    chain mesh: the same trees (leaf counts exact), samples within rtol and
    atol 1e-4."""
    got = _ranks_agree(pair, "nuts")
    ref = _reference("nuts", "pair")
    np.testing.assert_array_equal(got["tree_leaves"], ref["tree_leaves"])
    np.testing.assert_allclose(got["samples"], ref["samples"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["step_sizes"], ref["step_sizes"], rtol=1e-4, atol=1e-4)


def test_chees_sharded_matches_unsharded(quad):
    """Coupled ChEES on a (2, 2) mesh (its means and sums all-reduced over
    'chains'): samples, log T and the averaged log step within atol 0.05
    (JAX's)."""
    got = _ranks_agree(quad, "chees")
    ref = _reference("chees", "quad")
    for k in ("samples", "log_T", "log_step_avg"):
        np.testing.assert_allclose(got[k], ref[k], atol=0.05, err_msg=k)


def test_data_sharded_likelihood(quad):
    """The batch over 'data' of a (2, 2) mesh through ``data_parallel_ll``:
    the posterior mean of the slope within 0.1 of 2.0."""
    post = _ranks_agree(quad, "batch_mean")["samples"][:, 100:, 0]
    assert abs(post.mean() - 2.0) < 0.1


class _DataMesh:
    """A stand-in mesh (``DeviceMesh``'s interface): ``n`` data shards, this
    rank at ``j``."""

    def __init__(self, n, j):
        self.n, self.j = n, j
        self.shape = (1, n)

    def get_local_rank(self, name):
        return self.j if name == "data" else 0


def test_shard_query_splits_uneven_counts():
    """10,201 query points over 2 and 4 shards (neither divides): every
    point in exactly one shard, the larger shards first, ``y`` split on its
    query axis, numpy arrays too."""
    tx = torch.arange(10201 * 2, dtype=torch.float32).reshape(10201, 2)
    y = torch.arange(3 * 10201, dtype=torch.float32).reshape(3, 10201)
    for n, sizes in ((2, [5101, 5100]), (4, [2551, 2550, 2550, 2550])):
        parts = [shard_query(_DataMesh(n, j), tx, y) for j in range(n)]
        assert [p[0].shape[0] for p in parts] == sizes
        assert [p[1].shape[1] for p in parts] == sizes
        assert all(p[1].is_contiguous() for p in parts)
        torch.testing.assert_close(torch.cat([p[0] for p in parts]), tx, rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([p[1] for p in parts], 1), y, rtol=0, atol=0)
    tn, yn = shard_query(_DataMesh(2, 1), tx.numpy(), y.numpy())
    assert tn.shape == (5100, 2) and yn.shape == (3, 5100)


@pytest.mark.parametrize("scenario,set_", [("query_value_grad", "pair"),
                                           ("query_run", "quad")])
def test_query_sharded_value_and_grad_match_unsharded(pair, quad, scenario, set_):
    """The DeepONet log-posterior with its 33 query points over two 'data'
    shards (17 / 16; on a (1, 2) and a (2, 2) mesh): the value within rel
    1e-5 and the gradient within rtol 1e-4, atol 1e-6 of the unsharded ones;
    the prior, added outside ``data_parallel_ll``, counts once."""
    got = _ranks_agree({"pair": pair, "quad": quad}[set_], scenario)
    ref = _reference("query_value_grad", "pair")
    np.testing.assert_allclose(got["value"], ref["value"], rtol=1e-5)
    np.testing.assert_allclose(got["grad"], ref["grad"], rtol=1e-4, atol=1e-6)


def test_query_sharded_run_matches_unsharded(quad):
    """A short run on the (2, 2) mesh, queries over 'data' and the two
    chains over 'chains': rtol 1e-3, atol 1e-5 (JAX's)."""
    got = _ranks_agree(quad, "query_run")
    ref = _reference("query_run", "quad")
    np.testing.assert_allclose(got["samples"], ref["samples"], rtol=1e-3, atol=1e-5)


def test_query_sharded_matches_jax_shard_query(pair, devices):
    """The same numpy inputs through JAX's ``shard_query`` on the 8-device
    virtual mesh (2 chain x 4 data shards) and through the port's two-rank
    sharded log-posterior: value rel 1e-5, gradient rtol 1e-4, atol 1e-6.
    At 32 query points: JAX's ``device_put`` refuses a count its 4 data
    shards do not divide (the port's uneven 33 is held above)."""
    from vihmc_tpu.chains import make_chain_mesh as j_mesh
    from vihmc_tpu.chains import shard_query as j_shard_query
    from vihmc_tpu.models import DeepONetConfig as JCfg
    from vihmc_tpu.pipelines.common import make_flat_deeponet as j_flat

    _, flat0, branch_x, trunk_x, y = W.query_problem(W.JAX_QUERY_P)
    apply_flat, _, _ = j_flat(JCfg(**W.QUERY_KW))
    mesh = j_mesh(n_chain_shards=2, n_data_shards=4)
    tx_s, y_s = j_shard_query(mesh, jnp.asarray(trunk_x), jnp.asarray(y))
    bx = jnp.asarray(branch_x)

    def lp(q):
        pred = apply_flat(q, bx, tx_s)
        return -0.5 * jnp.sum((pred - y_s) ** 2) - 0.5 * jnp.sum(q * q) * 1e-2

    vg = jax.jit(jax.value_and_grad(lp))
    j_vals, j_grads = zip(*(vg(jnp.asarray(q)) for q in (flat0, 0.8 * flat0)))
    got = _ranks_agree(pair, "query_value_grad_even")
    np.testing.assert_allclose(got["value"], np.asarray(j_vals), rtol=1e-5)
    np.testing.assert_allclose(got["grad"], np.stack([np.asarray(g) for g in j_grads]),
                               rtol=1e-4, atol=1e-6)


def test_graft_workload_on_a_2x2_mesh_is_finite(quad):
    """The multi-chip dry run (``__graft_entry__.py``:44-180) on a (2, 2)
    mesh: REFRESH HMC on the batch-sharded DeepONet with the stride Gram
    field, coupled dual averaging, momentum persistence and step jitter;
    R-hat and ESS of the gathered chains; ChEES; and the query-sharded run
    with a rank-4 low-rank metric (Lanczos through the data-parallel HVP).
    All finite, with the shapes of 4 chains."""
    got = _ranks_agree(quad, "graft")
    assert got["samples"].shape == (4, 24, 32)
    assert got["chees"].shape == (4, 12, 32) and got["query"].shape == (4, 8, 32)
    assert got["metric_u"].shape == (32, 4)
    for k, v in got.items():
        assert np.isfinite(v).all(), k


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------

def test_run_operator_on_a_chain_mesh_matches_one_rank(pair):
    """Stage 3 ``run_operator(mesh=, use_fused=True)`` (the Gram field,
    REFRESH, coupled dual averaging) with 4 chains over two ranks: each
    rank's fused density runs on its own 2 chains, 1 + 2 x draws times;
    the gathered samples, MH probabilities, steps and per-chain frozen
    vectors, and the metrics and ESS every rank reports, equal the
    one-process run within rtol 1e-5, atol 1e-6 (the products at 2 chains
    may round apart from those at 4)."""
    got = _ranks_agree(pair, "operator")
    for w in pair:
        assert int(w["operator/merge_calls"]) == 1 + 2 * W.OPERATOR_DRAWS
        assert w["operator/merge_chains"].tolist() == [2]
    ref = _reference("operator", "pair")
    assert ref["merge_chains"].tolist() == [4]
    for k in ("samples", "accept_probs", "step_sizes", "frozen", "mse", "acceptance", "ess"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert got["samples"].shape == (4, W.OPERATOR_DRAWS, 12)


def test_run_operator_segment_size_with_mesh_raises_jax_message():
    """``segment_size`` with a mesh: JAX's ``ValueError``, word for word."""
    from vihmc_torch.pipelines import vi_hmc
    from vihmc_torch.pipelines.configs import VIHMCRunConfig
    from vihmc_torch.models.deeponet import DeepONetConfig

    cfg = VIHMCRunConfig(num_samples=6, num_chains=2, num_leapfrog=2, step_size=1e-3)
    with pytest.raises(ValueError) as err:
        vi_hmc.run_operator(cfg, DeepONetConfig(**W.TINY_KW), W.tiny_artifacts(),
                            data=W.tiny_operator_data(), use_fused=True, segment_size=3,
                            mesh=make_chain_mesh(), device="cpu")
    assert str(err.value) == JAX_SEGMENT_MESSAGE


@pytest.mark.parametrize("baseline", ["full", "nuts", "split"])
def test_baselines_accept_a_mesh(pair, baseline):
    """``hmc_full``, ``hmc_nuts`` and ``hmc_split`` with ``mesh=`` (2 chains
    over two ranks) equal their one-process runs: samples and the scored
    MSE within atol 1e-6."""
    got = _ranks_agree(pair, "baselines")
    ref = _reference("baselines", "pair")
    for k in (f"{baseline}_samples", f"{baseline}_mse"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, err_msg=k)
