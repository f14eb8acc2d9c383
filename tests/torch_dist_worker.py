"""One rank of a gloo world on the CPU, for tests/test_torch_distributed.py.

    python tests/torch_dist_worker.py --set pair --world 2 --rank 0 \\
        --store DIR/store --out DIR [--probe-port PORT]

Joins the world through a ``FileStore``, runs every scenario of the set on
its mesh and writes ``DIR/rank<r>.npz`` (``<scenario>/<key>`` arrays); on a
failure it writes the traceback to ``DIR/rank<r>.err`` and exits 1. The test
process runs the same scenario functions without a mesh. Imports torch,
numpy and vihmc_torch only (no JAX).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vihmc_torch.chains import (chains_per_host, gather_chains, global_chain_mesh,  # noqa: E402
                                initialize_distributed, make_chain_mesh, sample_chains,
                                sample_chains_chees, sample_chains_nuts, shard_batch,
                                shard_query)
from vihmc_torch.chains.diagnostics import (effective_sample_size_np,  # noqa: E402
                                            potential_scale_reduction_np)
from vihmc_torch.core.mesh import axis_size, data_parallel_grad, data_parallel_ll  # noqa: E402
from vihmc_torch.core.profiling import count_flops  # noqa: E402
from vihmc_torch.dists.likelihoods import get_likelihood  # noqa: E402
from vihmc_torch.dists.priors import DiagonalGaussianPrior  # noqa: E402
from vihmc_torch.hmc import (ChEESConfig, FrozenPolicy, HMCConfig, NUTSConfig,  # noqa: E402
                             SubspaceSpec, estimate_lowrank_metric, make_aux_refresh,
                             make_subspace_grad, make_subspace_log_prob, value_and_grad)
from vihmc_torch.models.deeponet import DeepONetConfig  # noqa: E402
from vihmc_torch.models.mlp import MLPConfig  # noqa: E402
from vihmc_torch.ops import deeponet_merge  # noqa: E402
from vihmc_torch.ops.gram_merge import make_gram_grad_full  # noqa: E402
from vihmc_torch.pipelines import hmc_full, hmc_nuts, hmc_split, vi_hmc  # noqa: E402
from vihmc_torch.pipelines.common import make_flat_deeponet, make_flat_mlp  # noqa: E402
from vihmc_torch.pipelines.configs import (NNHMCRunConfig, OperatorHMCRunConfig,  # noqa: E402
                                           SplitHMCRunConfig, VIHMCRunConfig)

TINY_KW = dict(in_branch=9, in_trunk=5, width_branch=8, width_trunk=8, depth_branch=3,
               depth_trunk=3)
QUERY_KW = dict(in_branch=5, in_trunk=5, width_branch=6, width_trunk=6, depth_branch=2,
                depth_trunk=2)
QUERY_B, QUERY_P = 6, 33          # 33 query points: uneven shards (17 / 16)
JAX_QUERY_P = 32                  # JAX's device_put needs P divisible by its 4 data shards
OPERATOR_DRAWS = 12


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def std_normal(q):
    return -0.5 * (q * q).sum(-1)


def hmc_chains(mesh):
    """The JAX chain-sharding test: 8 standard-normal chains, fixed step."""
    cfg = HMCConfig(num_samples=100, num_leapfrog=5, step_size=0.35)
    res = gather_chains(mesh, sample_chains(std_normal, torch.zeros(8, 2), cfg, seed=2,
                                            mesh=mesh))
    return {"samples": res.samples, "accepted": res.accepted}


SCALES = torch.tensor([1.0, 3.0, 0.5])


def aniso(q):
    return -0.5 * ((q / SCALES) ** 2).sum(-1)


def _inits(n, d, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, d)), dtype=torch.float32)


def coupled(mesh, schedule):
    """Coupled dual averaging and the pooled adaptive metric."""
    # the step stays below the leapfrog's stability limit (2 x the smallest
    # scale), where the flow does not amplify the last-place differences of a
    # sum over other shards
    cfg = HMCConfig(num_samples=60, num_leapfrog=5, step_size=0.3, burn=40,
                    sampler="hmc_nuts", da_axis="chains", adapt_mass=True,
                    mass_schedule=schedule, metric_axis="chains", target_accept=0.9,
                    max_step=0.6)
    res = gather_chains(mesh, sample_chains(aniso, _inits(8, 3, 5), cfg, seed=6, mesh=mesh))
    st = res.final_state
    out = {"samples": res.samples, "step_sizes": res.step_sizes,
           "log_step_avg": _np(st.da.log_step_avg)}
    if st.inv_mass is not None:
        out["inv_mass"] = _np(st.inv_mass)
    return out


def nuts(mesh):
    cfg = NUTSConfig(num_samples=40, max_depth=4, step_size=0.3, burn=30,
                     da_axis="chains", adapt_mass=True, mass_schedule="windowed",
                     metric_axis="chains")
    res = gather_chains(mesh, sample_chains_nuts(aniso, _inits(8, 3, 7), cfg, seed=8,
                                                 mesh=mesh))
    return {"samples": res.samples, "step_sizes": res.step_sizes,
            "tree_leaves": res.aux_trace["tree_leaves"]}


def chees(mesh):
    """The JAX ChEES mesh test: coupled chains on a (2, 2) mesh."""
    cfg = ChEESConfig(num_samples=40, step_size=0.3, init_traj_length=0.6, burn=20,
                      max_steps=16)
    res = gather_chains(mesh, sample_chains_chees(std_normal, _inits(8, 3, 8), cfg, seed=9,
                                                  mesh=mesh))
    st = res.final_state
    return {"samples": res.samples, "log_T": _np(st.log_T),
            "log_step_avg": _np(st.da.log_step_avg)}


def tiny_operator_data(seed=11, n_train=8, n_valid=4, nx=9, nt=5):
    """Burgers-shaped splits: ``branch_in`` (N, nx), the (nx * nt, 2) grid,
    ``solution`` (N, P)."""
    rng = np.random.default_rng(seed)
    xs, ts = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, nt), indexing="ij")
    grid = np.stack([xs.ravel(), ts.ravel()], -1).astype(np.float32)

    def split(n):
        return {"branch_in": rng.normal(size=(n, nx)).astype(np.float32), "trunk_in": grid,
                "solution": (0.3 * rng.normal(size=(n, nx * nt))).astype(np.float32)}

    return split(n_train), split(n_valid)


def tiny_artifacts(seed=24):
    d = DeepONetConfig(**TINY_KW).num_params
    rng = np.random.default_rng(seed)
    return {"mu": (0.05 * rng.normal(size=d)).astype(np.float32),
            "sigma": (0.02 + 0.05 * rng.random(d)).astype(np.float32),
            "indices": np.sort(rng.choice(d, size=12, replace=False))}


def operator(mesh):
    """Stage 3 with the fused merge-NLL density, the Gram field, REFRESH and
    coupled dual averaging, 4 chains; counts the density's merge sums."""
    calls = []
    real = deeponet_merge.merge_sums_reference

    def counted(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    cfg = VIHMCRunConfig(num_samples=OPERATOR_DRAWS, step_size=1e-3, post_std=0.02,
                         num_chains=4, num_leapfrog=4, loss="NLL", tau_out=1.0,
                         frozen_policy="refresh", vi_mass=True, clip_grad=13.0 * 12 ** 0.5,
                         jitter_eps=True, jitter_low_frac=0.5, adapt_step_size=True,
                         da_axis="chains", target_accept=0.65)
    deeponet_merge.merge_sums_reference = counted
    try:
        out = vi_hmc.run_operator(cfg, DeepONetConfig(**TINY_KW), tiny_artifacts(),
                                  data=tiny_operator_data(), use_fused=True, mesh=mesh,
                                  seed=3, device="cpu")
    finally:
        deeponet_merge.merge_sums_reference = real
    res = out["result"]
    return {"samples": res.samples, "accept_probs": res.accept_probs,
            "step_sizes": res.step_sizes, "frozen": _np(res.final_state.aux),
            "mse": np.asarray(out["metrics"]["expected_mse_of_mean"]),
            "acceptance": np.asarray(out["metrics"]["acceptance_rate"]), "ess": out["ess"],
            "merge_calls": np.asarray(len(calls)),
            "merge_chains": np.asarray(sorted(set(calls)))}


def baselines(mesh):
    """hmc_full, hmc_nuts and hmc_split with ``mesh=``, two chains, tiny."""
    data = tiny_operator_data(seed=12)
    op_kw = dict(n_train=8, n_valid=4, num_samples=10, step_size=0.02, post_std=0.16)
    nn_kw = dict(model=MLPConfig(widths=(16, 16)), n_train=20, n_val=30, step_size=2e-3,
                 post_std=0.01, num_chains=2, num_samples=12)
    rng = np.random.default_rng(0)
    x = np.linspace(-1, 1, 50, dtype=np.float32)[:, None]
    nn_data = {"x_train": x[:20], "y_train": np.sin(3 * x[:20]) + 0.05 * rng.normal(size=(20, 1)),
               "x_val": x[20:], "y_val": np.sin(3 * x[20:])}
    outs = {
        "full": hmc_full.run(NNHMCRunConfig(**nn_kw), data=nn_data, seed=1, mesh=mesh,
                             device="cpu"),
        "nuts": hmc_nuts.run(OperatorHMCRunConfig(model=DeepONetConfig(**TINY_KW), **op_kw),
                             data=data, num_chains=2, use_fused=True, seed=2, mesh=mesh,
                             device="cpu"),
        "split": hmc_split.run(SplitHMCRunConfig(model=DeepONetConfig(**TINY_KW), **op_kw),
                               data=data, num_chains=2, seed=3, mesh=mesh, device="cpu"),
    }
    return {f"{k}_{f}": v for k, o in outs.items()
            for f, v in (("samples", o["result"].samples),
                         ("mse", np.asarray(o["metrics"]["expected_mse_of_mean"])))}


def flops(mesh):
    """The matmul FLOPs of one transition of 8 MLP chains on this rank."""
    cfg = MLPConfig(in_dim=1, widths=(16, 16), out_dim=1, activation="tanh")
    apply_flat = make_flat_mlp(cfg)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, size=(64, 1)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=(64, 1)), dtype=torch.float32)

    def lp(q):
        return -0.5 * ((apply_flat(q, x) - y) ** 2).flatten(1).sum(-1) / 0.01 \
            - 0.5 * (q * q).sum(-1)

    inits = _inits(8, cfg.num_params, 1)
    n, _ = count_flops(lambda: sample_chains(lp, inits, HMCConfig(num_samples=1,
                                                                  num_leapfrog=4,
                                                                  step_size=1e-2),
                                             mesh=mesh))
    return {"flops": np.asarray(n)}


def query_problem(p=QUERY_P):
    """The JAX query-sharding test's DeepONet and data, at ``p`` query points."""
    cfg = DeepONetConfig(**QUERY_KW)
    rng = np.random.default_rng(0)
    flat0 = (0.3 * rng.normal(size=cfg.num_params)).astype(np.float32)
    branch_x = rng.normal(size=(QUERY_B, cfg.in_branch)).astype(np.float32)
    trunk_x = rng.uniform(size=(p, 2)).astype(np.float32)
    y = rng.normal(size=(QUERY_B, p)).astype(np.float32)
    return cfg, flat0, branch_x, trunk_x, y


def query_log_prob(mesh, p=QUERY_P):
    """``-0.5 sum (pred - y)^2`` over this rank's query points, summed over
    the ``'data'`` shards, plus the prior ``-0.005 |q|^2`` once."""
    cfg, _, branch_x, trunk_x, y = query_problem(p)
    apply_flat = make_flat_deeponet(cfg)
    tx, yy = (trunk_x, y) if mesh is None else shard_query(mesh, trunk_x, y)
    bx, tx, yy = (torch.as_tensor(a) for a in (branch_x, tx, yy))

    def ll(q):
        return -0.5 * ((apply_flat(q, bx, tx) - yy) ** 2).flatten(1).sum(-1)

    ll = data_parallel_ll(mesh, ll)
    return lambda q: ll(q) - 0.5 * (q * q).sum(-1) * 1e-2


def query_value_grad(mesh, p=QUERY_P):
    """The sharded log-posterior's value and gradient at two points."""
    _, flat0, *_ = query_problem(p)
    q = torch.as_tensor(np.stack([flat0, 0.8 * flat0]))
    v, g = value_and_grad(lambda x, a: query_log_prob(mesh, p)(x), q, None)
    return {"value": _np(v), "grad": _np(g)}


def query_run(mesh):
    """Value, gradient and a short run with queries over 'data' and the two
    chains over 'chains'."""
    _, flat0, *_ = query_problem()
    lp = query_log_prob(mesh)
    inits = torch.as_tensor(np.tile(flat0[None], (2, 1)))
    res = gather_chains(mesh, sample_chains(lp, inits, HMCConfig(num_samples=20,
                                                                 num_leapfrog=3,
                                                                 step_size=1e-3),
                                            seed=7, mesh=mesh))
    return {"samples": res.samples, **query_value_grad(mesh)}


def batch_mean(mesh):
    """The JAX data-sharding test: y = 2x over 64 points, the batch over
    'data'; the posterior mean of the slope within 0.1 of 2."""
    x = torch.linspace(-1, 1, 64).reshape(-1, 1)
    y = 2.0 * x
    x_s, y_s = (x, y) if mesh is None else shard_batch(mesh, (x, y))
    ll = data_parallel_ll(mesh, lambda q: -0.5 * ((q @ x_s.T - y_s.T) ** 2).sum(-1))

    def lp(q):
        return ll(q) - 0.5 * (q * q).sum(-1) * 1e-2

    cfg = HMCConfig(num_samples=300, num_leapfrog=5, step_size=0.05)
    res = gather_chains(mesh, sample_chains(lp, torch.zeros(2, 1), cfg, seed=3, mesh=mesh))
    return {"samples": res.samples}


def graft(mesh):
    """The multi-chip dry run of ``__graft_entry__.py`` (:44-180): REFRESH
    HMC on a batch-sharded DeepONet with the stride Gram field, coupled dual
    averaging, momentum persistence and step jitter; the gathered chains'
    R-hat and ESS; ChEES; and a query-sharded run with a rank-4 low-rank
    metric."""
    cfg = DeepONetConfig(in_branch=9, in_trunk=5, width_branch=8, width_trunk=8,
                         depth_branch=3, depth_trunk=3)
    apply_flat = make_flat_deeponet(cfg)
    d = cfg.num_params
    b, p = 8, 16
    rng = np.random.default_rng(0)
    branch_x = rng.normal(size=(b, cfg.in_branch)).astype(np.float32)
    trunk_x = torch.as_tensor(rng.uniform(size=(p, 2)), dtype=torch.float32)
    y = rng.normal(size=(b, p)).astype(np.float32)
    bx, yy = (torch.as_tensor(a) for a in shard_batch(mesh, (branch_x, y)))
    mu = torch.as_tensor(0.05 * rng.normal(size=d), dtype=torch.float32)
    sigma = torch.as_tensor(0.02 + 0.02 * rng.random(d), dtype=torch.float32)
    idx = torch.as_tensor(np.sort(rng.choice(d, size=32, replace=False)))
    spec = SubspaceSpec(idx=idx, mu=mu, sigma=sigma)
    like = get_likelihood("NLL")
    full_ll = data_parallel_ll(mesh, lambda flat: like(apply_flat(flat, bx, trunk_x), yy, 1.0))
    gen = torch.Generator().manual_seed(0)
    frozen = mu + sigma * torch.randn(d, generator=gen)
    lp_like, aux0 = make_subspace_log_prob(full_ll, spec, frozen, FrozenPolicy.REFRESH)
    refresh = make_aux_refresh(spec, FrozenPolicy.REFRESH)
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())

    def log_prob(q, aux):
        return lp_like(q, aux) + prior.log_prob(q)

    # the stride field on this rank's functions, summed over the shards
    grad_full = data_parallel_grad(mesh, make_gram_grad_full(
        cfg, bx, trunk_x, yy, 1.0, query_subset=np.arange(0, p, 2),
        fn_subset=np.arange(0, bx.shape[0], 2)))
    grad_fn = make_subspace_grad(grad_full, spec, prior=prior)
    n_chains = 2 * axis_size(mesh, "chains")
    inits = spec.sub_mu()[None, :].expand(n_chains, -1).clone()
    hmc_cfg = HMCConfig(num_samples=24, num_leapfrog=2, step_size=1e-3,
                        momentum_persistence=0.8, burn=8, sampler="hmc_nuts",
                        target_accept=0.65, da_axis="chains", jitter_eps=True,
                        jitter_low_frac=0.5)
    res = gather_chains(mesh, sample_chains(log_prob, inits, hmc_cfg,
                                            inv_mass=spec.sub_sigma() ** 2, aux=aux0,
                                            aux_refresh=refresh, grad_fn=grad_fn, seed=1,
                                            mesh=mesh))
    rhat = potential_scale_reduction_np(res.samples)
    ess = effective_sample_size_np(res.samples)
    chees_cfg = ChEESConfig(num_samples=12, step_size=1e-3, init_traj_length=2e-3, burn=6,
                            max_steps=4)
    res_c = gather_chains(mesh, sample_chains_chees(
        log_prob, inits, chees_cfg, inv_mass=spec.sub_sigma() ** 2, aux=aux0,
        aux_refresh=refresh, seed=2, mesh=mesh))
    trunk_q, y_q = shard_query(mesh, trunk_x, torch.as_tensor(y))
    branch_r = torch.as_tensor(rng.normal(size=(b, cfg.in_branch)), dtype=torch.float32)
    ll_q = data_parallel_ll(mesh, lambda flat: like(apply_flat(flat, branch_r, trunk_q), y_q,
                                                    1.0))
    frozen_q = mu + sigma * torch.randn(d, generator=gen)
    lp_q, aux_q = make_subspace_log_prob(ll_q, spec, frozen_q, FrozenPolicy.DRAW)

    def log_prob_q(q, aux):
        return lp_q(q, aux) + prior.log_prob(q)

    metric = estimate_lowrank_metric(log_prob_q, spec.sub_mu(), spec.sub_sigma() ** 2, 4,
                                     generator=torch.Generator().manual_seed(4), aux=aux_q)
    res_q = gather_chains(mesh, sample_chains(
        log_prob_q, inits, HMCConfig(num_samples=8, num_leapfrog=2, step_size=1e-3),
        inv_mass=metric, aux=aux_q, seed=5, mesh=mesh))
    return {"samples": res.samples, "rhat": rhat, "ess": ess, "chees": res_c.samples,
            "query": res_q.samples, "metric_u": _np(metric.u)}


def mesh_facts(mesh):
    """The global mesh's shape and the even chain split on a world of 4."""
    g = global_chain_mesh(2)
    try:
        chains_per_host(7)
        uneven = ""
    except ValueError as e:
        uneven = str(e)
    return {"shape": np.asarray([axis_size(g, "chains"), axis_size(g, "data")]),
            "per_host": np.asarray(chains_per_host(8)), "uneven": np.asarray(uneven),
            "coord": np.asarray(g.get_coordinate())}


#: scenario -> (mesh shape on the world, function); the meshes are built in this order
SETS = {
    "pair": [("hmc_chains", (2, 1), hmc_chains),
             ("coupled_windowed", (2, 1), lambda m: coupled(m, "windowed")),
             ("coupled_half", (2, 1), lambda m: coupled(m, "half")),
             ("nuts", (2, 1), nuts),
             ("operator", (2, 1), operator),
             ("baselines", (2, 1), baselines),
             ("flops", (2, 1), flops),
             ("query_value_grad", (1, 2), query_value_grad),
             ("query_value_grad_even", (1, 2), lambda m: query_value_grad(m, JAX_QUERY_P))],
    "quad": [("mesh_facts", (2, 2), mesh_facts),
             ("chees", (2, 2), chees),
             ("query_run", (2, 2), query_run),
             ("batch_mean", (2, 2), batch_mean),
             ("graft", (2, 2), graft)],
}


def nccl_refusal(rank: int, world: int, port: int) -> str:
    """Ask for NCCL with every rank on one device: the refusal's message."""
    try:
        initialize_distributed(f"localhost:{port}", world, rank, 30.0, backend="nccl",
                               device="cpu")
    except RuntimeError as e:
        return str(e)
    return ""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--set", required=True, choices=sorted(SETS))
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--probe-port", type=int, default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)
    try:
        results = {}
        if args.probe_port is not None:
            results["nccl/message"] = np.asarray(nccl_refusal(args.rank, args.world,
                                                              args.probe_port))
        dist.init_process_group("gloo", store=dist.FileStore(args.store, args.world),
                                rank=args.rank, world_size=args.world,
                                timeout=datetime.timedelta(seconds=60))
        for name, shape, fn in SETS[args.set]:
            for k, v in fn(make_chain_mesh(*shape)).items():
                results[f"{name}/{k}"] = np.asarray(v)
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **results)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(args.out, f"rank{args.rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


if __name__ == "__main__":
    main()
