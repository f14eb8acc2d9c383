"""Multi-process VI-HMC launch: one process per card, or several on one card.

Counterpart of ``scripts/run_multihost_vihmc.py``. Every process runs the
same program: ``initialize_distributed`` joins the process group, the
('chains', 'data') mesh spans every rank, every process makes the same
dataset and keeps its ``'data'`` slice (``shard_batch`` on ``branch_x`` and
``y``, the likelihood summed over the slices by ``data_parallel_ll``), and
``sample_chains(mesh=...)`` splits the chains over the ranks. The chains are
gathered on every rank for the diagnostics; rank 0 prints one machine-
readable ``RESULT {...}`` line, which a run over N processes must share with
the one-process run of the same workload (the chains' random numbers are
drawn for all chains on every rank and sliced).

Under torchrun (the environment gives the rank and the coordinator)::

    torchrun --nproc-per-node 2 -m vihmc_torch.run_multihost --backend gloo      # one card
    torchrun --nproc-per-node 4 -m vihmc_torch.run_multihost --backend nccl      # 4 cards

or by hand, one command per process (``--device cpu`` runs on the CPU)::

    python -m vihmc_torch.run_multihost --coordinator localhost:29500 \\
        --num-processes 2 --process-id 0 --backend gloo --device cpu

NCCL takes one rank per card; ranks that share a card need ``--backend gloo``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

#: the stream of the run seed the initial frozen draw comes from
_FROZEN_STREAM = 740_001


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-process VI-HMC over torch.distributed")
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--num-samples", type=int, default=120)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--subspace", type=int, default=256)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit under torchrun/SLURM)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--init-timeout", type=float, default=None,
                    help="coordinator handshake and collective timeout (seconds)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on a card, gloo on the CPU (NCCL: one rank per card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from vihmc_torch.chains import (gather_chains, global_chain_mesh, initialize_distributed,
                                    sample_chains, shard_batch, summarize_np)
    from vihmc_torch.core.device import resolve_device, stream_generator
    from vihmc_torch.core.mesh import data_parallel_ll, mesh_shape
    from vihmc_torch.core.precision import true_f32
    from vihmc_torch.dists.likelihoods import get_likelihood
    from vihmc_torch.dists.priors import DiagonalGaussianPrior
    from vihmc_torch.hmc import (FrozenPolicy, HMCConfig, SubspaceSpec, make_aux_refresh,
                                 make_subspace_log_prob)
    from vihmc_torch.models.deeponet import DeepONetConfig
    from vihmc_torch.pipelines.common import make_flat_deeponet

    distributed = initialize_distributed(args.coordinator, args.num_processes,
                                         args.process_id,
                                         initialization_timeout=args.init_timeout,
                                         backend=args.backend, device=args.device)
    # a card is the one initialize_distributed made current
    dev = resolve_device(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == 0:
        print(f"distributed={distributed} processes={world} devices={world}", flush=True)

    mesh = global_chain_mesh(n_data_shards=args.data_shards)

    # the same dataset on every process
    cfg = DeepONetConfig(in_branch=31, in_trunk=5, width_branch=32, width_trunk=32,
                         depth_branch=4, depth_trunk=4)
    apply_flat = make_flat_deeponet(cfg)
    d = cfg.num_params
    rng = np.random.default_rng(0)
    branch_x = rng.normal(size=(64, cfg.in_branch)).astype(np.float32)
    trunk_x = torch.as_tensor(rng.uniform(size=(512, 2)), dtype=torch.float32, device=dev)
    y = rng.normal(size=(64, 512)).astype(np.float32)
    branch_x, y = (torch.as_tensor(a, device=dev) for a in shard_batch(mesh, (branch_x, y)))

    mu = torch.as_tensor(0.05 * rng.normal(size=d), dtype=torch.float32, device=dev)
    sigma = torch.as_tensor(0.01 + 0.02 * rng.random(d), dtype=torch.float32, device=dev)
    idx = np.sort(rng.choice(d, size=min(args.subspace, d // 2), replace=False))
    spec = SubspaceSpec(idx=torch.as_tensor(idx, device=dev), mu=mu, sigma=sigma)
    like = get_likelihood("NLL")

    def full_ll(flat):
        with true_f32():
            pred = apply_flat(flat, branch_x, trunk_x)
        return like(pred, y, 1.0)

    frozen = mu + sigma * torch.randn(d, generator=stream_generator(dev, 0, _FROZEN_STREAM),
                                      device=dev)
    lp, aux0 = make_subspace_log_prob(data_parallel_ll(mesh, full_ll), spec, frozen,
                                      FrozenPolicy.REFRESH)
    refresh = make_aux_refresh(spec, FrozenPolicy.REFRESH)
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())

    def log_prob(q, aux):
        return lp(q, aux) + prior.log_prob(q)

    inits = spec.sub_mu()[None, :].expand(args.chains, -1).clone()
    hmc = HMCConfig(num_samples=args.num_samples, num_leapfrog=15, step_size=1e-3,
                    burn=args.num_samples // 5, sampler="hmc_nuts", target_accept=0.55)
    res = sample_chains(log_prob, inits, hmc, inv_mass=spec.sub_sigma() ** 2, aux=aux0,
                        aux_refresh=refresh, mesh=mesh, seed=1)
    # every rank gets the whole chain axis for the host-side diagnostics
    res = gather_chains(mesh, res)
    if rank == 0:
        stats = summarize_np(res.samples[:, args.num_samples // 5:, :], rank_normalized=False)
        print("RESULT " + json.dumps({
            "distributed": bool(distributed),
            "processes": world,
            "devices": world,
            "mesh": mesh_shape(mesh),
            "chains": args.chains,
            "draws": args.num_samples,
            "acceptance": round(res.acceptance_rate, 6),
            "max_rhat": round(float(np.max(stats["r_hat"])), 6),
            "median_ess": round(float(np.median(stats["ess"])), 4),
        }), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
