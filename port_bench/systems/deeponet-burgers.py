"""The system under test of ``deeponet-burgers``: the operator row of
``vihmc_torch.bench_operator``, composed as ``bench_operator`` composes it.

The benchmark makes the Burgers data and reads the stage-1/2 bundle and the
frozen draw's normals; the program's own functions make the subspace posterior,
the trajectory field (``trajectory_field``), the fused paired MH test
(``mh_delta``: one ``paired_sums`` launch per draw), the
conditional-Laplace diagonal (``problem_laplace_inv_mass``), the warm start
(``conditional_warm_start``, seeded by the run's seed) and the Lanczos
metric (``lowrank_metric``, with no cache file, so every run computes it).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from port_bench.harness import burgers
from port_bench.harness.cells import ROOT
from port_bench.harness.system import System


def build(config: dict, work: dict, seed: int, device) -> System:
    from vihmc_torch.bench_operator import (BenchProblem, density_log_likelihood,
                                            lowrank_metric, mh_delta,
                                            problem_laplace_inv_mass, sampler_config,
                                            trajectory_field)
    from vihmc_torch.core.device import sync
    from vihmc_torch.dists.priors import DiagonalGaussianPrior
    from vihmc_torch.hmc.subspace import FrozenPolicy, SubspaceSpec, make_subspace_log_prob
    from vihmc_torch.models.deeponet import DeepONetConfig
    from vihmc_torch.ops import cuda_build
    from vihmc_torch.pipelines.common import conditional_warm_start

    phases = {}
    if torch.device(device).type == "cuda":
        t0 = time.perf_counter()
        cuda_build.build_all(["paired_sums"])
        phases["build_s"] = time.perf_counter() - t0
    m, post = config["model"], config["posterior"]
    t0 = time.perf_counter()
    data = burgers.dataset(ROOT, config["data"], device)
    sync(device)
    phases["data_s"] = time.perf_counter() - t0
    with np.load(os.path.join(ROOT, post["bundle"])) as z:
        mu, sigma, scores = z["mu"], z["sigma"], z["scores"]
    with np.load(os.path.join(ROOT, post["draw_normals"])) as z:
        eps = z["eps_full"]
    top_k = work["subspace"]["top_k"]
    idx = np.sort(np.argsort(-scores)[:top_k])
    dev_t = {k: torch.as_tensor(v, device=device)
             for k, v in (("mu", mu), ("sigma", sigma), ("scores", scores), ("eps", eps))}
    idx_t = torch.as_tensor(idx, dtype=torch.int64, device=device)

    cfg = DeepONetConfig(in_branch=m["in_branch"], in_trunk=m["in_trunk"],
                         width_branch=m["width_branch"], width_trunk=m["width_trunk"],
                         depth_branch=m["depth_branch"], depth_trunk=m["depth_trunk"],
                         output_neurons=m["latent"], activation=m["activation"],
                         impose_bc=m["impose_bc"])
    spec = SubspaceSpec(idx=idx_t, mu=dev_t["mu"], sigma=dev_t["sigma"])
    chains = work["chains"]
    problem = BenchProblem(cfg, data["branch_x"], data["trunk_x"], data["y"], spec,
                           dev_t["eps"], chains, 0, {"posterior": "vi_fit"}, scores=scores)
    lp_like, aux0 = make_subspace_log_prob(density_log_likelihood(problem), spec,
                                           problem.frozen, FrozenPolicy(post["frozen_policy"]))
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())

    def log_prob(q, aux):
        return lp_like(q, aux) + prior.log_prob(q)

    inv_mass = problem_laplace_inv_mass(problem)
    f = work["field"]
    grad_fn = trajectory_field(problem, prior, inv_mass, use_gram=True, stride=f["stride"],
                               fn_stride=f["fn_stride"], grad_dtype=f["dtype"])
    delta_fn = mh_delta(problem, prior, paired_delta=True, fused_delta=True)

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    inits = conditional_warm_start(grad_fn, aux0, spec.sub_mu(), inv_mass,
                                   work["warm_start_steps"], chains, gen)
    q_center = inits.mean(0)
    sync(device)
    phases["warm_start_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    metric, _ = lowrank_metric(log_prob, aux0, q_center, inv_mass, work["lanczos"]["rank"],
                               work["lanczos"]["iters"], cache_file=None)
    sync(device)
    phases["lanczos_s"] = time.perf_counter() - t0

    s = work["sampler"]
    hmc = sampler_config(1, s["burn"], s["num_leapfrog"], coupled=True,
                         target_accept=s["target_accept"])
    return System(
        log_prob=log_prob, grad_fn=grad_fn, delta_fn=delta_fn, aux0=aux0, inits=inits,
        metric=metric, hmc_config=hmc, phases=phases,
        shapes={"C": chains, "B": data["y"].shape[0], "P": data["y"].shape[1],
                "K": m["latent"], "d": top_k, "q_center": q_center},
        reference_inputs={**data, **dev_t, "idx": idx_t})
