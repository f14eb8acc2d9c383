"""The system under test of ``fno2d-burgers``: subspace VI-HMC on the Bayesian
FNO2d, composed from ``vihmc_torch.bench_fno`` as ``systems/deeponet-burgers.py``
composes the DeepONet row from ``bench_operator``.

The benchmark makes the Burgers data and the seeded posterior
(``harness/fno_posterior.py``); the program's own functions make the
sensitivity scores (``fno_probe_scores``: Rademacher probes over a seeded
sample of the functions at the VI mean, timed as ``sensitivity_s`` after one
untimed forward and VJP of a row batch of the estimator's size,
``first_pass_s``, has taken the process's first-use costs at those shapes:
on the card ~4 s that a pass over one or 8 functions leaves in place), the
subspace posterior (``build_fno_problem``, ``fno_log_prob``), the
conditional-Laplace diagonal (``fno_laplace_inv_mass``, the cell's whole
metric: no Lanczos), the chain-batched autograd field over function chunks
(``fno_trajectory_field``), the paired MH test (``fno_mh_delta``) and the
warm start (``conditional_warm_start``, seeded by the run's seed). The
sampler is the row's coupled dual averaging (``sampler_config``), started at
the workload's ``initial_step``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from port_bench.harness import burgers
from port_bench.harness.cells import ROOT
from port_bench.harness.fno_posterior import posterior
from port_bench.harness.system import System

MODEL_KEYS = ("modes1", "modes2", "width", "n_layers", "fc_dim", "in_channels", "padding",
              "activation")


def build(config: dict, work: dict, seed: int, device) -> System:
    from vihmc_torch.bench_fno import (build_fno_problem, fno_laplace_inv_mass, fno_log_prob,
                                       fno_mh_delta, fno_probe_scores, fno_rows,
                                       fno_trajectory_field)
    from vihmc_torch.bench_operator import sampler_config
    from vihmc_torch.core.device import sync
    from vihmc_torch.core.precision import true_f32
    from vihmc_torch.dists.priors import DiagonalGaussianPrior
    from vihmc_torch.hmc.subspace import FrozenPolicy
    from vihmc_torch.models.fno import FNO2dConfig
    from vihmc_torch.pipelines.common import conditional_warm_start

    phases = {}
    m, post = config["model"], config["posterior"]
    cfg = FNO2dConfig(**{k: m[k] for k in MODEL_KEYS})
    if cfg.num_params != m["num_params"]:
        raise ValueError(f"FNO2dConfig has {cfg.num_params} parameters, the config "
                         f"{m['num_params']}")
    t0 = time.perf_counter()
    data = burgers.dataset(ROOT, config["data"], device)
    stride = int(config["data"].get("grid_stride", 1))
    u0 = data["branch_x"][:, ::stride].contiguous()
    y = data["y"]
    nt = y.shape[1] // u0.shape[1]
    pst = posterior(m, post, device)
    sync(device)
    phases["data_s"] = time.perf_counter() - t0

    s = work["sensitivity"]
    t0 = time.perf_counter()
    batch = u0[:s["functions"]].repeat(s["probes"], 1)
    with true_f32(), torch.enable_grad():
        w = pst["mu"].expand(batch.shape[0], -1).clone().requires_grad_(True)
        out = fno_rows(cfg, nt)(w, batch)
        torch.autograd.grad(out, w, grad_outputs=torch.ones_like(out))
    del batch, w, out
    sync(device)
    phases["first_pass_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    scores = fno_probe_scores(cfg, pst["mu"], pst["sigma"], u0, nt, s["functions"],
                              s["probes"], s["seed"])
    sync(device)
    phases["sensitivity_s"] = time.perf_counter() - t0

    f = work["field"]
    chains = work["chains"]
    problem = build_fno_problem(cfg, u0, y, pst["mu"], pst["sigma"], pst["eps"], scores,
                                work["subspace"]["top_k"],
                                max_bytes=int(f["memory_gb"] * 2 ** 30))
    spec = problem.spec
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())
    log_prob, aux0 = fno_log_prob(problem, prior, FrozenPolicy(post["frozen_policy"]))
    inv_mass = fno_laplace_inv_mass(problem)
    grad_fn = fno_trajectory_field(problem, prior, inv_mass, f["dtype"], f["clip"])
    delta_fn = fno_mh_delta(problem, prior)

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    inits = conditional_warm_start(grad_fn, aux0, spec.sub_mu(), inv_mass,
                                   work["warm_start_steps"], chains, gen)
    sync(device)
    phases["warm_start_s"] = time.perf_counter() - t0

    smp = work["sampler"]
    hmc = dataclasses.replace(
        sampler_config(1, smp["burn"], smp["num_leapfrog"], coupled=True,
                       target_accept=smp["target_accept"]),
        step_size=smp["initial_step"])
    return System(
        log_prob=log_prob, grad_fn=grad_fn, delta_fn=delta_fn, aux0=aux0, inits=inits,
        metric=inv_mass, hmc_config=hmc, phases=phases,
        shapes={"C": chains, "B": y.shape[0], "P": y.shape[1], "S1": nt, "S2": u0.shape[1],
                "pad": cfg.padding, "width": cfg.width, "n_layers": cfg.n_layers,
                "modes1": cfg.modes1, "modes2": cfg.modes2,
                "num_leapfrog": smp["num_leapfrog"], "d": spec.subspace_dim,
                "D": cfg.num_params},
        # ``idx`` only sizes the FLOP count: the reference draws its own
        # scores and subspace
        reference_inputs={"u0": u0, "y": y, **pst, "idx": spec.idx})
