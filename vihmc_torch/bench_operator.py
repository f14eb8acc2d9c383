"""The operator row: subspace VI-HMC on the reference-scale Bayesian DeepONet.

The port's counterpart of the zero-argument ``python bench.py`` operator row
(recipe ``bench.py:1826-1884``, sampler ``bench_jax`` :419-880), in the
``--fused-delta`` form:

* model and data: ``DeepONetConfig()`` (172,401 params) on Burgers data,
  B = 1000 training functions x P = 10,201 query points, solved on the device
  from the exported GRF initial conditions;
* subspace: the top-2048 coordinates by sensitivity score of
  ``assets/burgers_stage12_r2.npz``, the rest frozen at the exported VI draw;
* setup: the conditional-Laplace diagonal (``bench.py:495-507``), an
  ``init_opt``-step preconditioned-Adam warm start (:883-922) and a rank-k
  Lanczos ``LowRankMetric`` at the warm-start centre (:925-996);
* sampling: coupled dual averaging at ``target`` with ``adapt_forever`` and
  step jitter, L leapfrog steps on bf16 Gram trajectory gradients clipped at
  preconditioned norm 600, the fused paired f32 MH delta (one CUDA kernel
  launch per draw for all chains), segments of ``segment`` draws thinned
  ``thin`` x on the device;
* output: pooled and bulk ESS, R-hat, acceptance, wall, and the ``mfu``
  block (bench.py:873-876; :mod:`vihmc_torch.bench_mfu`): the draws' matmul
  FLOPs counted from one more transition of all chains (so ``paired_sums``
  launches ``draws + 1`` times in a row), over the sampling wall, against
  the card's bf16 peak. Unlike JAX's, it is not wrapped in a ``try``.

Run on the card::

    python -m vihmc_torch.bench_operator            # the full recipe
    python -m vihmc_torch.bench_operator --draws 240 --init-opt 200 --rank 32

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from vihmc_torch.bench_mfu import mfu_stats, sampling_flops
from vihmc_torch.chains.diagnostics import (effective_sample_size_np,
                                            ess_bulk_np, rhat_rank_np)
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core.device import resolve_device
from vihmc_torch.core.precision import true_f32
from vihmc_torch.data.burgers import (STAGE12_ASSET, get_burgers_train,
                                      load_port_inputs, load_stage12_artifacts)
from vihmc_torch.dists.priors import DiagonalGaussianPrior
from vihmc_torch.hmc.kernel import HMCConfig, clipped_grad_fn
from vihmc_torch.hmc.metric import (lanczos_eigs, lowrank_from_eigs,
                                    preconditioned_hvp)
from vihmc_torch.hmc.subspace import (SubspaceSpec, make_subspace_grad,
                                      make_subspace_log_prob)
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.ops.gram_merge import make_gram_grad_full
from vihmc_torch.pipelines.common import (conditional_warm_start,
                                          make_fused_paired_subspace_delta,
                                          make_nll_log_likelihood)

CLIP = 600.0          # preconditioned grad-norm clip at 2048 dims (bench.py:55)
TAU_VAR = 1.0         # NLL variance of the operator row
SUB_DIM = 2048
WARM_SEED = 0xA11     # the JAX warm start's key, reused as a torch seed
LANCZOS_SEED = 0x10E
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "runs", "torch_lanczos_cache")


@dataclasses.dataclass
class OperatorProblem:
    """The operator-row posterior on one device."""

    cfg: DeepONetConfig
    branch_x: torch.Tensor      # (B, 101)
    trunk_x: torch.Tensor       # (P, 2)
    y: torch.Tensor             # (B, P)
    spec: SubspaceSpec
    frozen: torch.Tensor        # (D,) the frozen VI draw
    inv_mass_diag: torch.Tensor  # (d,) conditional-Laplace variances
    tag: str = "custom"

    @property
    def prior(self) -> DiagonalGaussianPrior:
        return DiagonalGaussianPrior(loc=self.spec.sub_mu(), scale=self.spec.sub_sigma())


@dataclasses.dataclass
class OperatorFns:
    """The sampler's callables on one posterior, all chain-batched."""

    log_prob: Callable   # composed f32 log-density (q (C, d), aux) -> (C,)
    grad_fn: Callable    # clipped bf16 Gram trajectory field -> (C, d)
    delta_fn: Callable   # fused paired MH delta (q1, q0, aux) -> (dlp, lp1)


def operator_fns(problem: OperatorProblem) -> OperatorFns:
    """Build the row's density, trajectory field and MH delta
    (``bench.py:465-585``, ``--fused-delta`` form)."""
    spec, prior = problem.spec, problem.prior
    lp_like, _ = make_subspace_log_prob(
        make_nll_log_likelihood(problem.cfg, problem.branch_x, problem.trunk_x,
                                problem.y, TAU_VAR), spec, problem.frozen)

    def log_prob(q, a):
        return lp_like(q, a) + prior.log_prob(q)

    grad_full = make_gram_grad_full(problem.cfg, problem.branch_x, problem.trunk_x,
                                    problem.y, TAU_VAR, compute_dtype=torch.bfloat16)
    clip = CLIP * (spec.subspace_dim / 2048.0) ** 0.5
    grad_fn = clipped_grad_fn(make_subspace_grad(grad_full, spec, prior=prior),
                              clip, inv_mass=problem.inv_mass_diag)
    delta_fn = make_fused_paired_subspace_delta(
        problem.cfg, problem.branch_x, problem.trunk_x, problem.y, TAU_VAR, spec.idx, prior)
    return OperatorFns(log_prob=log_prob, grad_fn=grad_fn, delta_fn=delta_fn)


def laplace_inv_mass(scores, sigma, idx, n_eff) -> np.ndarray:
    """Diagonal conditional-Laplace variances (``bench.py:500-507``), in the
    same numpy arithmetic as the JAX bench."""
    g2 = scores[idx] / np.maximum(sigma[idx] ** 2, 1e-30)
    return (1.0 / (1.0 / np.maximum(sigma[idx] ** 2, 1e-30) + n_eff * g2)).astype(np.float32)


def build_operator_problem(device="cuda", sub_dim: int = SUB_DIM) -> OperatorProblem:
    """Load the asset and the exported draws, solve the Burgers training data
    on ``device``, and take the top-``sub_dim`` subspace (``bench.py:382``)."""
    dev = resolve_device(device)
    arts = load_stage12_artifacts()
    mu, sigma, scores = arts["mu"], arts["sigma"], arts["scores"]
    data = get_burgers_train(dev)
    frozen = load_port_inputs()["frozen_draw"]
    idx = np.sort(np.argsort(-scores)[:sub_dim])
    n_eff = data["branch_in"].shape[0] * data["trunk_in"].shape[0]
    spec = SubspaceSpec(idx=torch.as_tensor(idx, dtype=torch.int64, device=dev),
                        mu=torch.as_tensor(mu, device=dev),
                        sigma=torch.as_tensor(sigma, device=dev))
    return OperatorProblem(
        cfg=DeepONetConfig(), branch_x=data["branch_in"], trunk_x=data["trunk_in"],
        y=data["solution"].contiguous(), spec=spec,
        frozen=torch.as_tensor(frozen, device=dev),
        inv_mass_diag=torch.as_tensor(laplace_inv_mass(scores, sigma, idx, n_eff),
                                      device=dev),
        tag=f"{os.path.basename(STAGE12_ASSET)[:-4]}_d{sub_dim}")


def lowrank_metric(log_prob, aux, q_center, inv_mass_diag, rank: int,
                   iters: Optional[int] = None, cache_file: Optional[str] = None):
    """Rank-``rank`` Lanczos metric at ``q_center`` (``bench.py:925-996``):
    top eigenpairs of the preconditioned HVP of the composed f32 subspace
    log-density, floored at 1, through :func:`lowrank_from_eigs`. Returns
    ``(metric, extras)``; with ``cache_file`` the eigenpairs are read from or
    written to that ``.npz``."""
    dim = q_center.shape[0]
    iters = int(iters) if iters else max(2 * rank, rank + 10)
    dev = q_center.device
    cached = cache_file is not None and os.path.exists(cache_file)
    t0 = time.perf_counter()
    if cached:
        with np.load(cache_file) as z:
            eigvals = torch.as_tensor(z["eigvals"], device=dev)
            eigvecs = torch.as_tensor(z["eigvecs"], device=dev)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(LANCZOS_SEED)
        with true_f32():
            mv = preconditioned_hvp(log_prob, q_center, inv_mass_diag, aux=aux)
            eigvals, eigvecs = lanczos_eigs(mv, dim, rank, num_iters=iters,
                                            generator=gen, device=dev)
        if cache_file is not None:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            np.savez(cache_file, eigvals=eigvals.cpu().numpy(),
                     eigvecs=eigvecs.cpu().numpy())
    metric = lowrank_from_eigs(inv_mass_diag, torch.clamp(eigvals, min=1.0), eigvecs)
    ev = np.sort(eigvals.cpu().numpy())[::-1]
    extras = {"rank": rank, "iters": iters, "cached": cached,
              "lanczos_s": time.perf_counter() - t0,
              "eig_top4": [float(x) for x in ev[:4]],
              "n_above_10": int((ev > 10).sum())}
    return metric, extras


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_operator_row(device="cuda", draws: int = 2880, burn: int = 288,
                     thin: int = 3, chains: int = 48, L: int = 4,
                     target: float = 0.25, init_opt: int = 800,
                     lowrank_rank: int = 256, segment: int = 120, seed: int = 2,
                     lanczos_cache: bool = False,
                     problem: Optional[OperatorProblem] = None) -> dict:
    """Run the operator row and return its statistics (see module doc).

    ``problem`` reuses an already built posterior (it must live on
    ``device``); by default it is built from the assets. ``seed`` seeds the
    sampler's generators (the JAX bench's key 2 is its first headline key).
    """
    dev = resolve_device(device)
    if thin > 1 and (segment % thin or burn % thin):
        raise ValueError("thin must divide the segment size and burn")
    phases = {}
    t0 = time.perf_counter()
    if problem is None:
        problem = build_operator_problem(dev)
    _sync(dev)
    phases["problem_s"] = time.perf_counter() - t0

    spec, aux = problem.spec, problem.frozen
    fns = operator_fns(problem)
    log_prob, grad_fn = fns.log_prob, fns.grad_fn

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(WARM_SEED)
    if init_opt:
        inits = conditional_warm_start(grad_fn, aux, spec.sub_mu(),
                                       problem.inv_mass_diag, init_opt, chains, gen)
    else:
        inits = spec.sub_mu().expand(chains, -1).clone()
    q_center = inits.mean(0)
    _sync(dev)
    phases["warm_start_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    metric, lr_extras = problem.inv_mass_diag, None
    if lowrank_rank:
        cache = (os.path.join(CACHE_DIR, f"{problem.tag}_lap_draw_w{init_opt}_c{chains}"
                              f"_k{lowrank_rank}.npz") if lanczos_cache else None)
        metric, lr_extras = lowrank_metric(log_prob, aux, q_center,
                                           problem.inv_mass_diag, lowrank_rank,
                                           cache_file=cache)
    _sync(dev)
    phases["lanczos_s"] = time.perf_counter() - t0

    config = HMCConfig(num_samples=draws, num_leapfrog=L, step_size=0.1,
                       target_accept=target, sampler="hmc_nuts", adapt_forever=True,
                       da_axis="chains", jitter_eps=True, jitter_low_frac=0.5)
    seg_walls = []
    t_seg = [time.perf_counter()]

    def mark(seg_i, n_segs, state):
        now = time.perf_counter()
        seg_walls.append(now - t_seg[0])
        t_seg[0] = now

    t0 = time.perf_counter()
    res = sample_chains_resumable(log_prob, inits, config, segment, metric, aux,
                                  grad_fn, fns.delta_fn, thin=thin, seed=seed,
                                  progress=mark)
    _sync(dev)
    phases["sampling_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    post = res.samples[:, burn // thin:, :]
    stats = {}
    if post.shape[1] >= 4:
        ess, raw_tau, tau_floor = effective_sample_size_np(post, return_tau=True)
        stats.update({
            "ess_median": float(np.median(ess)),
            "ess_bulk_median": float(np.median(ess_bulk_np(post))),
            "ess_min": float(np.min(ess)),
            "rhat_max": float(np.max(rhat_rank_np(post))),
            "tau_floor_frac": float(np.mean(raw_tau < tau_floor)),
        })
    phases["diagnostics_s"] = time.perf_counter() - t0
    total_flops = sampling_flops(log_prob, config, inits, metric, aux, draws, grad_fn=grad_fn,
                                 delta_fn=fns.delta_fn)
    stats["mfu"] = mfu_stats(total_flops, phases["sampling_s"], chains, draws, dev)

    step_tr = np.median(res.step_sizes, axis=0)
    n4 = len(step_tr) // 4
    wall = sum(phases.values())
    stats.update({
        "acceptance": res.acceptance_rate,
        "step_quartiles": ([float(np.median(step_tr[i * n4:(i + 1) * n4]))
                            for i in range(4)] if n4 else []),
        "wall_s": wall,
        # each draw advances every chain; draws/s over the sampling phase
        "draws_per_s": draws / phases["sampling_s"],
        "chain_draws_per_s": chains * draws / phases["sampling_s"],
        "phases_s": phases,
        "segment_walls_s": seg_walls,
        "chains": chains, "draws": draws, "burn": burn, "thin": thin, "L": L,
        "target_accept": target, "init_opt": init_opt, "subspace_dim": spec.subspace_dim,
        "samples_shape": list(res.samples.shape),
        "samples_finite": bool(np.isfinite(res.samples).all()),
        "divergent": int(res.divergent.sum()),
        "lowrank_metric": lr_extras,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
    })
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=2880)
    ap.add_argument("--burn", type=int, default=288)
    ap.add_argument("--thin", type=int, default=3)
    ap.add_argument("--chains", type=int, default=48)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--target", type=float, default=0.25)
    ap.add_argument("--init-opt", type=int, default=800)
    ap.add_argument("--rank", type=int, default=256)
    ap.add_argument("--segment", type=int, default=120)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--no-lanczos-cache", action="store_true")
    args = ap.parse_args(argv)
    stats = run_operator_row(
        device=args.device, draws=args.draws, burn=args.burn, thin=args.thin,
        chains=args.chains, L=args.L, target=args.target, init_opt=args.init_opt,
        lowrank_rank=args.rank, segment=args.segment, seed=args.seed,
        lanczos_cache=not args.no_lanczos_cache)
    keys = ("ess_median", "ess_bulk_median", "ess_min", "rhat_max", "acceptance",
            "wall_s", "draws_per_s", "device")
    print(json.dumps({k: stats.get(k) for k in keys}))


if __name__ == "__main__":
    main()
