"""Subspace VI-HMC on the Bayesian FNO2d: the problem, its sensitivity stage,
trajectory field and MH test, composed as :mod:`vihmc_torch.bench_operator`
composes the DeepONet row's.

* :class:`FNOProblem` / :func:`build_fno_problem`: the published FNO2d
  (:mod:`vihmc_torch.models.fno`) on initial conditions ``u0`` (B, nx) and
  their solutions ``y`` (B, nt nx), a VI posterior ``(mu, sigma)`` over the
  flat vector, the frozen 'draw' vector ``mu + sigma eps`` and the top-k
  subspace by sensitivity score.
* :func:`fno_probe_scores`: the stage-2 scores at the VI mean, ``E[(dy/dw)^2]
  sigma^2`` from Rademacher probes (``sensitivity.mean_squared_jacobian``
  with ``probes``) over a seeded sample of the functions, each function a row
  of the chain-batched forward.
* :func:`fno_log_prob`, :func:`fno_trajectory_field`, :func:`fno_mh_delta`:
  the subspace log density (IEEE f32, float64 sums), the clipped autograd
  field over function chunks (bf16 GEMM operands with ``grad_dtype``
  'bfloat16'), and the paired MH delta; the metric is the conditional-Laplace
  diagonal of the scores (:func:`fno_laplace_inv_mass`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vihmc_torch.bench_operator import BENCH_CLIP, TAU_VAR, laplace_inv_mass
from vihmc_torch.hmc.kernel import clipped_grad_fn
from vihmc_torch.hmc.subspace import (FrozenPolicy, SubspaceSpec, draw_full,
                                      make_subspace_grad, make_subspace_log_prob)
from vihmc_torch.models.fno import FNO2dConfig, fno_apply_chains, fno_input
from vihmc_torch.pipelines.common import (make_fno_grad_full, make_fno_nll_log_likelihood,
                                          make_fno_paired_subspace_delta)
from vihmc_torch.sensitivity.scores import sensitivity_scores


@dataclasses.dataclass
class FNOProblem:
    """The posterior of the FNO2d cell, on one device."""

    cfg: FNO2dConfig
    u0: torch.Tensor        # (B, nx) initial conditions
    y: torch.Tensor         # (B, nt nx) solutions, t-major
    spec: SubspaceSpec
    eps: torch.Tensor       # (D,) the standard normals of the 'draw' vector
    scores: np.ndarray      # (D,) sensitivity scores
    max_bytes: Optional[int] = None   # device bytes a function chunk may hold

    @property
    def idx(self) -> np.ndarray:
        return self.spec.idx.cpu().numpy()

    @property
    def frozen(self) -> torch.Tensor:
        return draw_full(self.spec, self.eps)


def fno_rows(cfg: FNO2dConfig, nt: int):
    """``apply_rows(flat (E, D), u0 (E, nx)) -> (E, nt, nx)``: row ``e`` is
    vector ``e`` on function ``e`` (each a chain of one function)."""

    def apply_rows(flat, u0):
        return fno_apply_chains(cfg, flat, fno_input(u0, nt)[:, None])[:, 0]

    return apply_rows


def fno_probe_scores(cfg: FNO2dConfig, mu: torch.Tensor, sigma: torch.Tensor,
                     u0: torch.Tensor, nt: int, n_functions: int, probes: int,
                     seed: int) -> np.ndarray:
    """``(D,)`` scores ``E[(dy/dw)^2] sigma^2`` at ``mu`` over ``n_functions``
    functions of ``u0`` drawn without replacement by a generator seeded with
    ``seed``, each with ``probes`` Rademacher probes from the same seed."""
    gen = torch.Generator(device=u0.device)
    gen.manual_seed(int(seed))
    pick = torch.randperm(u0.shape[0], generator=gen, device=u0.device)[:n_functions]
    rows = fno_rows(cfg, nt)
    scores = sensitivity_scores(lambda p, x: rows(p[None], x[None])[0], mu, sigma, u0[pick],
                                chunk_size=n_functions, probes=probes, seed=seed,
                                apply_rows=rows)
    return scores.cpu().numpy()


def build_fno_problem(cfg: FNO2dConfig, u0: torch.Tensor, y: torch.Tensor,
                      mu: torch.Tensor, sigma: torch.Tensor, eps: torch.Tensor,
                      scores: np.ndarray, top_k: int,
                      max_bytes: Optional[int] = None) -> FNOProblem:
    """The subspace of the ``top_k`` highest ``scores`` (sorted indices)."""
    if mu.shape[0] != cfg.num_params:
        raise ValueError(f"a posterior of {mu.shape[0]} for an FNO2d of {cfg.num_params}")
    idx = np.sort(np.argsort(-scores)[:top_k])
    spec = SubspaceSpec(idx=torch.as_tensor(idx, dtype=torch.int64, device=mu.device),
                        mu=mu, sigma=sigma)
    return FNOProblem(cfg, u0, y, spec, eps, scores, max_bytes)


def fno_log_prob(problem: FNOProblem, prior, policy: FrozenPolicy = FrozenPolicy.DRAW):
    """``(log_prob(q (C, d), aux) -> (C,), aux0)``: the subspace log density
    (likelihood in IEEE f32 with float64 sums, plus ``prior``)."""
    p = problem
    full_ll = make_fno_nll_log_likelihood(p.cfg, p.u0, p.y, TAU_VAR, p.max_bytes)
    lp_like, aux0 = make_subspace_log_prob(full_ll, p.spec, p.frozen, policy)

    def log_prob(q, aux):
        return lp_like(q, aux) + prior.log_prob(q)

    return log_prob, aux0


def fno_laplace_inv_mass(problem: FNOProblem) -> torch.Tensor:
    """The conditional-Laplace diagonal of the scores (``bench.py:500-507``'s
    rule at ``n_eff = B nt nx``)."""
    n_eff = problem.y.shape[0] * problem.y.shape[1]
    sigma = problem.spec.sigma.cpu().numpy()
    return torch.as_tensor(laplace_inv_mass(problem.scores, sigma, problem.idx, n_eff),
                           device=problem.y.device)


def fno_trajectory_field(problem: FNOProblem, prior, inv_mass, grad_dtype: str = "bfloat16",
                         clip: float = BENCH_CLIP):
    """The clipped trajectory field: the autograd gradient of the FNO's
    likelihood over function chunks (bf16 GEMM operands with ``grad_dtype``
    'bfloat16'), gathered at the subspace, plus the prior's; clipped at
    ``clip sqrt(d / 2048)`` in the ``inv_mass`` norm."""
    p = problem
    dt = torch.bfloat16 if grad_dtype == "bfloat16" else None
    grad_full = make_fno_grad_full(p.cfg, p.u0, p.y, TAU_VAR, dt, p.max_bytes)
    limit = clip * (p.spec.subspace_dim / 2048.0) ** 0.5
    return clipped_grad_fn(make_subspace_grad(grad_full, p.spec, prior=prior), limit,
                           inv_mass=inv_mass)


def fno_mh_delta(problem: FNOProblem, prior):
    """The paired MH delta (IEEE f32 forwards of both endpoints in one pass,
    float64 sums)."""
    p = problem
    return make_fno_paired_subspace_delta(p.cfg, p.u0, p.y, TAU_VAR, p.spec.idx, prior,
                                          p.max_bytes)
