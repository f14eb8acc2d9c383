"""Kinetic-energy metrics and Lanczos curvature estimation.

Counterpart of ``vihmc_tpu/hmc/metric.py``: ``LowRankMetric`` (mass
``M = D + U U^T`` with the k x k capacitance Cholesky factored once),
``lowrank_from_eigs``, the metric-agnostic helpers ``mass_velocity`` /
``mass_kinetic_energy`` / ``mass_sample_momentum`` for the diagonal and
low-rank cases, and ``hvp_fn`` / ``preconditioned_hvp`` / ``lanczos_tridiag``
/ ``lanczos_eigs`` (CGS2 full reorthogonalization, ``which='top'``).

Convention, as in JAX: a diagonal metric is passed as the INVERSE mass (a
posterior variance estimate), while ``LowRankMetric`` stores the mass itself.
Momenta and positions are chain-batched ``(C, d)``; the metric is shared.
Momentum draws take their standard normals as tensors, so a caller (or a
test) controls every random number.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LowRankMetric:
    """Mass ``diag(diag_mass) + u u^T`` with ``chol_cap`` = lower Cholesky of
    ``I_k + u^T D^-1 u``. Build with :func:`make_lowrank_metric`."""

    diag_mass: torch.Tensor  # (d,)
    u: torch.Tensor          # (d, k)
    chol_cap: torch.Tensor   # (k, k)

    @property
    def rank(self) -> int:
        return int(self.u.shape[-1])

    def dense(self) -> torch.Tensor:
        """Dense M -- tests and small problems only."""
        return torch.diag(self.diag_mass) + self.u @ self.u.T


def make_lowrank_metric(diag_mass, u) -> LowRankMetric:
    diag_mass = torch.as_tensor(diag_mass, dtype=torch.float32)
    u = torch.as_tensor(u, dtype=torch.float32, device=diag_mass.device)
    cap = (torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
           + (u.T / diag_mass[None, :]) @ u)
    return LowRankMetric(diag_mass=diag_mass, u=u,
                         chol_cap=torch.linalg.cholesky(cap))


def lowrank_from_eigs(diag_inv_mass, eigvals, eigvecs) -> LowRankMetric:
    """Metric from leading eigenpairs of the PRECONDITIONED curvature
    ``S (-H) S``, ``S = diag(sqrt(diag_inv_mass))``:
    ``M = S^-2 + sum_i max(lambda_i - 1, 0) (S^-1 v_i)(S^-1 v_i)^T``."""
    diag_inv_mass = torch.as_tensor(diag_inv_mass, dtype=torch.float32)
    eigvals = torch.as_tensor(eigvals, dtype=torch.float32, device=diag_inv_mass.device)
    eigvecs = torch.as_tensor(eigvecs, dtype=torch.float32, device=diag_inv_mass.device)
    scale = torch.sqrt(torch.clamp(eigvals - 1.0, min=0.0))
    u = (eigvecs / torch.sqrt(diag_inv_mass)[:, None]) * scale[None, :]
    return make_lowrank_metric(1.0 / diag_inv_mass, u)


def mass_velocity(inv_mass, p: torch.Tensor) -> torch.Tensor:
    """``M^-1 p`` per chain: Woodbury solve for a :class:`LowRankMetric`,
    a multiply for a scalar/diagonal inverse mass."""
    if isinstance(inv_mass, LowRankMetric):
        d_inv = 1.0 / inv_mass.diag_mass
        w = d_inv * p                                            # (C, d)
        rhs = (w @ inv_mass.u).T                                 # (k, C)
        z = torch.cholesky_solve(rhs, inv_mass.chol_cap).T       # (C, k)
        return w - d_inv * (z @ inv_mass.u.T)
    return inv_mass * p


def mass_kinetic_energy(inv_mass, p: torch.Tensor, velocity=None) -> torch.Tensor:
    """``0.5 p^T M^-1 p`` per chain, ``(C,)``."""
    if velocity is None:
        velocity = mass_velocity(inv_mass, p)
    return 0.5 * (p * velocity).sum(-1)


def momentum_normals_shape(inv_mass, n_chains: int, dim: int):
    """Shapes of the standard normals :func:`mass_sample_momentum` consumes:
    ``z1`` (C, d) and, for a low-rank metric, ``z2`` (C, k)."""
    if isinstance(inv_mass, LowRankMetric):
        return (n_chains, dim), (n_chains, inv_mass.rank)
    return (n_chains, dim), None


def mass_sample_momentum(inv_mass, z1: torch.Tensor, z2=None) -> torch.Tensor:
    """``p ~ N(0, M)`` from standard normals: ``sqrt(D) z1 + U z2`` for a
    low-rank metric (``Cov p = D + U U^T``), ``z1 / sqrt(inv_mass)`` for a
    diagonal one."""
    if isinstance(inv_mass, LowRankMetric):
        return torch.sqrt(inv_mass.diag_mass) * z1 + z2 @ inv_mass.u.T
    return z1 / torch.sqrt(torch.as_tensor(inv_mass, dtype=z1.dtype, device=z1.device))


# ---------------------------------------------------------------------------
# Lanczos eigenpair estimation from Hessian-vector products
# ---------------------------------------------------------------------------


def hvp_fn(log_prob, q0: torch.Tensor, aux=None):
    """``v (d,) -> -H(log_prob)(q0) v`` by double backward.

    ``log_prob(q (1, d), aux) -> (1,)``. The gradient graph at ``q0`` is
    built once and every product differentiates it again (the JAX package
    takes ``jvp`` of ``grad``; the product is the same). Returns the
    NEGATIVE-Hessian product, PSD at a mode.
    """
    q = q0.detach().reshape(1, -1).clone().requires_grad_(True)
    with torch.enable_grad():
        lp = log_prob(q, aux).sum()
        (g,) = torch.autograd.grad(lp, q, create_graph=True)

    def hvp(v: torch.Tensor) -> torch.Tensor:
        (hv,) = torch.autograd.grad(g, q, grad_outputs=v.reshape(1, -1),
                                    retain_graph=True)
        return -hv.reshape(-1)

    return hvp


def preconditioned_hvp(log_prob, q0, diag_inv_mass, aux=None):
    """HVP of ``A = S (-H) S`` with ``S = diag(sqrt(diag_inv_mass))``."""
    s = torch.sqrt(torch.as_tensor(diag_inv_mass, dtype=torch.float32))
    base = hvp_fn(log_prob, q0, aux=aux)

    def hvp(v):
        return s * base(s * v)

    return hvp


def lanczos_tridiag(matvec, v0: torch.Tensor, num_iters: int):
    """Lanczos with full reorthogonalization (two classical Gram-Schmidt
    passes against the whole stored basis per iteration). ``v0`` (dim,) is the
    start vector, normalized here. Returns ``(alphas (n,), betas (n-1,),
    basis (n, dim))``."""
    dim = v0.shape[0]
    basis = torch.zeros((num_iters, dim), dtype=v0.dtype, device=v0.device)
    basis[0] = v0 / torch.linalg.vector_norm(v0)
    alphas, betas = [], []
    for i in range(num_iters):
        v = basis[i]
        w = matvec(v)
        alphas.append(torch.dot(w, v))
        # the full-buffer projection removes alpha v and beta v_prev and
        # reorthogonalizes against every stored row (rows > i are still zero)
        for _ in range(2):
            w = w - basis.T @ (basis @ w)
        beta = torch.linalg.vector_norm(w)
        betas.append(beta)
        if i + 1 < num_iters:
            basis[i + 1] = w / torch.clamp(beta, min=1e-30)
    return torch.stack(alphas), torch.stack(betas)[:-1], basis


def lanczos_eigs(matvec, dim: int, rank: int, num_iters=None, v0=None,
                 generator=None, device="cpu"):
    """The ``rank`` LARGEST eigenpairs of a symmetric operator, descending
    (``which='top'`` of the JAX function). ``num_iters`` defaults to
    ``min(dim, max(2*rank, rank+10))``. The start vector is ``v0`` if given,
    else a standard normal draw from ``generator``."""
    if num_iters is None:
        num_iters = min(dim, max(2 * rank, rank + 10))
    if num_iters < rank:
        raise ValueError(f"num_iters={num_iters} < rank={rank}")
    if v0 is None:
        v0 = torch.randn(dim, generator=generator, device=device)
    alphas, betas, basis = lanczos_tridiag(matvec, v0.to(torch.float32), num_iters)
    t = torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)
    evals, evecs = torch.linalg.eigh(t)                  # ascending
    sel = torch.arange(num_iters - 1, num_iters - rank - 1, -1, device=evals.device)
    ritz_vals = evals[sel]
    ritz_vecs = basis.T @ evecs[:, sel]                  # (dim, rank)
    ritz_vecs = ritz_vecs / torch.linalg.vector_norm(ritz_vecs, dim=0, keepdim=True)
    return ritz_vals, ritz_vecs
