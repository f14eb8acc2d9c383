"""Kinetic-energy metrics and Lanczos curvature estimation.

Counterpart of ``vihmc_tpu/hmc/metric.py``: ``LowRankMetric`` (mass
``M = D + U U^T`` with the k x k capacitance Cholesky factored once),
``lowrank_from_eigs``, ``EigenMetric`` (the two-sided eigenvalue-corrected
metric ``M = S^-1 (I + V (Lam - I) V^T) S^-1``, :77-131) and
``eigen_metric_from_eigs``, the metric-agnostic helpers ``mass_velocity`` /
``mass_kinetic_energy`` / ``mass_sample_momentum`` for the diagonal,
low-rank and eigen cases, ``mass_diag_inv`` (:220) / ``as_inv_mass`` (:236),
``hutchinson_diag`` (:288), and ``hvp_fn`` / ``preconditioned_hvp`` /
``lanczos_tridiag`` / ``lanczos_eigs`` (CGS2 full reorthogonalization,
``which='top'`` or ``'both'``) / ``estimate_lowrank_metric``.

Convention, as in JAX: a diagonal metric is passed as the INVERSE mass (a
posterior variance estimate), while ``LowRankMetric`` stores the mass itself.
Momenta and positions are chain-batched ``(C, d)``; the metric is shared.
Momentum draws take their standard normals as tensors, so a caller (or a
test) controls every random number.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vihmc_torch.core.profiling import count, span


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


@dataclasses.dataclass
class EigenMetric:
    """Mass ``M = S^-1 W(Lam) S^-1`` with ``S = diag(sqrt(diag_inv_mass))``,
    ``W(a) x = x + V diag(a - 1) V^T x`` and ORTHONORMAL ``v`` (d, k): the
    base diagonal metric with k preconditioned directions corrected to their
    curvatures ``eigvals``, stiffened (lambda > 1) or softened (lambda < 1).
    Every operation is exact and O(dk) without a solve: the momentum is
    ``S^-1 W(sqrt Lam) z``, the velocity ``S W(1/Lam) S p``."""

    diag_inv_mass: torch.Tensor  # (d,)
    v: torch.Tensor              # (d, k) orthonormal
    eigvals: torch.Tensor        # (k,)

    @property
    def rank(self) -> int:
        return int(self.v.shape[-1])

    def w_apply(self, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``W(a) x`` for ``x`` (..., d)."""
        return x + ((x @ self.v) * (a - 1.0)) @ self.v.T

    def dense(self) -> torch.Tensor:
        """Dense M -- tests and small problems only."""
        s_inv = 1.0 / torch.sqrt(self.diag_inv_mass)
        inner = (torch.eye(self.v.shape[0], dtype=self.v.dtype, device=self.v.device)
                 + self.v @ ((self.eigvals - 1.0)[:, None] * self.v.T))
        return (s_inv[:, None] * inner) * s_inv[None, :]


def eigen_metric_from_eigs(diag_inv_mass, eigvals, eigvecs, min_eig: float = 0.01,
                           max_eig: float = math.inf) -> EigenMetric:
    """An :class:`EigenMetric` from preconditioned Ritz pairs, the eigenvalues
    clipped to ``[min_eig, max_eig]`` (underconverged soft Ritz values would
    overstate the widening)."""
    diag_inv_mass = torch.as_tensor(diag_inv_mass, dtype=torch.float32)
    dev = diag_inv_mass.device
    lam = torch.clamp(torch.as_tensor(eigvals, dtype=torch.float32, device=dev),
                      min_eig, max_eig)
    return EigenMetric(diag_inv_mass=diag_inv_mass,
                       v=torch.as_tensor(eigvecs, dtype=torch.float32, device=dev),
                       eigvals=lam)


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
    if isinstance(inv_mass, EigenMetric):
        s = torch.sqrt(inv_mass.diag_inv_mass)
        return s * inv_mass.w_apply(1.0 / inv_mass.eigvals, s * p)
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
    low-rank metric (``Cov p = D + U U^T``), ``S^-1 W(sqrt Lam) z1`` for an
    eigen metric, ``z1 / sqrt(inv_mass)`` for a diagonal one."""
    if isinstance(inv_mass, LowRankMetric):
        return torch.sqrt(inv_mass.diag_mass) * z1 + z2 @ inv_mass.u.T
    if isinstance(inv_mass, EigenMetric):
        return (inv_mass.w_apply(torch.sqrt(inv_mass.eigvals), z1)
                / torch.sqrt(inv_mass.diag_inv_mass))
    return z1 / torch.sqrt(torch.as_tensor(inv_mass, dtype=z1.dtype, device=z1.device))


def mass_diag_inv(inv_mass, template=None):
    """A (d,) diagonal-inverse-mass view for preconditioned norms and clips:
    ``1/diag_mass`` of a low-rank metric (an upper bound on the marginals of
    ``M^-1``), the base diagonal of an eigen metric, else ``inv_mass``
    (broadcast like ``template`` when given)."""
    if isinstance(inv_mass, LowRankMetric):
        return 1.0 / inv_mass.diag_mass
    if isinstance(inv_mass, EigenMetric):
        return inv_mass.diag_inv_mass
    if template is not None:
        return inv_mass * torch.ones_like(template)
    return inv_mass


def as_inv_mass(inv_mass, device=None):
    """Structured metrics pass through; scalars and arrays become float32
    tensors (on ``device`` when given)."""
    if isinstance(inv_mass, (LowRankMetric, EigenMetric)):
        return inv_mass
    return torch.as_tensor(inv_mass, dtype=torch.float32, device=device)


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
    """HVP of ``A = S (-H) S`` with ``S = diag(sqrt(diag_inv_mass))``; each
    product is a ``vihmc.lanczos.hvp`` span (host clock) and a
    ``lanczos.hvps`` count."""
    s = torch.sqrt(torch.as_tensor(diag_inv_mass, dtype=torch.float32))
    base = hvp_fn(log_prob, q0, aux=aux)

    def hvp(v):
        count("lanczos.hvps")
        with span("vihmc.lanczos.hvp"):
            return s * base(s * v)

    return hvp


def hutchinson_diag(matvec, dim: int, n_probes: int, generator=None, probes=None,
                    device="cpu") -> torch.Tensor:
    """Hutchinson estimate of ``diag(A)``, ``mean_i v_i * (A v_i)`` over
    Rademacher probes ``v_i``: ``probes`` (n_probes, dim) when given (a test
    injects JAX's), else drawn from ``generator``."""
    if probes is None:
        bits = torch.randint(0, 2, (n_probes, dim), generator=generator, device=device)
        probes = 2.0 * bits.to(torch.float32) - 1.0
    acc = torch.zeros(dim, dtype=torch.float32, device=probes.device)
    for v in probes:
        acc = acc + v * matvec(v)
    return acc / n_probes


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
                 generator=None, device="cpu", which: str = "top"):
    """Extreme eigenpairs of a symmetric operator: ``which='top'`` the
    ``rank`` LARGEST, descending; ``'both'`` the ``rank // 2`` largest
    (descending) then the ``rank - rank // 2`` smallest (ascending), as an
    :class:`EigenMetric` needs. ``num_iters`` defaults to
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
    if which == "both":
        n_top = rank // 2
        sel = torch.cat([torch.arange(num_iters - 1, num_iters - n_top - 1, -1),
                         torch.arange(rank - n_top)]).to(evals.device)
    else:
        sel = torch.arange(num_iters - 1, num_iters - rank - 1, -1, device=evals.device)
    ritz_vals = evals[sel]
    ritz_vecs = basis.T @ evecs[:, sel]                  # (dim, rank)
    ritz_vecs = ritz_vecs / torch.linalg.vector_norm(ritz_vecs, dim=0, keepdim=True)
    return ritz_vals, ritz_vecs


def estimate_lowrank_metric(log_prob, q0: torch.Tensor, diag_inv_mass, rank: int,
                            num_iters=None, v0=None, generator=None, aux=None,
                            min_eig: float = 1.0) -> LowRankMetric:
    """Lanczos on the preconditioned curvature ``S (-H) S`` of ``log_prob``
    at ``q0`` (d,), then :func:`lowrank_from_eigs` with the Ritz values
    floored at ``min_eig`` (``metric.py:386-413`` of the JAX package). The
    start vector is ``v0``, else a standard normal draw from ``generator``
    (JAX draws it from its key)."""
    diag = torch.as_tensor(diag_inv_mass, dtype=torch.float32, device=q0.device)
    mv = preconditioned_hvp(log_prob, q0, diag, aux=aux)
    vals, vecs = lanczos_eigs(mv, q0.shape[0], rank, num_iters=num_iters, v0=v0,
                              generator=generator, device=q0.device)
    return lowrank_from_eigs(diag, torch.clamp(vals, min=min_eig), vecs)
