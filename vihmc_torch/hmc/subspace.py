"""Subspace (VI-HMC) sampling: frozen-coordinate policies over the flat vector.

Counterpart of ``vihmc_tpu/hmc/subspace.py`` (:35-145). HMC runs over the
sensitive coordinates ``idx`` only; the other coordinates are frozen:

``FrozenPolicy.MEAN``     at the VI means;
``FrozenPolicy.DRAW``     at one VI-posterior draw taken at init;
``FrozenPolicy.REFRESH``  re-drawn from the VI posterior before every draw,
                          each chain its own (the reference's resample hook).

JAX makes the DRAW/REFRESH initial draw from a threefry key, which PyTorch
cannot replay: the caller passes the initial frozen vector (drawn from a
``torch.Generator``, or JAX's own, e.g. the operator row's exported
``frozen_draw``), and the refresh hook takes the standard normals of the new
draws, which the transition draws from its generator (or a test injects).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

from vihmc_torch.core.ravel import scatter_subspace


class FrozenPolicy(enum.Enum):
    MEAN = "mean"
    DRAW = "draw"
    REFRESH = "refresh"


@dataclasses.dataclass(frozen=True)
class SubspaceSpec:
    """Sensitive indices (sorted) and the VI mean/std over the FULL vector."""

    idx: torch.Tensor    # (d,) int64
    mu: torch.Tensor     # (D,)
    sigma: torch.Tensor  # (D,)

    @property
    def subspace_dim(self) -> int:
        return int(self.idx.shape[0])

    def sub_mu(self) -> torch.Tensor:
        return self.mu[self.idx]

    def sub_sigma(self) -> torch.Tensor:
        return self.sigma[self.idx]


def draw_full(spec: SubspaceSpec, z: torch.Tensor) -> torch.Tensor:
    """Full-vector draws from the VI posterior, ``mu + sigma z``, for standard
    normals ``z`` (..., D) (the reference ``sample_weights``)."""
    return spec.mu + spec.sigma * z


def make_subspace_log_prob(full_log_prob: Callable, spec: SubspaceSpec,
                           frozen_draw=None, policy: FrozenPolicy = FrozenPolicy.DRAW):
    """``(log_prob(q (C, d), aux) -> (C,), aux0)``.

    ``full_log_prob`` takes full ``(C, D)`` vectors. ``aux0`` is the VI mean
    under MEAN, else ``frozen_draw`` (D,), the initial frozen draw. ``aux``
    may be ``(D,)`` (shared by the chains) or ``(C, D)`` (one per chain, as
    REFRESH leaves it). The JAX function also returns the refresh hook:
    here that is :func:`make_aux_refresh`.
    """
    idx = spec.idx
    if policy is FrozenPolicy.MEAN:
        aux0 = spec.mu
    elif policy in (FrozenPolicy.DRAW, FrozenPolicy.REFRESH):
        if frozen_draw is None:
            raise ValueError(f"FrozenPolicy.{policy.name} requires the initial frozen draw")
        aux0 = frozen_draw
    else:
        raise ValueError(f"unknown policy {policy}")

    def log_prob(q_sub, frozen):
        return full_log_prob(scatter_subspace(frozen, q_sub, idx))

    return log_prob, aux0


def make_aux_refresh(spec: SubspaceSpec, policy: FrozenPolicy):
    """The REFRESH hook ``refresh(z (C, D)) -> (C, D)``: each chain's new
    frozen vector ``mu + sigma z``; None under MEAN and DRAW."""
    if policy is not FrozenPolicy.REFRESH:
        return None
    return lambda z: draw_full(spec, z)


def make_subspace_grad(full_grad: Callable, spec: SubspaceSpec, prior=None):
    """Subspace gradient ``grad(q (C, d), aux) -> (C, d)`` from a full-vector
    oracle: ``full_grad(scatter(aux, q))[:, idx]`` plus the prior's gradient."""
    idx = spec.idx

    def grad(q_sub, frozen):
        g = full_grad(scatter_subspace(frozen, q_sub, idx))[:, idx]
        if prior is not None:
            g = g + prior.grad(q_sub)
        return g

    return grad
