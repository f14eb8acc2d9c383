"""Subspace (VI-HMC) sampling: the 'draw' frozen policy over the flat vector.

Counterpart of ``vihmc_tpu/hmc/subspace.py`` (:35-145). HMC runs over the
sensitive coordinates ``idx`` only; the other coordinates stay frozen at one
VI-posterior draw (``FrozenPolicy.DRAW``). JAX makes that draw from
``jax.random.key(0)``; the port reads the same vector from the exported asset
(``assets/burgers_r2_port_inputs.npz``, ``frozen_draw``), since PyTorch cannot
replay ``jax.random``. ``MEAN`` and ``REFRESH`` are not ported.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

from vihmc_torch.core.ravel import scatter_subspace


class FrozenPolicy(enum.Enum):
    DRAW = "draw"


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


def make_subspace_log_prob(full_log_prob: Callable, spec: SubspaceSpec,
                           frozen_draw: torch.Tensor,
                           policy: FrozenPolicy = FrozenPolicy.DRAW):
    """``(log_prob(q (C, d), aux) -> (C,), aux0)`` for the DRAW policy.

    ``full_log_prob`` takes full ``(C, D)`` vectors; ``aux0`` is the frozen
    full vector ``frozen_draw`` (D,). The JAX function also returns a refresh
    hook, which is None under DRAW and is dropped here.
    """
    if policy is not FrozenPolicy.DRAW:
        raise NotImplementedError(f"frozen policy {policy} is not ported")
    idx = spec.idx

    def log_prob(q_sub, frozen):
        return full_log_prob(scatter_subspace(frozen, q_sub, idx))

    return log_prob, frozen_draw


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
