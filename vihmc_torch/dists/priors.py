"""Diagonal Gaussian prior over chain-batched flat vectors.

Counterpart of ``DiagonalGaussianPrior`` in ``vihmc_tpu/dists/priors.py``
(same math as ``torch.distributions.Normal.log_prob``, summed).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_LOG_2PI = math.log(2 * math.pi)


@dataclasses.dataclass
class DiagonalGaussianPrior:
    """``N(loc, diag(scale^2))`` -- e.g. the VI posterior on the subspace."""

    loc: torch.Tensor    # (d,)
    scale: torch.Tensor  # (d,)

    def log_prob(self, q: torch.Tensor) -> torch.Tensor:
        """``(C, d) -> (C,)``."""
        z = (q - self.loc) / self.scale
        return (-0.5 * z * z - torch.log(self.scale) - 0.5 * _LOG_2PI).sum(-1)

    def grad(self, q: torch.Tensor) -> torch.Tensor:
        """d log_prob / dq, ``(C, d)``."""
        return -(q - self.loc) / (self.scale * self.scale)
