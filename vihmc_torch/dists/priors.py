"""Gaussian priors over chain-batched flat vectors.

Counterpart of ``IsotropicGaussianPrior``, ``DiagonalGaussianPrior`` and
``PerSegmentGaussianPrior`` in ``vihmc_tpu/dists/priors.py`` (same math as
``torch.distributions.Normal.log_prob``, summed).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_LOG_2PI = math.log(2 * math.pi)


def normal_logpdf(x, loc, scale) -> torch.Tensor:
    """Elementwise Gaussian log-density (``torch.distributions.Normal.log_prob``'s
    math): ``-z^2 / 2 - log(scale) - log(2 pi) / 2``, ``z = (x - loc) / scale``."""
    x = torch.as_tensor(x)
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(torch.as_tensor(scale, dtype=x.dtype,
                                                    device=x.device)) - 0.5 * _LOG_2PI


def diag_normal_logpdf_sum(x, loc, scale) -> torch.Tensor:
    """The sum of :func:`normal_logpdf` over every element (a diagonal
    Gaussian's log-density)."""
    return torch.sum(normal_logpdf(x, loc, scale))


@dataclasses.dataclass
class IsotropicGaussianPrior:
    """``N(0, scale^2 I)`` -- the subspace prior when ``load_prior`` is off."""

    scale: float = 1.0

    def log_prob(self, flat: torch.Tensor) -> torch.Tensor:
        """``(C, d) -> (C,)``."""
        z = flat / self.scale
        return (-0.5 * z * z - math.log(self.scale) - 0.5 * _LOG_2PI).sum(-1)

    def grad(self, q: torch.Tensor) -> torch.Tensor:
        """d log_prob / dq, ``(C, d)``."""
        return -q / (self.scale * self.scale)


@dataclasses.dataclass
class DiagonalGaussianPrior:
    """``N(loc, diag(scale^2))`` -- e.g. the VI posterior on the subspace."""

    loc: torch.Tensor    # (d,)
    scale: torch.Tensor  # (d,)

    def log_prob(self, flat: torch.Tensor) -> torch.Tensor:
        """``(C, d) -> (C,)``."""
        z = (flat - self.loc) / self.scale
        return (-0.5 * z * z - torch.log(self.scale) - 0.5 * _LOG_2PI).sum(-1)

    def grad(self, q: torch.Tensor) -> torch.Tensor:
        """d log_prob / dq, ``(C, d)``."""
        return -(q - self.loc) / (self.scale * self.scale)


@dataclasses.dataclass
class PerSegmentGaussianPrior:
    """Zero-mean Gaussian with one scale per parameter tensor, broadcast over
    the flat vector (:func:`~vihmc_torch.core.ravel.per_segment_vector`):
    the reference's per-tensor ``tau_list`` priors."""

    scales_flat: torch.Tensor  # (D,)

    def log_prob(self, flat: torch.Tensor) -> torch.Tensor:
        """``(C, D) -> (C,)``."""
        z = flat / self.scales_flat
        return (-0.5 * z * z - torch.log(self.scales_flat) - 0.5 * _LOG_2PI).sum(-1)

    def grad(self, q: torch.Tensor) -> torch.Tensor:
        """d log_prob / dq, ``(C, D)``."""
        return -q / (self.scales_flat * self.scales_flat)
