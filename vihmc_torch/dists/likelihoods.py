"""Gaussian NLL log-likelihood, torch ``GaussianNLLLoss`` semantics.

Counterpart of the ``'NLL'`` entry of ``vihmc_tpu/dists/likelihoods.py``:
variance clamped at 1e-6, no ``0.5 log 2 pi`` constant, ``tau`` is the
VARIANCE. Only the NLL likelihood is ported.
"""

from __future__ import annotations

import torch

GNLL_EPS = 1e-6


def gaussian_nll(pred: torch.Tensor, target: torch.Tensor, var: float) -> torch.Tensor:
    """Elementwise ``0.5 (log var + (pred - target)^2 / var)``."""
    v = max(float(var), GNLL_EPS)
    return 0.5 * (torch.log(torch.tensor(v, dtype=pred.dtype, device=pred.device))
                  + (pred - target) ** 2 / v)


def nll_log_likelihood(pred: torch.Tensor, target: torch.Tensor,
                       tau: float) -> torch.Tensor:
    """``-sum gaussian_nll`` over every axis but the leading chain axis: (C,)."""
    return -gaussian_nll(pred, target, tau).flatten(1).sum(-1)
