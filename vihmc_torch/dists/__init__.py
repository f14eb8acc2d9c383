"""Likelihoods and priors (counterpart of ``vihmc_tpu.dists``)."""

from vihmc_torch.dists.likelihoods import gaussian_nll, get_likelihood, nll_log_likelihood
from vihmc_torch.dists.priors import (DiagonalGaussianPrior, IsotropicGaussianPrior,
                                      PerSegmentGaussianPrior)

__all__ = ["gaussian_nll", "get_likelihood", "nll_log_likelihood",
           "DiagonalGaussianPrior", "IsotropicGaussianPrior", "PerSegmentGaussianPrior"]
