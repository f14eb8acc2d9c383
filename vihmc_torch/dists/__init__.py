"""Likelihoods and priors (counterpart of ``vihmc_tpu.dists``)."""

from vihmc_torch.dists.likelihoods import (LIKELIHOODS, gaussian_nll, get_likelihood,
                                           nll_log_likelihood)
from vihmc_torch.dists.priors import (DiagonalGaussianPrior, IsotropicGaussianPrior,
                                      PerSegmentGaussianPrior)

__all__ = ["LIKELIHOODS", "gaussian_nll", "get_likelihood", "nll_log_likelihood",
           "DiagonalGaussianPrior", "IsotropicGaussianPrior", "PerSegmentGaussianPrior"]
