"""Likelihoods and priors (counterpart of ``vihmc_tpu.dists``)."""

from vihmc_torch.dists.likelihoods import (LIKELIHOODS, gaussian_nll, get_likelihood,
                                           nll_log_likelihood)
from vihmc_torch.dists.priors import (DiagonalGaussianPrior, IsotropicGaussianPrior,
                                      PerSegmentGaussianPrior, diag_normal_logpdf_sum,
                                      normal_logpdf)

__all__ = ["LIKELIHOODS", "gaussian_nll", "get_likelihood", "nll_log_likelihood",
           "DiagonalGaussianPrior", "IsotropicGaussianPrior", "PerSegmentGaussianPrior",
           "normal_logpdf", "diag_normal_logpdf_sum"]
