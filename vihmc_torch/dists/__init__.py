"""Likelihood and prior (counterpart of ``vihmc_tpu.dists``)."""

from vihmc_torch.dists.likelihoods import gaussian_nll, nll_log_likelihood
from vihmc_torch.dists.priors import DiagonalGaussianPrior, IsotropicGaussianPrior

__all__ = ["gaussian_nll", "nll_log_likelihood", "DiagonalGaussianPrior",
           "IsotropicGaussianPrior"]
