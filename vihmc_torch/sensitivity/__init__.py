"""Sensitivity scores and the subspace cut (counterpart of ``vihmc_tpu.sensitivity``)."""

from vihmc_torch.sensitivity.scores import (captured_variance_count, flatten_mean_std,
                                            mean_squared_jacobian,
                                            select_sensitive_indices, sensitivity_scores)

__all__ = ["captured_variance_count", "flatten_mean_std", "mean_squared_jacobian",
           "select_sensitive_indices", "sensitivity_scores"]
