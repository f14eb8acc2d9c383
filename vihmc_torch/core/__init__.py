"""Flat-vector layout, subspace scatter/gather, derivatives, seeds, precision
and device policy."""

from vihmc_torch.core.calculus import LogProbError, gradient, has_nan_or_inf, hessian, jacobian
from vihmc_torch.core.device import resolve_device
from vihmc_torch.core.precision import matmul_precision, true_f32
from vihmc_torch.core.prng import fold_in_str, split_like
from vihmc_torch.core.ravel import (gather_subspace, per_segment_vector, ravel_pytree,
                                    scatter_subspace, segment_sizes, segment_slices)

__all__ = ["resolve_device", "true_f32", "matmul_precision", "gather_subspace",
           "per_segment_vector", "scatter_subspace", "ravel_pytree", "segment_sizes",
           "segment_slices", "split_like", "fold_in_str", "LogProbError", "has_nan_or_inf",
           "gradient", "jacobian", "hessian"]
