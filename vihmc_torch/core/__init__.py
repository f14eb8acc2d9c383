"""Flat-vector layout, subspace scatter/gather, precision and device policy."""

from vihmc_torch.core.device import resolve_device
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import gather_subspace, per_segment_vector, scatter_subspace

__all__ = ["resolve_device", "true_f32", "gather_subspace", "per_segment_vector",
           "scatter_subspace"]
