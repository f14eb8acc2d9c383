"""Merge reductions of the DeepONet likelihood and the leapfrog update
(counterpart of ``vihmc_tpu.ops``).

The hand-written CUDA kernels: ``deeponet_merge.paired_sums`` and
``deeponet_merge.merge_sums`` (behind ``fused_merge_nll``),
``leapfrog.fused_leapfrog_update``, and ``field_stacks.FeatureStacks`` (the
bf16 Gram field's tanh stacks); the rest of ``gram_merge`` is matmul work.
"""

from vihmc_torch.ops.deeponet_merge import (fused_merge_nll,
                                            fused_paired_delta, merge_nll_reference,
                                            merge_sums, merge_sums_reference,
                                            paired_delta_reference,
                                            paired_sums,
                                            paired_sums_reference)
from vihmc_torch.ops.gram_merge import (grid_stride_subset, infer_grid_shape,
                                        make_gram_grad_full, merge_nll_gram_cotangents)
from vihmc_torch.ops.leapfrog import (fused_leapfrog_update,
                                      leapfrog_update_reference)

__all__ = ["fused_merge_nll", "fused_paired_delta", "merge_nll_reference",
           "merge_sums", "merge_sums_reference", "paired_delta_reference",
           "paired_sums", "paired_sums_reference", "grid_stride_subset",
           "infer_grid_shape", "make_gram_grad_full",
           "merge_nll_gram_cotangents", "fused_leapfrog_update",
           "leapfrog_update_reference"]
