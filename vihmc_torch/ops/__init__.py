"""Merge reductions of the DeepONet likelihood (counterpart of ``vihmc_tpu.ops``).

``deeponet_merge.paired_sums`` is the hand-written CUDA kernel of this slice;
``gram_merge`` is plain matmul work.
"""

from vihmc_torch.ops.deeponet_merge import (fused_paired_delta,
                                            paired_delta_reference,
                                            paired_sums,
                                            paired_sums_reference)
from vihmc_torch.ops.gram_merge import (make_gram_grad_full,
                                        merge_nll_gram_cotangents)

__all__ = ["fused_paired_delta", "paired_delta_reference", "paired_sums",
           "paired_sums_reference", "make_gram_grad_full",
           "merge_nll_gram_cotangents"]
