"""Chain drivers and diagnostics (counterpart of ``vihmc_tpu.chains``)."""

from vihmc_torch.chains.diagnostics import (effective_sample_size_np,
                                            ess_bulk_np, ess_tail_np,
                                            rhat_rank_np, summarize_np)
from vihmc_torch.chains.resume import SampleResult, sample_chains_resumable

__all__ = ["effective_sample_size_np", "ess_bulk_np", "ess_tail_np",
           "rhat_rank_np", "summarize_np",
           "SampleResult", "sample_chains_resumable"]
