"""Chain drivers and diagnostics (counterpart of ``vihmc_tpu.chains``)."""

from vihmc_torch.chains.diagnostics import (effective_sample_size,
                                            effective_sample_size_np, ess_bulk_np,
                                            ess_tail_np, potential_scale_reduction,
                                            potential_scale_reduction_np, rhat_rank_np,
                                            summarize, summarize_np)
from vihmc_torch.chains.parallel import (ChainSampler, sample_chains, sample_chains_chees,
                                         sample_chains_nuts)
from vihmc_torch.chains.resume import SampleResult, sample_chains_resumable

__all__ = ["effective_sample_size", "potential_scale_reduction", "summarize",
           "effective_sample_size_np", "ess_bulk_np", "ess_tail_np",
           "potential_scale_reduction_np", "rhat_rank_np", "summarize_np",
           "ChainSampler", "sample_chains", "sample_chains_chees", "sample_chains_nuts",
           "SampleResult", "sample_chains_resumable"]
