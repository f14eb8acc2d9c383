"""Chain samplers, the process mesh and diagnostics (counterpart of ``vihmc_tpu.chains``)."""

from vihmc_torch.chains.diagnostics import (effective_sample_size,
                                            effective_sample_size_np, ess_bulk_np,
                                            ess_tail_np, potential_scale_reduction,
                                            potential_scale_reduction_np, rhat_rank_np,
                                            summarize, summarize_np)
from vihmc_torch.chains.distributed import (chains_per_host, global_chain_mesh,
                                            initialize_distributed)
from vihmc_torch.chains.parallel import (ChainSampler, gather_chains, make_chain_mesh,
                                         sample_chains, sample_chains_chees,
                                         sample_chains_nuts, shard_batch, shard_query)
from vihmc_torch.chains.resume import SampleResult, sample_chains_resumable
from vihmc_torch.core.mesh import data_parallel_grad, data_parallel_ll

__all__ = ["effective_sample_size", "potential_scale_reduction", "summarize",
           "effective_sample_size_np", "ess_bulk_np", "ess_tail_np",
           "potential_scale_reduction_np", "rhat_rank_np", "summarize_np",
           "ChainSampler", "sample_chains", "sample_chains_chees", "sample_chains_nuts",
           "SampleResult", "sample_chains_resumable", "make_chain_mesh", "shard_batch",
           "shard_query", "gather_chains", "initialize_distributed", "global_chain_mesh",
           "chains_per_host", "data_parallel_ll",
           "data_parallel_grad"]
