"""HMC sampler pieces (counterpart of ``vihmc_tpu.hmc``)."""

from vihmc_torch.hmc.adaptation import DualAveragingState, da_init, da_update
from vihmc_torch.hmc.integrators import leapfrog, leapfrog_grad_only, split_leapfrog
from vihmc_torch.hmc.kernel import (HMCConfig, HMCState, TransitionNoise,
                                    clipped_grad_fn, draw_noise, gaussian_field_grad,
                                    init_state, make_kernel, value_and_grad)
from vihmc_torch.hmc.metric import (LowRankMetric, estimate_lowrank_metric,
                                    lanczos_eigs, lowrank_from_eigs,
                                    make_lowrank_metric, mass_kinetic_energy,
                                    mass_sample_momentum, mass_velocity,
                                    preconditioned_hvp)
from vihmc_torch.hmc.subspace import (FrozenPolicy, SubspaceSpec, draw_full,
                                      make_aux_refresh, make_subspace_grad,
                                      make_subspace_log_prob)

__all__ = [
    "DualAveragingState", "da_init", "da_update", "leapfrog", "leapfrog_grad_only",
    "split_leapfrog", "HMCConfig", "HMCState", "TransitionNoise", "clipped_grad_fn",
    "draw_noise", "gaussian_field_grad", "init_state", "make_kernel", "value_and_grad",
    "LowRankMetric", "estimate_lowrank_metric", "lanczos_eigs", "lowrank_from_eigs",
    "make_lowrank_metric", "mass_kinetic_energy", "mass_sample_momentum", "mass_velocity",
    "preconditioned_hvp", "FrozenPolicy", "SubspaceSpec", "draw_full",
    "make_aux_refresh", "make_subspace_grad", "make_subspace_log_prob",
]
