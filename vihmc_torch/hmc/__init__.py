"""HMC sampler pieces of the operator row (counterpart of ``vihmc_tpu.hmc``)."""

from vihmc_torch.hmc.adaptation import DualAveragingState, da_init, da_update
from vihmc_torch.hmc.integrators import leapfrog_grad_only
from vihmc_torch.hmc.kernel import (HMCConfig, HMCState, TransitionNoise,
                                    clipped_grad_fn, draw_noise, init_state,
                                    make_kernel)
from vihmc_torch.hmc.metric import (LowRankMetric, lanczos_eigs,
                                    lowrank_from_eigs, make_lowrank_metric,
                                    mass_kinetic_energy, mass_sample_momentum,
                                    mass_velocity, preconditioned_hvp)
from vihmc_torch.hmc.subspace import (FrozenPolicy, SubspaceSpec,
                                      make_subspace_grad,
                                      make_subspace_log_prob)

__all__ = [
    "DualAveragingState", "da_init", "da_update", "leapfrog_grad_only",
    "HMCConfig", "HMCState", "TransitionNoise", "clipped_grad_fn",
    "draw_noise", "init_state", "make_kernel", "LowRankMetric",
    "lanczos_eigs", "lowrank_from_eigs", "make_lowrank_metric",
    "mass_kinetic_energy", "mass_sample_momentum", "mass_velocity",
    "preconditioned_hvp", "FrozenPolicy", "SubspaceSpec",
    "make_subspace_grad", "make_subspace_log_prob",
]
