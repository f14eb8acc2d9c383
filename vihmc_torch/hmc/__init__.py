"""HMC sampler pieces (counterpart of ``vihmc_tpu.hmc``)."""

from vihmc_torch.hmc.adaptation import (DualAveragingState, da_init, da_restart, da_update,
                                        find_reasonable_step_size)
from vihmc_torch.hmc.chees import ChEESConfig, chees_sample
from vihmc_torch.hmc.integrators import leapfrog, leapfrog_grad_only, split_leapfrog
from vihmc_torch.hmc.kernel import (HMCConfig, HMCState, SampleResult, TransitionNoise,
                                    WelfordState, clipped_grad_fn, draw_noise,
                                    gaussian_field_grad, init_state, make_kernel,
                                    mass_window_schedule, pooled_variance, sample,
                                    value_and_grad, windowed_metric_update)
from vihmc_torch.hmc.metric import (EigenMetric, LowRankMetric, as_inv_mass,
                                    eigen_metric_from_eigs, estimate_lowrank_metric,
                                    hutchinson_diag, lanczos_eigs, lowrank_from_eigs,
                                    make_lowrank_metric, mass_diag_inv, mass_kinetic_energy,
                                    mass_sample_momentum, mass_velocity,
                                    preconditioned_hvp)
from vihmc_torch.hmc.nuts import NUTSConfig, nuts_sample
from vihmc_torch.hmc.subspace import (FrozenPolicy, SubspaceSpec, draw_full,
                                      make_aux_refresh, make_subspace_grad,
                                      make_subspace_log_prob)


def sample_model(*args, **kwargs):
    """``hmc.api.sample_model`` (imported on call: the API imports the pipelines)."""
    from vihmc_torch.hmc.api import sample_model as _sm

    return _sm(*args, **kwargs)


def predict_model(*args, **kwargs):
    """``hmc.api.predict_model`` (imported on call, as :func:`sample_model`)."""
    from vihmc_torch.hmc.api import predict_model as _pm

    return _pm(*args, **kwargs)


__all__ = [
    "DualAveragingState", "da_init", "da_restart", "da_update", "find_reasonable_step_size",
    "ChEESConfig", "chees_sample", "leapfrog", "leapfrog_grad_only", "split_leapfrog",
    "HMCConfig", "HMCState", "SampleResult", "TransitionNoise", "WelfordState",
    "clipped_grad_fn", "draw_noise", "gaussian_field_grad", "init_state", "make_kernel",
    "mass_window_schedule", "pooled_variance", "sample", "value_and_grad",
    "windowed_metric_update", "EigenMetric", "LowRankMetric", "as_inv_mass",
    "eigen_metric_from_eigs", "estimate_lowrank_metric", "hutchinson_diag", "lanczos_eigs",
    "lowrank_from_eigs", "make_lowrank_metric", "mass_diag_inv", "mass_kinetic_energy",
    "mass_sample_momentum", "mass_velocity", "preconditioned_hvp", "NUTSConfig",
    "nuts_sample", "FrozenPolicy", "SubspaceSpec", "draw_full", "make_aux_refresh",
    "make_subspace_grad", "make_subspace_log_prob", "sample_model", "predict_model",
]
