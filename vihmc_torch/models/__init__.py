"""Chain-batched models (counterpart of ``vihmc_tpu.models``)."""

from vihmc_torch.models.bayesian import (BayesianFlat, VariationalParams, bayesian_deeponet_apply,
                                         bayesian_mlp_apply, bbb_conv2d_apply,
                                         bbb_linear_apply, init_variational, kl_divergence,
                                         kl_gaussian, lrt_conv2d_apply, lrt_linear_apply,
                                         mean_params, sample_params, softplus_sigma)
from vihmc_torch.models.deeponet import (DeepONetConfig, bc_embedding,
                                         deeponet_apply, deeponet_features,
                                         init_deeponet, unravel_deeponet)
from vihmc_torch.models.mlp import (MLPConfig, get_activation, init_mlp, mlp_apply,
                                   unravel_mlp)

__all__ = ["BayesianFlat", "VariationalParams", "bayesian_deeponet_apply",
           "bayesian_mlp_apply", "bbb_conv2d_apply", "bbb_linear_apply", "init_variational",
           "kl_divergence", "kl_gaussian", "lrt_conv2d_apply", "lrt_linear_apply",
           "mean_params", "sample_params", "softplus_sigma", "DeepONetConfig",
           "bc_embedding", "deeponet_apply", "deeponet_features", "init_deeponet",
           "unravel_deeponet", "MLPConfig", "get_activation", "init_mlp", "mlp_apply",
           "unravel_mlp"]
