"""The three stages' pipelines and their plumbing (counterpart of ``vihmc_tpu.pipelines``)."""

from vihmc_torch.pipelines import configs
from vihmc_torch.pipelines.common import (deeponet_vi_apply, fno_vi_apply,
                                          make_flat_deeponet, make_flat_mlp,
                                          make_log_posterior, mlp_vi_apply)
from vihmc_torch.pipelines.predict import posterior_predictive, predictive_metrics

__all__ = ["configs", "make_flat_mlp", "make_flat_deeponet", "make_log_posterior",
           "mlp_vi_apply", "deeponet_vi_apply", "posterior_predictive", "predictive_metrics",
           "fno_vi_apply"]
