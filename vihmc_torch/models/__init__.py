"""Chain-batched models (counterpart of ``vihmc_tpu.models``)."""

from vihmc_torch.models.deeponet import (DeepONetConfig, bc_embedding,
                                         deeponet_apply, deeponet_features,
                                         unravel_deeponet)

__all__ = ["DeepONetConfig", "bc_embedding", "deeponet_apply",
           "deeponet_features", "unravel_deeponet"]
