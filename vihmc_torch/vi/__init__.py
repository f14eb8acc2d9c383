"""VI training (counterpart of ``vihmc_tpu.vi``)."""

from vihmc_torch.vi.elbo import ELBOConfig, elbo_loss, get_beta
from vihmc_torch.vi.train import (PlateauState, VIConfig, VIState, VITrainer,
                                  plateau_init, plateau_update, predictive_samples,
                                  run_epochs)

__all__ = ["ELBOConfig", "elbo_loss", "get_beta", "PlateauState", "VIConfig", "VIState",
           "VITrainer", "plateau_init", "plateau_update", "predictive_samples", "run_epochs"]
