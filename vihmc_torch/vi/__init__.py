"""VI training (counterpart of ``vihmc_tpu.vi``)."""

from vihmc_torch.vi.elbo import ELBOConfig, accuracy, elbo_loss, get_beta
from vihmc_torch.vi.train import (PlateauState, VIConfig, VIState, VITrainer, VITrainState,
                                  init_train_state, make_eval_fn, make_train_step,
                                  plateau_init, plateau_update, predictive_samples,
                                  run_epochs, train)

__all__ = ["ELBOConfig", "accuracy", "elbo_loss", "get_beta", "PlateauState", "VIConfig",
           "VIState", "VITrainer", "VITrainState", "init_train_state", "make_eval_fn",
           "make_train_step", "plateau_init", "plateau_update", "predictive_samples",
           "run_epochs", "train"]
