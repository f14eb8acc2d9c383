"""Run artifacts and checkpoints (counterpart of ``vihmc_tpu.io``)."""

from vihmc_torch.io.artifacts import RunStore, make_uid
from vihmc_torch.io.checkpoint import latest_step, load_checkpoint, save_checkpoint

__all__ = ["RunStore", "make_uid", "save_checkpoint", "load_checkpoint", "latest_step"]
