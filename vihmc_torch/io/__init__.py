"""Run artifacts (counterpart of ``vihmc_tpu.io``)."""

from vihmc_torch.io.artifacts import RunStore, make_uid

__all__ = ["RunStore", "make_uid"]
