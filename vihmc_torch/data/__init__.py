"""Burgers data (counterpart of ``vihmc_tpu.data.burgers``)."""

from vihmc_torch.data.burgers import (burgers_dataset, get_burgers_train,
                                      load_port_inputs, solve_burgers)

__all__ = ["burgers_dataset", "get_burgers_train", "load_port_inputs",
           "solve_burgers"]
