"""Burgers and synthetic regression data (counterpart of ``vihmc_tpu.data``)."""

from vihmc_torch.data.burgers import (burgers_dataset, generate_burgers_dataset,
                                      get_burgers, get_burgers_train, load_burgers_mat,
                                      load_port_inputs, load_stage12_artifacts,
                                      solve_burgers, split_shards, subsample_trunk)
from vihmc_torch.data.synthetic import regression_data

__all__ = ["burgers_dataset", "generate_burgers_dataset", "get_burgers",
           "get_burgers_train", "load_burgers_mat",
           "load_port_inputs", "load_stage12_artifacts", "solve_burgers",
           "split_shards", "subsample_trunk", "regression_data"]
