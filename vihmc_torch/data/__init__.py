"""Burgers, Cone and synthetic regression data (counterpart of ``vihmc_tpu.data``)."""

from vihmc_torch.data.burgers import (burgers_dataset, generate_burgers_dataset,
                                      get_burgers, get_burgers_train, load_burgers_mat,
                                      load_port_inputs, load_stage12_artifacts,
                                      solve_burgers, split_shards, subsample_trunk)
from vihmc_torch.data.cone import (CONE_STATS, ConeStats, cone_to_operator_splits,
                                   generate_cone_dataset, get_cone, load_cone,
                                   normalize_cone, normalize_cone_inputs)
from vihmc_torch.data.synthetic import load_reference_regression_data, regression_data

__all__ = ["burgers_dataset", "generate_burgers_dataset", "get_burgers",
           "get_burgers_train", "load_burgers_mat",
           "load_port_inputs", "load_stage12_artifacts", "solve_burgers",
           "split_shards", "subsample_trunk", "regression_data",
           "load_reference_regression_data", "CONE_STATS", "ConeStats",
           "cone_to_operator_splits", "generate_cone_dataset", "get_cone", "load_cone",
           "normalize_cone", "normalize_cone_inputs"]
