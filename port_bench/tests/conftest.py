"""A small size of the cell, shared by the CPU tests of the harness."""

import pytest
import torch

SMALL = {
    "deeponet-row-top2048": (
        {"data": {"n_functions": 4, "grid_stride": 10}},
        {"chains": 2, "warm_start_steps": 3, "lanczos": {"rank": 4, "iters": 40},
         "window": {"segment": 3, "burn_segments": 1}}),
}

# A size at which the likelihood, not the subspace prior, carries most of
# the field (all 1000 functions on every other grid point; at SMALL's 4 x 121
# points the prior does, and a fault in the likelihood's part of the field
# changes next to nothing), with the chains warm-started into the bulk and a
# Lanczos metric that has converged.
FAULTS = {
    "deeponet-row-top2048": (
        {"data": {"n_functions": 1000, "grid_stride": 2}},
        {"chains": 2, "warm_start_steps": 200, "lanczos": {"rank": 4, "iters": 40},
         "window": {"segment": 9, "burn_segments": 4}}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    return torch.device("cuda:0")
