"""What a configuration's ``systems/<config>.py`` hands the window."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class System:
    """The system under test of one cell, built by the program's own functions.

    ``log_prob``, ``grad_fn`` and ``delta_fn`` are the callables handed to
    ``sample_chains_resumable``; ``inits`` the (C, d) chains after the warm
    start; ``metric`` the kinetic metric; ``hmc_config`` the sampler's
    settings (its ``num_samples`` is replaced by the window); ``phases`` the
    set-up's host-clock spans (s); ``shapes`` the sizes the metrics read;
    ``reference_inputs`` the benchmark-made tensors and raw arrays that the
    reference gets, none of them made by the program."""

    log_prob: Callable
    grad_fn: Optional[Callable]
    delta_fn: Optional[Callable]
    aux0: Any
    inits: Any
    metric: Any
    hmc_config: Any
    phases: dict
    shapes: dict
    reference_inputs: dict
