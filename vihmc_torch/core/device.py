"""Device policy of the entry points: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises when a CUDA device is asked for (the default of every entry point)
    and none is present: a measurement or a sampler run never falls back to
    the CPU silently. Tests pass ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vihmc_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    return dev
