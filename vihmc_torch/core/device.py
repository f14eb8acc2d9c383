"""Device policy of the entry points (the card unless the caller asks for
the CPU), the seeded generator streams of a run, and tensor placement."""

from __future__ import annotations

import numpy as np
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


def sync(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): wall-clock
    phases end here."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stream_generator(device, seed: int, stream: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed * 1_000_003 +
    stream``: the independent random streams of one run seed (a sampler's
    segment i is stream i; the pipelines use streams from 700,001 up)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + int(stream))
    return gen


def to_f32(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or an array (arrays are
    copied, so read-only numpy views are fine)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def split_to(split: dict, device) -> dict:
    """Every entry of a data split as a contiguous float32 tensor on ``device``."""
    return {k: to_f32(v, device).contiguous() for k, v in split.items()}
