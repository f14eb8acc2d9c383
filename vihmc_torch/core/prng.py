"""Seed derivations (counterpart of ``vihmc_tpu/core/prng.py``).

JAX threads ``jax.random`` keys; the port draws from ``torch.Generator``
streams of integer seeds (:func:`~vihmc_torch.core.device.stream_generator`:
stream ``s`` of seed ``k`` is seeded with ``k * 1_000_003 + s``). The two
helpers here derive such seeds: :func:`fold_in_str` a named one, through
``zlib.crc32`` (Python's ``hash`` of a string changes between processes),
offset by 2^32 so that a named seed never equals one of the numbered streams
the pipelines draw; :func:`split_like` one per leaf of a tree. No existing
path draws from them, so no stream of the port moves.
"""

from __future__ import annotations

import zlib

from vihmc_torch.core.ravel import map_leaves

#: the seed multiplier of core/device.stream_generator
SEED_STRIDE = 1_000_003
#: named seeds lie above the numbered streams (< 2^32)
NAMED_OFFSET = 2 ** 32


def fold_in_str(seed: int, name: str) -> int:
    """A seed derived from ``seed`` and ``name``, the same in every process."""
    return int(seed) * SEED_STRIDE + NAMED_OFFSET + zlib.crc32(name.encode())


def split_like(seed: int, tree):
    """A tree of ``tree``'s structure whose i-th leaf (``ravel_pytree``
    order) is ``fold_in_str(seed, f"split_like/{i}")``."""
    counter = iter(range(1 << 62))
    return map_leaves(lambda _: fold_in_str(seed, f"split_like/{next(counter)}"), tree)
