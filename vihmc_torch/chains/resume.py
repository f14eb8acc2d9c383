"""Segmented multi-chain sampling with thinning on the device.

Counterpart of ``sample_chains_resumable`` in ``vihmc_tpu/chains/resume.py``
(:63-176), without the checkpoint/resume half: ``config.num_samples`` draws
run in segments of ``segment_size``; within a segment every draw advances all
chains with one call of the transition, the kept positions (every
``thin``-th) stay on the device, and the segment's samples and per-draw info
arrays go to the host once, at its end. Each segment draws its random numbers
from a generator seeded with ``(seed, segment index)``, so a later resume can
replay a segment exactly. Resume from ``torch.save`` state is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from vihmc_torch.hmc.kernel import (HMCConfig, HMCState, draw_noise,
                                    init_state, make_kernel)

INFO_KEYS = ("accepted", "accept_prob", "step_size", "divergent", "log_prob")


@dataclasses.dataclass
class SampleResult:
    samples: np.ndarray        # (C, S // thin, d)
    log_probs: np.ndarray      # (C, S)
    accept_probs: np.ndarray   # (C, S)
    accepted: np.ndarray       # (C, S) bool
    step_sizes: np.ndarray     # (C, S)
    divergent: np.ndarray      # (C, S) bool
    final_state: HMCState

    @property
    def acceptance_rate(self) -> float:
        return float(np.mean(self.accepted))


def segment_generator(device, seed: int, segment: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + int(segment))
    return gen


def sample_chains_resumable(log_prob_fn: Callable, init_positions: torch.Tensor,
                            config: HMCConfig, segment_size: int, inv_mass,
                            aux: torch.Tensor, grad_fn: Callable,
                            delta_fn: Callable, thin: int = 1, seed: int = 0,
                            progress: Optional[Callable] = None) -> SampleResult:
    """Run ``config.num_samples`` draws of all chains (see module doc).

    ``progress(segment, n_segments, state)`` is called after each segment,
    once its samples are on the host.
    """
    n_chains, dim = init_positions.shape
    n_total = config.num_samples
    n_segments = -(-n_total // segment_size)
    if thin < 1 or segment_size % thin:
        raise ValueError("thin must divide segment_size")
    dev = init_positions.device
    kernel = make_kernel(config, inv_mass, grad_fn, delta_fn)
    state = init_state(log_prob_fn, init_positions, config, aux, grad_fn)

    collected = []
    infos = {k: [] for k in INFO_KEYS}
    for seg in range(n_segments):
        gen = segment_generator(dev, seed, seg)
        kept, seg_info = [], {k: [] for k in INFO_KEYS}
        for i in range(segment_size):
            state, info = kernel(state, draw_noise(gen, inv_mass, n_chains, dim, dev))
            if (i + 1) % thin == 0:
                kept.append(state.position)
            for k in INFO_KEYS:
                seg_info[k].append(info[k])
        # thinned on the device; one host copy per segment
        collected.append(torch.stack(kept, dim=1).cpu().numpy())
        for k in INFO_KEYS:
            infos[k].append(torch.stack(seg_info[k], dim=1).cpu().numpy())
        if progress is not None:
            progress(seg + 1, n_segments, state)

    out = {k: np.concatenate(v, axis=1)[:, :n_total] for k, v in infos.items()}
    return SampleResult(
        samples=np.concatenate(collected, axis=1)[:, :n_total // thin],
        log_probs=out["log_prob"], accept_probs=out["accept_prob"],
        accepted=out["accepted"], step_sizes=out["step_size"],
        divergent=out["divergent"], final_state=state)
