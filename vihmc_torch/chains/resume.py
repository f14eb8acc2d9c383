"""Segmented multi-chain sampling with thinning on the device.

Counterpart of ``sample_chains_resumable`` in ``vihmc_tpu/chains/resume.py``
(:63-176), without the checkpoint/resume half: ``config.num_samples`` draws
run in segments of ``segment_size``, with the transition paths of
:func:`vihmc_torch.hmc.kernel.make_kernel` (paired or unpaired MH test,
fixed or adapted step, gradient-only, autograd or split-Hamiltonian
trajectory, with or without an ``aux_refresh``); within a segment every draw
advances all chains with one call of the transition, the kept positions
(every ``thin``-th) stay on the device, and the segment's samples and
per-draw info arrays go to the host once, at its end. The state carries the
global draw index, so the burn boundary of dual averaging holds across
segments. Each segment draws its random numbers from a generator seeded with
``(seed, segment index)``, so a later resume can replay a segment exactly.
Resume from ``torch.save`` state is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from vihmc_torch.core.device import stream_generator
from vihmc_torch.hmc.kernel import (HMCConfig, HMCState, draw_noise, init_state,
                                    jitter_l_range, make_kernel)

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

    @property
    def num_divergent(self) -> int:
        return int(np.sum(self.divergent))


def segment_generator(device, seed: int, segment: int) -> torch.Generator:
    return stream_generator(device, seed, segment)


def sample_chains_resumable(log_prob_fn: Callable, init_positions: torch.Tensor,
                            config: HMCConfig, segment_size: int, inv_mass,
                            aux: torch.Tensor, grad_fn: Optional[Callable] = None,
                            delta_fn: Optional[Callable] = None, thin: int = 1,
                            seed: int = 0,
                            progress: Optional[Callable] = None,
                            aux_refresh: Optional[Callable] = None,
                            aux_draw: Optional[Callable] = None,
                            shard_log_prob_fn: Optional[Callable] = None,
                            shard_data=None) -> SampleResult:
    """Run ``config.num_samples`` draws of all chains (see module doc).

    ``grad_fn`` None: the trajectory differentiates ``log_prob_fn`` by
    autograd; ``delta_fn`` None: the unpaired MH test on ``log_prob_fn``.
    ``aux_refresh(z) -> aux``: redraw every chain's aux before each draw from
    ``aux_draw(generator)``, drawn after the transition's own draws (default:
    ``(C, D)`` standard normals, the REFRESH policy's). The splitting
    integrator takes ``shard_log_prob_fn`` and ``shard_data``
    (:func:`~vihmc_torch.hmc.kernel.make_kernel`).

    ``progress(segment, n_segments, state)`` is called after each segment,
    once its samples are on the host.
    """
    n_chains, dim = init_positions.shape
    n_total = config.num_samples
    n_segments = -(-n_total // segment_size)
    if thin < 1 or segment_size % thin:
        raise ValueError("thin must divide segment_size")
    dev = init_positions.device
    kernel = make_kernel(config, inv_mass, grad_fn, delta_fn, log_prob_fn, aux_refresh,
                         shard_log_prob_fn, shard_data)
    state = init_state(log_prob_fn, init_positions, config, aux, grad_fn)
    if aux_refresh is None:
        aux_draw = None
    elif aux_draw is None:
        aux_dim = aux.shape[-1]

        def aux_draw(g):
            return torch.randn((n_chains, aux_dim), generator=g, device=dev)
    n_steps_range = jitter_l_range(config)

    collected = []
    infos = {k: [] for k in INFO_KEYS}
    for seg in range(n_segments):
        gen = segment_generator(dev, seed, seg)
        kept, seg_info = [], {k: [] for k in INFO_KEYS}
        for i in range(segment_size):
            noise = draw_noise(gen, inv_mass, n_chains, dim, dev, aux_draw, n_steps_range)
            state, info = kernel(state, noise)
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
