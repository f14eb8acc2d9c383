"""Segmented multi-chain sampling with thinning on the device, checkpointed
and resumable.

Counterpart of ``sample_chains_resumable`` in ``vihmc_tpu/chains/resume.py``
(:63-176): ``config.num_samples`` draws run in segments of ``segment_size``,
with the transition paths of
:func:`vihmc_torch.hmc.kernel.make_kernel` (paired or unpaired MH test,
fixed or adapted step, gradient-only, autograd or split-Hamiltonian
trajectory, with or without an ``aux_refresh``); within a segment every draw
advances all chains with one call of the transition, the kept positions
(every ``thin``-th) stay on the device, and the segment's samples and
per-draw info arrays go to the host once, at its end. The state carries the
global draw index, the adaptive metric's accumulators and the carried
momentum, so the burn, switch and window boundaries and the momentum
persistence hold across segments. Each segment draws its random numbers from
a generator seeded with ``(seed, segment index)``, so a later resume can
replay a segment exactly. :func:`run_segments` is the loop itself, which the
NUTS and ChEES samplers share.

With ``checkpoint_dir`` the sampler state (``{"state": HMCState}``, through
:mod:`vihmc_torch.io.checkpoint`) and the segment's kept samples
(``samples_seg<seg:05d>.npy``, JAX's file names) are written after every
segment, the samples first, then the state, which marks the segment
complete; both are written before ``progress`` is called, so a ``progress``
that stops the run leaves that segment resumable (JAX calls it first). A
later call with the same directory starts after the latest complete
segment, and since the segments' generators depend only on ``(seed,
segment)`` the resumed run gives the uninterrupted run's samples bit for
bit. As in JAX, the per-draw info arrays then cover only the segments run in
this process. With ``config.store_aux_trace`` each draw's aux (the frozen
vectors, or ``{'frozen', 'tidx'}``) is kept, broadcast to every chain, as
``SampleResult.aux_trace`` ``(C, S, ...)`` (kernel.py:754-767).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from vihmc_torch.core.device import stream_generator
from vihmc_torch.io.checkpoint import latest_step, load_checkpoint, save_checkpoint
from vihmc_torch.hmc.kernel import (HMCConfig, SampleResult, draw_noise, init_state,
                                    jitter_l_range, make_kernel)

INFO_KEYS = ("accepted", "accept_prob", "step_size", "divergent", "log_prob")
#: the generator stream of the initial step search (segments are streams 0, 1, ...)
STEP_SEARCH_STREAM = 0x1517


def segment_generator(device, seed: int, segment: int) -> torch.Generator:
    return stream_generator(device, seed, segment)


def per_chain_aux(aux, n_chains: int):
    """``aux`` with every tensor given a leading chain axis: a shared ``(n,)``
    vector (or index set) is broadcast to ``(C, n)``; a dict is mapped."""
    if isinstance(aux, dict):
        return {k: per_chain_aux(v, n_chains) for k, v in aux.items()}
    return aux.expand(n_chains, -1) if aux.ndim == 1 else aux


def _stack_trace(trace):
    if isinstance(trace[0], dict):
        return {k: _stack_trace([t[k] for t in trace]) for k in trace[0]}
    return torch.stack(trace, dim=1).cpu().numpy()


def _concat_trace(parts):
    if isinstance(parts[0], dict):
        return {k: _concat_trace([p[k] for p in parts]) for k in parts[0]}
    return np.concatenate(parts, axis=1)


def run_segments(step: Callable, state, n_total: int, segment_size: int, thin: int,
                 seed: int, device, info_keys=INFO_KEYS, extra_keys=(),
                 progress: Optional[Callable] = None, start_segment: int = 0,
                 on_segment: Optional[Callable] = None, trace_aux: bool = False):
    """Advance ``state`` by the segments ``start_segment, ...,
    ceil(n_total / segment_size) - 1`` of ``segment_size`` draws,
    ``step(state, generator) -> (state, info)`` per draw with the segment's
    generator; keep every ``thin``-th position on the device and copy each
    segment's kept positions and info arrays to the host once. ``info[k]``
    is ``(C,)`` for ``info_keys`` and, for ``extra_keys``, any shape (a
    scalar per draw is kept as ``(S,)``). ``on_segment(seg, state,
    samples)`` runs after each segment, before ``progress(seg + 1,
    n_segments, state)``; with ``trace_aux`` every draw's ``state.aux`` is
    kept (:func:`per_chain_aux`) as ``infos['aux_trace']``. Returns
    ``(state, samples (C, kept, d), infos)`` of the segments run here."""
    if thin < 1 or segment_size % thin:
        raise ValueError("thin must divide segment_size")
    n_segments = -(-n_total // segment_size)
    keys = tuple(info_keys) + tuple(extra_keys)
    collected, infos, traces = [], {k: [] for k in keys}, []
    n_chains = state.position.shape[0]
    for seg in range(start_segment, n_segments):
        gen = segment_generator(device, seed, seg)
        kept, seg_info, seg_trace = [], {k: [] for k in keys}, []
        for i in range(segment_size):
            state, info = step(state, gen)
            if (i + 1) % thin == 0:
                kept.append(state.position)
            if trace_aux:
                seg_trace.append(per_chain_aux(state.aux, n_chains))
            for k in keys:
                seg_info[k].append(torch.as_tensor(info[k]))
        # thinned on the device; one host copy per segment
        collected.append(torch.stack(kept, dim=1).cpu().numpy())
        for k in keys:
            v = torch.stack(seg_info[k], dim=-1 if k in info_keys else 0)
            infos[k].append(v.cpu().numpy())
        if trace_aux:
            traces.append(_stack_trace(seg_trace))
        if on_segment is not None:
            on_segment(seg, state, collected[-1])
        if progress is not None:
            progress(seg + 1, n_segments, state)
    n_run = min(n_total, n_segments * segment_size) - start_segment * segment_size
    out = {k: (np.concatenate(infos[k], axis=1)[:, :n_run] if infos[k]
               else np.zeros((n_chains, 0))) for k in info_keys}
    out.update({k: np.concatenate(infos[k], axis=0)[:n_run] for k in extra_keys if infos[k]})
    samples = (np.concatenate(collected, axis=1)[:, :n_run // thin] if collected
               else np.zeros((n_chains, 0, state.position.shape[1]), np.float32))
    if trace_aux and traces:
        trace = _concat_trace(traces)
        out["aux_trace"] = ({k: v[:, :n_run] for k, v in trace.items()}
                            if isinstance(trace, dict) else trace[:, :n_run])
    return state, samples, out


def resolve_aux_draw(aux_refresh, aux_draw, aux, n_chains: int, device):
    """The refresh hook's draw: None without a hook, ``aux_draw`` when given,
    else the REFRESH policy's ``(C, D)`` standard normals."""
    if aux_refresh is None:
        return None
    if aux_draw is not None:
        return aux_draw
    aux_dim = aux.shape[-1]

    def default_draw(g):
        return torch.randn((n_chains, aux_dim), generator=g, device=device)

    return default_draw


def sample_chains_resumable(log_prob_fn: Callable, init_positions: torch.Tensor,
                            config: HMCConfig, segment_size: int, inv_mass,
                            aux: torch.Tensor, grad_fn: Optional[Callable] = None,
                            delta_fn: Optional[Callable] = None, thin: int = 1,
                            seed: int = 0,
                            progress: Optional[Callable] = None,
                            aux_refresh: Optional[Callable] = None,
                            aux_draw: Optional[Callable] = None,
                            shard_log_prob_fn: Optional[Callable] = None,
                            shard_data=None,
                            checkpoint_dir: Optional[str] = None) -> SampleResult:
    """Run ``config.num_samples`` draws of all chains (see module doc).

    ``grad_fn`` None: the trajectory differentiates ``log_prob_fn`` by
    autograd; ``delta_fn`` None: the unpaired MH test on ``log_prob_fn``.
    ``aux_refresh(z) -> aux``: redraw every chain's aux before each draw from
    ``aux_draw(generator)``, drawn after the transition's own draws (default:
    ``(C, D)`` standard normals, the REFRESH policy's). The splitting
    integrator takes ``shard_log_prob_fn`` and ``shard_data``
    (:func:`~vihmc_torch.hmc.kernel.make_kernel`). With ``init_step_search``
    the search's momentum normals come from the stream
    ``STEP_SEARCH_STREAM`` of ``seed``.

    ``checkpoint_dir``: save after every segment and resume from the latest
    complete one. ``progress(segment, n_segments, state)`` is called after
    each segment, once its samples are on the host (and saved).
    """
    n_chains, dim = init_positions.shape
    dev = init_positions.device
    kernel = make_kernel(config, inv_mass, grad_fn, delta_fn, log_prob_fn, aux_refresh,
                         shard_log_prob_fn, shard_data)
    step_noise = None
    if config.init_step_search:
        step_noise = torch.randn((n_chains, dim),
                                 generator=stream_generator(dev, seed, STEP_SEARCH_STREAM),
                                 device=dev)
    # the initial state is computed on a resume too (as in JAX), then replaced
    state = init_state(log_prob_fn, init_positions, config, aux, grad_fn, inv_mass=inv_mass,
                       step_noise=step_noise)
    start, loaded, on_segment = 0, [], None
    if checkpoint_dir is not None:
        done = latest_step(checkpoint_dir)
        if done is not None:
            state = load_checkpoint(checkpoint_dir, done, map_location=dev)["state"]
            loaded = [np.load(_segment_file(checkpoint_dir, seg)) for seg in range(done)]
            start = done

        def on_segment(seg, st, samples):
            os.makedirs(checkpoint_dir, exist_ok=True)
            np.save(_segment_file(checkpoint_dir, seg), samples)
            save_checkpoint(checkpoint_dir, seg + 1, {"state": st})

    aux_draw = resolve_aux_draw(aux_refresh, aux_draw, aux, n_chains, dev)
    n_steps_range = jitter_l_range(config)

    def step(st, gen):
        return kernel(st, draw_noise(gen, inv_mass, n_chains, dim, dev, aux_draw,
                                     n_steps_range))

    state, samples, out = run_segments(step, state, config.num_samples, segment_size, thin,
                                       seed, dev, progress=progress, start_segment=start,
                                       on_segment=on_segment,
                                       trace_aux=config.store_aux_trace)
    if loaded:
        samples = np.concatenate(loaded + [samples], axis=1)[:, :config.num_samples // thin]
    return SampleResult(
        samples=samples, log_probs=out["log_prob"], accept_probs=out["accept_prob"],
        accepted=out["accepted"], step_sizes=out["step_size"],
        divergent=out["divergent"], final_state=state, aux_trace=out.get("aux_trace"))


def _segment_file(directory: str, seg: int) -> str:
    return os.path.join(directory, f"samples_seg{seg:05d}.npy")
