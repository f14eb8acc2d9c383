"""Phase timers, device traces, sampler throughput and model-FLOP counts.

Counterpart of ``vihmc_tpu/core/profiling.py`` (:17-90): :class:`Timer`,
:func:`device_trace` (``torch.profiler`` to a Chrome trace in place of
``jax.profiler``), :func:`sampler_throughput` and :class:`ProgressPrinter`.
:func:`count_flops` is the port's model-FLOP count of a computation: the
matmuls torch issues, each counted from its shapes
(``torch.utils.flop_counter``), plus the products of the port's CUDA
kernels that ran in it, which torch does not see (each kernel wrapper adds
its products' FLOPs to its ``flops`` counter where it launches).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable

import numpy as np
import torch


class Timer:
    """Phase wall-clock timer: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = None
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (the CPU, and the card when
    there is one) and write ``<log_dir>/trace.json``, a Chrome trace; yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sampler_throughput(result, elapsed_s: float, num_leapfrog: int, ess=None) -> dict:
    """Throughput counters of a :class:`~vihmc_torch.hmc.kernel.SampleResult`
    (and a precomputed ESS): draws and leapfrog gradients per second."""
    samples = np.asarray(result.samples)
    if samples.ndim == 2:
        samples = samples[None]
    c, s, _ = samples.shape
    out = {
        "chains": c,
        "draws_per_chain": s,
        "samples_per_s": c * s / elapsed_s,
        "leapfrog_grads_per_s": c * s * (num_leapfrog + 1) / elapsed_s,
        "acceptance_rate": float(np.asarray(result.acceptance_rate)),
        "divergences": int(np.asarray(result.num_divergent)),
        "elapsed_s": elapsed_s,
    }
    if ess is not None:
        out["ess_median"] = float(np.median(np.asarray(ess)))
        out["ess_per_s"] = out["ess_median"] / elapsed_s
    return out


class ProgressPrinter:
    """Segment-level progress line (draws done, draws/s, segment): the
    ``progress`` callback of ``sample_chains_resumable``."""

    def __init__(self, total_draws: int, every: int = 1, stream=None):
        self.total = total_draws
        self.every = every
        self.stream = stream or sys.stderr
        self.t0 = time.perf_counter()

    def __call__(self, seg_done: int, n_segments: int, state):
        if seg_done % self.every and seg_done != n_segments:
            return
        done = int(self.total * seg_done / n_segments)
        rate = done / max(time.perf_counter() - self.t0, 1e-9)
        self.stream.write(f"\r[sample] {done}/{self.total} draws  {rate:8.1f} draws/s  "
                          f"segment {seg_done}/{n_segments}")
        if seg_done == n_segments:
            self.stream.write("\n")
        self.stream.flush()


def _kernel_flops() -> int:
    from vihmc_torch.ops.deeponet_merge import merge_sums, paired_sums

    return paired_sums.flops + merge_sums.flops


def count_flops(fn: Callable, *args, **kwargs):
    """``(flops, fn's result)``: the matmul FLOPs of one call of ``fn``
    (2 per multiply-add, counted from the shapes of the matmuls torch
    issues) plus those of the port's kernels it launched."""
    from torch.utils.flop_counter import FlopCounterMode

    k0 = _kernel_flops()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return int(counter.get_total_flops()) + _kernel_flops() - k0, out
