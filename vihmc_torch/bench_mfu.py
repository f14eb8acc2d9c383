"""Model-FLOP utilization of the bench rows.

Counterpart of ``bench.py``'s ``_device_peak_flops``, ``_sampling_flops``
and ``_mfu_stats`` (:173-272). JAX reads the FLOPs of its sampler from XLA's
HLO cost analysis; the port has no compiler to ask, so it counts them from
the matmuls one transition issues (:func:`vihmc_torch.core.profiling.count_flops`:
torch's matmuls from their shapes, plus the products of the port's CUDA
kernels). One transition of all chains is run under the counter, from the
row's own initial positions, configuration, metric, field and MH test: the
L trajectory gradients (all L, also under step or length jitter, where the
kernel computes the masked steps and discards them), the MH density
evaluations and any refresh. The row's total is ``draws`` times that. Only
matmul FLOPs count (2 per multiply-add); XLA's analysis also counts the
elementwise work, so JAX's totals are larger for the same sampler.

The MFU is the achieved model FLOP/s over the row's wall against the card's
dense bf16 tensor-core peak, as JAX's against its chip's bf16 peak.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vihmc_torch.chains.resume import resolve_aux_draw
from vihmc_torch.core.profiling import count_flops
from vihmc_torch.hmc.kernel import (HMCConfig, draw_noise, init_state, jitter_l_range,
                                    make_kernel)

#: dense bf16 tensor-core peak FLOP/s by device name (``torch.cuda.get_device_name``
#: substring, lower case): the H100 SXM data sheet's, at its 700 W limit
PEAK_FLOPS = (("h100", 989e12),)


def device_peak_flops(device) -> tuple:
    """``(device name, dense bf16 peak FLOP/s or None)``."""
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for sub, peak in PEAK_FLOPS:
        if sub in kind.lower():
            return kind, peak
    return kind, None


def transition_flops(log_prob: Callable, config: HMCConfig, inits: torch.Tensor, inv_mass,
                     aux, grad_fn: Optional[Callable] = None,
                     delta_fn: Optional[Callable] = None,
                     aux_refresh: Optional[Callable] = None) -> int:
    """Matmul FLOPs of one transition of every chain of ``inits`` (C, d),
    with the REFRESH hook's draw when ``aux_refresh`` is given."""
    dev = inits.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_state(log_prob, inits, config, aux, grad_fn, inv_mass=inv_mass)
    kernel = make_kernel(config, inv_mass, grad_fn, delta_fn, log_prob,
                         aux_refresh=aux_refresh)
    aux_draw = resolve_aux_draw(aux_refresh, None, aux, inits.shape[0], dev)
    noise = draw_noise(gen, inv_mass, inits.shape[0], inits.shape[1], dev, aux_draw=aux_draw,
                       n_steps_range=jitter_l_range(config))
    flops, _ = count_flops(kernel, state, noise)
    return flops


def sampling_flops(log_prob: Callable, config: HMCConfig, inits: torch.Tensor, inv_mass,
                   aux, draws: int, grad_fn: Optional[Callable] = None,
                   delta_fn: Optional[Callable] = None,
                   aux_refresh: Optional[Callable] = None) -> float:
    """Model FLOPs of ``draws`` transitions of every chain (module doc)."""
    return float(draws) * transition_flops(log_prob, config, inits, inv_mass, aux,
                                           grad_fn, delta_fn, aux_refresh)


def mfu_stats(total_flops: float, wall_s: float, n_chains: int, n_samples: int,
              device) -> dict:
    """JAX's ``mfu`` block: achieved model FLOP/s over ``wall_s`` against the
    card's bf16 peak (``peak_tflops_bf16`` and ``mfu`` None off the card).
    ``achieved_tflops`` and ``mfu`` are not rounded (JAX rounds them to 4 and
    5 places, which makes the NN row's mfu, a few millionths, read 0)."""
    kind, peak = device_peak_flops(device)
    achieved = total_flops / wall_s
    return {
        "model_flops_total": total_flops,
        "flops_per_draw_per_chain": round(total_flops / (n_chains * n_samples)),
        "achieved_tflops": achieved / 1e12,
        "device_kind": kind,
        "peak_tflops_bf16": round(peak / 1e12, 1) if peak else None,
        "mfu": achieved / peak if peak else None,
    }
