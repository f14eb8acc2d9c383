"""Carry the JAX package's numpy arrays into the port's tensors.

The tests use these to put both sides on identical inputs: a flat parameter
vector, a low-rank metric, a sampler state. They take numpy arrays (what
``np.asarray`` of a JAX array gives) and never import JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from vihmc_torch.hmc.adaptation import DualAveragingState
from vihmc_torch.hmc.kernel import HMCState
from vihmc_torch.hmc.metric import LowRankMetric
from vihmc_torch.models.deeponet import DeepONetConfig, unravel_deeponet


def _t(x, device="cpu", dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def params_from_flat(flat_np, cfg: DeepONetConfig, device="cpu") -> dict:
    """Per-layer ``(w, b)`` tensors (chain dim 1) of a JAX flat vector (D,) or
    flat batch (C, D), in ``ravel_pytree`` order."""
    flat = _t(flat_np, device)
    if flat.ndim == 1:
        flat = flat[None, :]
    return unravel_deeponet(cfg, flat.contiguous())


def metric_from_jax(diag_mass, u, chol_cap, device="cpu") -> LowRankMetric:
    """A :class:`LowRankMetric` from the fields of the JAX one (no refactoring)."""
    return LowRankMetric(diag_mass=_t(diag_mass, device), u=_t(u, device),
                         chol_cap=_t(chol_cap, device))


def state_from_jax(position, log_prob, grad, aux, log_step, log_step_avg,
                   h_bar, mu, t, device="cpu") -> HMCState:
    """An :class:`HMCState` from a JAX chain-batched state's arrays.

    ``position``/``grad`` (C, d), ``log_prob`` and the dual-averaging fields
    (C,) or scalars (broadcast over chains), ``aux`` the frozen full vector
    (D,) or the JAX per-chain copy (C, D), whose chains must agree.
    """
    pos = _t(position, device)
    c = pos.shape[0]

    def per_chain(x):
        return _t(x, device).expand(c).clone()

    aux_t = _t(aux, device)
    if aux_t.ndim == 2:
        if not bool((aux_t == aux_t[:1]).all()):
            raise ValueError("the port shares one frozen vector across chains")
        aux_t = aux_t[0].clone()
    da = DualAveragingState(log_step=per_chain(log_step),
                            log_step_avg=per_chain(log_step_avg),
                            h_bar=per_chain(h_bar), mu=per_chain(mu),
                            t=per_chain(t))
    return HMCState(position=pos, log_prob=per_chain(log_prob),
                    grad=_t(grad, device), da=da, aux=aux_t)
