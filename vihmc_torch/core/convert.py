"""Carry the JAX package's numpy arrays into the port's tensors.

The tests use these to put both sides on identical inputs: a flat parameter
vector, a parameter or variational tree, a low-rank metric, a sampler state
(HMC and NUTS: ``HMCState`` with its Welford moments, carried metric and
momentum; ChEES: ``ChEESState``), so a test can start the port from the
state JAX is in.
They take numpy arrays (what ``np.asarray`` of a JAX array gives) and never
import JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from vihmc_torch.hmc.adaptation import DualAveragingState
from vihmc_torch.hmc.chees import ChEESState
from vihmc_torch.hmc.kernel import HMCState, WelfordState
from vihmc_torch.hmc.metric import LowRankMetric
from vihmc_torch.models.deeponet import DeepONetConfig, unravel_deeponet


def _t(x, device="cpu", dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def flat_from_tree(tree) -> np.ndarray:
    """The ``ravel_pytree`` flat vector of a JAX parameter tree given as numpy
    arrays: dict keys in sorted order, lists and tuples in order, each leaf
    raveled row-major (so a linear layer's ``b`` comes before its ``w``)."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            leaves.append(np.asarray(node, dtype=np.float32).ravel())

    walk(tree)
    return np.concatenate(leaves) if leaves else np.zeros(0, np.float32)


def params_from_tree(tree, device="cpu") -> torch.Tensor:
    """A JAX MLP or DeepONet parameter tree as the port's flat ``(D,)`` tensor."""
    return _t(flat_from_tree(tree), device)


def vp_from_jax(vp, device="cpu") -> dict:
    """A JAX variational tree ``{'mu': tree, 'rho': tree}`` as the port's flat
    ``{'mu': (D,), 'rho': (D,)}``."""
    return {k: params_from_tree(vp[k], device) for k in ("mu", "rho")}


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
                   h_bar, mu, t, device="cpu", welford=None, inv_mass=None,
                   momentum=None, iteration: int = 0) -> HMCState:
    """An :class:`HMCState` (the HMC and the NUTS kernel's) from a JAX
    chain-batched state's arrays.

    ``position``/``grad`` (C, d), ``log_prob`` and the dual-averaging fields
    (C,) or scalars (broadcast over chains), ``aux`` the frozen full vector
    (D,), or the JAX per-chain copy (C, D): one shared vector when the chains
    agree, else each chain's (as REFRESH leaves it). ``welford``: the JAX
    ``WelfordState``'s ``(mean, m2, count)`` (:func:`welford_from_jax`);
    ``inv_mass`` the carried (C, d) metric, ``momentum`` the carried (C, d)
    momentum; ``iteration`` the global index of the next draw.
    """
    pos = _t(position, device)
    c = pos.shape[0]

    def per_chain(x):
        return _t(x, device).expand(c).clone()

    aux_t = None if aux is None else _t(aux, device)
    if aux_t is not None and aux_t.ndim == 2 and bool((aux_t == aux_t[:1]).all()):
        aux_t = aux_t[0].clone()
    da = DualAveragingState(log_step=per_chain(log_step),
                            log_step_avg=per_chain(log_step_avg),
                            h_bar=per_chain(h_bar), mu=per_chain(mu),
                            t=per_chain(t))
    return HMCState(position=pos, log_prob=per_chain(log_prob),
                    grad=_t(grad, device), da=da, aux=aux_t, iteration=iteration,
                    welford=None if welford is None else welford_from_jax(*welford,
                                                                          device=device),
                    inv_mass=None if inv_mass is None else _t(inv_mass, device),
                    momentum=None if momentum is None else _t(momentum, device))


def welford_from_jax(mean, m2, count, device="cpu") -> WelfordState:
    """A :class:`WelfordState` from a JAX chain-batched one's arrays: ``mean``
    and ``m2`` (C, d), ``count`` (C,) or a scalar (the same for every chain)."""
    count = np.asarray(count, np.float32).ravel()
    if not (count == count[0]).all():
        raise ValueError("the chains' Welford counts differ")
    return WelfordState(mean=_t(mean, device), m2=_t(m2, device),
                        count=torch.tensor(float(count[0]), dtype=torch.float32,
                                           device=device))


def chees_state_from_jax(positions, log_probs, grads, log_step, log_step_avg, h_bar, mu,
                         t, log_T, adam_m, adam_v, adam_t, aux=None, iteration: int = 0,
                         device="cpu") -> ChEESState:
    """A :class:`~vihmc_torch.hmc.chees.ChEESState` from a JAX ``ChEESState``'s
    arrays (scalar dual averaging and Adam state; ``aux`` as in
    :func:`state_from_jax`)."""
    aux_t = None if aux is None else _t(aux, device)
    if aux_t is not None and aux_t.ndim == 2 and bool((aux_t == aux_t[:1]).all()):
        aux_t = aux_t[0].clone()
    da = DualAveragingState(log_step=_t(log_step, device), log_step_avg=_t(log_step_avg, device),
                            h_bar=_t(h_bar, device), mu=_t(mu, device), t=_t(t, device))
    return ChEESState(position=_t(positions, device), log_prob=_t(log_probs, device),
                      grad=_t(grads, device), da=da, log_T=_t(log_T, device),
                      adam_m=_t(adam_m, device), adam_v=_t(adam_v, device),
                      adam_t=_t(adam_t, device), aux=aux_t, iteration=iteration)
