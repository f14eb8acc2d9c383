"""Sensitivity analysis: rank parameters by squared output-Jacobian x VI variance.

Counterpart of ``vihmc_tpu/sensitivity/scores.py`` (:30-83). The score of
parameter i is ``S_i = E_x[(dy/dw_i)^2] sigma_i^2``, the expectation over
inputs and output coordinates at the VI mean; the HMC subspace is the
smallest top-scoring set whose cumulative share of the total stays within a
threshold (default 0.90).

The Jacobian is taken with ``torch.func.jacrev`` with respect to the flat
parameter vector, ``vmap``-ed over chunks of ``chunk_size`` examples so that
only one ``(chunk, *out, D)`` block lives at a time, in IEEE float32
(:func:`~vihmc_torch.core.precision.true_f32`). The cut itself
(:func:`captured_variance_count`, :func:`select_sensitive_indices`) is the
JAX package's numpy code verbatim, on float32 scores: a float64 cumsum, a
``torch.sort`` or another ``argsort`` kind can move it.

Where the ``(outputs x D)`` block does not fit (the FNO2d's is 10,201 x
2,368,001 per function), ``probes=n`` estimates the same mean from
Rademacher probes: ``E_v[(v^T J)^2] = sum_o J_o^2`` for ``v`` of +-1 over the
outputs, so ``n`` seeded probes per example, each one VJP, average to the
mean squared Jacobian. The examples run as rows of ``apply_rows(flat (E, D),
inputs) -> (E, *out)`` (row ``e`` the forward of copy ``e`` of the vector on
example ``e``; default ``vmap`` of ``apply_one``): ``chunk_size`` examples at
a time, each repeated once per probe, so that one forward and one backward
give every probe's VJP of the chunk (``probes x chunk_size`` rows; the chunk
bounds the memory). ``probes=0`` is the
exact ``jacrev`` path above, unchanged. Span ``vihmc.sensitivity`` (the probe
estimator); counter ``sensitivity.probes`` (probes x examples, one VJP each
row).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jacrev, vmap

from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.profiling import count, span
from vihmc_torch.models.bayesian import softplus_sigma


def _take(inputs, lo: int, hi: int):
    if isinstance(inputs, dict):
        return {k: v[lo:hi] for k, v in inputs.items()}
    return inputs[lo:hi]


def _batch_size(inputs) -> int:
    if isinstance(inputs, dict):
        return int(next(iter(inputs.values())).shape[0])
    return int(inputs.shape[0])


def mean_squared_jacobian(apply_one: Callable, flat_params: torch.Tensor, inputs,
                          chunk_size: int = 0, probes: int = 0, seed: int = 0,
                          apply_rows: Optional[Callable] = None) -> torch.Tensor:
    """``(D,)``: the mean over examples and output coordinates of
    ``(d output / d flat_params)^2``.

    ``apply_one(flat (D,), one_input) -> outputs`` is the forward of ONE
    example; ``inputs`` is a tensor or a dict of tensors with a leading
    example axis. ``chunk_size > 0`` streams the examples in chunks of that
    size (0: all at once). ``probes > 0``: the Rademacher estimate of ``probes``
    probes per example drawn from a generator seeded with ``seed``, the rows
    run by ``apply_rows`` (module doc).
    """
    if probes:
        return _probe_mean_squared_jacobian(apply_one, flat_params, inputs, chunk_size,
                                            probes, seed, apply_rows)
    flat = flat_params.detach()

    def one_example(x):
        jac = jacrev(lambda p: apply_one(p, x))(flat)       # (*out, D)
        return jac.reshape(-1, jac.shape[-1]).pow(2).mean(0)

    n = _batch_size(inputs)
    step = chunk_size if chunk_size and chunk_size > 0 else n
    per_example = []
    with true_f32():
        for lo in range(0, n, step):
            per_example.append(vmap(one_example)(_take(inputs, lo, min(lo + step, n))))
    return torch.cat(per_example).mean(0)


def _probe_mean_squared_jacobian(apply_one, flat_params, inputs, chunk_size, probes, seed,
                                 apply_rows):
    flat = flat_params.detach()
    dev = flat.device
    if apply_rows is None:
        apply_rows = vmap(apply_one)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = _batch_size(inputs)
    step = chunk_size if chunk_size and chunk_size > 0 else n
    acc = torch.zeros_like(flat)
    n_out = None
    with span("vihmc.sensitivity", dev), true_f32():
        for lo in range(0, n, step):
            rows = _take(inputs, lo, min(lo + step, n))
            e = _batch_size(rows)
            # every probe of every example a row: one forward, one backward
            rep = _repeat(rows, probes)
            with torch.enable_grad():
                leaf = flat.expand(probes * e, -1).clone().requires_grad_(True)
                out = apply_rows(leaf, rep)
                n_out = out[0].numel()
                v = torch.randint(0, 2, out.shape, generator=gen, device=dev,
                                  dtype=out.dtype).mul_(2).sub_(1)
                (g,) = torch.autograd.grad(out, leaf, grad_outputs=v)
            acc += (g * g).sum(0)
            del g, out, leaf
            count("sensitivity.probes", probes * e)
    return acc / (n * n_out * probes)


def _repeat(inputs, k: int):
    """The examples ``k`` times over, probe-major."""
    if isinstance(inputs, dict):
        return {key: v.repeat(k, *([1] * (v.dim() - 1))) for key, v in inputs.items()}
    return inputs.repeat(k, *([1] * (inputs.dim() - 1)))


def sensitivity_scores(apply_one: Callable, flat_mu: torch.Tensor, flat_sigma: torch.Tensor,
                       inputs, chunk_size: int = 0, probes: int = 0, seed: int = 0,
                       apply_rows: Optional[Callable] = None) -> torch.Tensor:
    """``S = E[(dy/dw)^2] sigma^2`` at the VI posterior mean (exact, or with
    ``probes`` Rademacher probes per example: :func:`mean_squared_jacobian`)."""
    return mean_squared_jacobian(apply_one, flat_mu, inputs, chunk_size, probes, seed,
                                 apply_rows) * flat_sigma ** 2


def captured_variance_count(scores, threshold: float = 0.90) -> int:
    """Number of top parameters whose cumulative score ratio stays <= threshold
    (reference ``captured_var``, sensitivity.py:205-236)."""
    s = np.sort(np.asarray(scores))[::-1]
    ratio = np.cumsum(s) / s.sum()
    return int(np.sum(ratio <= threshold))


def select_sensitive_indices(scores, threshold: float = 0.90) -> np.ndarray:
    """Sorted indices of the minimal top-score set capturing ``threshold`` of
    total sensitivity (reference: ``np.sort(np.argsort(-imp)[:num])``,
    sensitivity.py:278-281)."""
    num = captured_variance_count(scores, threshold)
    order = np.argsort(-np.asarray(scores))
    return np.sort(order[:num])


def flatten_mean_std(vp: dict):
    """Flat ``(mu, sigma)`` of the variational parameters ``{'mu', 'rho'}``
    (already flat in the port)."""
    return vp["mu"].detach(), softplus_sigma(vp["rho"].detach())
