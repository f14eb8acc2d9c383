"""Posterior-predictive evaluation.

Counterpart of ``vihmc_tpu/pipelines/predict.py``. The JAX ``vmap``/``scan``
over samples becomes a loop over chunks of samples: ``log_prob_and_forward``
takes a chunk of sample rows (any tuple of tensors sharing a leading axis,
e.g. ``(rows, chain_ids)``) and returns ``(log_probs (S_c,), preds (S_c, ...))``
for the whole chunk at once.
"""

from __future__ import annotations

from typing import Callable

import torch


def _chunks(samples, chunk_size: int):
    parts = samples if isinstance(samples, (tuple, list)) else (samples,)
    n = parts[0].shape[0]
    step = chunk_size if chunk_size and chunk_size > 0 else n
    for i in range(0, n, step):
        chunk = tuple(t[i:i + step] for t in parts)
        yield chunk if isinstance(samples, (tuple, list)) else chunk[0]


def posterior_predictive(log_prob_and_forward: Callable, samples, chunk_size: int = 0):
    """``(log_probs (S,), preds (S, ...))`` for every sample row, ``chunk_size``
    rows per call (all at once when 0)."""
    lps, preds = [], []
    for chunk in _chunks(samples, chunk_size):
        lp, pred = log_prob_and_forward(chunk)
        lps.append(lp)
        preds.append(pred)
    return torch.cat(lps), torch.cat(preds)


def streaming_predictive_metrics(log_prob_and_forward: Callable, samples, y,
                                 chunk_size: int = 32) -> dict:
    """Predictive metrics without keeping all predictions: memory is one
    chunk of predictions plus their running sum. The sum adds one sample at a
    time, in sample order, as the JAX scan does. Returns the keys of
    :func:`predictive_metrics` (with ``expected_log_prob``) plus
    ``mean_prediction``."""
    sum_pred = torch.zeros_like(y)
    lps, mses = [], []
    n_s = 0
    for chunk in _chunks(samples, chunk_size):
        lp, pred = log_prob_and_forward(chunk)
        pred = pred.reshape(-1, *y.shape)
        for row in pred:
            sum_pred = sum_pred + row
        mses.append(((pred - y) ** 2).flatten(1).mean(-1))
        lps.append(lp)
        n_s += pred.shape[0]
    sample_mse = torch.cat(mses)
    mean_pred = sum_pred / n_s
    return {
        "sample_mse": sample_mse,
        "expected_mse_of_mean": ((mean_pred - y) ** 2).mean(),
        "mean_sample_mse": sample_mse.mean(),
        "final_mse": sample_mse[-1],
        "min_mse": sample_mse.min(),
        "expected_log_prob": torch.cat(lps).mean(),
        "mean_prediction": mean_pred,
    }


def predictive_metrics(preds, y, log_probs=None) -> dict:
    """Summary metrics over stacked predictions (S, ...) vs targets."""
    preds = preds.reshape(preds.shape[0], *y.shape)
    sample_mse = ((preds - y) ** 2).flatten(1).mean(-1)
    mean_pred = preds.mean(0)
    out = {
        "sample_mse": sample_mse,
        "expected_mse_of_mean": ((mean_pred - y) ** 2).mean(),
        "mean_sample_mse": sample_mse.mean(),
        "final_mse": sample_mse[-1],
        "min_mse": sample_mse.min(),
    }
    if log_probs is not None:
        out["expected_log_prob"] = log_probs.mean()
    return out
