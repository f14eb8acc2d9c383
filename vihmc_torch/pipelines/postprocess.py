"""Error metrics of posterior-predictive samples and multi-run helpers.

Exact numpy copies of ``l2_relative_error``, ``error_report``,
``error_sigma_correlation`` and ``stack_runs`` of
``vihmc_tpu/pipelines/postprocess.py`` (:18-63, :105-115), which the stage-3
summary and multi-run post-processing read, and
``function_space_diagnostics`` (:65-102), the diagnostics battery on
posterior-predictive probe outputs, with the probe forward in torch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vihmc_torch.chains.diagnostics import summarize_np
from vihmc_torch.core.device import resolve_device


def l2_relative_error(pred, truth, axis=-1):
    """``||pred - truth||_2 / ||truth||_2`` along ``axis``."""
    pred = np.asarray(pred)
    truth = np.asarray(truth)
    num = np.linalg.norm(pred - truth, axis=axis)
    den = np.linalg.norm(truth, axis=axis)
    return num / den


def error_report(preds, truth, log_probs=None) -> dict:
    """Mean relative-L2, MAP error, argmin/argmax examples.
    ``preds``: (S, N, P), ``truth``: (N, P)."""
    preds = np.asarray(preds)
    truth = np.asarray(truth)
    mean_pred = preds.mean(axis=0)
    rel = l2_relative_error(mean_pred, truth)        # (N,)
    out = {
        "mean_relative_l2": float(rel.mean()),
        "per_example_relative_l2": rel,
        "argmin_example": int(rel.argmin()),
        "argmax_example": int(rel.argmax()),
    }
    if log_probs is not None:
        map_idx = int(np.asarray(log_probs).argmax())
        out["map_relative_l2"] = float(l2_relative_error(preds[map_idx], truth).mean())
        out["map_sample_index"] = map_idx
    return out


def error_sigma_correlation(preds, truth, nt: int, nx: int) -> dict:
    """Per-time-slice correlation between |error| and predictive sigma.
    ``preds``: (S, N, nt*nx)."""
    preds = np.asarray(preds).reshape(len(preds), -1, nt, nx)
    truth = np.asarray(truth).reshape(-1, nt, nx)
    mean_pred = preds.mean(axis=0)
    sigma = preds.std(axis=0)
    abs_err = np.abs(mean_pred - truth)
    corrs = np.zeros(nt)
    for t in range(nt):
        e = abs_err[:, t, :].ravel()
        s = sigma[:, t, :].ravel()
        if e.std() > 0 and s.std() > 0:
            corrs[t] = float(np.corrcoef(e, s)[0, 1])
    return {"per_time_correlation": corrs, "mean_correlation": float(corrs.mean()),
            "sigma": sigma, "abs_error": abs_err}


def function_space_diagnostics(samples, predict_fn: Callable, thin: int = 1,
                               chunk: int = 256, device="cuda") -> dict:
    """The :func:`~vihmc_torch.chains.diagnostics.summarize_np` battery on
    posterior-predictive PROBE outputs instead of weight coordinates (probe
    outputs are invariant to the weight-space symmetries that make a
    network's weight posterior multimodal). ``samples`` (C, S, d);
    ``predict_fn(q (n, d) tensor) -> (n, P)`` maps draws to probe outputs
    and runs on ``device`` in chunks of ``chunk`` draws. Returns the summary
    of the (C, S // thin, P) traces plus the traces as ``probes``."""
    device = resolve_device(device)
    x = np.asarray(samples)[:, ::thin, :]
    c, s, d = x.shape
    flat = x.reshape(c * s, d)
    outs = []
    with torch.no_grad():
        for i in range(0, flat.shape[0], chunk):
            q = torch.as_tensor(flat[i:i + chunk], dtype=torch.float32, device=device)
            outs.append(predict_fn(q).reshape(q.shape[0], -1).cpu().numpy())
    probes = np.concatenate(outs, axis=0).reshape(c, s, -1)
    diag = summarize_np(probes)
    diag["probes"] = probes
    return diag


def stack_runs(stores, name: str = "hmc_params", burn: int = 0) -> np.ndarray:
    """Post-burn samples of several :class:`~vihmc_torch.io.artifacts.RunStore`
    runs stacked into one ``(N, D)`` array: a ``(S, D)`` array from its
    ``burn``-th row, a ``(C, S, D)`` one each chain from its ``burn``-th draw."""
    parts = []
    for store in stores:
        arr = np.asarray(store.load_array(name))
        if arr.ndim == 2:
            parts.append(arr[burn:])
        else:
            parts.append(arr[:, burn:].reshape(-1, arr.shape[-1]))
    return np.concatenate(parts, axis=0)
