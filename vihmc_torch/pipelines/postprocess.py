"""Error metrics of posterior-predictive samples (numpy).

Exact copies of ``l2_relative_error``, ``error_report`` and
``error_sigma_correlation`` of ``vihmc_tpu/pipelines/postprocess.py``
(:18-63), which the stage-3 summary reads. They import neither JAX nor torch.
"""

from __future__ import annotations

import numpy as np


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
