"""MCMC diagnostics: pooled, bulk and tail ESS, R-hat.

The host-side functions are exact copies of the numpy functions of
``vihmc_tpu/chains/diagnostics.py`` (``effective_sample_size_np`` :74,
``_rank_normalize_np``, ``ess_bulk_np`` :141, ``ess_tail_np`` :151,
``rhat_rank_np`` :166, ``potential_scale_reduction_np`` :179 and
``summarize_np`` :207), so the port reads its chains with the same
estimators as the JAX package. ``potential_scale_reduction``,
``effective_sample_size`` and ``summarize`` (:16-73, :197-205) are their
on-device counterparts: torch on ``(C, S, D)`` tensors, on the tensors' own
device, with the FFT autocovariance of every dimension at once.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def potential_scale_reduction(samples: torch.Tensor) -> torch.Tensor:
    """Split-R-hat of ``(C, S, D)`` samples -> ``(D,)`` (2C half-chains)."""
    c, s, d = samples.shape
    half = s // 2
    x = torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)
    chain_means = x.mean(dim=1)
    b = half * chain_means.var(dim=0, unbiased=True)
    w = x.var(dim=1, unbiased=True).mean(dim=0)
    var_plus = (half - 1) / half * w + b / half
    return torch.sqrt(var_plus / w)


def effective_sample_size(samples: torch.Tensor) -> torch.Tensor:
    """Pooled cross-chain ESS with monotone initial-positive-sequence
    truncation (JAX's ``effective_sample_size``): ``(C, S, D)`` -> ``(D,)``."""
    c, s, d = samples.shape
    x = samples - samples.mean(dim=1, keepdim=True)
    f = torch.fft.rfft(x, 2 * s, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), 2 * s, dim=1)[:, :s].real / s   # (C, S, D)
    w = samples.var(dim=1, unbiased=True).mean(dim=0)                         # (D,)
    b_over_n = (samples.mean(dim=1).var(dim=0, unbiased=True) if c > 1
                else torch.zeros_like(w))
    var_plus = w * (s - 1) / s + b_over_n
    rho = 1.0 - (w - acov.mean(dim=0)) / var_plus                             # (S, D)
    n_pairs = s // 2
    pair = rho[:2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)
    pair_min = torch.cummin(pair, dim=0).values
    tau = -1.0 + 2.0 * torch.where(pair_min > 0, pair_min, torch.zeros_like(pair_min)).sum(0)
    tau = torch.clamp(tau, min=1.0 / math.log10(c * s + 10.0))
    return c * s / tau


def summarize(samples: torch.Tensor) -> dict:
    """``mean``, ``std``, split ``r_hat`` and ``ess`` of ``(C, S, D)`` samples."""
    return {"mean": samples.mean(dim=(0, 1)), "std": samples.std(dim=(0, 1), unbiased=False),
            "r_hat": potential_scale_reduction(samples),
            "ess": effective_sample_size(samples)}


def effective_sample_size_np(samples, return_tau: bool = False):
    """Pooled cross-chain ESS with monotone initial-positive-sequence
    truncation. ``samples`` (C, S, D) -> (D,).

    ``return_tau=True`` additionally returns ``(tau, tau_floor)`` so callers
    can detect where the sub-1 autocorrelation-time floor binds.
    """
    x = np.asarray(samples)
    c, s, d = x.shape
    # chunk the dim axis: the complex FFT intermediate is (C, S+1, chunk)
    chunk = 4096
    if d > chunk:
        parts = [effective_sample_size_np(x[:, :, i:i + chunk],
                                          return_tau=return_tau)
                 for i in range(0, d, chunk)]
        if return_tau:
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]), parts[0][2])
        return np.concatenate(parts)
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = 2 * s
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :s, :].real / s  # (C,S,D)
    chain_var = x.var(axis=1, ddof=1)                                    # (C,D)
    w = chain_var.mean(axis=0)
    b_over_n = x.mean(axis=1).var(axis=0, ddof=1) if c > 1 else np.zeros(d)
    var_plus = w * (s - 1) / s + b_over_n
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (w[None, :] - acov.mean(axis=0)) / var_plus[None, :]
    rho = np.where(np.isfinite(rho), rho, 0.0)  # constant dims -> tau floor
    n_pairs = s // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2, d).sum(axis=1)
    pair_min = np.minimum.accumulate(pair, axis=0)
    raw_tau = -1.0 + 2.0 * np.where(pair_min > 0, pair_min, 0.0).sum(axis=0)
    tau_floor = 1.0 / np.log10(c * s + 10.0)
    tau = np.maximum(raw_tau, tau_floor)
    ess = c * s / tau
    if return_tau:
        return ess, raw_tau, tau_floor
    return ess


def _rank_normalize_np(x):
    """Fractional ranks over ALL chains/draws through the normal quantile
    function (Vehtari et al. 2021 eq. 14). ``x``: (C, S, D) -> same shape."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    c, s, d = x.shape
    # average ranks for ties (a stable argsort would order ties by chain)
    ranks = rankdata(x.reshape(c * s, d), method="average", axis=0)
    z = ndtri((ranks - 0.375) / (c * s + 0.25))
    return z.reshape(c, s, d)


def ess_bulk_np(samples):
    """Rank-normalized bulk ESS (Vehtari et al. 2021)."""
    return effective_sample_size_np(_rank_normalize_np(np.asarray(samples)))


def ess_tail_np(samples, prob: float = 0.05):
    """Rank-normalized tail ESS: min over the ``prob`` and ``1-prob``
    quantile-indicator ESSs (Vehtari et al. 2021 section 4.3)."""
    x = np.asarray(samples)
    lo = x <= np.quantile(x, prob, axis=(0, 1), keepdims=True)
    hi = x <= np.quantile(x, 1.0 - prob, axis=(0, 1), keepdims=True)
    ess_lo = effective_sample_size_np(_rank_normalize_np(lo.astype(np.float64)))
    ess_hi = effective_sample_size_np(_rank_normalize_np(hi.astype(np.float64)))
    return np.minimum(ess_lo, ess_hi)


def rhat_rank_np(samples):
    """Rank-normalized split-R-hat, max of the bulk and folded variants."""
    x = np.asarray(samples)
    bulk = potential_scale_reduction_np(_rank_normalize_np(x))
    folded = np.abs(x - np.median(x, axis=(0, 1), keepdims=True))
    fold = potential_scale_reduction_np(_rank_normalize_np(folded))
    return np.maximum(bulk, fold)


def potential_scale_reduction_np(samples):
    """Split-R-hat, (C, S, D) -> (D,)."""
    x = np.asarray(samples)
    c, s, d = x.shape
    half = s // 2
    if half < 2:
        return np.full(d, np.nan)  # too few draws to split
    x = np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)
    chain_means = x.mean(axis=1)
    b = half * chain_means.var(axis=0, ddof=1)
    w = x.var(axis=1, ddof=1).mean(axis=0)
    var_plus = (half - 1) / half * w + b / half
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / w)  # NaN for constant dims, as in Stan


def summarize_np(samples, rank_normalized: bool = True,
                 rank_dims: int = 16384) -> dict:
    """Summary over (C, S, D) samples: mean, std, split-R-hat, pooled ESS
    and, with ``rank_normalized``, ``ess_bulk``, ``ess_tail``, ``r_hat_rank``
    (on a fixed random subset of ``rank_dims`` dims when D is larger) and
    ``tau_floor_frac``, the share of dims where the raw tau hit its floor."""
    x = np.asarray(samples)
    ess, raw_tau, tau_floor = effective_sample_size_np(x, return_tau=True)
    out = {
        "mean": x.mean(axis=(0, 1)),
        "std": x.std(axis=(0, 1)),
        "r_hat": potential_scale_reduction_np(x),
        "ess": ess,
    }
    if rank_normalized:
        xr = x
        if x.shape[2] > rank_dims:
            sub = np.random.default_rng(0).choice(x.shape[2], rank_dims,
                                                  replace=False)
            xr = x[:, :, np.sort(sub)]
            out["rank_dims_subsampled"] = int(rank_dims)
        out["ess_bulk"] = ess_bulk_np(xr)
        out["ess_tail"] = ess_tail_np(xr)
        out["r_hat_rank"] = rhat_rank_np(xr)
        out["tau_floor_frac"] = float(np.mean(raw_tau < tau_floor))
    return out
