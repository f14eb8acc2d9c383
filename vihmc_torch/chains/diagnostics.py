"""Host-side MCMC diagnostics (numpy): pooled ESS, bulk ESS, rank R-hat.

Exact copies of the numpy functions of ``vihmc_tpu/chains/diagnostics.py``
(``effective_sample_size_np`` :74, ``_rank_normalize_np``, ``ess_bulk_np``
:141, ``rhat_rank_np`` :166 and the ``potential_scale_reduction_np`` it
calls), so the port reads its chains with the same estimator as the JAX
package. They import neither JAX nor torch.
"""

from __future__ import annotations

import numpy as np


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
