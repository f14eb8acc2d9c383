"""Error metrics of posterior-predictive samples, multi-run helpers and plots.

Exact numpy copies of ``l2_relative_error``, ``error_report``,
``error_sigma_correlation`` and ``stack_runs`` of
``vihmc_tpu/pipelines/postprocess.py`` (:18-63, :105-115), which the stage-3
summary and multi-run post-processing read, and
``function_space_diagnostics`` (:65-102), the diagnostics battery on
posterior-predictive probe outputs, with the probe forward in torch.

The plots (:122-293): predictive spaghetti and uncertainty bands, training
curves, sensitivity histograms, per-layer sensitivity maps, the
captured-variance curve, error-vs-sigma panels and a solution animation.
They take numpy arrays (or host tensors) and import matplotlib only when
called, so nothing on a sampling path needs it.
``plot_sensitivity_layers`` takes a model config (its flat layout) or a
tree of arrays in place of JAX's params tree.
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


# ---------------------------------------------------------------------------
# Plots (matplotlib imported when a plot is drawn)
# ---------------------------------------------------------------------------

def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_predictions(x, preds, truth=None, train_xy=None, path: str = "prediction.pdf",
                     alpha: float = 0.05):
    """Posterior-predictive spaghetti plot of ``preds`` (S, ...) over ``x``."""
    plt = _plt()
    x, preds = _np(x), _np(preds)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(x, preds.reshape(preds.shape[0], -1).T, "C0", alpha=alpha)
    ax.plot(x, preds.mean(axis=0).ravel(), "k", linewidth=3, label="Mean prediction")
    if truth is not None:
        ax.plot(x, _np(truth).ravel(), "r", linewidth=2, label="True function")
    if train_xy is not None:
        ax.plot(_np(train_xy[0]), _np(train_xy[1]), ".C3", markersize=12, label="train",
                alpha=0.6)
    ax.set_xlabel("x")
    ax.set_ylabel("f(x)")
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_uq(x, mean, std, truth=None, path: str = "uq.pdf", k: float = 3.0):
    """Mean +- ``k`` sigma band."""
    plt = _plt()
    x, mean, std = _np(x).ravel(), _np(mean).ravel(), _np(std).ravel()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.fill_between(x, mean - k * std, mean + k * std, alpha=0.3, label=f"±{k:g}σ")
    ax.plot(x, mean, "k", label="mean")
    if truth is not None:
        ax.plot(x, _np(truth).ravel(), "r", label="truth")
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_metrics(metrics, path: str = "metrics.pdf"):
    """Loss and MSE curves of the VI metric rows (epochs, 4 or 5)."""
    plt = _plt()
    m = _np(metrics)
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].plot(m[:, 0], label="train loss")
    axes[0].plot(m[:, 1], label="valid loss")
    axes[0].set_yscale("symlog")
    axes[0].legend()
    axes[0].grid(True)
    axes[1].plot(m[:, 2], label="train mse")
    axes[1].plot(m[:, 3], label="valid mse")
    axes[1].set_yscale("log")
    axes[1].legend()
    axes[1].grid(True)
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_sensitivity_histogram(scores, path: str = "sensitivity_hist.pdf"):
    """Histogram of the positive scores' log10."""
    plt = _plt()
    s = _np(scores)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(np.log10(s[s > 0]), bins=60)
    ax.set_xlabel("log10 sensitivity")
    ax.set_ylabel("count")
    ax.grid(True)
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def layout_segments(layout) -> list:
    """``[(start, stop, shape), ...]`` of every parameter tensor in the flat
    vector: ``layout`` is an ``MLPConfig`` or ``DeepONetConfig`` (per layer
    the bias, then the ``(out, in)`` weight; the DeepONet's merge bias first)
    or a tree of arrays (``ravel_pytree`` order)."""
    from vihmc_torch.core.ravel import segment_slices, tree_leaves
    from vihmc_torch.models.deeponet import DeepONetConfig, param_slices
    from vihmc_torch.models.mlp import MLPConfig, mlp_slices

    if isinstance(layout, (MLPConfig, DeepONetConfig)):
        if isinstance(layout, MLPConfig):
            slices, segs = mlp_slices(layout)[0], []
        else:
            sl = param_slices(layout)
            slices, segs = sl["branch"] + sl["trunk"], [(0, 1, ())]
        for s_ in slices:
            if s_.w > s_.b:
                segs.append((s_.b, s_.w, (s_.d_out,)))
            segs.append((s_.w, s_.end, (s_.d_out, s_.d_in)))
        return segs
    return [(a, b, np.shape(leaf)) for (a, b), leaf in zip(segment_slices(layout),
                                                            tree_leaves(layout))]


def plot_sensitivity_layers(scores, layout, path_prefix: str = "sensitivity_layer"):
    """One log10 sensitivity map per parameter tensor of ``layout`` (see
    :func:`layout_segments`); returns the files written."""
    plt = _plt()
    scores = _np(scores)
    paths = []
    for i, (start, stop, shape) in enumerate(layout_segments(layout)):
        block = scores[start:stop].reshape(shape)
        if block.ndim < 2:
            block = block.reshape(1, -1)
        fig, ax = plt.subplots(figsize=(6, 4))
        im = ax.imshow(np.log10(np.maximum(block.reshape(block.shape[0], -1), 1e-30)),
                       aspect="auto", cmap="viridis")
        fig.colorbar(im, ax=ax, label="log10 sensitivity")
        out = f"{path_prefix}_{i}.pdf"
        fig.tight_layout()
        fig.savefig(out, dpi=150)
        plt.close(fig)
        paths.append(out)
    return paths


def plot_captured_variance(scores, path: str = "captured_variance.pdf"):
    """Cumulative captured-variance curve of the sorted scores."""
    plt = _plt()
    s = np.sort(_np(scores))[::-1]
    ratio = np.cumsum(s) / s.sum()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(np.arange(1, len(ratio) + 1), ratio, linewidth=2)
    ax.set_xlabel("No of parameters")
    ax.set_ylabel("Ratio of variance captured")
    ax.set_xscale("log")
    ax.grid(True)
    fig.tight_layout()
    fig.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_error_sigma_correlation(preds, truth, nt: int, nx: int,
                                 path_prefix: str = "correlation",
                                 scatter_times: tuple = (0.25, 0.5, 0.75, 1.0)):
    """Error-vs-sigma scatter panels at ``scatter_times`` and the per-time
    correlation curve (the numbers of :func:`error_sigma_correlation`)."""
    plt = _plt()
    stats = error_sigma_correlation(_np(preds), _np(truth), nt, nx)
    sigma, abs_err, corrs = stats["sigma"], stats["abs_error"], stats["per_time_correlation"]

    t_idx = [min(nt - 1, int(round(f * (nt - 1)))) for f in scatter_times]
    fig, axes = plt.subplots(1, len(t_idx), figsize=(4 * len(t_idx), 4), sharey=True)
    for ax, t in zip(np.atleast_1d(axes), t_idx):
        ax.plot(sigma[:, t, :].ravel(), abs_err[:, t, :].ravel(), ".", ms=2, alpha=0.3)
        ax.set_title(f"t = {t / max(nt - 1, 1):.2f}  (r = {corrs[t]:+.2f})")
        ax.set_xlabel("predictive σ")
        ax.grid(True)
    np.atleast_1d(axes)[0].set_ylabel("|error|")
    scatter_path = f"{path_prefix}_scatter.pdf"
    fig.tight_layout()
    fig.savefig(scatter_path, dpi=150)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(np.linspace(0, 1, nt), corrs, linewidth=2)
    ax.axhline(0.0, color="k", linewidth=0.8)
    ax.set_xlabel("t")
    ax.set_ylabel("corr(|error|, σ)")
    ax.grid(True)
    curve_path = f"{path_prefix}_curve.pdf"
    fig.tight_layout()
    fig.savefig(curve_path, dpi=200)
    plt.close(fig)
    return [scatter_path, curve_path]


def animate_solution(preds, truth, nt: int, nx: int, path: str = "solution.mp4",
                     fps: int = 10):
    """Mean +- 3 sigma against the truth over time; a GIF when no mp4 writer
    (ffmpeg) is present. Returns the file written."""
    plt = _plt()
    from matplotlib import animation

    preds = _np(preds).reshape(len(preds), nt, nx)
    truth = _np(truth).reshape(nt, nx)
    mean, std = preds.mean(axis=0), preds.std(axis=0)
    x = np.linspace(0, 1, nx)

    fig, ax = plt.subplots(figsize=(8, 5))
    (line_m,) = ax.plot(x, mean[0], "k", label="mean")
    (line_t,) = ax.plot(x, truth[0], "r--", label="truth")
    band = [ax.fill_between(x, mean[0] - 3 * std[0], mean[0] + 3 * std[0], alpha=0.3)]
    ax.set_ylim(float((mean - 3 * std).min()), float((mean + 3 * std).max()))
    ax.legend()
    ax.grid(True)

    def update(t):
        line_m.set_ydata(mean[t])
        line_t.set_ydata(truth[t])
        band[0].remove()
        band[0] = ax.fill_between(x, mean[t] - 3 * std[t], mean[t] + 3 * std[t],
                                  alpha=0.3, color="C0")
        ax.set_title(f"t = {t / (nt - 1):.2f}")
        return line_m, line_t

    anim = animation.FuncAnimation(fig, update, frames=nt, blit=False)
    try:
        anim.save(path, fps=fps)
    except Exception:
        path = path.rsplit(".", 1)[0] + ".gif"
        anim.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path
