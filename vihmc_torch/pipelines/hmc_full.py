"""Full-parameter HMC for the regression MLP: the reference's baseline.

Counterpart of ``vihmc_tpu/pipelines/hmc_full.py`` (``build_log_posterior``,
``run``, ``reevaluate``; :31-112), itself the reference's
``Neural_network/HMC/main_regression_hmc.py``: per-tensor Gaussian priors of
precision ``tau``, the ``regression`` likelihood (``tau_out`` a precision),
plain HMC with the fixed step and the analytic trajectory length (L = 643 at
the config's defaults), all chains advanced together, then the
posterior-predictive metrics of the pooled post-burn draws on the validation
grid.

Sampling goes through :func:`~vihmc_torch.chains.resume.sample_chains_resumable`
in one segment, every draw kept (burn draws included, as JAX's ``sample``
keeps them). The data noise and the chain inits come from ``torch.Generator``
streams of ``seed``; JAX draws them from a key, which PyTorch cannot replay,
so ``data=`` and ``inits=`` take JAX's for a test. The entry point runs the
config's defaults on the card and prints one JSON line::

    python -m vihmc_torch.pipelines.hmc_full [--draws N] [--chains C] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from vihmc_torch.chains.diagnostics import summarize_np
from vihmc_torch.chains.parallel import gather_chains
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core.mesh import is_lead
from vihmc_torch.core.device import resolve_device, split_to, stream_generator, sync, to_f32
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import per_segment_vector
from vihmc_torch.data.synthetic import regression_data
from vihmc_torch.dists.priors import PerSegmentGaussianPrior
from vihmc_torch.hmc.kernel import HMCConfig
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.mlp import MLPConfig, mlp_slices
from vihmc_torch.pipelines.common import make_flat_mlp, make_log_posterior
from vihmc_torch.pipelines.configs import NNHMCRunConfig
from vihmc_torch.pipelines.predict import posterior_predictive, predictive_metrics

#: generator streams of a run's seed (the sampler's segment is stream 0)
_DATA_STREAM, _INIT_STREAM = 710_001, 710_002
#: samples per forward in the evaluation (JAX's chunk)
EVAL_CHUNK = 256


def mlp_param_tree(cfg: MLPConfig, device="cpu") -> list:
    """The MLP's parameters shaped as the JAX package's tree (a list of
    ``{'w', 'b'}`` dicts, no ``'b'`` on a bias-free last layer), zeros: its
    leaves give the per-tensor segments of the flat vector."""
    slices, _ = mlp_slices(cfg)
    return [{"w": torch.zeros(s.d_out, s.d_in, device=device),
             **({"b": torch.zeros(s.d_out, device=device)} if s.w > s.b else {})}
            for s in slices]


def build_log_posterior(cfg: NNHMCRunConfig, data, device="cpu"):
    """``(log_prob(flat (C, D)) -> (C,), apply_flat, prior)``: per-tensor
    ``N(0, tau^-1/2)`` priors and the ``cfg.loss`` likelihood on the training
    data, as ``hamiltorch.sample_model`` builds them."""
    apply_flat = make_flat_mlp(cfg.model)
    tree = mlp_param_tree(cfg.model)
    n_leaves = sum(len(layer) for layer in tree)
    scales = per_segment_vector(tree, [cfg.tau ** -0.5] * n_leaves).to(device)
    prior = PerSegmentGaussianPrior(scales)
    x = data["x_train"]
    log_prob = make_log_posterior(lambda flat: apply_flat(flat, x), data["y_train"],
                                  cfg.loss, cfg.tau_out, prior)
    return log_prob, apply_flat, prior


def _score(cfg, apply_flat, prior, data, samples, burn):
    """Pooled posterior predictive of ``(C, S, D)`` samples on the validation
    data: ``(metrics, preds, log_probs)``."""
    dev = data["x_val"].device
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[None]
    pooled = torch.as_tensor(samples[:, burn:, :].reshape(-1, samples.shape[-1]),
                             dtype=torch.float32, device=dev)
    lp_val = make_log_posterior(lambda f: apply_flat(f, data["x_val"]), data["y_val"],
                                cfg.loss, cfg.tau_out, prior)

    def lp_and_pred(flat):
        with true_f32():
            return lp_val(flat), apply_flat(flat, data["x_val"])

    log_probs, preds = posterior_predictive(lp_and_pred, pooled, chunk_size=EVAL_CHUNK)
    return predictive_metrics(preds, data["y_val"], log_probs), preds, log_probs


def host_metrics(metrics: dict) -> dict:
    """Tensor metrics as floats and numpy arrays."""
    return {k: (float(v) if v.ndim == 0 else v.cpu().numpy()) if isinstance(v, torch.Tensor)
            else v for k, v in metrics.items()}


def run(cfg: NNHMCRunConfig = NNHMCRunConfig(), data=None, inits=None,
        store: Optional[RunStore] = None, seed: int = 0, mesh=None, device="cuda"):
    """Sample, evaluate and (optionally) persist; returns ``result``,
    ``metrics``, ``diagnostics``, ``data``, ``apply_flat`` and ``phases_s``.

    ``data``: the dict of :func:`~vihmc_torch.data.synthetic.regression_data`
    (tensors or arrays), or None to make it here with noise std
    ``tau_out^-1/2``. ``inits`` (C, D): the chains' start, else
    ``0.3 N(0, 1)``.

    ``mesh`` (:func:`~vihmc_torch.chains.make_chain_mesh`) splits the chains
    over ranks and gathers them before the scoring, so every rank reports
    the whole run; the run store is written by its first rank.
    """
    dev = resolve_device(device)
    phases = {}
    t0 = time.perf_counter()
    if data is None:
        data = regression_data(cfg.n_train, cfg.n_val, noise_std=cfg.tau_out ** -0.5,
                               generator=stream_generator(dev, seed, _DATA_STREAM), device=dev)
    else:
        data = split_to(data, dev)
    log_prob, apply_flat, prior = build_log_posterior(cfg, data, dev)

    def lp(flat, aux):
        with true_f32():
            return log_prob(flat)

    d = cfg.model.num_params
    if inits is None:
        gen = stream_generator(dev, seed, _INIT_STREAM)
        inits = 0.3 * torch.randn((cfg.num_chains, d), generator=gen, device=dev)
    inits = to_f32(inits, dev)
    hmc_cfg = HMCConfig(num_samples=cfg.num_samples, num_leapfrog=cfg.L,
                        step_size=cfg.step_size)
    sync(dev)
    phases["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sample_chains_resumable(lp, inits, hmc_cfg, cfg.num_samples, 1.0, None, seed=seed,
                                  mesh=mesh)
    sync(dev)
    phases["sampling_s"] = time.perf_counter() - t0
    res = gather_chains(mesh, res)

    t0 = time.perf_counter()
    metrics, _, _ = _score(cfg, apply_flat, prior, data, res.samples, cfg.burn)
    metrics = host_metrics(metrics)
    metrics["acceptance_rate"] = res.acceptance_rate
    metrics["num_divergent"] = res.num_divergent
    diag = summarize_np(res.samples[:, cfg.burn:, :])
    sync(dev)
    phases["evaluate_s"] = time.perf_counter() - t0
    if store is not None and is_lead(mesh):
        store.save_config(cfg)
        store.save_array("hmc_params", res.samples)
        store.save_array("sample_mse", metrics["sample_mse"])
    return {"result": res, "metrics": metrics, "diagnostics": diag, "data": data,
            "apply_flat": apply_flat, "phases_s": phases}


def reevaluate(cfg: NNHMCRunConfig, store: RunStore, data=None, seed: int = 0,
               device="cuda"):
    """Reload ``hmc_params`` from a run store and re-score on the validation
    data without sampling (the reference's ``test`` mode)."""
    dev = resolve_device(device)
    if data is None:
        data = regression_data(cfg.n_train, cfg.n_val, noise_std=cfg.tau_out ** -0.5,
                               generator=stream_generator(dev, seed, _DATA_STREAM), device=dev)
    else:
        data = split_to(data, dev)
    _, apply_flat, prior = build_log_posterior(cfg, data, dev)
    samples = np.asarray(store.load_array("hmc_params"))
    if samples.ndim == 2:
        samples = samples[None]
    metrics, preds, _ = _score(cfg, apply_flat, prior, data, samples, cfg.burn)
    return {"metrics": host_metrics(metrics), "predictions": preds.cpu().numpy(),
            "diagnostics": summarize_np(samples[:, cfg.burn:, :])}


def summarize_run(out: dict, cfg, dev) -> dict:
    """The entry point's JSON line: metrics, acceptance, draws/s, phase walls
    and the device (shared by the three baselines)."""
    res, met, diag = out["result"], out["metrics"], out["diagnostics"]
    phases = out["phases_s"]
    return {
        "config": type(cfg).__name__, "chains": int(res.samples.shape[0]),
        "draws": int(cfg.num_samples), "burn": int(cfg.burn), "L": int(cfg.L),
        "step": float(cfg.step_size),
        "acceptance": float(res.acceptance_rate),
        "num_divergent": int(res.num_divergent),
        "step_final": [float(s) for s in res.step_sizes[:, -1]],
        "expected_mse_of_mean": float(met["expected_mse_of_mean"]),
        "mean_sample_mse": float(met["mean_sample_mse"]),
        "expected_log_prob": float(met["expected_log_prob"]),
        "ess_median": float(np.median(diag["ess"])),
        "r_hat_max": float(np.nanmax(diag["r_hat"])),
        "draws_per_s": cfg.num_samples / phases["sampling_s"],
        "phases_s": phases,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def divergence_note(out):
    """Say on stderr when most draws diverged: the chains then barely left
    their random starts, and the metrics score those starts."""
    res = out["result"]
    n = res.accepted.size
    if 2 * res.num_divergent > n or not res.accepted.any():
        print(f"{int(res.accepted.sum())} of {n} proposals accepted, {res.num_divergent} "
              f"divergent: the chains barely left their random starts", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(description="full-parameter HMC of the regression MLP")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=None, help="default: the config's 1000")
    ap.add_argument("--chains", type=int, default=None, help="default: the config's 1")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = NNHMCRunConfig()
    if args.draws is not None:
        cfg = dataclasses.replace(cfg, num_samples=args.draws)
    if args.chains is not None:
        cfg = dataclasses.replace(cfg, num_chains=args.chains)
    dev = resolve_device(args.device)
    out = run(cfg, seed=args.seed, device=dev)
    divergence_note(out)
    print(json.dumps(summarize_run(out, cfg, dev)))


if __name__ == "__main__":
    main()
