"""Parity harness on the reference's OSF dataset (``scripts/parity_osf.py``).

Runs the three stages at the reference-exact configurations on the
reference's ``DeepOnet_data.mat`` (``--mat``; not in the repository) and
prints the reference's quality battery:

1. VI: batch 128 over all trunk points, lr 1e-3, patience 500, ``num_ens``
   5, prior sigma 0.1, noise variance 1.0, ``--epochs`` (the reference ships
   10);
2. sensitivity: 90 % captured variance, 100 trunk points per function;
3. VI-HMC: step 1e-4, ``--draws`` 1000, ``--burn`` 100, the analytic L from
   ``post_std`` 0.0214 (7), NLL at tau 1.0, prior N(0, 0.1), REFRESH, from
   the prior (no VI start), the composed density, seed 1.

Reports expected validation log-probability, the expected MSE of the
posterior-predictive mean, the last and the smallest per-sample MSE, mean
relative L2 and the error-sigma correlation. With ``--ref-samples`` (a
reference ``hmc_params_<uid>.npy`` of the same ``.mat``; ``--ref-indices``,
``--ref-means`` (a ``torch.save`` file), ``--ref-stds``) it also pushes the
reference draws through the same DeepONet and reports posterior-predictive
moment parity normalized by the Monte Carlo error. Writes
``<out>/parity/parity_summary.json``::

    python -m vihmc_torch.scripts.parity_osf --mat DeepOnet_data.mat [--epochs 10]
        [--draws 1000] [--burn 100] [--chains 1] [--n-train 1000] [--n-valid 1000]
        [--out runs/parity_osf] [--ref-samples ... --ref-indices ... --ref-means ...]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from vihmc_torch.core.device import resolve_device, sync
from vihmc_torch.core.precision import true_f32
from vihmc_torch.data.burgers import get_burgers
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.pipelines import sensitivity, vi_hmc, vi_train
from vihmc_torch.pipelines.common import make_flat_deeponet
from vihmc_torch.pipelines.configs import (OperatorVIRunConfig, SensitivityRunConfig,
                                           VIHMCRunConfig)
from vihmc_torch.pipelines.postprocess import error_report, error_sigma_correlation
from vihmc_torch.scripts._common import check_output, json_line
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import VIConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="parity run on the reference's OSF .mat")
    ap.add_argument("--mat", required=True, help="path to DeepOnet_data.mat")
    ap.add_argument("--epochs", type=int, default=10,
                    help="VI epochs (reference ships 10; use >=1000 for a converged stage 1)")
    ap.add_argument("--draws", type=int, default=1000)
    ap.add_argument("--burn", type=int, default=100)
    ap.add_argument("--chains", type=int, default=1,
                    help="reference runs chains sequentially; >1 vectorizes")
    ap.add_argument("--n-train", type=int, default=1000)
    ap.add_argument("--n-valid", type=int, default=1000,
                    help="train/valid split sizes (reference: 1000/1000)")
    ap.add_argument("--out", default="runs/parity_osf")
    ap.add_argument("--ref-samples", default=None,
                    help="reference hmc_params_<uid>.npy from the same .mat")
    ap.add_argument("--ref-indices", default=None,
                    help="reference gradient_indices_<uid>.npy")
    ap.add_argument("--ref-means", default=None,
                    help="reference means_flattened_<uid> (torch.save file)")
    ap.add_argument("--ref-stds", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def stage_configs(model: DeepONetConfig, n_train: int, n_valid: int, n_points: int,
                  epochs: int, draws: int, burn: int, chains: int):
    """``(vi_cfg, sens_cfg, hmc_cfg)`` at the reference-exact settings (:607-636)."""
    vi_cfg = OperatorVIRunConfig(
        model=model, n_train=n_train, n_valid=n_valid, batch_size=128,
        p=min(10201, n_points),
        vi=VIConfig(epochs=epochs, lr_start=1e-3, patience=500, num_ens=5, prior_sigma=0.1,
                    elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=1.0)))
    sens_cfg = SensitivityRunConfig(importance_threshold=0.90, p_subsample=100, batch_chunk=8)
    hmc_cfg = VIHMCRunConfig(
        step_size=1e-4, num_samples=draws, burn=burn, post_std=0.0214, prior_var=0.1 ** 2,
        loss="NLL", tau_out=1.0, num_chains=chains, load_prior=False, load_std=False,
        init_prior=False, frozen_policy="refresh")
    return vi_cfg, sens_cfg, hmc_cfg


def predictive_moments(apply_flat, draws_full, branch_x, trunk_x, chunk: int = 16):
    """Posterior-predictive mean and std over (S, D) draws, (N, P) each, and S."""
    dev = branch_x.device
    s1 = s2 = None
    n = 0
    for start in range(0, draws_full.shape[0], chunk):
        block = torch.as_tensor(draws_full[start:start + chunk], dtype=torch.float32,
                                device=dev)
        with torch.no_grad(), true_f32():
            preds = apply_flat(block, branch_x, trunk_x).double().cpu().numpy()
        s1 = preds.sum(0) if s1 is None else s1 + preds.sum(0)
        s2 = (preds ** 2).sum(0) if s2 is None else s2 + (preds ** 2).sum(0)
        n += preds.shape[0]
    mean = s1 / n
    return mean, np.sqrt(np.maximum(s2 / n - mean ** 2, 0.0)), n


def moment_parity(args, model, sens, valid, preds) -> dict:
    """The reference draws' predictive moments against this run's."""
    apply_flat = make_flat_deeponet(model)
    ref_draws = np.load(args.ref_samples)                     # (S, d_sub)
    ref_idx = (np.asarray(np.load(args.ref_indices)).ravel() if args.ref_indices
               else np.asarray(sens["indices"]))
    base = np.asarray(sens["mu"], np.float64)
    if args.ref_means:
        base = np.asarray(torch.load(args.ref_means, map_location="cpu")).ravel()
    full = np.tile(base[None], (ref_draws.shape[0], 1))
    full[:, ref_idx] = ref_draws[:, :len(ref_idx)]
    ref_mean, ref_std, s_ref = predictive_moments(apply_flat, full, valid["branch_in"],
                                                  valid["trunk_in"])
    our_mean, our_std = preds.mean(0), preds.std(0)
    # the difference of two posterior-mean estimates has std
    # ~ sqrt(var_ref / S_ref + var_ours / S_ours)
    mc = np.sqrt(ref_std ** 2 / s_ref + our_std ** 2 / preds.shape[0]) + 1e-12
    z = np.abs(ref_mean - our_mean) / mc
    return {
        "ref_samples": os.path.abspath(args.ref_samples),
        "ref_draws_used": int(s_ref),
        "mean_abs_mean_diff": float(np.mean(np.abs(ref_mean - our_mean))),
        "max_abs_mean_diff": float(np.max(np.abs(ref_mean - our_mean))),
        "median_mean_z": float(np.median(z)),
        "frac_mean_z_above_3": float(np.mean(z > 3.0)),
        "mean_abs_std_diff": float(np.mean(np.abs(ref_std - our_std))),
        "std_ratio_median": float(np.median(our_std / np.maximum(ref_std, 1e-12))),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    check_output(args.out)
    model = DeepONetConfig()
    data = get_burgers(dev, args.n_train, args.n_valid, mat_path=args.mat)
    train_split, valid_split = data
    nxnt = train_split["trunk_in"].shape[0]
    n_valid = valid_split["branch_in"].shape[0]
    print(f"[data] {args.mat}: {train_split['branch_in'].shape[0]} train / {n_valid} valid "
          f"fns x {nxnt} pts", flush=True)
    store = RunStore(args.out, uid="parity")
    vi_cfg, sens_cfg, hmc_cfg = stage_configs(model, args.n_train, args.n_valid, nxnt,
                                              args.epochs, args.draws, args.burn, args.chains)

    t0 = time.perf_counter()
    vi_out = vi_train.run_operator(vi_cfg, seed=0, data=data, store=store, device=dev)
    m = np.asarray(vi_out["metrics"])
    sync(dev)
    print(f"[vi] {args.epochs} epochs in {time.perf_counter() - t0:.1f}s  valid_mse "
          f"{m[0, 3]:.4f} -> {m[-1, 3]:.4f}", flush=True)
    sens = sensitivity.run_operator(vi_out["best_state"].vp, model, data[1], sens_cfg, seed=0,
                                    store=store)
    print(f"[sensitivity] {sens['num_sensitive']}/{len(sens['scores'])}", flush=True)

    artifacts = {"mu": sens["mu"], "sigma": sens["sigma"], "indices": sens["indices"]}
    t0 = time.perf_counter()
    out = vi_hmc.run_operator(hmc_cfg, model, artifacts, data=data, store=store, seed=1,
                              evaluate=True, device=dev)
    met = out["metrics"]
    truth = valid_split["solution"].cpu().numpy()
    preds = np.asarray(out["predictions"]).reshape(-1, n_valid, nxnt)
    rep = error_report(preds, truth)
    nt = int(round(nxnt ** 0.5))
    corr = error_sigma_correlation(preds, truth, nt=nt, nx=nxnt // nt)
    summary = {
        "mat": os.path.abspath(args.mat),
        "vi_epochs": args.epochs,
        "subspace_dim": int(sens["num_sensitive"]),
        "chains": args.chains, "draws": args.draws, "burn": args.burn,
        "L": hmc_cfg.L, "step": hmc_cfg.step_size,
        "acceptance": float(met["acceptance_rate"]),
        "expected_log_prob": float(np.mean(np.asarray(met["expected_log_prob"]))),
        "expected_mse_of_mean": float(met["expected_mse_of_mean"]),
        "final_sample_mse": float(np.asarray(met["final_mse"])),
        "min_sample_mse": float(np.asarray(met["min_mse"])),
        "mean_relative_l2": rep["mean_relative_l2"],
        "mean_error_sigma_correlation": corr["mean_correlation"],
        "sampling_seconds": time.perf_counter() - t0,
    }
    if args.ref_samples:
        summary["moment_parity"] = moment_parity(args, model, sens, valid_split, preds)
    store.save_config(summary, name="parity_summary")
    json_line(None, summary)
    return summary


if __name__ == "__main__":
    main()
