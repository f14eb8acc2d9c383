"""End-to-end operator demo: VI -> sensitivity -> VI-HMC on Burgers
(``scripts/run_operator_demo.py``).

The three stages at the script's configurations, writing the artifacts and
``demo_summary.json`` (the script's keys) to a run store under ``--out``:

1. VI: the reference DeepONet on 1000 + 200 functions (101 x 101 grid),
   batch 128, 512 trunk points per example, ``num_ens`` 3, Adam 1e-3,
   patience 20, prior sigma 0.1, ``'mean_x_n'``; 200 epochs;
2. sensitivity at 90 % captured variance, 100 trunk points, chunks of 8;
3. VI-HMC over that subspace: 16 chains x 450 draws, L = 31, REFRESH, the
   VI-variance metric, step jitter over [L/2, L], NLL at tau 1; by default
   dual averaging at 0.65 from step 1e-4 with the trajectory field clipped
   at 13 sqrt(d) and the dual-stride (3/3) Gram surrogate field;
   ``--gauss-field`` the VI-Gaussian score field at the fixed step
   ``0.8 d^-1/4`` instead.

``--small`` runs the script's small DeepONet (32 + 16 functions, 17 x 17,
5 epochs, 4 chains x 30 draws, the full-grid field). As in the script, the
density is the composed NLL (no ``fused_merge_nll``, so no kernel of the
port runs). The data of data seed 0 on the 101 x 101 grid are the exported
initial conditions, other sizes a torch-drawn GRF
(``scripts/_common.burgers_splits``)::

    python -m vihmc_torch.scripts.run_operator_demo [--small] [--epochs N]
        [--draws N] [--gauss-field] [--out runs/demo] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from vihmc_torch.core.device import resolve_device, sync
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.pipelines import sensitivity, vi_hmc, vi_train
from vihmc_torch.pipelines.configs import (OperatorVIRunConfig, SensitivityRunConfig,
                                           VIHMCRunConfig)
from vihmc_torch.pipelines.postprocess import error_report, error_sigma_correlation
from vihmc_torch.scripts._common import (SMALL_DEEPONET, SMALL_SIZES, burgers_splits,
                                         check_output, json_line)
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import VIConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="end-to-end operator demo (three stages)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default="runs/demo")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--draws", type=int, default=None)
    ap.add_argument("--gauss-field", action="store_true",
                    help="VI-Gaussian trajectory field instead of the dual-stride Gram "
                         "oracle (fixed d^-1/4 step)")
    ap.add_argument("--device", default="cuda")
    return ap


def demo_configs(small: bool, epochs=None, draws=None):
    """``(model, sizes, vi_cfg, chains, draws)`` of the script (:40-59, :69-74)."""
    if small:
        model = SMALL_DEEPONET
        sizes = dict(SMALL_SIZES)
        epochs, draws, chains = epochs or 5, draws or 30, 4
    else:
        model = DeepONetConfig()
        sizes = {"n_train": 1000, "n_valid": 200, "nx": 101, "nt": 101, "p": 512}
        epochs, draws, chains = epochs or 200, draws or 450, 16
    vi_cfg = OperatorVIRunConfig(
        model=model, n_train=sizes["n_train"], n_valid=sizes["n_valid"], batch_size=128,
        p=sizes["p"],
        vi=VIConfig(epochs=epochs, lr_start=1e-3, patience=20, num_ens=3, prior_sigma=0.1,
                    elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=1.0)))
    return model, sizes, vi_cfg, chains, draws


def sensitivity_config(nx: int, nt: int) -> SensitivityRunConfig:
    return SensitivityRunConfig(importance_threshold=0.90, p_subsample=min(100, nx * nt),
                                batch_chunk=8)


def hmc_config(num_sensitive: int, draws: int, chains: int, small: bool,
               gauss_field: bool) -> VIHMCRunConfig:
    """Stage 3 of the script (:94-120)."""
    if gauss_field:
        return VIHMCRunConfig(num_samples=draws, step_size=0.8 * num_sensitive ** -0.25,
                              post_std=0.0214, num_chains=chains, num_leapfrog=31,
                              loss="NLL", tau_out=1.0, frozen_policy="refresh",
                              vi_mass=True, jitter_l=True, jitter_low_frac=0.5,
                              gauss_field=1.0)
    return VIHMCRunConfig(num_samples=draws, step_size=1e-4, post_std=0.0214,
                          num_chains=chains, num_leapfrog=31, target_accept=0.65,
                          loss="NLL", tau_out=1.0, frozen_policy="refresh", vi_mass=True,
                          adapt_step_size=True, jitter_l=True, jitter_low_frac=0.5,
                          clip_grad=13.0 * num_sensitive ** 0.5,
                          coarse_stride=None if small else 3,
                          fn_stride=None if small else 3)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    check_output(args.out)
    model, sizes, vi_cfg, chains, draws = demo_configs(args.small, args.epochs, args.draws)
    nx, nt = sizes["nx"], sizes["nt"]
    store = RunStore(args.out)
    print(f"artifacts -> {store.path}", flush=True)

    t0 = time.perf_counter()
    data = burgers_splits(dev, 0, sizes["n_train"], sizes["n_valid"], nx, nt)
    sync(dev)
    print(f"[data] generated {sizes['n_train']}+{sizes['n_valid']} Burgers functions "
          f"({nx}x{nt} grid) in {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    vi_out = vi_train.run_operator(vi_cfg, seed=0, data=data, store=store, device=dev)
    m = vi_out["metrics"]
    print(f"[vi] {vi_cfg.vi.epochs} epochs in {time.perf_counter() - t0:.1f}s  "
          f"first/last valid_mse: {m[0, 3]:.4f} -> {m[-1, 3]:.4f}", flush=True)

    t0 = time.perf_counter()
    sens = sensitivity.run_operator(vi_out["best_state"].vp, model, data[1],
                                    sensitivity_config(nx, nt), seed=0, store=store)
    n_sens, n_all = int(sens["num_sensitive"]), len(sens["scores"])
    print(f"[sensitivity] {n_sens}/{n_all} params ({100 * n_sens / n_all:.1f}%) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    hmc_cfg = hmc_config(n_sens, draws, chains, args.small, args.gauss_field)
    artifacts = {"mu": sens["mu"], "sigma": sens["sigma"], "indices": sens["indices"]}
    out = vi_hmc.run_operator(hmc_cfg, model, artifacts, data=data, store=store, seed=0,
                              device=dev)
    dt = time.perf_counter() - t0
    met = out["metrics"]
    print(f"[vi-hmc] {chains}x{draws} draws (L={hmc_cfg.L}) in {dt:.1f}s  "
          f"accept={float(met['acceptance_rate']):.3f}  div={int(met['num_divergent'])}",
          flush=True)

    truth = data[1]["solution"].cpu().numpy()
    preds = np.asarray(out["predictions"]).reshape(-1, *truth.shape)
    rep = error_report(preds, truth, log_probs=np.asarray(met["expected_log_prob"])[None])
    corr = error_sigma_correlation(preds, truth, nt=nt, nx=nx)
    summary = {
        "valid_mse_vi_first": float(m[0, 3]),
        "valid_mse_vi_last": float(m[-1, 3]),
        "subspace_frac": n_sens / n_all,
        "acceptance": float(met["acceptance_rate"]),
        "expected_mse_of_mean": float(met["expected_mse_of_mean"]),
        "mean_relative_l2": rep["mean_relative_l2"],
        "mean_error_sigma_correlation": corr["mean_correlation"],
        "ess_median": float(np.median(np.asarray(out["ess"]))),
        "r_hat_max": float(np.max(np.asarray(out["diagnostics"]["r_hat"]))),
        "sampling_seconds": dt,
    }
    store.save_config(summary, name="demo_summary")
    json_line(None, summary)
    return summary


if __name__ == "__main__":
    main()
