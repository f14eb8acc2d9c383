"""NN-workload demo at the reference's configurations (``scripts/run_nn_demo.py``).

On the regression MLP (141 parameters), in order, each block of the summary
under the script's key:

- ``hmc_full``: full-parameter HMC at the reference Neural_network/HMC
  config (``--hmc-draws`` 1000, step 1e-4, L = 643, tau_out 400);
- ``vi``: VI at the reference config (``--epochs`` 10,000, Adam 1e-2,
  patience 100, ``num_ens`` 10, beta 1.0, priors N(0, 1));
- ``sensitivity``: 90 % captured variance;
- ``vi_hmc``: VI-HMC at the reference VI_HMC config (10 chains x
  ``--vihmc-draws`` 100, step 5e-4, the analytic L, NLL at tau 5e-2^2, the
  VI posterior as prior and start, REFRESH), seed 1;
- ``vi_hmc_converged``: the same posterior run long enough to converge (64
  chains x ``--converged-draws`` 3000, step 0.1, L = 96, step jitter, the
  trajectory field clipped at 13 sqrt(d), the VI-variance metric), seed 2,
  with the rank-normalized battery;
- ``vi_nuts``: the ``vi_hmc`` posterior under NUTS (depth 6), seed 1.

Writes the artifacts and ``demo_summary.json`` to a run store under
``--out``. The data are the NN workload's 20 training points of
``jax.random.key(0)`` (``assets/nn_port_inputs.npz``) and the noise-free
validation curve; the script draws its training noise from a split of key 0,
which PyTorch cannot replay. Seeds 0, 1, 2 seed the port's
``torch.Generator`` streams where the script passes keys 0, 1, 2. No kernel
of the port runs (the MLP's densities are composed)::

    python -m vihmc_torch.scripts.run_nn_demo [--epochs 10000] [--hmc-draws 1000]
        [--vihmc-draws 100] [--converged-draws 3000] [--out runs/demo_nn] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from vihmc_torch.chains.diagnostics import summarize_np
from vihmc_torch.core.device import resolve_device, sync
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.pipelines import hmc_full, sensitivity, vi_hmc, vi_train
from vihmc_torch.pipelines.configs import NNHMCRunConfig, SensitivityRunConfig, VIHMCRunConfig
from vihmc_torch.scripts._common import check_output, json_line, nn_regression_data
from vihmc_torch.scripts.run_nn_stage12 import nn_vi_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="NN demo at the reference configurations")
    ap.add_argument("--out", default="runs/demo_nn")
    ap.add_argument("--epochs", type=int, default=10_000)
    ap.add_argument("--hmc-draws", type=int, default=1000)
    ap.add_argument("--vihmc-draws", type=int, default=100)
    ap.add_argument("--converged-draws", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    return ap


def vihmc_config(draws: int, **kw) -> VIHMCRunConfig:
    """The reference VI_HMC config of the script (:83-87), plus ``kw``."""
    return VIHMCRunConfig(num_samples=draws, step_size=5e-4, post_std=0.2501,
                          num_chains=10, loss="NLL", tau_out=5e-2 ** 2, load_prior=True,
                          load_std=True, init_prior=True, frozen_policy="refresh", **kw)


def converged_config(draws: int, num_sensitive: int) -> VIHMCRunConfig:
    """The script's converged run (:112-118)."""
    return VIHMCRunConfig(
        num_samples=draws, step_size=0.1, num_leapfrog=96, post_std=0.2501, num_chains=64,
        loss="NLL", tau_out=5e-2 ** 2, load_prior=True, load_std=True, init_prior=True,
        frozen_policy="refresh", vi_mass=True, jitter_eps=True, jitter_low_frac=0.5,
        clip_grad=13.0 * num_sensitive ** 0.5)


def _ess_rhat(out) -> dict:
    return {"ess_median": float(np.median(np.asarray(out["ess"]))),
            "r_hat_max": float(np.max(out["diagnostics"]["r_hat"]))}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    check_output(args.out)
    store = RunStore(args.out)
    print(f"artifacts -> {store.path}", flush=True)
    summary, walls = {}, {}

    t0 = time.perf_counter()
    hmc_cfg = NNHMCRunConfig(num_samples=args.hmc_draws)
    hmc_out = hmc_full.run(hmc_cfg, data=nn_regression_data(dev), store=store, seed=0,
                           device=dev)
    m = hmc_out["metrics"]
    walls["hmc_full"] = time.perf_counter() - t0
    print(f"[hmc-full] {args.hmc_draws} draws (L={hmc_cfg.L}) in {walls['hmc_full']:.1f}s  "
          f"accept={float(m['acceptance_rate']):.3f}  "
          f"expectedMSE={float(m['expected_mse_of_mean']):.4f}", flush=True)
    summary["hmc_full"] = {
        "acceptance": float(m["acceptance_rate"]),
        "expected_mse_of_mean": float(m["expected_mse_of_mean"]),
        "expected_log_prob": float(m["expected_log_prob"]),
        "ess_median": float(np.median(hmc_out["diagnostics"]["ess"])),
    }

    t0 = time.perf_counter()
    vi_cfg = nn_vi_config(args.epochs, 100)
    vi_out = vi_train.run_nn(vi_cfg, seed=0, data=hmc_out["data"], store=store, device=dev)
    mm = np.asarray(vi_out["metrics"])
    sync(dev)
    walls["vi"] = time.perf_counter() - t0
    print(f"[vi] {args.epochs} epochs in {walls['vi']:.1f}s  valid_mse {mm[0, 3]:.3f} -> "
          f"{mm[-1, 3]:.3f}", flush=True)
    summary["vi"] = {"valid_mse_first": float(mm[0, 3]), "valid_mse_last": float(mm[-1, 3]),
                     "valid_mse_best": float(mm[:, 3].min())}

    sens = sensitivity.run_nn(vi_out["best_state"].vp, vi_cfg.model, vi_out["data"]["x_val"],
                              SensitivityRunConfig(importance_threshold=0.90), store=store)
    n_sens = int(sens["num_sensitive"])
    print(f"[sensitivity] {n_sens}/{len(sens['scores'])} params", flush=True)
    summary["sensitivity"] = {"num_sensitive": n_sens, "total": int(len(sens["scores"]))}
    arts = {"mu": sens["mu"], "sigma": sens["sigma"], "indices": sens["indices"]}

    t0 = time.perf_counter()
    vihmc_cfg = vihmc_config(args.vihmc_draws)
    out = vi_hmc.run_nn(vihmc_cfg, vi_cfg.model, arts, data=vi_out["data"], store=store,
                        seed=1, device=dev)
    met = out["metrics"]
    walls["vi_hmc"] = time.perf_counter() - t0
    print(f"[vi-hmc] 10x{args.vihmc_draws} draws (L={vihmc_cfg.L}) in {walls['vi_hmc']:.1f}s"
          f"  accept={float(met['acceptance_rate']):.3f}  "
          f"expectedMSE={float(met['expected_mse_of_mean']):.4f}", flush=True)
    summary["vi_hmc"] = {
        "subspace_dim": n_sens,
        "acceptance": float(met["acceptance_rate"]),
        "expected_mse_of_mean": float(met["expected_mse_of_mean"]),
        "expected_log_prob": float(met["expected_log_prob"]),
        **_ess_rhat(out),
    }

    t0 = time.perf_counter()
    conv_cfg = converged_config(args.converged_draws, n_sens)
    out_c = vi_hmc.run_nn(conv_cfg, vi_cfg.model, arts, data=vi_out["data"], seed=2,
                          device=dev)
    met_c = out_c["metrics"]
    diag_c = summarize_np(np.asarray(out_c["result"].samples)[:, conv_cfg.burn_:, :])
    walls["vi_hmc_converged"] = time.perf_counter() - t0
    print(f"[vi-hmc-converged] 64x{args.converged_draws} draws (L=96) in "
          f"{walls['vi_hmc_converged']:.1f}s  accept={float(met_c['acceptance_rate']):.3f}  "
          f"rhat_max={float(np.nanmax(diag_c['r_hat'])):.3f}", flush=True)
    summary["vi_hmc_converged"] = {
        "chains": 64, "draws": int(args.converged_draws),
        "acceptance": float(met_c["acceptance_rate"]),
        "expected_mse_of_mean": float(met_c["expected_mse_of_mean"]),
        "ess_median": float(np.median(diag_c["ess"])),
        "ess_bulk_median": float(np.median(diag_c["ess_bulk"])),
        "ess_tail_median": float(np.median(diag_c["ess_tail"])),
        "r_hat_max": float(np.nanmax(diag_c["r_hat"])),
        "r_hat_rank_max": float(np.nanmax(diag_c["r_hat_rank"])),
        "tau_floor_frac": float(diag_c["tau_floor_frac"]),
    }

    t0 = time.perf_counter()
    nuts_cfg = vihmc_config(args.vihmc_draws, algorithm="nuts", nuts_max_depth=6)
    out_n = vi_hmc.run_nn(nuts_cfg, vi_cfg.model, arts, data=vi_out["data"], seed=1,
                          device=dev)
    met_n = out_n["metrics"]
    walls["vi_nuts"] = time.perf_counter() - t0
    print(f"[vi-nuts] 10x{args.vihmc_draws} draws (depth 6) in {walls['vi_nuts']:.1f}s  "
          f"accept={float(met_n['acceptance_rate']):.3f}  "
          f"expectedMSE={float(met_n['expected_mse_of_mean']):.4f}", flush=True)
    summary["vi_nuts"] = {
        "expected_mse_of_mean": float(met_n["expected_mse_of_mean"]),
        "acceptance": float(met_n["acceptance_rate"]),
        **_ess_rhat(out_n),
    }

    store.save_config(summary, name="demo_summary")
    json_line(None, summary)
    json_line("nn-demo-walls", walls)
    return summary


if __name__ == "__main__":
    main()
