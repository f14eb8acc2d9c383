"""Stage 1 + 2 of the NN workload at the reference configuration, written
as a bundle (``scripts/run_nn_stage12.py``).

Trains the Bayesian MLP's VI stage at the reference hyperparameters (10,000
epochs, Adam 1e-2, patience 5000, ``num_ens`` 10, beta 1.0, priors N(0, 1),
the summed ELBO at noise 5e-2), runs sensitivity at 90 % captured variance
on the 300 validation inputs, and writes a bundle with the keys of
``assets/nn_stage12.npz`` (``mu``, ``sigma``, ``indices``, ``scores``,
``data_seed``, ``n_train``, ``n_val``, ``noise_std``, ``vi_epochs``,
``vi_valid_mse``), which ``bench_nn.build_nn_problem`` reads when its
``NN_STAGE12_ASSET`` points at it.

The data are the ones ``bench_nn`` closes over: the 20 training points of
``regression_data(jax.random.key(0), 20, 300, noise_std=5e-2)``, exported
to ``assets/nn_port_inputs.npz`` (PyTorch cannot replay JAX's noise draws),
and the noise-free validation curve. ``--out`` defaults to
``runs/torch_run_nn_stage12/nn_stage12.npz`` (the script's default
overwrites the committed ``assets/nn_stage12.npz``)::

    python -m vihmc_torch.scripts.run_nn_stage12 [--epochs 10000] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from vihmc_torch.core.device import resolve_device, sync
from vihmc_torch.pipelines import sensitivity, vi_train
from vihmc_torch.pipelines.configs import NNVIRunConfig, SensitivityRunConfig
from vihmc_torch.scripts._common import check_output, nn_regression_data, runs_path
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import VIConfig

NAME = "run_nn_stage12"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="NN stage 1 (VI) + stage 2 (sensitivity) bundle")
    ap.add_argument("--epochs", type=int, default=10_000)
    ap.add_argument("--out", default=runs_path(NAME, "nn_stage12.npz"))
    ap.add_argument("--device", default="cuda")
    return ap


def nn_vi_config(epochs: int, patience: int) -> NNVIRunConfig:
    """The reference NN VI configuration (``patience`` 5000 here, 100 in the demo)."""
    return NNVIRunConfig(vi=VIConfig(
        epochs=epochs, lr_start=1e-2, patience=patience, num_ens=10, beta_type=1.0,
        prior_mu=0.0, prior_sigma=1.0,
        elbo=ELBOConfig(reduction="sum", fixed_noise_var=5e-2 ** 2)))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    check_output(args.out)
    data = nn_regression_data(dev)
    t0 = time.perf_counter()
    vi_cfg = nn_vi_config(args.epochs, 5000)
    vi_out = vi_train.run_nn(vi_cfg, seed=0, data=data, device=dev)
    mm = np.asarray(vi_out["metrics"])
    sync(dev)
    vi_s = time.perf_counter() - t0
    print(f"[vi] {args.epochs} epochs in {vi_s:.1f}s  valid_mse {mm[0, 3]:.3f} -> "
          f"{mm[-1, 3]:.3f} (best {mm[:, 3].min():.3f})", flush=True)
    sens = sensitivity.run_nn(vi_out["best_state"].vp, vi_cfg.model, vi_out["data"]["x_val"],
                              SensitivityRunConfig(importance_threshold=0.90))
    print(f"[sensitivity] {sens['num_sensitive']}/{len(sens['scores'])} params", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out,
             mu=np.asarray(sens["mu"], np.float32), sigma=np.asarray(sens["sigma"], np.float32),
             indices=np.asarray(sens["indices"], np.int64),
             scores=np.asarray(sens["scores"], np.float32),
             data_seed=0, n_train=20, n_val=300, noise_std=5e-2, vi_epochs=args.epochs,
             vi_valid_mse=mm[:, 3].astype(np.float32))
    print(f"wrote {args.out}", flush=True)
    return {"vi_seconds": vi_s, "num_sensitive": int(sens["num_sensitive"]),
            "valid_mse_best": float(mm[:, 3].min()), "out": args.out}


if __name__ == "__main__":
    main()
