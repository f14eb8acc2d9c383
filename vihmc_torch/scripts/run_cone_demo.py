"""Cone workload end-to-end demo: VI -> sensitivity -> VI-HMC and the
function-space battery (``scripts/run_cone_demo.py``).

The reference DeepONet with the Cone trunk input (``in_trunk`` 2, no BC
embedding) on generated Cone data, 1000 training and 988 validation
examples, each with its own query point, so the merge runs per example:

1. VI: batch 128, ``num_ens`` 3, Adam 1e-3, patience 100, prior sigma 0.1,
   ``'mean_x_n'`` at noise variance 1e-2, ``--epochs`` 1200;
2. sensitivity at 90 % captured variance (at least the 8 top-scored
   coordinates);
3. VI-HMC: ``--chains`` 16 x ``--draws`` 600, L = 31, REFRESH, the
   VI-variance metric, the field clipped at 13 sqrt(d), dual averaging
   coupled over the chains at 0.65 from step 0.1 and kept on past burn, step
   jitter over [0.5, 1], NLL at tau 1e-2, seed 1;
4. the function-space Vehtari battery on the first 64 validation examples.

``--small`` runs the script's small DeepONet on 64 + 32 examples (at most
30 epochs, 40 draws, 4 chains). The density is composed (per-example query
points: no merge kernel applies, in JAX too). The Cone data come from a
``torch.Generator`` seeded with 0 (JAX: ``jax.random.key(0)``). ``--out``
defaults to ``runs/torch_run_cone_demo/cone_demo_summary.json`` (the
script's default overwrites the committed
``docs/results/cone_demo_summary.json``)::

    python -m vihmc_torch.scripts.run_cone_demo [--small] [--epochs 1200] [--draws 600]
        [--chains 16] [--out PATH] [--store runs/cone_demo] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from vihmc_torch.core.device import resolve_device, sync
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.data.cone import get_cone
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.pipelines import sensitivity, vi_hmc, vi_train
from vihmc_torch.pipelines.common import make_flat_deeponet
from vihmc_torch.pipelines.configs import (OperatorVIRunConfig, SensitivityRunConfig,
                                           VIHMCRunConfig)
from vihmc_torch.pipelines.postprocess import function_space_diagnostics
from vihmc_torch.scripts._common import check_output, json_line, runs_path, write_json
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import VIConfig

NAME = "run_cone_demo"
NOISE_VAR = 1e-2
MIN_SUBSPACE = 8
N_PROBE = 64


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Cone workload end-to-end demo")
    ap.add_argument("--small", action="store_true", help="CPU smoke scale")
    ap.add_argument("--epochs", type=int, default=1200)
    ap.add_argument("--draws", type=int, default=600)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--out", default=runs_path(NAME, "cone_demo_summary.json"))
    ap.add_argument("--store", default="runs/cone_demo")
    ap.add_argument("--device", default="cuda")
    return ap


def demo_configs(small: bool, epochs: int, draws: int, chains: int):
    """``(model, n_train, n_valid, vi_cfg, draws, chains)`` of the script (:57-84)."""
    if small:
        model = DeepONetConfig(in_branch=17, in_trunk=2, width_branch=16, width_trunk=16,
                               depth_branch=3, depth_trunk=3, impose_bc=False)
        n_train, n_valid = 64, 32
        epochs, draws, chains = min(epochs, 30), min(draws, 40), 4
    else:
        model = DeepONetConfig(in_trunk=2, impose_bc=False)
        n_train, n_valid = 1000, 988
    vi_cfg = OperatorVIRunConfig(
        model=model, dataset="Cone", n_train=n_train, n_valid=n_valid, batch_size=128,
        vi=VIConfig(epochs=epochs, lr_start=1e-3, patience=100, num_ens=3, prior_sigma=0.1,
                    elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=NOISE_VAR)))
    return model, n_train, n_valid, vi_cfg, draws, chains


def hmc_config(d_sub: int, draws: int, chains: int) -> VIHMCRunConfig:
    """Stage 3 of the script (:107-113)."""
    return VIHMCRunConfig(
        step_size=0.1, num_samples=draws, num_chains=chains, num_leapfrog=31, loss="NLL",
        tau_out=NOISE_VAR, frozen_policy="refresh", vi_mass=True, clip_grad=13.0 * d_sub ** 0.5,
        adapt_step_size=True, target_accept=0.65, da_axis="chains", adapt_forever=True,
        jitter_eps=True, jitter_low_frac=0.5)


def subspace_indices(sens: dict) -> np.ndarray:
    """The 90 % index set, or the top ``MIN_SUBSPACE`` scores when it is
    smaller (at the small scale one parameter can capture 90 % alone)."""
    if int(sens["num_sensitive"]) < MIN_SUBSPACE:
        return np.sort(np.argsort(-sens["scores"])[:MIN_SUBSPACE])
    return np.asarray(sens["indices"])


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    check_output(args.out)
    check_output(args.store)
    model, n_train, n_valid, vi_cfg, draws, chains = demo_configs(
        args.small, args.epochs, args.draws, args.chains)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    data = get_cone(gen, n_train, n_valid, in_branch=model.in_branch, device=dev)
    store = RunStore(args.store, uid="cone")
    print(f"[data] cone {n_train}+{n_valid} examples (per-example query)", flush=True)

    t0 = time.perf_counter()
    vi_out = vi_train.run_operator(vi_cfg, seed=0, data=data, store=store, device=dev)
    m = np.asarray(vi_out["metrics"])
    sync(dev)
    vi_s = time.perf_counter() - t0
    print(f"[vi] {vi_cfg.vi.epochs} epochs in {vi_s:.1f}s  valid_mse {m[0, 3]:.4f} -> "
          f"{m[-1, 3]:.4f} (best {m[:, 3].min():.4f})", flush=True)

    t0 = time.perf_counter()
    sens = sensitivity.run_operator(vi_out["best_state"].vp, model, data[1],
                                    SensitivityRunConfig(importance_threshold=0.90,
                                                         batch_chunk=8),
                                    seed=0, store=store)
    indices = subspace_indices(sens)
    d_sub = len(indices)
    print(f"[sensitivity] {d_sub}/{len(sens['scores'])} in {time.perf_counter() - t0:.1f}s",
          flush=True)

    hmc_cfg = hmc_config(d_sub, draws, chains)
    artifacts = {"mu": sens["mu"], "sigma": sens["sigma"], "indices": indices}
    t0 = time.perf_counter()
    out = vi_hmc.run_operator(hmc_cfg, model, artifacts, data=data, store=store, seed=1,
                              evaluate=True, device=dev)
    wall = time.perf_counter() - t0
    res, met = out["result"], out["metrics"]
    acc = float(np.asarray(res.accept_probs)[:, hmc_cfg.burn_:].mean())
    print(f"[vi-hmc] {chains}x{draws} (L={hmc_cfg.L}) in {wall:.1f}s accept={acc:.3f}",
          flush=True)

    # the function-space battery on a validation probe subset
    apply_flat = make_flat_deeponet(model)
    valid = data[1]
    nprobe = min(N_PROBE, n_valid)
    branch_p, trunk_p = valid["branch_in"][:nprobe], valid["trunk_in"][:nprobe]
    frozen = torch.as_tensor(sens["mu"], dtype=torch.float32, device=dev)
    idx = torch.as_tensor(indices, dtype=torch.int64, device=dev)

    def predict_fn(q):
        with true_f32():
            return apply_flat(scatter_subspace(frozen, q, idx), branch_p,
                              trunk_p).reshape(q.shape[0], -1)

    fs = function_space_diagnostics(np.asarray(res.samples)[:, hmc_cfg.burn_:, :], predict_fn,
                                    device=dev)
    fs.pop("probes")
    diag = out["diagnostics"]
    summary = {
        "workload": "cone_synthetic",
        "model_params": int(model.num_params),
        "subspace_dim": int(d_sub),
        "n_train": n_train, "n_valid": n_valid,
        "vi_epochs": vi_cfg.vi.epochs,
        "vi_valid_mse_best": float(m[:, 3].min()),
        "chains": chains, "draws": draws, "L": int(hmc_cfg.L),
        "acceptance_post_burn": acc,
        "expected_mse_of_mean": float(met["expected_mse_of_mean"]),
        "expected_log_prob": float(np.mean(np.asarray(met["expected_log_prob"]))),
        "ess_median": float(np.median(np.asarray(diag["ess"]))),
        "r_hat_max": float(np.nanmax(np.asarray(diag["r_hat"]))),
        "fs_r_hat_max": float(np.nanmax(fs["r_hat"])),
        "fs_r_hat_rank_max": float(np.nanmax(fs["r_hat_rank"])),
        "fs_ess_median": float(np.median(fs["ess"])),
        "fs_ess_bulk_median": float(np.median(fs["ess_bulk"])),
        "fs_ess_tail_median": float(np.median(fs["ess_tail"])),
        "sampling_seconds": wall,
        "vi_seconds": vi_s,
    }
    write_json(args.out, summary)
    json_line(None, summary)
    print(f"wrote {args.out}", flush=True)
    return summary


if __name__ == "__main__":
    main()
