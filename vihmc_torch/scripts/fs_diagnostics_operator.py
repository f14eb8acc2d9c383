"""Function-space convergence analysis of a saved stage-3 operator run
(``scripts/fs_diagnostics_operator.py``).

Reads a stage-3 run directory of either package (``demo_summary.json``, for
``burn``, ``draws`` and ``thin``, and ``hmc_params.npy`` (C, S, d)) and the
stage-1/2 bundle its draws belong to (``--assets``: ``mu``, ``indices`` and
the data parameters), then reports both views of convergence:

1. the Vehtari battery (split and rank R-hat, bulk and tail ESS) on
   posterior-predictive probe outputs, ``--probe-fns`` validation functions
   at ``--probe-pts`` grid points, every ``--thin``-th kept draw
   (:func:`vihmc_torch.pipelines.postprocess.function_space_diagnostics`);
2. weight-space mode evidence: the eight worst split-R-hat coordinates,
   the chain means of the worst one, whether they split into two basins
   (the largest gap in the sorted means above twice the within-chain spread
   and R-hat above 1.1) and each basin's mean probe MSE.

Writes the run's summary merged with the ``fs_*`` keys and
``weight_space_mode_evidence`` to ``--out`` (default
``<run>/fs_summary.json``). The probes run on the card unless ``--device
cpu``. The DeepONet is the one of the bundle's size (the reference one, or
``run_operator_stage12 --small``'s; the script always takes the reference
one); the data of data seed 0 on the 101 x 101 grid are the exported initial
conditions, other sizes a torch-drawn GRF (``scripts/_common.burgers_splits``)::

    python -m vihmc_torch.scripts.fs_diagnostics_operator --run runs/op_r2/stage3/<uid>
        [--assets runs/torch_run_operator_stage12/burgers_stage12.npz] [--thin 4]
        [--probe-fns 8] [--probe-pts 64] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from vihmc_torch.chains.diagnostics import potential_scale_reduction_np
from vihmc_torch.core.device import resolve_device
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.pipelines.common import make_flat_deeponet
from vihmc_torch.pipelines.postprocess import function_space_diagnostics
from vihmc_torch.scripts._common import (burgers_splits, check_output,
                                         deeponet_for, json_line, load_bundle, write_json)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="function-space diagnostics of a stage-3 run")
    ap.add_argument("--run", default="runs/op_r2/stage3/converged")
    ap.add_argument("--thin", type=int, default=4, help="probe every thin-th KEPT draw")
    ap.add_argument("--probe-fns", type=int, default=8)
    ap.add_argument("--probe-pts", type=int, default=64)
    ap.add_argument("--assets", default="assets/burgers_stage12.npz",
                    help="stage-1/2 bundle the run's draws belong to")
    ap.add_argument("--out", default=None,
                    help="summary json path (default <run>/fs_summary.json)")
    ap.add_argument("--device", default="cuda")
    return ap


def probe_set(valid: dict, nfn: int, npts: int):
    """``(branch (nfn, nx), trunk (npts', 2), truth (nfn, npts'))``: the
    first ``nfn`` validation functions at every ``P // npts``-th grid point."""
    n_pts = valid["trunk_in"].shape[0]
    stride = max(1, n_pts // npts)
    pt_idx = torch.arange(n_pts, device=valid["trunk_in"].device)[::stride][:npts]
    return (valid["branch_in"][:nfn], valid["trunk_in"][pt_idx],
            valid["solution"][:nfn][:, pt_idx].cpu().numpy())


def mode_evidence(x: np.ndarray, probes: np.ndarray, truth_p: np.ndarray) -> dict:
    """The script's weight-space mode evidence of kept draws ``x`` (C, S, d)
    and their probe outputs ``probes`` (C, S', nfn * npts)."""
    c = x.shape[0]
    rhat_w = potential_scale_reduction_np(x)
    worst = np.argsort(-rhat_w)[:8]
    cm0 = x[:, :, worst[0]].mean(axis=1)
    sd_within = float(x[:, :, worst[0]].std(axis=1).mean())
    srt = np.sort(cm0)
    gap = int(np.argmax(np.diff(srt)))
    basin_real = (float(np.diff(srt)[gap]) > 2.0 * sd_within
                  and float(rhat_w[worst[0]]) > 1.1)
    thr = 0.5 * (srt[gap] + srt[gap + 1])
    lo, hi = np.where(cm0 <= thr)[0], np.where(cm0 > thr)[0]
    pm = probes.mean(axis=1).reshape(c, *truth_p.shape)
    mse_chain = ((pm - truth_p[None]) ** 2).mean(axis=(1, 2))
    return {
        "worst_dims_subspace_idx": [int(i) for i in worst],
        "worst_dims_r_hat": [round(float(rhat_w[i]), 3) for i in worst],
        "worst_dim_chain_means": [round(float(v), 4) for v in cm0],
        "basin_split_significant": bool(basin_real),
        **({"basin_sizes": [int(len(lo)), int(len(hi))],
            "basin_mean_probe_mse": [float(mse_chain[lo].mean()),
                                     float(mse_chain[hi].mean())]}
           if basin_real else {}),
        "probe_mse_per_chain_spread": float(mse_chain.std()),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out_path = check_output(args.out or os.path.join(args.run, "fs_summary.json"))
    meta = load_bundle(args.assets)
    with open(os.path.join(args.run, "demo_summary.json")) as f:
        demo = json.load(f)
    # the run's recorded burn; draws // 5 is only the stage-3 default fallback
    burn = int(demo.get("burn") or int(demo["draws"]) // 5)
    burn_kept = burn // int(demo["thin"])
    samples = np.load(os.path.join(args.run, "hmc_params.npy"), mmap_mode="r")
    x = np.asarray(samples[:, burn_kept:, :])
    c, s, d = x.shape
    print(f"[load] {c} chains x {s} kept draws x {d} subspace dims", flush=True)

    _, valid = burgers_splits(dev, meta["data_seed"], meta["n_train"], meta["n_valid"],
                              meta["nx"], meta["nt"])
    branch_p, trunk_p, truth_p = probe_set(valid, args.probe_fns, args.probe_pts)
    apply_flat = make_flat_deeponet(deeponet_for(len(meta["mu"])))
    frozen = torch.as_tensor(meta["mu"], dtype=torch.float32, device=dev)
    idx = torch.as_tensor(np.asarray(meta["indices"]), dtype=torch.int64, device=dev)

    def predict_fn(q):
        with true_f32():
            return apply_flat(scatter_subspace(frozen, q, idx), branch_p,
                              trunk_p).reshape(q.shape[0], -1)

    diag = function_space_diagnostics(x, predict_fn, thin=args.thin, device=dev)
    probes = diag.pop("probes")
    summary = dict(demo)
    summary.update({
        "fs_probe_fns": args.probe_fns, "fs_probe_pts": int(trunk_p.shape[0]),
        "fs_probe_thin": args.thin,
        "fs_r_hat_max": float(np.nanmax(diag["r_hat"])),
        "fs_r_hat_rank_max": float(np.nanmax(diag["r_hat_rank"])),
        "fs_ess_median": float(np.median(diag["ess"])),
        "fs_ess_bulk_median": float(np.median(diag["ess_bulk"])),
        "fs_ess_bulk_min": float(np.min(diag["ess_bulk"])),
        "fs_ess_tail_median": float(np.median(diag["ess_tail"])),
        "weight_space_mode_evidence": mode_evidence(x, probes, truth_p),
    })
    write_json(out_path, summary)
    json_line(None, summary)
    return summary


if __name__ == "__main__":
    main()
