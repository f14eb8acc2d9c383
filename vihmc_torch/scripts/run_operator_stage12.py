"""Stage 1 + 2 of the flagship operator demo (``scripts/run_operator_stage12.py``).

Trains the Bayesian DeepONet's VI stage at the reference minibatch regime
(batch 128, ``--p`` trunk points per example, ``num_ens`` 3, Adam 1e-3,
prior sigma 0.1, ``'mean_x_n'``), runs sensitivity at 90 % captured
variance (100 trunk points per validation function, chunks of 8) and writes:

- ``<out>/stage12/``: the run store (``means_flattened``,
  ``stds_flattened``, ``gradient_indices``, ``sensitivity_scores``, the
  metric rows, ``stage12_summary.json`` with the script's keys) that
  ``run_operator_stage3 --artifacts <out>/stage12`` reads; the port adds
  ``stage12_data.json``, the data parameters and the DeepONet, so stage 3
  regenerates the same data and builds the same model at any size;
- ``--assets``: the bundle with the keys of ``assets/burgers_stage12.npz``.

Built on :func:`vihmc_torch.pipelines.vi_train.run_stage12`. ``--small``
runs the script's small DeepONet on 32 + 16 functions of a 17 x 17 grid
(at most 5 epochs). ``--compare-loop N`` first times N epochs of the
Python-loop trainer (:func:`vihmc_torch.vi.train.train`, one step per
minibatch with the trailing partial batch kept) against N epochs of the
trainer path (:func:`vihmc_torch.vi.train.run_epochs`) on the same data and
config and prints ``[vi-path-compare] {...}``.

Differences from the script: ``--assets`` defaults to
``runs/torch_run_operator_stage12/burgers_stage12.npz`` (the script's
default overwrites the committed ``assets/burgers_stage12.npz``); the data
of data seed 0 on the 101 x 101 grid are the exported initial conditions
(``scripts/_common.burgers_splits``), other sizes a torch-drawn GRF::

    python -m vihmc_torch.scripts.run_operator_stage12 [--small] [--epochs 2400]
        [--patience 200] [--p 512] [--compare-loop N] [--out runs/op_r2/stage12]
        [--assets PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from vihmc_torch.core.device import resolve_device, stream_generator, sync
from vihmc_torch.core.precision import true_f32
from vihmc_torch.data.burgers import subsample_trunk
from vihmc_torch.models.bayesian import init_variational
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.pipelines import vi_train
from vihmc_torch.pipelines.common import deeponet_vi_apply
from vihmc_torch.scripts._common import (SMALL_DEEPONET, SMALL_SIZES, burgers_splits,
                                         check_output, json_line, runs_path)
from vihmc_torch.vi.train import init_train_state, train

NAME = "run_operator_stage12"
DATA_SEED = 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="stage 1 (VI) + stage 2 (sensitivity) of the "
                                             "flagship operator demo")
    ap.add_argument("--small", action="store_true", help="CPU smoke scale")
    ap.add_argument("--out", default="runs/op_r2/stage12")
    ap.add_argument("--assets", default=runs_path(NAME, "burgers_stage12.npz"),
                    help="the bundle (never under assets/)")
    ap.add_argument("--epochs", type=int, default=2400)
    ap.add_argument("--patience", type=int, default=200,
                    help="ReduceLROnPlateau patience")
    ap.add_argument("--p", type=int, default=512, help="trunk points per example during VI")
    ap.add_argument("--compare-loop", type=int, default=0,
                    help="also time N epochs of loop-vs-trainer VI paths")
    ap.add_argument("--device", default="cuda")
    return ap


def sizes(small: bool, epochs: int, p: int):
    """``(model, meta, epochs, p)`` of the script's two scales."""
    if small:
        meta = {"data_seed": DATA_SEED, **{k: SMALL_SIZES[k] for k in
                                          ("n_train", "n_valid", "nx", "nt")}}
        return SMALL_DEEPONET, meta, min(epochs, 5), SMALL_SIZES["p"]
    meta = {"data_seed": DATA_SEED, "n_train": 1000, "n_valid": 200, "nx": 101, "nt": 101}
    return DeepONetConfig(), meta, epochs, p


def compare_loop_path(model, data, p: int, epochs: int, dev) -> dict:
    """Time ``epochs`` epochs of the Python-loop VI path (one step per
    minibatch, host-side shuffle, the partial batch kept) against the
    trainer path at the same config and data (the script's
    ``compare_loop_path``); returns its summary keys."""
    train_split, valid_split = data
    n_train = train_split["branch_in"].shape[0]
    n_grid = train_split["trunk_in"].shape[0]
    op_cfg = vi_train.stage12_config(epochs, p, 20, n_train, valid_split["branch_in"].shape[0],
                                     model)
    apply_fn = deeponet_vi_apply(model, op_cfg.mode)
    vp = init_variational(model.num_params, stream_generator(dev, 0, vi_train._INIT_STREAM),
                          op_cfg.posterior_mu_initial, op_cfg.posterior_rho_initial,
                          device=dev)
    state = init_train_state(vp, op_cfg.vi)
    bs = op_cfg.batch_size

    def batches_fn(g, epoch):
        order = torch.randperm(n_train, generator=g, device=dev)
        out = []
        for start in range(0, n_train, bs):
            idx = order[start:start + bs]
            trunk, y = subsample_trunk({"trunk_in": train_split["trunk_in"],
                                        "solution": train_split["solution"][idx]}, p,
                                       generator=g)
            out.append({"branch": train_split["branch_in"][idx], "trunk": trunk, "y": y})
        return out

    nb = min(bs, valid_split["branch_in"].shape[0])
    valid_batch = {"branch": valid_split["branch_in"][:nb], "trunk": valid_split["trunk_in"],
                   "y": valid_split["solution"][:nb]}
    train_eval_batch = {"branch": train_split["branch_in"][:nb],
                        "trunk": train_split["trunk_in"], "y": train_split["solution"][:nb]}
    t0 = time.perf_counter()
    with true_f32():
        _, _, metrics_loop = train(apply_fn, state, op_cfg.vi, batches_fn, valid_batch,
                                   train_eval_batch, n_train * n_grid,
                                   generator=stream_generator(dev, 0, vi_train._TRAIN_STREAM))
    sync(dev)
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_scan = vi_train.run_operator(op_cfg, data=data, device=dev)
    sync(dev)
    scan_s = time.perf_counter() - t0
    return {"epochs": epochs, "loop_seconds": loop_s, "scan_seconds": scan_s,
            "loop_valid_mse_last": float(metrics_loop[-1, 3]),
            "scan_valid_mse_last": float(out_scan["metrics"][-1, 3])}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    check_output(args.out)
    check_output(args.assets)
    model, meta, epochs, p = sizes(args.small, args.epochs, args.p)
    print(f"artifacts -> {os.path.join(args.out, 'stage12')}", flush=True)
    t0 = time.perf_counter()
    data = burgers_splits(dev, **meta)
    sync(dev)
    print(f"[data] {meta['n_train']}+{meta['n_valid']} Burgers fns ({meta['nx']}x{meta['nt']}) "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    compare = None
    if args.compare_loop:
        compare = compare_loop_path(model, data, p, args.compare_loop, dev)
        json_line("vi-path-compare", compare)

    res = vi_train.run_stage12(device=dev, epochs=epochs, p=p, patience=args.patience,
                               out=args.out, model=model, data=data, meta=meta,
                               assets=args.assets, vi_path_compare=compare)
    s = res["summary"]
    m = res["vi"]["metrics"]
    print(f"[vi] {epochs} epochs in {s['vi_seconds']:.1f}s  valid_mse {m[0, 3]:.4f} -> "
          f"{m[-1, 3]:.4f} (best {m[:, 3].min():.4f} @epoch {int(m[:, 3].argmin())})",
          flush=True)
    print(f"[sensitivity] {s['num_sensitive']}/{len(res['sensitivity']['scores'])} in "
          f"{s['sensitivity_seconds']:.1f}s", flush=True)
    print(f"[assets] wrote {args.assets} ({os.path.getsize(args.assets) / 1e6:.1f} MB)",
          flush=True)
    summary = {**{k: s[k] for k in vi_train.STORE_SUMMARY_KEYS}, "vi_path_compare": compare}
    json_line(None, summary)
    json_line("stage12-port", {k: s[k] for k in ("device", "data_seconds", "seconds_per_epoch",
                                                 "epoch_wall_median", "best_epoch")})
    return summary


if __name__ == "__main__":
    main()
