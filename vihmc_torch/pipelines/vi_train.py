"""VI training pipelines (NN regression and the Burgers DeepONet), and the
stage-1/2 entry point.

Counterpart of ``vihmc_tpu/pipelines/vi_train.py`` (:35-289) on its
float-beta paths: ``run_nn`` trains full-batch (``train_fullbatch_scan``),
``run_operator`` minibatches the functions (``_run_operator_scan``): every
epoch reshuffles, drops the trailing partial batch and draws ``cfg.p`` trunk
points per example when ``p`` is below the grid; evaluation uses the first
``min(batch_size, n)`` functions on the full grid. The epoch loop is
:func:`vihmc_torch.vi.train.run_epochs`. Every random draw (the data noise,
the initial ``mu``/``rho``, the shuffles, the subsamples, the ensemble
normals) comes from one ``torch.Generator`` seeded with ``seed``; the
initial variational parameters can be injected (``init_vp``). The Cone
dataset is not ported and raises ``NotImplementedError``.

The entry point runs stage 1 and stage 2 of the operator pipeline on the
card at the configuration of ``scripts/run_operator_stage12.py`` that made
``assets/burgers_stage12_r2.npz`` (reference DeepONet, 1000 training and
200 validation functions, batch 128, 512 trunk points per example,
``num_ens`` 3, Adam 1e-3, prior sigma 0.1, ``'mean_x_n'``, 400 epochs; then
sensitivity on the validation functions with 100 trunk points each, chunks of
8, threshold 0.90) and writes a bundle with that asset's keys under
``runs/`` (never into ``assets/``)::

    python -m vihmc_torch.pipelines.vi_train [--epochs 400] [--p 512] [--patience 200]
        [--device cuda] [--out runs/torch_stage12]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from vihmc_torch.core.device import resolve_device, split_to, stream_generator, to_f32
from vihmc_torch.core.precision import true_f32
from vihmc_torch.data.burgers import ASSETS, get_burgers, load_port_inputs, subsample_trunk
from vihmc_torch.data.synthetic import regression_data
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.bayesian import BayesianFlat, init_variational
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.pipelines import sensitivity
from vihmc_torch.pipelines.common import deeponet_vi_apply, mlp_vi_apply
from vihmc_torch.pipelines.configs import (NNVIRunConfig, OperatorVIRunConfig,
                                           SensitivityRunConfig)
from vihmc_torch.sensitivity import flatten_mean_std
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import VIConfig, VITrainer, check_vi_config, run_epochs

#: generator streams of a run's seed (core/device.stream_generator)
_DATA_STREAM, _INIT_STREAM, _TRAIN_STREAM = 900_001, 900_002, 900_003
REPO = os.path.dirname(ASSETS)


def _init_vp(num_params, cfg, init_vp, dev, seed):
    if init_vp is None:
        return init_variational(num_params, stream_generator(dev, seed, _INIT_STREAM),
                                cfg.posterior_mu_initial, cfg.posterior_rho_initial,
                                device=dev)
    return {k: to_f32(init_vp[k], dev) for k in ("mu", "rho")}


def _save_vi_posterior(store: RunStore, best_state):
    """The best posterior as flat ``vi_mu_flattened``/``vi_sigma_flattened``
    arrays, so the sensitivity stage can run against a finished VI run."""
    flat_mu, flat_sigma = flatten_mean_std(best_state.vp)
    store.save_array("vi_mu_flattened", flat_mu.cpu().numpy())
    store.save_array("vi_sigma_flattened", flat_sigma.cpu().numpy())


def _finish(cfg, trainer, final, best, metrics, data, store):
    if store is not None:
        store.save_config(cfg)
        _save_vi_posterior(store, best)
    return {"state": final, "best_state": best, "metrics": metrics, "data": data,
            "model": trainer.model, "trainer": trainer}


def run_nn(cfg: NNVIRunConfig = NNVIRunConfig(), seed: int = 0, data=None,
           store: Optional[RunStore] = None, init_vp=None, device="cuda") -> dict:
    """NN VI training, full batch (one step per epoch). Returns ``state`` and
    ``best_state`` (:class:`~vihmc_torch.vi.train.VIState`), ``metrics``
    (epochs, 4), ``data``, the ``model`` and its ``trainer``."""
    dev = resolve_device(device)
    check_vi_config(cfg.vi)
    if data is None:
        data = regression_data(cfg.n_train, cfg.n_val, noise_std=cfg.noise,
                               generator=stream_generator(dev, seed, _DATA_STREAM), device=dev)
    else:
        data = split_to(data, dev)
    vp = _init_vp(cfg.model.num_params, cfg, init_vp, dev, seed)
    model = BayesianFlat(mlp_vi_apply(cfg.model, cfg.mode), vp["mu"], vp["rho"])
    trainer = VITrainer(model, cfg.vi, train_size=data["x_train"].shape[0],
                        generator=stream_generator(dev, seed, _TRAIN_STREAM))
    train_batch = {"x": data["x_train"], "y": data["y_train"]}
    valid_batch = {"x": data["x_val"], "y": data["y_val"]}
    callback = None if store is None else (lambda e, row, t: store.append_metrics_row(row))
    with true_f32():
        final, best, metrics = run_epochs(trainer, lambda epoch: [train_batch], valid_batch,
                                          train_batch, callback=callback)
    return _finish(cfg, trainer, final, best, metrics, data, store)


def run_operator(cfg: OperatorVIRunConfig = OperatorVIRunConfig(), seed: int = 0,
                 data=None, store: Optional[RunStore] = None, init_vp=None,
                 device="cuda", epochs: Optional[int] = None, callback=None) -> dict:
    """Operator VI training on Burgers (minibatched; see module doc).

    ``data``: ``(train, valid)`` dicts of ``branch_in``, ``trunk_in`` (a
    shared (P, 2) grid), ``solution``, or None for
    :func:`~vihmc_torch.data.burgers.get_burgers` (``cfg.n_train`` and
    ``cfg.n_valid`` rows of the exported initial conditions). ``epochs``
    overrides ``cfg.vi.epochs``; ``callback(epoch, row, trainer)`` runs after
    each epoch.
    """
    dev = resolve_device(device)
    if cfg.dataset != "Burgers":
        raise NotImplementedError(f"dataset {cfg.dataset!r} is not ported (Burgers only)")
    check_vi_config(cfg.vi)
    if data is None:
        train, valid = get_burgers(dev, cfg.n_train, cfg.n_valid)
    else:
        train, valid = (split_to(s, dev) for s in data)
    if train["trunk_in"].ndim != 2:
        raise NotImplementedError("per-example query datasets (Cone) are not ported")
    n_train, n_grid = train["branch_in"].shape[0], train["trunk_in"].shape[0]
    bs = min(cfg.batch_size, n_train)
    n_batches = n_train // bs
    subsampling = cfg.p < n_grid
    vp = _init_vp(cfg.model.num_params, cfg, init_vp, dev, seed)
    model = BayesianFlat(deeponet_vi_apply(cfg.model, cfg.mode), vp["mu"], vp["rho"])
    gen = stream_generator(dev, seed, _TRAIN_STREAM)
    # the reference's train_size: N_train x trunk points
    trainer = VITrainer(model, cfg.vi, train_size=n_train * n_grid, generator=gen)

    def batches(epoch):
        order = torch.randperm(n_train, generator=gen, device=dev)[:n_batches * bs]
        for idx in order.view(n_batches, bs):
            branch = train["branch_in"][idx]
            sol = train["solution"][idx]
            if subsampling:
                trunk, y = subsample_trunk({"trunk_in": train["trunk_in"], "solution": sol},
                                           cfg.p, generator=gen)
            else:
                trunk, y = train["trunk_in"], sol
            yield {"branch": branch, "trunk": trunk, "y": y}

    nb = min(bs, valid["branch_in"].shape[0])
    valid_batch = {"branch": valid["branch_in"][:nb], "trunk": valid["trunk_in"],
                   "y": valid["solution"][:nb]}
    train_eval_batch = {"branch": train["branch_in"][:nb], "trunk": train["trunk_in"],
                        "y": train["solution"][:nb]}

    def on_epoch(epoch, row, t):
        if store is not None:
            store.append_metrics_row(row)
        if callback is not None:
            callback(epoch, row, t)

    with true_f32():
        final, best, metrics = run_epochs(trainer, batches, valid_batch, train_eval_batch,
                                          epochs=epochs, callback=on_epoch)
    return _finish(cfg, trainer, final, best, metrics, (train, valid), store)


# ---------------------------------------------------------------------------
# The stage-1/2 entry point (scripts/run_operator_stage12.py, full scale)
# ---------------------------------------------------------------------------

def stage12_config(epochs: int = 400, p: int = 512, patience: int = 200,
                   n_train: int = 1000, n_valid: int = 200) -> OperatorVIRunConfig:
    """The VI configuration of ``run_operator_stage12.py`` (reference scale)."""
    return OperatorVIRunConfig(
        model=DeepONetConfig(), n_train=n_train, n_valid=n_valid, batch_size=128, p=p,
        vi=VIConfig(epochs=epochs, lr_start=1e-3, patience=patience, num_ens=3,
                    prior_sigma=0.1,
                    elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=1.0)))


def run_stage12(device="cuda", epochs: int = 400, p: int = 512, patience: int = 200,
                seed: int = 0, out: Optional[str] = None, progress=None) -> dict:
    """Stage 1 and stage 2 at full scale; returns the summary, and with
    ``out`` writes ``<out>/stage12/`` (the run store) and
    ``<out>/burgers_stage12.npz`` with the keys of the committed asset."""
    dev = resolve_device(device)
    grid = load_port_inputs()
    n_train, n_valid = int(grid["n_train"]), int(grid["n_valid"])
    nx, nt = int(grid["nx"]), int(grid["nt"])
    store = RunStore(out, uid="stage12") if out else None
    cfg = stage12_config(epochs, p, patience, n_train, n_valid)
    t0 = time.perf_counter()
    data = get_burgers(dev, n_train, n_valid)
    t_data = time.perf_counter() - t0
    epoch_walls = []
    t_last = [time.perf_counter()]

    def on_epoch(epoch, row, trainer):
        now = time.perf_counter()
        epoch_walls.append(now - t_last[0])
        t_last[0] = now
        if progress is not None:
            progress(epoch, row)

    t0 = t_last[0] = time.perf_counter()
    vi_out = run_operator(cfg, seed=seed, data=data, store=store, device=dev,
                          callback=on_epoch)
    vi_s = time.perf_counter() - t0
    m = vi_out["metrics"]

    t0 = time.perf_counter()
    sens = sensitivity.run_operator(
        vi_out["best_state"].vp, cfg.model, data[1],
        SensitivityRunConfig(importance_threshold=0.90, p_subsample=min(100, nx * nt),
                             batch_chunk=8), seed=seed, store=store)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sens_s = time.perf_counter() - t0
    summary = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "epochs": epochs, "p": p, "patience": patience,
        "valid_mse_first": float(m[0, 3]), "valid_mse_last": float(m[-1, 3]),
        "valid_mse_best": float(m[:, 3].min()), "best_epoch": int(m[:, 3].argmin()),
        "data_seconds": t_data, "vi_seconds": vi_s,
        "seconds_per_epoch": vi_s / max(len(m), 1),
        "epoch_wall_median": float(np.median(epoch_walls)) if epoch_walls else None,
        "sensitivity_seconds": sens_s,
        "num_sensitive": int(sens["num_sensitive"]),
        "subspace_frac": sens["num_sensitive"] / len(sens["scores"]),
    }
    if out:
        np.savez_compressed(
            os.path.join(out, "burgers_stage12.npz"),
            mu=np.asarray(sens["mu"], np.float32), sigma=np.asarray(sens["sigma"], np.float32),
            indices=np.asarray(sens["indices"], np.int32),
            scores=np.asarray(sens["scores"], np.float32),
            data_seed=0, n_train=n_train, n_valid=n_valid, nx=nx, nt=nt,
            vi_epochs=epochs, vi_p=p, vi_valid_mse=np.asarray(m[:, 3], np.float32))
        store.save_config(summary, name="stage12_summary")
    return {"summary": summary, "vi": vi_out, "sensitivity": sens}


def main(argv=None):
    ap = argparse.ArgumentParser(description="stage 1 (VI) + stage 2 (sensitivity) of the "
                                             "Burgers DeepONet at reference scale")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--p", type=int, default=512, help="trunk points per example during VI")
    ap.add_argument("--patience", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "torch_stage12"),
                    help="output directory (under runs/, never assets/)")
    args = ap.parse_args(argv)
    out_dir = os.path.abspath(args.out)
    if os.path.commonpath([out_dir, ASSETS]) == ASSETS:
        raise ValueError("the stage-1/2 bundle is written under runs/, never into assets/")
    res = run_stage12(device=args.device, epochs=args.epochs, p=args.p,
                      patience=args.patience, seed=args.seed, out=out_dir,
                      progress=lambda e, row: print(
                          f"epoch {e}: " + " ".join(f"{v:.6g}" for v in row), flush=True)
                      if e % 20 == 0 else None)
    print(json.dumps(res["summary"]))


if __name__ == "__main__":
    main()
