"""VI training pipelines (NN regression and the Burgers DeepONet), and the
stage-1/2 entry point.

Counterpart of ``vihmc_tpu/pipelines/vi_train.py`` (:35-289). With a
constant float ``beta_type`` (the shipped configs) ``run_nn`` trains
full-batch (``train_fullbatch_scan``) and ``run_operator`` minibatches the
functions (``_run_operator_scan``): every epoch reshuffles, drops the
trailing partial batch and draws ``cfg.p`` trunk points per example when
``p`` is below the grid; the epoch loop is
:func:`vihmc_torch.vi.train.run_epochs`. A string ``beta_type`` schedule
runs JAX's Python loop, :func:`vihmc_torch.vi.train.train`, whose operator
batches keep the trailing partial batch (JAX's ``make_batches``).
Evaluation uses the first ``min(batch_size, n)`` functions on the full
grid. Every random draw (the data, the initial ``mu``/``rho``, the
shuffles, the subsamples, the ensemble normals) comes from ``torch.Generator``
streams of ``seed``; the initial variational parameters can be injected
(``init_vp``). The operator data are Burgers (``mat_path``: the reference's
``.mat``) or Cone (JAX's dataset switch, vi_train.py:195-230: generated, or
read from ``mat_path``): Cone has per-example query points, ``trunk_in``
(N, 1, 2), which the DeepONet merges per example and which are never
subsampled. With ``learn_noise`` the metric rows of the operator pipeline
gain the ``exp(noise_param)`` column; the NN pipeline's constant-beta path
writes none, as JAX's full-batch scan.

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
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from vihmc_torch.core.device import resolve_device, split_to, stream_generator, to_f32
from vihmc_torch.core.precision import true_f32
from vihmc_torch.data.burgers import ASSETS, get_burgers, load_port_inputs, subsample_trunk
from vihmc_torch.data.cone import get_cone
from vihmc_torch.data.synthetic import regression_data
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.bayesian import BayesianFlat, init_variational
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.models.fno import FNO2dConfig
from vihmc_torch.pipelines import sensitivity
from vihmc_torch.pipelines.common import deeponet_vi_apply, fno_vi_apply, mlp_vi_apply
from vihmc_torch.pipelines.configs import (NNVIRunConfig, OperatorVIRunConfig,
                                           SensitivityRunConfig)
from vihmc_torch.sensitivity import flatten_mean_std
from vihmc_torch.vi.elbo import ELBOConfig
from vihmc_torch.vi.train import (VIConfig, VITrainer, check_vi_config, init_train_state,
                                  run_epochs, train)

#: generator streams of a run's seed (core/device.stream_generator)
_DATA_STREAM, _INIT_STREAM, _TRAIN_STREAM = 900_001, 900_002, 900_003
REPO = os.path.dirname(ASSETS)


def nn_data(cfg: NNVIRunConfig, seed: int, device) -> dict:
    """The synthetic regression data of :func:`run_nn` with ``seed``."""
    return regression_data(cfg.n_train, cfg.n_val, noise_std=cfg.noise,
                           generator=stream_generator(device, seed, _DATA_STREAM),
                           device=device)


def _operator_vi_apply(model, mode: str):
    """The VI trainer's apply of an operator model: the DeepONet's, or the
    FNO2d's (weight space, on the shared grid)."""
    if isinstance(model, FNO2dConfig):
        return fno_vi_apply(model, mode)
    return deeponet_vi_apply(model, mode)


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
            "model": None if trainer is None else trainer.model, "trainer": trainer}


def _train_loop(cfg, apply_fn, vp, batches, valid_batch, train_eval_batch, train_size, gen,
                store):
    """A string ``beta_type``: the functional trainer (``model`` and
    ``trainer`` are None in the result; the states are ``VITrainState``)."""
    def callback(epoch, row, st):
        if store is not None:
            store.append_metrics_row(row)

    with true_f32():
        return train(apply_fn, init_train_state(vp, cfg.vi), cfg.vi, batches, valid_batch,
                     train_eval_batch, train_size, generator=gen, callback=callback)


def run_nn(cfg: NNVIRunConfig = NNVIRunConfig(), seed: int = 0, data=None,
           store: Optional[RunStore] = None, init_vp=None, device="cuda") -> dict:
    """NN VI training, full batch (one step per epoch). Returns ``state`` and
    ``best_state`` (:class:`~vihmc_torch.vi.train.VIState`), ``metrics``
    (epochs, 4), ``data``, the ``model`` and its ``trainer``."""
    dev = resolve_device(device)
    check_vi_config(cfg.vi)
    data = nn_data(cfg, seed, dev) if data is None else split_to(data, dev)
    vp = _init_vp(cfg.model.num_params, cfg, init_vp, dev, seed)
    train_batch = {"x": data["x_train"], "y": data["y_train"]}
    valid_batch = {"x": data["x_val"], "y": data["y_val"]}
    gen = stream_generator(dev, seed, _TRAIN_STREAM)
    if not isinstance(cfg.vi.beta_type, float):
        final, best, metrics = _train_loop(
            cfg, mlp_vi_apply(cfg.model, cfg.mode), vp, lambda g, epoch: [train_batch],
            valid_batch, train_batch, data["x_train"].shape[0], gen, store)
        return _finish(cfg, None, final, best, metrics, data, store)
    model = BayesianFlat(mlp_vi_apply(cfg.model, cfg.mode), vp["mu"], vp["rho"])
    trainer = VITrainer(model, cfg.vi, train_size=data["x_train"].shape[0], generator=gen)
    callback = None if store is None else (lambda e, row, t: store.append_metrics_row(row))
    with true_f32():
        final, best, metrics = run_epochs(trainer, lambda epoch: [train_batch], valid_batch,
                                          train_batch, callback=callback, noise_column=False)
    return _finish(cfg, trainer, final, best, metrics, data, store)


def run_operator(cfg: OperatorVIRunConfig = OperatorVIRunConfig(), seed: int = 0,
                 data=None, store: Optional[RunStore] = None, init_vp=None,
                 device="cuda", epochs: Optional[int] = None, callback=None,
                 mat_path: Optional[str] = None) -> dict:
    """Operator VI training on Burgers or Cone (minibatched; see module doc).

    ``data``: ``(train, valid)`` dicts of ``branch_in``, ``trunk_in`` (a
    shared (P, 2) grid, or per-example points (N, p, 2)), ``solution``, or
    None for ``cfg.dataset``'s data: Burgers,
    :func:`~vihmc_torch.data.burgers.get_burgers` (``cfg.n_train`` and
    ``cfg.n_valid`` rows of the exported initial conditions, or of the
    ``.mat`` at ``mat_path``), or Cone, :func:`~vihmc_torch.data.cone.get_cone`
    (generated from the seed, or read from ``mat_path``). ``epochs``
    overrides ``cfg.vi.epochs`` (float ``beta_type``); ``callback(epoch,
    row, trainer)`` runs after each epoch. A ``cfg.model`` of
    :class:`~vihmc_torch.models.fno.FNO2dConfig` trains the Bayesian FNO2d
    (Burgers on the shared grid, ``p`` at the grid's points).
    """
    dev = resolve_device(device)
    check_vi_config(cfg.vi)
    if data is None:
        if cfg.dataset == "Cone":
            train, valid = get_cone(stream_generator(dev, seed, _DATA_STREAM), cfg.n_train,
                                    cfg.n_valid, mat_path, cfg.model.in_branch, device=dev)
        elif cfg.dataset == "Burgers":
            train, valid = get_burgers(dev, cfg.n_train, cfg.n_valid, mat_path=mat_path)
        else:
            # the reference's error surface (Operator_network/VI/utils.py:57)
            raise NotImplementedError(f"Dataset: {cfg.dataset} is NOT implemented. "
                                      f"Dataset should be Burgers or Cone")
    else:
        train, valid = (split_to(s, dev) for s in data)
    # per-example query points (Cone) or a shared grid; only a shared grid
    # is subsampled
    per_example = train["trunk_in"].ndim == 3
    n_train = train["branch_in"].shape[0]
    n_grid = train["trunk_in"].shape[-2] if per_example else train["trunk_in"].shape[0]
    bs = min(cfg.batch_size, n_train)
    n_batches = n_train // bs
    subsampling = not per_example and cfg.p < n_grid
    vp = _init_vp(cfg.model.num_params, cfg, init_vp, dev, seed)
    gen = stream_generator(dev, seed, _TRAIN_STREAM)
    nb = min(bs, valid["branch_in"].shape[0])

    def first(split):
        return {"branch": split["branch_in"][:nb],
                "trunk": split["trunk_in"][:nb] if per_example else split["trunk_in"],
                "y": split["solution"][:nb]}

    valid_batch, train_eval_batch = first(valid), first(train)

    def batch_of(idx, g):
        sol = train["solution"][idx]
        if subsampling:
            trunk, y = subsample_trunk({"trunk_in": train["trunk_in"], "solution": sol},
                                       cfg.p, generator=g)
        else:
            trunk = train["trunk_in"][idx] if per_example else train["trunk_in"]
            y = sol
        return {"branch": train["branch_in"][idx], "trunk": trunk, "y": y}

    if not isinstance(cfg.vi.beta_type, float):
        def all_batches(g, epoch):  # JAX's make_batches: the partial batch kept
            order = torch.randperm(n_train, generator=g, device=dev)
            return [batch_of(order[i:i + cfg.batch_size], g)
                    for i in range(0, n_train, cfg.batch_size)]

        final, best, metrics = _train_loop(
            cfg, _operator_vi_apply(cfg.model, cfg.mode), vp, all_batches, valid_batch,
            train_eval_batch, n_train * n_grid, gen, store)
        return _finish(cfg, None, final, best, metrics, (train, valid), store)
    model = BayesianFlat(_operator_vi_apply(cfg.model, cfg.mode), vp["mu"], vp["rho"])
    # the reference's train_size: N_train x trunk points
    trainer = VITrainer(model, cfg.vi, train_size=n_train * n_grid, generator=gen)

    def batches(epoch):
        order = torch.randperm(n_train, generator=gen, device=dev)[:n_batches * bs]
        for idx in order.view(n_batches, bs):
            yield batch_of(idx, gen)

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
                   n_train: int = 1000, n_valid: int = 200,
                   model: Optional[DeepONetConfig] = None) -> OperatorVIRunConfig:
    """The VI configuration of ``run_operator_stage12.py`` (reference scale
    unless ``model`` says otherwise)."""
    return OperatorVIRunConfig(
        model=DeepONetConfig() if model is None else model, n_train=n_train,
        n_valid=n_valid, batch_size=128, p=p,
        vi=VIConfig(epochs=epochs, lr_start=1e-3, patience=patience, num_ens=3,
                    prior_sigma=0.1,
                    elbo=ELBOConfig(reduction="mean_x_n", fixed_noise_var=1.0)))


#: the keys of the run store's ``stage12_summary.json``, the JAX script's
#: (with its ``vi_path_compare``)
STORE_SUMMARY_KEYS = ("valid_mse_first", "valid_mse_last", "valid_mse_best", "vi_seconds",
                      "sensitivity_seconds", "num_sensitive", "subspace_frac")


def run_stage12(device="cuda", epochs: int = 400, p: int = 512, patience: int = 200,
                seed: int = 0, out: Optional[str] = None, progress=None,
                model: Optional[DeepONetConfig] = None, data=None, meta: Optional[dict] = None,
                assets: Optional[str] = None, vi_path_compare: Optional[dict] = None) -> dict:
    """Stage 1 and stage 2; returns the summary, and with ``out`` writes
    ``<out>/stage12/`` (the run store, with ``stage12_summary.json``, the
    ``STORE_SUMMARY_KEYS`` of the summary and ``vi_path_compare``, and the
    data's ``meta`` and the model as ``stage12_data.json``) and the bundle
    with the keys of the committed asset at ``assets`` (default
    ``<out>/burgers_stage12.npz``).

    By default the reference DeepONet on the exported Burgers inputs (1000 +
    200 functions, 101 x 101); ``model`` with ``data`` ``(train, valid)`` and
    its ``meta`` (``data_seed``, ``n_train``, ``n_valid``, ``nx``, ``nt``)
    run another size."""
    dev = resolve_device(device)
    if meta is None:
        grid = load_port_inputs()
        meta = {"data_seed": 0, **{k: int(grid[k]) for k in ("n_train", "n_valid", "nx", "nt")}}
    n_train, n_valid, nx, nt = (int(meta[k]) for k in ("n_train", "n_valid", "nx", "nt"))
    store = RunStore(out, uid="stage12") if out else None
    cfg = stage12_config(epochs, p, patience, n_train, n_valid, model)
    t0 = time.perf_counter()
    data = get_burgers(dev, n_train, n_valid) if data is None else data
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
        assets = os.path.join(out, "burgers_stage12.npz") if assets is None else assets
        os.makedirs(os.path.dirname(os.path.abspath(assets)), exist_ok=True)
        np.savez_compressed(
            assets,
            mu=np.asarray(sens["mu"], np.float32), sigma=np.asarray(sens["sigma"], np.float32),
            indices=np.asarray(sens["indices"], np.int32),
            scores=np.asarray(sens["scores"], np.float32),
            data_seed=int(meta["data_seed"]), n_train=n_train, n_valid=n_valid, nx=nx, nt=nt,
            vi_epochs=epochs, vi_p=p, vi_valid_mse=np.asarray(m[:, 3], np.float32))
        store.save_config({**{k: summary[k] for k in STORE_SUMMARY_KEYS},
                           "vi_path_compare": vi_path_compare}, name="stage12_summary")
        store.save_config({**meta, "model": dataclasses.asdict(cfg.model)},
                          name="stage12_data")
    return {"summary": summary, "vi": vi_out, "sensitivity": sens, "data": data,
            "store": store, "assets": assets}


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
