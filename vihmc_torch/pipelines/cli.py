"""Command-line entry points of the port, one subcommand per reference script.

Counterpart of ``vihmc_tpu/pipelines/cli.py``: the same subcommands, flags,
defaults and printed lines, run on the port's pipelines::

    python -m vihmc_torch <command> [flags]

    vi-nn | vi-operator | sensitivity | vi-hmc | reevaluate | predict |
    hmc-full | hmc-nuts | hmc-split | postprocess | bench

Every command that computes takes one more flag, ``--device`` (default
``cuda``; ``--device cpu`` runs on the CPU). Flags override the typed config
defaults; every run writes its artifacts and a JSON config snapshot into
``--out/<uid>`` through :class:`~vihmc_torch.io.artifacts.RunStore`, with the
JAX package's file names (``vi_mu_flattened``, ``vi_sigma_flattened``,
``means_flattened``, ``stds_flattened``, ``gradient_indices``,
``hmc_params``, ``vi_params``, ``config``, ``output``), so ``reevaluate``
reads a run that either package's ``vi-hmc`` wrote.

Where the port differs: the data of a seed are the port's own streams, so a
standalone ``sensitivity`` or a ``reevaluate`` of ``--workload nn`` sees the
data of the ``vi-nn`` / ``vi-hmc`` run of the same ``--seed`` (JAX's see
data of another key); without ``--mat`` the Burgers data are the exported
initial conditions, whose 200 validation rows cap ``--n-valid``;
``vi-operator --dataset Cone`` generates the Cone data from ``--seed`` (or
reads ``--mat``, a Cone ``.mat``/``.npz``);
``reevaluate`` and ``predict`` score against each chain's last frozen
vector when the run stored its VI trace (``vi_params``), the base its own
evaluation used, else against the VI mean as JAX does; ``bench`` runs the
port's ``python -m vihmc_torch.bench [--quick] --device D``, never ``bench.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np


def _common(p):
    p.add_argument("--out", default="runs", help="artifact root directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--uid", default=None, help="run uid (default: timestamp)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")


def _print_metrics(metrics):
    out = {}
    for k, v in metrics.items():
        arr = np.asarray(v)
        out[k] = float(arr) if arr.ndim == 0 else arr.shape
    print(json.dumps(out, default=str, indent=2))


def build_parser():
    ap = argparse.ArgumentParser(prog="vihmc_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("hmc-full", help="full-parameter HMC, regression MLP")
    _common(p)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--step-size", type=float, default=None)
    p.add_argument("--num-chains", type=int, default=None)

    p = sub.add_parser("vi-nn", help="VI training, regression MLP")
    _common(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--mode", choices=["bbb", "lrt"], default=None)
    p.add_argument("--with-sensitivity", action="store_true",
                   help="also run the sensitivity stage, writing the "
                        "VI-HMC artifact contract into the same run store")
    p.add_argument("--threshold", type=float, default=0.90)

    p = sub.add_parser("vi-operator", help="VI training, Bayesian DeepONet")
    _common(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--dataset", choices=["Burgers", "Cone"], default=None)
    p.add_argument("--mat", default=None,
                   help="path to DeepOnet_data.mat (Burgers) or a Cone "
                        ".mat/.npz with Xf/Xp/Y keys")
    p.add_argument("--n-train", type=int, default=None)
    p.add_argument("--n-valid", type=int, default=None)
    p.add_argument("--with-sensitivity", action="store_true")
    p.add_argument("--threshold", type=float, default=0.90)

    p = sub.add_parser("vi-hmc", help="subspace VI-HMC from sensitivity artifacts")
    _common(p)
    p.add_argument("--artifacts", required=True, help="RunStore uid dir with "
                   "means_flattened/stds_flattened/gradient_indices")
    p.add_argument("--workload", choices=["nn", "operator"], default="nn")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--num-chains", type=int, default=None)
    p.add_argument("--policy", choices=["mean", "draw", "refresh"], default=None)
    p.add_argument("--algorithm", choices=["hmc", "nuts", "chees", "auto"], default=None,
                   help="hmc = reference behavior; nuts/chees adapt the trajectory length")
    p.add_argument("--save-vi-trace", action="store_true",
                   help="persist the per-draw frozen VI draw ('vi_params')")
    p.add_argument("--jitter-l", action="store_true",
                   help="jitter the trajectory length over [L/2, L]")
    p.add_argument("--jitter-eps", action="store_true",
                   help="jitter the step size over [eps/2, eps] instead")
    p.add_argument("--clip-grad", type=float, default=None,
                   help="preconditioned grad-norm clip on the trajectory field")
    p.add_argument("--coarse-stride", type=int, default=None,
                   help="Gram field on every stride-th query point per grid dim")
    p.add_argument("--fn-stride", type=int, default=None,
                   help="Gram field on every stride-th training function")
    p.add_argument("--gauss-field", type=float, default=None,
                   help="VI-Gaussian trajectory field with this alpha")
    p.add_argument("--gauss-field-auto", action="store_true",
                   help="probe the VI-Gaussian field and keep it if its acceptance "
                        "clears the floor")
    p.add_argument("--adapt-step-size", action="store_true",
                   help="dual-averaging step adaptation during burn")
    p.add_argument("--da-axis", action="store_true",
                   help="couple dual averaging across chains")
    p.add_argument("--adapt-forever", action="store_true",
                   help="diminishing adaptation past burn")
    p.add_argument("--target-accept", type=float, default=None)
    p.add_argument("--laplace-mass", action="store_true",
                   help="kinetic metric from the stage-2 Fisher instead of VI sigma^2")
    p.add_argument("--lowrank-rank", type=int, default=None, metavar="K",
                   help="low-rank+diagonal kinetic metric (Lanczos on conditional HVPs)")
    p.add_argument("--init-optimize", type=int, default=None, metavar="N",
                   help="warm-start chain inits with N preconditioned Adam steps")
    p.add_argument("--grad-dtype", choices=["float32", "bfloat16"], default=None,
                   help="Gram trajectory-gradient datapath dtype (operator workload)")
    p.add_argument("--segment", type=int, default=None,
                   help="run in checkpointed segments of this many draws "
                        "(resumable with --ckpt)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir for mid-run resume (with --segment)")
    p.add_argument("--thin", type=int, default=1,
                   help="keep every thin-th draw (segmented runs)")
    p.add_argument("--mat", default=None)

    p = sub.add_parser("sensitivity", help="standalone sensitivity stage "
                       "against a finished VI run (reads vi_mu/sigma_flattened)")
    _common(p)
    p.add_argument("--vi-run", required=True,
                   help="RunStore uid dir of a finished vi-nn/vi-operator run")
    p.add_argument("--workload", choices=["nn", "operator"], default="nn")
    p.add_argument("--threshold", type=float, default=0.90)
    p.add_argument("--mat", default=None)

    p = sub.add_parser("reevaluate", help="reload saved hmc_params and "
                       "re-score on validation data without sampling")
    _common(p)
    p.add_argument("--run", required=True,
                   help="RunStore uid dir containing hmc_params.npy")
    p.add_argument("--artifacts", default=None,
                   help="RunStore uid dir with means/stds/gradient_indices "
                        "(default: --run itself)")
    p.add_argument("--workload", choices=["nn", "operator"], default="nn")
    p.add_argument("--burn", type=int, default=None)
    p.add_argument("--mat", default=None)

    p = sub.add_parser("predict", help="posterior predictive from saved "
                       "hmc_params: persist thinned predictions + mean prediction")
    _common(p)
    p.add_argument("--run", required=True)
    p.add_argument("--artifacts", default=None)
    p.add_argument("--workload", choices=["nn", "operator"], default="nn")
    p.add_argument("--burn", type=int, default=None)
    p.add_argument("--keep", type=int, default=64,
                   help="number of thinned posterior-predictive samples kept")
    p.add_argument("--mat", default=None)

    p = sub.add_parser("hmc-nuts", help="full-parameter DeepONet HMC + adaptation")
    _common(p)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--mat", default=None)

    p = sub.add_parser("hmc-split", help="split-Hamiltonian DeepONet HMC")
    _common(p)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--num-splits", type=int, default=None)
    p.add_argument("--nuts", action="store_true")
    p.add_argument("--mat", default=None)

    p = sub.add_parser("postprocess", help="stack saved runs and print error metrics")
    p.add_argument("--runs", nargs="+", required=True,
                   help="run directories (each containing hmc_params.npy)")
    p.add_argument("--burn", type=int, default=0)
    p.add_argument("--out", default=None, help="save stacked samples here (.npy)")

    p = sub.add_parser("bench", help="run the ESS/s benchmark (python -m vihmc_torch.bench)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return ap


def _override(cfg, **updates):
    updates = {k: v for k, v in updates.items() if v is not None}
    return dataclasses.replace(cfg, **updates) if updates else cfg


def _open(run_dir: str):
    from vihmc_torch.io.artifacts import RunStore

    root, uid = os.path.split(run_dir.rstrip("/"))
    return RunStore.open(root or ".", uid)


def _artifacts(run_dir: str) -> dict:
    store = _open(run_dir)
    return {"mu": store.load_array("means_flattened"),
            "sigma": store.load_array("stds_flattened"),
            "indices": store.load_array("gradient_indices")}


def _burgers(n_train, n_valid, mat, dev):
    """Operator data of the subcommands: the ``.mat``'s rows, or the exported
    initial conditions with ``n_valid`` capped at their validation rows."""
    from vihmc_torch.data.burgers import get_burgers, load_port_inputs

    if mat is None:
        exported = int(load_port_inputs()["n_valid"])
        if n_valid > exported:
            print(f"n_valid {n_valid} capped at the {exported} exported validation rows "
                  f"(pass --mat for the reference's data)", file=sys.stderr)
            n_valid = exported
    return get_burgers(dev, n_train, n_valid, mat_path=mat)


def _reevaluate(args, dev):
    """Shared reevaluate/predict flow: rebuild the run's config from its
    snapshot, reload hmc_params, re-score."""
    from vihmc_torch.pipelines import configs as C
    from vihmc_torch.pipelines import vi_hmc

    run_store = _open(args.run)
    artifacts = _artifacts(args.artifacts or args.run)
    saved = run_store.load_config()
    fields = {f.name for f in dataclasses.fields(C.VIHMCRunConfig)}
    cfg = C.VIHMCRunConfig(**{k: v for k, v in saved.items() if k in fields})
    if args.burn is not None:
        cfg = dataclasses.replace(cfg, burn=args.burn)
    base = None
    if os.path.exists(os.path.join(run_store.path, "vi_params.npy")):
        base = run_store.load_array("vi_params")[:, -1]   # each chain's last frozen vector
    keep = getattr(args, "keep", 64)
    if args.workload == "nn":
        return vi_hmc.reevaluate_nn(cfg, C.NNVIRunConfig().model, artifacts, run_store,
                                    seed=args.seed, frozen_base=base, keep_predictions=keep,
                                    device=dev)
    data = _burgers(1000, 1000, args.mat, dev)
    return vi_hmc.reevaluate_operator(cfg, C.OperatorVIRunConfig().model, artifacts,
                                      run_store, data=data, frozen_base=base,
                                      keep_predictions=keep, device=dev)


def _bench(args) -> int:
    return subprocess.call([sys.executable, "-m", "vihmc_torch.bench", "--device",
                            args.device] + (["--quick"] if args.quick else []))


def _postprocess(args) -> int:
    from vihmc_torch.pipelines.postprocess import stack_runs

    stores = [_open(r) for r in args.runs]
    stacked = stack_runs(stores, burn=args.burn)
    print(f"stacked {stacked.shape[0]} post-burn samples "
          f"(dim {stacked.shape[1]}) from {len(stores)} runs")
    print(f"pooled mean |theta|: {np.abs(stacked).mean():.5f}   "
          f"pooled std: {stacked.std(axis=0).mean():.5f}")
    if args.out:
        np.save(args.out, stacked)
        print(f"saved -> {args.out}")
    return 0


def run(argv=None):
    """Parse ``argv`` and run the command: ``(exit code, the pipeline's
    result dict or None)``."""
    from vihmc_torch.core.device import resolve_device
    from vihmc_torch.io.artifacts import RunStore
    from vihmc_torch.pipelines import configs as C
    from vihmc_torch.pipelines import hmc_full, hmc_nuts, hmc_split
    from vihmc_torch.pipelines import sensitivity as sens_p
    from vihmc_torch.pipelines import vi_hmc, vi_train

    args = build_parser().parse_args(argv)
    if args.command == "bench":
        return _bench(args), None
    if args.command == "postprocess":
        return _postprocess(args), None

    dev = resolve_device(args.device)
    store = RunStore(args.out, uid=args.uid)
    print(f"run uid: {store.uid}  ->  {store.path}")
    seed = args.seed

    if args.command == "hmc-full":
        cfg = _override(C.NNHMCRunConfig(), num_samples=args.num_samples,
                        step_size=args.step_size, num_chains=args.num_chains)
        out = hmc_full.run(cfg, store=store, seed=seed, device=dev)
        _print_metrics(out["metrics"])
    elif args.command == "vi-nn":
        cfg = C.NNVIRunConfig()
        vi = _override(cfg.vi, epochs=args.epochs, lr_start=args.lr)
        cfg = _override(cfg, vi=vi, mode=args.mode)
        out = vi_train.run_nn(cfg, seed=seed, store=store, device=dev)
        print("final metrics row:", out["metrics"][-1].tolist())
        if args.with_sensitivity:
            sens = sens_p.run_nn(out["best_state"].vp, cfg.model, out["data"]["x_val"],
                                 C.SensitivityRunConfig(importance_threshold=args.threshold),
                                 store=store)
            print(f"sensitive params: {sens['num_sensitive']} "
                  f"(artifacts in {store.path})")
    elif args.command == "vi-operator":
        cfg = C.OperatorVIRunConfig()
        vi = _override(cfg.vi, epochs=args.epochs)
        cfg = _override(cfg, vi=vi, n_train=args.n_train, n_valid=args.n_valid,
                        dataset=args.dataset)
        data = (_burgers(cfg.n_train, cfg.n_valid, args.mat, dev)
                if cfg.dataset == "Burgers" else None)
        out = vi_train.run_operator(cfg, seed=seed, data=data, store=store, device=dev,
                                    mat_path=args.mat)
        print("final metrics row:", out["metrics"][-1].tolist())
        if args.with_sensitivity:
            sens = sens_p.run_operator(out["best_state"].vp, cfg.model, out["data"][1],
                                       C.SensitivityRunConfig(importance_threshold=args.threshold),
                                       seed=seed, store=store)
            print(f"sensitive params: {sens['num_sensitive']} "
                  f"(artifacts in {store.path})")
    elif args.command == "vi-hmc":
        artifacts = _artifacts(args.artifacts)
        jitter = args.jitter_l or args.jitter_eps
        cfg = _override(C.VIHMCRunConfig(), num_samples=args.num_samples,
                        num_chains=args.num_chains, frozen_policy=args.policy,
                        algorithm=args.algorithm,
                        save_vi_trace=True if args.save_vi_trace else None,
                        jitter_l=True if args.jitter_l else None,
                        jitter_eps=True if args.jitter_eps else None,
                        jitter_low_frac=0.5 if jitter else None,
                        clip_grad=args.clip_grad, coarse_stride=args.coarse_stride,
                        fn_stride=args.fn_stride, gauss_field=args.gauss_field,
                        gauss_field_auto=True if args.gauss_field_auto else None,
                        adapt_step_size=True if args.adapt_step_size else None,
                        da_axis="chains" if args.da_axis else None,
                        adapt_forever=True if args.adapt_forever else None,
                        target_accept=args.target_accept,
                        laplace_mass=True if args.laplace_mass else None,
                        lowrank_rank=args.lowrank_rank, init_optimize=args.init_optimize,
                        grad_dtype=args.grad_dtype)
        seg_kw = dict(segment_size=args.segment, checkpoint_dir=args.ckpt,
                      sample_thin=args.thin, store=store, seed=seed, device=dev)
        if args.workload == "nn":
            out = vi_hmc.run_nn(cfg, C.NNVIRunConfig().model, artifacts, **seg_kw)
        else:
            out = vi_hmc.run_operator(cfg, C.OperatorVIRunConfig().model, artifacts,
                                      mat_path=args.mat, **seg_kw)
        _print_metrics(out["metrics"])
    elif args.command == "sensitivity":
        vi_store = _open(args.vi_run)
        flat_mu = vi_store.load_array("vi_mu_flattened")
        flat_sigma = vi_store.load_array("vi_sigma_flattened")
        scfg = C.SensitivityRunConfig(importance_threshold=args.threshold)
        if args.workload == "nn":
            nn_cfg = C.NNVIRunConfig()
            data = vi_train.nn_data(nn_cfg, seed, dev)
            out = sens_p.run_nn_flat(flat_mu, flat_sigma, nn_cfg.model, data["x_val"], scfg,
                                     store=store)
        else:
            op_cfg = C.OperatorVIRunConfig()
            _, valid = _burgers(op_cfg.n_train, op_cfg.n_valid, args.mat, dev)
            out = sens_p.run_operator_flat(flat_mu, flat_sigma, op_cfg.model, valid, scfg,
                                           seed=seed, store=store)
        print(f"sensitive params: {out['num_sensitive']}/"
              f"{len(out['scores'])} (artifacts in {store.path})")
    elif args.command in ("reevaluate", "predict"):
        out = _reevaluate(args, dev)
        _print_metrics(out["metrics"])
        diag = out["diagnostics"]
        print(json.dumps({
            "ess_median": float(np.median(np.asarray(diag["ess"]))),
            "r_hat_max": float(np.nanmax(np.asarray(diag["r_hat"]))),
        }))
        if args.command == "predict":
            store.save_array("predictions", out["predictions"])
            store.save_array("pred_mean", out["mean_prediction"])
            print(f"predictions {np.asarray(out['predictions']).shape} "
                  f"-> {store.path}")
    elif args.command == "hmc-nuts":
        cfg = _override(C.OperatorHMCRunConfig(), num_samples=args.num_samples)
        data = (None if args.mat is None
                else _burgers(cfg.n_train, cfg.n_valid, args.mat, dev))
        out = hmc_nuts.run(cfg, data=data, store=store, seed=seed, device=dev)
        _print_metrics(out["metrics"])
    elif args.command == "hmc-split":
        cfg = _override(C.SplitHMCRunConfig(), num_samples=args.num_samples,
                        num_splits=args.num_splits)
        if args.nuts:
            cfg = dataclasses.replace(cfg, is_nuts=True)
        data = (None if args.mat is None
                else _burgers(cfg.n_train, cfg.n_valid, args.mat, dev))
        out = hmc_split.run(cfg, data=data, store=store, seed=seed, device=dev)
        _print_metrics(out["metrics"])
    return 0, out


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
