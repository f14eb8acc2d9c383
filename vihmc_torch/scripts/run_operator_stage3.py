"""Stage 3 of the flagship operator demo: segmented, resumable VI-HMC
(``scripts/run_operator_stage3.py``).

Reads a stage-1/2 run store (``--artifacts <root>/<uid>``, written by either
package; ``run_operator_stage12`` writes ``<out>/stage12``), regenerates its
Burgers data and samples its sensitive subspace in segments of
``--segment`` draws, every ``--thin``-th kept, checkpointed to ``--ckpt``
(``samples_seg<seg:05d>.npy`` and the sampler state after every segment; a
rerun resumes from the last complete one). Without ``--no-eval`` it scores
the posterior predictive on the validation functions and writes
``<out>/<uid>/demo_summary.json`` with the script's keys (``burn``,
``draws`` and ``thin`` among them, which ``fs_diagnostics_operator`` reads)
beside ``hmc_params.npy``. Variants select the trajectory field only (the
MH test always uses the exact density): ``stride`` (the dual-stride Gram
surrogate, default 3/3), ``gauss`` (the VI-Gaussian score; step
``0.8 d^-1/4`` unless ``--step`` moves it off 1e-4) and ``autodiff`` (the
full-grid field). The configuration is
:func:`vihmc_torch.pipelines.vi_hmc.stage3_config`'s, the run
:func:`~vihmc_torch.pipelines.vi_hmc.run_stage3`'s; the flags it shares with
``python -m vihmc_torch.pipelines.vi_hmc`` come from
:func:`~vihmc_torch.pipelines.vi_hmc.add_stage3_flags`.

Differences from the script:

- the density is the fused merge-NLL (``ops.deeponet_merge.fused_merge_nll``:
  one ``merge_sums`` launch per density evaluation for all chains, 1 + 2 x
  draws per run); the script runs the composed density
  (``vihmc_tpu/pipelines/vi_hmc.py:641-650``, ``use_fused=False``); both are
  the same NLL, the fused one with f64 sums;
- a missing ``--artifacts`` directory falls back to the committed
  ``assets/burgers_stage12.npz``, as in the script; a store the port wrote
  carries its own data parameters (``stage12_data.json``), a JAX store takes
  them from that bundle, as the script does; the DeepONet is the one whose
  size the store's ``means_flattened`` has (the reference one, or
  ``run_operator_stage12 --small``'s);
- the data of data seed 0 on the 101 x 101 grid are the exported initial
  conditions, other sizes a torch-drawn GRF (``scripts/_common.burgers_splits``);
- ``--key`` seeds the port's ``torch.Generator`` streams (JAX: a threefry key)::

    python -m vihmc_torch.scripts.run_operator_stage3 [--artifacts runs/op_r2/stage12/stage12]
        [--out runs/op_r2/stage3] [--uid U] [--ckpt DIR] [--variant stride|gauss|autodiff]
        [--draws 450] [--chains 16] [--segment 90] [--thin 3] [--key 0] [--no-eval]
        [--adapt --da-axis --adapt-forever ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from vihmc_torch.core.device import resolve_device, sync
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.pipelines import vi_hmc
from vihmc_torch.scripts._common import (burgers_splits, check_output,
                                         json_line, stage12_artifacts)

#: the script's summary keys, with and without ``--no-eval``
SUMMARY_KEYS = ("variant", "chains", "draws", "thin", "burn", "L", "step", "adapt",
                "da_axis", "jitter", "acceptance", "acceptance_post_burn",
                "expected_mse_of_mean", "mean_relative_l2", "mean_error_sigma_correlation",
                "ess_median", "ess_bulk_median", "ess_tail_median", "ess_bulk_min",
                "r_hat_max", "r_hat_rank_max", "tau_floor_frac", "sampling_seconds")
NO_EVAL_KEYS = ("acceptance_post_burn", "ess_median_head", "wall_seconds")
#: the script's --step default; under the gauss variant it means "0.8 d^-1/4"
DEFAULT_STEP = 1e-4


def build_parser() -> argparse.ArgumentParser:
    ap = vi_hmc.add_stage3_flags(argparse.ArgumentParser(
        description="stage 3 of the flagship operator demo (segmented, resumable VI-HMC)"))
    ap.add_argument("--artifacts", default="runs/op_r2/stage12/stage12",
                    help="stage-1/2 run store <root>/<uid> of either package")
    ap.add_argument("--out", default="runs/op_r2/stage3")
    ap.add_argument("--uid", default=None)
    ap.add_argument("--ckpt", default=None, help="checkpoint dir for mid-run resume")
    ap.add_argument("--step", type=float, default=DEFAULT_STEP,
                    help="initial step (fixed unless --adapt)")
    ap.add_argument("--key", type=int, default=0)
    ap.add_argument("--no-eval", action="store_true",
                    help="skip the posterior-predictive evaluation (probes)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    check_output(args.out)
    if args.ckpt:
        check_output(args.ckpt)
    artifacts, meta, model = stage12_artifacts(args.artifacts)
    d_sub = len(artifacts["indices"])
    t0 = time.perf_counter()
    data = burgers_splits(dev, **meta)
    sync(dev)
    print(f"[data] regenerated in {time.perf_counter() - t0:.1f}s; subspace {d_sub} dims",
          flush=True)
    store = RunStore(args.out, uid=args.uid)
    print(f"artifacts -> {store.path}", flush=True)
    seg_t = [time.perf_counter()]

    def progress(seg, n_segs, state):
        now = time.perf_counter()
        if args.adapt:
            log_step = state.da.log_step if args.adapt_forever else state.da.log_step_avg
            eps = float(np.exp(log_step.double().cpu().numpy()).mean())
        else:
            eps = float(summary_step)
        print(f"[seg {seg}/{n_segs}] {args.segment} draws in {now - seg_t[-1]:.1f}s  "
              f"step={eps:.3e}", flush=True)
        seg_t.append(now)

    kw = vi_hmc.stage3_kwargs(args)
    step = None if args.variant == "gauss" and args.step == DEFAULT_STEP else args.step
    summary_step = step if step is not None else 0.8 * d_sub ** -0.25
    full, out = vi_hmc.run_stage3(
        **kw, seed=args.key, step=step, data=data, artifacts=artifacts, model=model,
        grid=meta, store=None if args.no_eval else store, checkpoint_dir=args.ckpt,
        progress=progress, evaluate=not args.no_eval)
    acc = full["acceptance_post_burn"]
    wall = full.get("wall_seconds", full["phases_s"]["sampling_s"])
    print(f"[vi-hmc] {args.chains}x{args.draws} draws (L={args.L}, variant={args.variant}) "
          f"in {wall:.1f}s  accept={acc:.3f}", flush=True)
    keys = NO_EVAL_KEYS if args.no_eval else SUMMARY_KEYS
    summary = {k: full[k] for k in keys}
    if not args.no_eval:
        store.save_config(summary, name="demo_summary")
    json_line(None, summary)
    json_line("stage3-port", {"density": "fused_merge_nll", "run": store.path,
                              "draws_per_s": full["draws_per_s"], "phases_s": full["phases_s"],
                              "ckpt": args.ckpt and os.path.abspath(args.ckpt)})
    return summary


if __name__ == "__main__":
    main()
