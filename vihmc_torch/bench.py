"""The port's ``bench.py``: one JSON line of ESS/s for VI-HMC on the card.

    python -m vihmc_torch.bench [bench.py's flags] [--device cuda|cpu] [--composed-delta]

Counterpart of ``bench.py``'s ``main`` (:1605-2037): every flag of
``bench.py`` with its default, the same ``ap.error`` checks, the same
zero-argument recipe (:1806-1884: the full-grid bf16 Gram field, the
conditional-Laplace diagonal, a rank-256 Lanczos metric, L = 4 at a 0.25
target, 2880 draws, burn 288, thin 3, keys 2,3,4, an 800-step warm start
under the 'draw' policy), and one printed line ``{"metric":
"ess_per_sec_vihmc_deeponet", "value", "unit", "vs_baseline", "extras"}``
whose ``value`` is the median ESS over the keys divided by their median wall.
:func:`resolve` turns the flags into the keyword arguments of
:func:`vihmc_torch.bench_operator.bench_operator` (JAX's ``bench_jax``
keywords), of the CPU baseline and of the NN row.

Where it differs from ``bench.py``:

* ``--device`` (default ``cuda``; ``cpu`` runs everything on the CPU).
* The paired MH delta is the fused form (one ``paired_sums`` launch per
  draw for all chains) unless ``--composed-delta`` asks for JAX's composed
  default; ``--fused-delta`` is accepted and changes nothing.
* No number measured on a TPU enters the line: ``bench.py``'s measured
  constants and the fields they fill (``subspace_90pct``,
  ``torch_cpu_ess_per_s``, ``vs_baseline_ess_like_for_like`` and the
  constant ``vs_baseline_like_for_like`` on ``stress``) are left out.
* A failing phase (the ``--extras`` variants, the baseline, the NN row)
  stops the run with its error; ``bench.py`` prints it and goes on.
* The CPU baseline unpacks the port's own flat layout
  (:func:`~vihmc_torch.bench_operator.baseline_log_prob`).
* ``--workload nn`` (and the NN row the default invocation appends) runs
  :func:`vihmc_torch.bench_nn.bench_nn` on the row's real posterior also at
  ``--quick``, at JAX's quick depth (4 chains, 20 draws, L = 8, key 2).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from vihmc_torch import bench_nn
from vihmc_torch.bench_operator import (BENCH_FN_STRIDE, BENCH_JITTER_LOW, BENCH_L,
                                        BENCH_STEP, BENCH_STRIDE, bench_grad_path,
                                        bench_operator, bench_torch_baseline)
from vihmc_torch.chains.diagnostics import effective_sample_size_np
from vihmc_torch.core.device import resolve_device

#: low-rank rank of the NN row the default invocation appends (bench.py:305)
NN_LOWRANK_RANK = 0
#: the CPU baseline's time cap: the headline's, and the 90 % row's (bench.py:1963)
BASELINE_SECONDS, BASELINE_SECONDS_90PCT = 120.0, 240.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m vihmc_torch.bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="bench.py's small synthetic posterior (4 chains, 20 draws)")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--extras", action="store_true",
                    help="also run the bf16-forward row and the composed vs fused "
                         "gradient of the full log posterior")
    ap.add_argument("--workload", choices=["operator", "nn"], default="operator")
    ap.add_argument("--draws", type=int, default=None, help="total draws")
    ap.add_argument("--burn", type=int, default=None, help="burn draws (default draws//5)")
    ap.add_argument("--subspace", default=None,
                    help="an int (top-k by sensitivity score) or '90pct' (the bundle's "
                         "90%%-captured-variance set); default 2048")
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--segment", type=int, default=None,
                    help="draws per segment (default 120, 60 above 16,384 dims)")
    ap.add_argument("--windowed-mass", action="store_true",
                    help="pooled windowed mass adaptation on the coupled recipe")
    ap.add_argument("--thin", type=int, default=1, help="keep every thin-th draw")
    ap.add_argument("--keys", default=None, help="comma-separated run seeds (default 2,3,4)")
    ap.add_argument("--L", type=int, default=None,
                    help=f"trajectory length (default {BENCH_L})")
    ap.add_argument("--frozen-policy", default="draw", choices=["refresh", "mean", "draw"])
    ap.add_argument("--asset", default="prod",
                    help="'prod' (400-epoch fit), 'stress' (2400-epoch fit) or a .npz path")
    ap.add_argument("--lowrank-mass", type=int, default=0, metavar="K",
                    help="Lanczos low-rank + diagonal metric of rank K")
    ap.add_argument("--lowrank-iters", type=int, default=None,
                    help="Lanczos iterations (default max(2K, K+10))")
    ap.add_argument("--fused-delta", action="store_true",
                    help="accepted for bench.py's sake: the fused delta is the default here")
    ap.add_argument("--no-paired-delta", action="store_true",
                    help="the unpaired MH test (two separate density sums)")
    ap.add_argument("--eigen-two-sided", action="store_true",
                    help="with --lowrank-mass K: K/2 stiffest and K/2 softest directions")
    ap.add_argument("--hutch-diag", type=int, default=0, metavar="N",
                    help="the measured conditional diagonal from N Hutchinson probes")
    ap.add_argument("--persist", type=float, default=0.0, metavar="ALPHA",
                    help="momentum persistence (partial momentum refresh)")
    ap.add_argument("--target-accept", type=float, default=None,
                    help="coupled dual-averaging target (default 0.65)")
    ap.add_argument("--grad-dtype", default=None, choices=["float32", "bfloat16"],
                    help="dtype of the Gram trajectory field")
    ap.add_argument("--density-precision", default="float32",
                    choices=["default", "float32", "highest"],
                    help="MH density forward: IEEE f32, or bf16 operands with f32 "
                         "accumulation ('default')")
    ap.add_argument("--init-opt", type=int, default=None, metavar="N",
                    help="warm-start steps (default 800 under 'draw', else 0)")
    ap.add_argument("--no-nn-row", action="store_true",
                    help="skip the NN row the default invocation appends")
    ap.add_argument("--nn-step", type=float, default=None, help="NN row fixed step")
    ap.add_argument("--laplace-mass", action="store_true",
                    help="the conditional-Laplace diagonal as the metric")
    ap.add_argument("--torch-ess", type=float, default=None, metavar="SECONDS",
                    help="run the CPU baseline at the full-grid fixed-step setting for "
                         "SECONDS, print its ESS/s and exit")
    ap.add_argument("--no-gram", action="store_true",
                    help="autograd through the density as the trajectory field")
    ap.add_argument("--stride", type=int, default=None,
                    help=f"query-grid stride of the Gram field (default {BENCH_STRIDE})")
    ap.add_argument("--fn-stride", type=int, default=None,
                    help=f"function stride of the Gram field (default {BENCH_FN_STRIDE})")
    ap.add_argument("--adaptive", action="store_true",
                    help="the legacy adaptive recipe (dual averaging at 0.55 from 1e-4)")
    ap.add_argument("--coupled", action="store_true",
                    help="coupled dual averaging with adapt_forever and step jitter")
    ap.add_argument("--gauss-field", type=float, nargs="?", const=1.0, default=None,
                    metavar="ALPHA", help="the VI-Gaussian trajectory field")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--composed-delta", action="store_true",
                    help="JAX's composed paired delta instead of the fused kernel")
    return ap


def parse_args(argv=None):
    """``bench.py``'s parse and checks (:1761-1805); the recipe defaults are
    filled by :func:`resolve`."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.subspace is not None and args.subspace != "90pct":
        args.subspace = int(args.subspace)
    if args.windowed_mass and (args.no_gram or args.adaptive or args.gauss_field is not None):
        ap.error("--windowed-mass rides the --coupled recipe (default when no "
                 "trajectory-field flag is given)")
    if args.torch_ess is not None:
        return args
    if args.no_gram and (args.stride or args.fn_stride):
        ap.error("--stride/--fn-stride require the Gram trajectory-gradient path "
                 "(drop --no-gram)")
    if args.gauss_field is not None and args.no_gram:
        ap.error("--gauss-field is a trajectory field of its own; drop --no-gram")
    if args.gauss_field is not None and (args.stride or args.fn_stride):
        ap.error("--gauss-field replaces the Gram trajectory oracle; --stride/--fn-stride "
                 "do not apply")
    if args.coupled and (args.no_gram or args.adaptive):
        ap.error("--coupled needs a surrogate trajectory field; it composes with "
                 "--stride/--fn-stride (default) or --gauss-field")
    return args


def resolve(args) -> dict:
    """The recipe of one invocation (``bench.py:1806-1931``), as keyword
    arguments: ``operator`` (of ``bench_operator``), ``nn`` (of
    ``bench_nn.bench_nn``, under ``--workload nn``), ``nn_row`` (the row the
    default invocation appends, or None) and ``default_invocation``.
    Fills ``args``' recipe defaults in place, as ``bench.py`` does."""
    default_invocation = (not args.quick and args.subspace is None and args.draws is None
                          and args.keys is None and args.chains is None)
    if args.gauss_field is None and not (args.stride or args.fn_stride or args.no_gram
                                         or args.adaptive or args.coupled):
        args.coupled = True
        if args.frozen_policy == "draw" and not args.quick and args.workload == "operator":
            args.stride = args.fn_stride = 1
            args.laplace_mass = True
            args.grad_dtype = args.grad_dtype or "bfloat16"
            args.lowrank_mass = args.lowrank_mass or 256
            args.L = 4 if args.L is None else args.L
            args.target_accept = 0.25 if args.target_accept is None else args.target_accept
            args.draws = 2880 if args.draws is None else args.draws
            args.burn = 288 if args.burn is None else args.burn
            args.thin = 3 if args.thin == 1 else args.thin
            args.keys = args.keys or "2,3,4"
    keys = tuple(int(k) for k in args.keys.split(",")) if args.keys else None
    init_opt = (args.init_opt if args.init_opt is not None
                else (800 if args.frozen_policy == "draw" and not args.quick else 0))
    operator = dict(
        quick=args.quick, draws=args.draws, burn=args.burn, use_gram=not args.no_gram,
        adaptive=args.adaptive, stride=args.stride, fn_stride=args.fn_stride,
        gauss_alpha=args.gauss_field, coupled=args.coupled, sub_dim=args.subspace,
        chains=args.chains, segment=args.segment, windowed_mass=args.windowed_mass,
        thin=args.thin, keys=keys, num_leapfrog=args.L, frozen_policy=args.frozen_policy,
        laplace_mass=args.laplace_mass, asset=args.asset, lowrank_rank=args.lowrank_mass,
        lowrank_iters=args.lowrank_iters, init_opt=init_opt,
        density_precision=args.density_precision, target_accept=args.target_accept,
        hutch_diag=args.hutch_diag, eigen_two_sided=args.eigen_two_sided,
        paired_delta=not args.no_paired_delta, grad_dtype=args.grad_dtype or "float32",
        persist=args.persist, fused_delta=not args.composed_delta)
    nn = nn_kwargs(args.quick, args.skip_baseline, args.frozen_policy, args.nn_step, args.L,
                   args.chains, args.lowrank_mass, args.draws,
                   args.thin if args.thin > 1 else None, args.segment, args.persist)
    nn_row = None
    if default_invocation and not args.no_nn_row:
        nn_row = nn_kwargs(args.quick, args.skip_baseline, args.frozen_policy, args.nn_step,
                           lowrank_rank=NN_LOWRANK_RANK)
    return {"operator": operator, "nn": nn, "nn_row": nn_row,
            "default_invocation": default_invocation}


def nn_kwargs(quick: bool, skip_baseline: bool = False, frozen_policy: str = "draw",
              step=None, L=None, chains=None, lowrank_rank: int = 0, draws=None, thin=None,
              segment=None, persist: float = 0.0) -> dict:
    """``bench.py``'s ``bench_nn`` arguments (None = its default) as
    ``bench_nn.bench_nn``'s (bench.py:1136-1143: 1024 chains, 2880 draws,
    L = 96, thin 24, segments of 480, keys 2-6; quick 4, 20, 8, 1, one
    segment, key 2)."""
    draws = (20 if quick else 2880) if draws is None else draws
    return dict(frozen_policy=frozen_policy, step=step,
                L=(8 if quick else 96) if L is None else L,
                chains=(4 if quick else 1024) if chains is None else chains,
                rank=lowrank_rank, draws=draws,
                thin=(1 if quick else 24) if thin is None else thin,
                segment=(draws if quick else 480) if segment is None else segment,
                persist=persist, keys=(2,) if quick else bench_nn.BENCH_KEYS,
                skip_baseline=skip_baseline)


def _rounded(stats: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in stats.items()}


def nn_line(stats: dict) -> dict:
    """The NN row's line (bench.py:1894-1902)."""
    vsb = stats.pop("vs_baseline", None)
    return {"metric": "ess_per_sec_vihmc_nn", "value": round(stats["ess_per_s"], 3),
            "unit": "effective_samples/s/chip",
            "vs_baseline": round(vsb, 2) if vsb is not None else None,
            "extras": _rounded(stats)}


def torch_ess_line(quick: bool, seconds: float) -> dict:
    """``--torch-ess``: the CPU baseline at the full-grid fixed-step setting,
    collecting its chain (bench.py:1769-1791)."""
    tb = bench_torch_baseline(quick, max_seconds=seconds, collect=True, step=BENCH_STEP,
                              jitter_low_frac=BENCH_JITTER_LOW)
    sam = tb.get("samples")
    out = {"metric": "torch_cpu_ess_per_sec_fullgrid", "draws": tb["draws"],
           "elapsed_s": round(tb["elapsed_s"], 1),
           "samples_per_s": round(tb["samples_per_s"], 4)}
    if sam is not None and sam.shape[0] >= 50:
        ess = effective_sample_size_np(sam[None, sam.shape[0] // 5:, :])
        out["ess_median"] = round(float(np.median(ess)), 2)
        out["ess_per_s"] = round(out["ess_median"] / tb["elapsed_s"], 5)
    else:
        out["error"] = "too few draws for an ESS estimate; raise SECONDS"
    return out


def baseline_kwargs(args, stats: dict) -> dict:
    """The CPU baseline's arguments (bench.py:1952-1968): the headline's
    setting, or for ``--subspace 90pct`` the row's own subspace, asset and L
    at its last step quartile."""
    if args.subspace == "90pct":
        return dict(quick=args.quick, sub_dim="90pct", asset=args.asset,
                    L=args.L or BENCH_L, step=(stats.get("step_quartiles") or [1e-3])[-1],
                    max_seconds=BASELINE_SECONDS_90PCT)
    return dict(quick=args.quick, max_seconds=BASELINE_SECONDS)


def vs_baseline_fields(args, samples_per_s: float, torch_samples_per_s: float) -> dict:
    """``vs_baseline`` and its kind (bench.py:1969-1990): the card's chain
    draws/s over the CPU chain's, like for like on the full grid."""
    vs = samples_per_s / torch_samples_per_s
    full_grid = args.gauss_field is None and (
        args.no_gram or ((args.stride or BENCH_STRIDE) == 1
                         and (args.fn_stride or BENCH_FN_STRIDE) == 1))
    out = {"vs_baseline": vs, "torch_cpu_samples_per_s": torch_samples_per_s}
    if full_grid:
        out.update(vs_baseline_kind="like_for_like_fullgrid",
                   vs_baseline_like_for_like=round(vs, 2))
    else:
        out.update(vs_baseline_kind="framework_trajectory_field",
                   vs_baseline_framework=round(vs, 2))
    return out


def run(argv=None) -> dict:
    """Run one invocation and return its line (the dict :func:`main` prints)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.torch_ess is not None:
        return torch_ess_line(args.quick, args.torch_ess)
    recipe = resolve(args)
    if args.workload == "nn":
        return nn_line(bench_nn.bench_nn(device=dev, **recipe["nn"]))

    stats, _ = bench_operator(device=dev, **recipe["operator"])
    if args.extras:
        bf16, _ = bench_operator(args.quick, compute_dtype=torch.bfloat16, device=dev)
        stats["bf16_samples_per_s"] = bf16["samples_per_s"]
        stats["bf16_acceptance"] = bf16["acceptance"]
        stats.update(bench_grad_path(args.quick, device=dev))
    vs_baseline = math.nan
    if not args.skip_baseline:
        kw = baseline_kwargs(args, stats)
        tb = bench_torch_baseline(**kw)
        if args.subspace == "90pct":
            stats["torch_baseline_config"] = {"step": kw["step"], "L": kw["L"],
                                              "draws_timed": tb["draws"]}
        fields = vs_baseline_fields(args, stats["samples_per_s"], tb["samples_per_s"])
        vs_baseline = fields.pop("vs_baseline")
        stats.update(fields)
    if recipe["nn_row"] is not None:
        stats["nn"] = nn_line(bench_nn.bench_nn(device=dev, **recipe["nn_row"]))
    return {"metric": "ess_per_sec_vihmc_deeponet", "value": round(stats["ess_per_s"], 3),
            "unit": "effective_samples/s/chip",
            "vs_baseline": round(vs_baseline, 2) if vs_baseline == vs_baseline else None,
            "extras": _rounded(stats)}


def main(argv=None):
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    sys.exit(main())
