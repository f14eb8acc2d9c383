"""Canonicalize stored stage-3 operator draws and re-measure split R-hat
(``scripts/canonicalize_operator_draws.py``).

Reads the ``samples_seg*.npy`` segments (C, S, d) of a stage-3 checkpoint
directory of either package (``run_operator_stage3 --ckpt``), drops the
first ``--burn-kept`` kept draws, maps every draw (scattered into the
bundle's VI mean ``mu`` at its ``indices``) to the canonical representative
of its tanh-sign / hidden-unit-permutation / merge-channel symmetry orbit
(:func:`vihmc_torch.models.symmetry.canonicalize_deeponet`), and reports the
split R-hat of the raw, the sign-canonicalized and (``--permute``) the
permutation-aligned draws, with a per-dimension view (rank R-hat, ESS,
chain means and a within-basin R-hat where the chain means split) of the
worst raw and the worst canonicalized dimensions.

The canonicalization is numpy on the host, as in JAX; ``--device`` is
resolved like every entry point's (the card unless ``--device cpu``) but no
step needs it. The DeepONet is the one of the bundle's size (the script
always takes the reference one). ``--out`` defaults to
``runs/torch_canonicalize_operator_draws/canonicalization_r2.json`` (the
script's default overwrites the committed
``docs/results/canonicalization_r2.json``)::

    python -m vihmc_torch.scripts.canonicalize_operator_draws --ckpt DIR
        [--assets BUNDLE] [--burn-kept 140] [--permute] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from vihmc_torch.chains.diagnostics import (effective_sample_size_np,
                                            potential_scale_reduction_np, rhat_rank_np)
from vihmc_torch.core.device import resolve_device
from vihmc_torch.models.symmetry import canonicalize_deeponet
from vihmc_torch.scripts._common import (check_output, deeponet_for, json_line, runs_path,
                                         write_json)

NAME = "canonicalize_operator_draws"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="canonicalize stage-3 draws, re-measure R-hat")
    ap.add_argument("--ckpt", default="runs/op_r2/stage3_ckpt")
    ap.add_argument("--assets", default="assets/burgers_stage12_r2.npz")
    ap.add_argument("--burn-kept", type=int, default=140,
                    help="kept draws to drop (demo: burn 420 / thin 3)")
    ap.add_argument("--permute", action="store_true",
                    help="also run the permutation-alignment stage "
                         "(one linear assignment per draw per layer)")
    ap.add_argument("--out", default=runs_path(NAME, "canonicalization_r2.json"))
    ap.add_argument("--device", default="cuda")
    return ap


def canonicalize_all(draws, mu, idx, cfg, permute: bool, chunk: int = 256) -> np.ndarray:
    """(C, S, d) subspace draws scattered into ``mu`` and canonicalized;
    returns the canonical subspace coordinates (same shape, float32)."""
    c, s, d_sub = draws.shape
    out = np.empty_like(draws)
    rows, out_rows = draws.reshape(c * s, d_sub), out.reshape(c * s, d_sub)
    t0 = time.perf_counter()
    for start in range(0, c * s, chunk):
        stop = min(start + chunk, c * s)
        full = np.tile(mu[None, :], (stop - start, 1))
        full[:, idx] = rows[start:stop]
        out_rows[start:stop] = canonicalize_deeponet(full, mu, cfg, permute=permute)[
            :, idx].astype(np.float32)
        if start % (chunk * 8) == 0:
            print(f"  canonicalize[{'perm' if permute else 'sign'}] {stop}/{c * s} draws "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    return out


def load_segments(ckpt: str) -> np.ndarray:
    """The ``samples_seg*.npy`` segments of ``ckpt`` joined along the draws."""
    files = sorted(f for f in os.listdir(ckpt)
                   if f.startswith("samples_seg") and f.endswith(".npy"))
    return np.concatenate([np.load(os.path.join(ckpt, f)) for f in files], axis=1)


def dim_entry(dim: int, rhat_raw, rhat_best, canon_best) -> dict:
    """The per-dimension view of one subspace coordinate."""
    dsel = canon_best[:, :, dim:dim + 1]
    entry = {
        "subspace_idx": int(dim),
        "rhat_raw": round(float(rhat_raw[dim]), 3),
        "rhat_canon": round(float(rhat_best[dim]), 3),
        "rhat_canon_rank": round(float(rhat_rank_np(dsel)[0]), 3),
        "ess_canon": round(float(effective_sample_size_np(dsel)[0]), 1),
        "chain_means_canon": [round(float(m), 4) for m in dsel[:, :, 0].mean(axis=1)],
    }
    # within-basin fallback: split the chains at the largest gap of their
    # sorted means only when the gap dominates the within-chain spread
    means = dsel[:, :, 0].mean(axis=1)
    sd_within = float(dsel[:, :, 0].std(axis=1).mean())
    srt = np.sort(means)
    gaps = np.diff(srt)
    if len(gaps) and gaps.max() > 2.0 * sd_within and entry["rhat_canon"] > 1.1:
        lo = means <= srt[np.argmax(gaps)]
        entry["basin_sizes"] = [int(lo.sum()), int((~lo).sum())]
        for name, mask in (("lo", lo), ("hi", ~lo)):
            if mask.sum() >= 2:
                entry[f"rhat_within_{name}"] = round(
                    float(potential_scale_reduction_np(dsel[mask])[0]), 3)
    return entry


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    check_output(args.out)
    with np.load(args.assets) as z:
        mu = np.asarray(z["mu"], np.float64)
        idx = np.sort(np.asarray(z["indices"]))
    cfg = deeponet_for(mu.shape[0])
    draws = load_segments(args.ckpt)
    c, s_all, d_sub = draws.shape
    draws = draws[:, args.burn_kept:]
    s = draws.shape[1]
    print(f"[load] {c} chains x {s_all} kept draws ({s} post-burn) x {d_sub} dims", flush=True)
    if d_sub != len(idx):
        raise ValueError(f"the draws have {d_sub} dimensions, the bundle's subspace {len(idx)}")
    report = {"chains": c, "post_burn_kept_draws": s, "subspace_dim": d_sub,
              "permute_stage": bool(args.permute)}

    stages = [("raw", draws), ("sign", canonicalize_all(draws, mu, idx, cfg, permute=False))]
    if args.permute:
        stages.append(("perm", canonicalize_all(draws, mu, idx, cfg, permute=True)))
    rhats = {}
    for name, x in stages:
        rhats[name] = potential_scale_reduction_np(x)
        report[f"rhat_{name}_max"] = float(np.nanmax(rhats[name]))
        report[f"rhat_{name}_frac_above_1_1"] = float(np.mean(rhats[name] > 1.1))
        print(f"[{name}] max split-R-hat {report[f'rhat_{name}_max']:.3f}  >1.1 on "
              f"{100 * report[f'rhat_{name}_frac_above_1_1']:.2f}% of dims", flush=True)
    best_name, canon_best = stages[-1]
    rhat_raw, rhat_best = rhats["raw"], rhats[best_name]
    worst_raw = np.argsort(-np.nan_to_num(rhat_raw))[:8]
    still = np.argsort(-np.nan_to_num(rhat_best))[:8]
    report["dims"] = [dim_entry(int(dim), rhat_raw, rhat_best, canon_best)
                      for dim in np.unique(np.concatenate([worst_raw, still]))]
    write_json(args.out, report)
    json_line(None, {k: v for k, v in report.items() if k != "dims"})
    print(f"wrote {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
