"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed with its wall time:

1. device: the card's name and power limit, and the build of every CUDA
   kernel of the port from ``vihmc_torch/csrc`` (one ``nvcc`` per source, all
   started together);
2. kernels against their plain PyTorch versions on the card, at a ragged
   shape and at the operator row's shape, on real features at q0 and at q1
   one leapfrog trajectory away, with a float64 evaluation as a third
   reference; the kernel's time beside its bound and the plain version's;
3. the operator row at full width through ``run_operator_row`` (reference
   DeepONet, B = 1000 x P = 10,201, 2048-dim subspace, 48 chains, L = 4,
   bf16 Gram trajectory gradients, the fused paired delta, a low-rank
   metric), with only its depth cut; the kernel launch counts of that run
   must show that every draw went through the kernel;
4. where a draw's time goes: the trajectory field, the delta's feature
   forwards and the kernel timed alone at 48 chains, beside the sampling
   wall per draw.

The second-to-last line is a JSON object describing every kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result. It needs a CUDA device and the
rest of the repository; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from vihmc_torch.bench_operator import (build_operator_problem, operator_fns,
                                        run_operator_row)
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.data.burgers import load_port_inputs
from vihmc_torch.hmc.integrators import leapfrog_grad_only
from vihmc_torch.models.deeponet import deeponet_features, unravel_deeponet
from vihmc_torch.ops import cuda_build
from vihmc_torch.ops.deeponet_merge import (close_paired_sums, paired_sums,
                                            paired_sums_reference, y_sums)
from vihmc_torch.ops.gram_merge import make_gram_grad_full

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
DLL_ATOL = 1e-2      # nats: the paired form's stated float error (pipelines/common.py:165-166)
LP1_RTOL = 1e-5
BURGERS_ATOL = 1e-4  # f32 pseudo-spectral solve, 2000 steps, |u| <= ~3.4: cuFFT vs XLA rounding

KERNELS = {
    "paired_sums": {"route": "cuda", "source": "vihmc_torch/csrc/paired_sums.cu",
                    "replaces": "vihmc_tpu/ops/deeponet_merge.py:349"},
}


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase(name: str, t0: float):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def paired_sums_f64(bout1, tout1, bout0, tout0, y) -> torch.Tensor:
    rows = []
    y64 = y.double()
    for c in range(bout1.shape[0]):
        m1 = bout1[c].double() @ tout1[c].double().T
        m0 = bout0[c].double() @ tout0[c].double().T
        dm, sm = m1 - m0, m1 + m0
        rows.append(torch.stack([(dm * (sm - 2 * y64)).sum(), dm.sum(), sm.sum(),
                                 (m1 * m1).sum(), (m1 * y64).sum()]))
    return torch.stack(rows)


def paired_sums_bound_ms(c, b, p, k):
    flops = 4.0 * c * b * p * k + 12.0 * c * b * p   # two products + the epilogue
    nbytes = 4.0 * (2 * c * b * k + 2 * c * p * k + b * p + 5 * c)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def compare_paired(label, feats, biases, y, tau=1.0):
    """Kernel vs plain vs f64 on one input set; returns the kernel's max |dDll|."""
    bout1, tout1, bout0, tout0 = feats
    b1, b0 = biases
    c, b, k = bout1.shape
    p = tout1.shape[1]
    sy = y_sums(y)
    s_k = paired_sums(bout1, tout1, bout0, tout0, y)
    torch.cuda.synchronize()
    s_p = paired_sums_reference(bout1, tout1, bout0, tout0, y)
    s_64 = paired_sums_f64(bout1, tout1, bout0, tout0, y)
    d_k, lp_k = close_paired_sums(s_k, b1, b0, b * p, tau, *sy)
    d_p, lp_p = close_paired_sums(s_p, b1, b0, b * p, tau, *sy)
    d_64, lp_64 = close_paired_sums(s_64, b1, b0, b * p, tau, *sy)
    names = ("D", "Bd", "Sm", "Q1", "C1")
    for i, n in enumerate(names):
        ad = (s_k[:, i].double() - s_p[:, i].double()).abs().max().item()
        rd = ad / max(s_p[:, i].double().abs().max().item(), 1e-30)
        ad64 = (s_k[:, i].double() - s_64[:, i]).abs().max().item()
        print(f"  {label} {n}: kernel-plain max abs {ad:.4g} rel {rd:.3g}; "
              f"kernel-f64 max abs {ad64:.4g}")
    err_dll = (d_k.double() - d_p.double()).abs().max().item()
    err_lp1 = ((lp_k.double() - lp_p.double()).abs() / lp_p.double().abs()).max().item()
    print(f"  {label} dll: kernel-plain max abs {err_dll:.4g} nats, kernel-f64 "
          f"{(d_k.double() - d_64.double()).abs().max().item():.4g}, plain-f64 "
          f"{(d_p.double() - d_64.double()).abs().max().item():.4g} "
          f"(|dll| up to {d_64.abs().max().item():.4g})")
    print(f"  {label} lp1: kernel-plain max rel {err_lp1:.3g}, kernel-f64 rel "
          f"{((lp_k.double() - lp_64.double()).abs() / lp_64.abs()).max().item():.3g}")
    check(bool(torch.isfinite(s_k).all()), f"{label}: non-finite kernel sums")
    check(err_dll <= DLL_ATOL, f"{label}: |dll kernel - plain| {err_dll} > {DLL_ATOL} nats")
    check(err_lp1 <= LP1_RTOL, f"{label}: lp1 rel err {err_lp1} > {LP1_RTOL}")
    return err_dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PyTorch port smoke run on one GPU")
    ap.add_argument("--draws", type=int, default=240, help="main-path draws")
    ap.add_argument("--segment", type=int, default=120)
    ap.add_argument("--burn", type=int, default=48)
    ap.add_argument("--init-opt", type=int, default=800)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--timing-reps", type=int, default=20)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- phase 1: device and build ----
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    tb = time.perf_counter()
    built = cuda_build.build_all()
    print(f"build: {time.perf_counter() - tb:.2f} s ({', '.join(built) or 'cached'})")
    for n, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {n}: {line.strip()}")
    phase("1 device+build", t0)

    # ---- phase 2: the kernel against its plain version ----
    t0 = time.perf_counter()
    problem = build_operator_problem(dev)
    torch.cuda.synchronize()
    print(f"problem: Burgers solve + asset load {time.perf_counter() - t0:.2f} s; "
          f"y {tuple(problem.y.shape)}, subspace {problem.spec.subspace_dim}")
    rows = torch.as_tensor(load_port_inputs()["solution_rows"], device=dev)
    burgers_err = (problem.y[:rows.shape[0]] - rows).abs().max().item()
    print(f"  Burgers rows vs JAX solution: max abs {burgers_err:.3g}")
    check(burgers_err <= BURGERS_ATOL, f"Burgers solve differs from JAX by {burgers_err}")

    cfg, spec, aux = problem.cfg, problem.spec, problem.frozen
    fns = operator_fns(problem)
    field = fns.grad_fn
    chains, d = 48, spec.subspace_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    scale = torch.sqrt(problem.inv_mass_diag)
    q0 = spec.sub_mu() + 0.5 * scale * torch.randn((chains, d), generator=gen, device=dev)
    p0 = torch.randn((chains, d), generator=gen, device=dev) / scale
    q1, _, _ = leapfrog_grad_only(lambda q: field(q, aux), q0, p0, field(q0, aux), 0.1, 4,
                                  problem.inv_mass_diag)
    # the bf16 Gram field against autograd of the composed f32 likelihood
    with torch.enable_grad(), true_f32():
        full = scatter_subspace(aux, q0[:1], spec.idx).requires_grad_(True)
        params = unravel_deeponet(cfg, full)
        bo, to = deeponet_features(cfg, params, problem.branch_x, problem.trunk_x)
        pred = bo @ to.transpose(-1, -2) + params["b"][:, None, None]
        (g_auto,) = torch.autograd.grad(-0.5 * ((pred - problem.y) ** 2).sum(), full)
    g_gram = make_gram_grad_full(cfg, problem.branch_x, problem.trunk_x, problem.y, 1.0,
                                 compute_dtype=torch.bfloat16)(full.detach())
    cos = torch.nn.functional.cosine_similarity(g_gram[0, spec.idx], g_auto[0, spec.idx],
                                                dim=0).item()
    print(f"  Gram bf16 field vs f32 autograd on the subspace: cosine {cos:.6f}")
    check(cos > 0.99, f"Gram field cosine {cos}")
    del pred, g_auto
    with true_f32():
        params1 = unravel_deeponet(cfg, scatter_subspace(aux, q1, spec.idx))
        params0 = unravel_deeponet(cfg, scatter_subspace(aux, q0, spec.idx))
        bout1, tout1 = deeponet_features(cfg, params1, problem.branch_x, problem.trunk_x)
        bout0, tout0 = deeponet_features(cfg, params0, problem.branch_x, problem.trunk_x)
    y = problem.y
    biases = (params1["b"].contiguous(), params0["b"].contiguous())
    ragged = [t[:3, :n, :12].contiguous() for t, n in
              ((bout1, 130), (tout1, 301), (bout0, 130), (tout0, 301))]
    compare_paired("ragged C=3 B=130 P=301 K=12", ragged,
                   (biases[0][:3], biases[1][:3]), y[:130, :301].contiguous())
    feats = [t.contiguous() for t in (bout1, tout1, bout0, tout0)]
    c, b, k = feats[0].shape
    p = feats[1].shape[1]
    err_main = compare_paired(f"main C={c} B={b} P={p} K={k}", feats, biases, y)
    ms = time_cuda(lambda: paired_sums(*feats, y), args.timing_reps)
    plain_ms = time_cuda(lambda: paired_sums_reference(*feats, y), 5, warmup=1)
    bound_ms, bound_by = paired_sums_bound_ms(c, b, p, k)
    print(f"  paired_sums at C={c} B={b} P={p} K={k}: kernel {ms:.3f} ms (median of "
          f"{args.timing_reps}), bound {bound_ms:.3f} ms ({bound_by}; f32 "
          f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, {PEAK_BYTES_PER_S / 1e12:.2f} TB/s), "
          f"plain {plain_ms:.3f} ms, library_ms n/a (no single PyTorch call "
          f"computes these five sums)")
    del feats, ragged, bout1, tout1, bout0, tout0
    phase("2 kernels vs plain", t0)

    # ---- phase 3: the main path at full width ----
    t0 = time.perf_counter()
    cuts = {"init_opt": (args.init_opt, 800), "lowrank_rank": (args.rank, 256),
            "draws": (args.draws, 2880), "burn": (args.burn, 288),
            "segment": (args.segment, 120)}
    for key_, (val, full_val) in cuts.items():
        if val != full_val:
            print(f"  depth cut: {key_} {val} (recipe {full_val})")
    torch.cuda.synchronize()
    paired_sums.launches = 0
    stats = run_operator_row(device=dev, draws=args.draws, burn=args.burn, thin=3,
                             chains=48, L=4, target=0.25, init_opt=args.init_opt,
                             lowrank_rank=args.rank, segment=args.segment, seed=2,
                             problem=problem)
    torch.cuda.synchronize()
    launches = {"paired_sums": paired_sums.launches}
    print(f"  launches in the main path: {launches} for {args.draws} draws")
    check(launches["paired_sums"] == args.draws,
          f"paired_sums launched {launches['paired_sums']} times for {args.draws} draws")
    acc = stats["acceptance"]
    steps = stats["step_quartiles"]
    check(math.isfinite(acc) and acc > 0.0, f"acceptance {acc}")
    check(len(steps) == 4 and all(math.isfinite(s) and s > 0 for s in steps),
          f"step quartiles {steps}")
    check(stats["samples_finite"], "non-finite samples")
    check(stats["samples_shape"] == [48, args.draws // 3, d],
          f"samples shape {stats['samples_shape']}")
    print(f"  acceptance {acc:.4f}; step quartiles {[round(s, 4) for s in steps]}; "
          f"divergent {stats['divergent']}")
    print(f"  draws/s {stats['draws_per_s']:.3f} (each draw moves 48 chains; "
          f"{stats['chain_draws_per_s']:.1f} chain-draws/s)")
    print("  phases (s): " + ", ".join(f"{k_} {v:.2f}" for k_, v in stats["phases_s"].items()))
    print(f"  segment walls (s): {[round(w, 2) for w in stats['segment_walls_s']]}")
    print(f"  lowrank metric: {stats['lowrank_metric']}")
    print("  diagnostics (reduced depth): " + json.dumps(
        {k_: stats.get(k_) for k_ in ("ess_median", "ess_bulk_median", "ess_min",
                                      "rhat_max")}))
    phase("3 main path", t0)

    # ---- phase 4: where a draw's time goes (after the counts were read) ----
    t0 = time.perf_counter()
    reps = args.timing_reps
    grad_ms = time_cuda(lambda: field(q0, aux), reps)

    def feature_forwards():
        with true_f32():
            for q in (q1, q0):
                deeponet_features(cfg, unravel_deeponet(cfg, scatter_subspace(aux, q, spec.idx)),
                                  problem.branch_x, problem.trunk_x)

    feat_ms = time_cuda(feature_forwards, reps)
    delta_ms = time_cuda(lambda: fns.delta_fn(q1, q0, aux), reps)
    draw_ms = 1e3 * stats["phases_s"]["sampling_s"] / args.draws
    parts = {"gram_field_x4": 4 * grad_ms, "delta_feature_forwards": feat_ms,
             "paired_sums": ms, "delta_rest": delta_ms - feat_ms - ms}
    parts["rest_of_draw"] = draw_ms - sum(parts.values())
    print(f"  per draw at C=48 (CUDA events, median of {reps}): sampling wall {draw_ms:.2f} ms = "
          + ", ".join(f"{k_} {v:.2f}" for k_, v in parts.items()) + " ms")
    phase("4 per-draw breakdown", t0)

    print(json.dumps({"kernels": [dict(
        name="paired_sums", **KERNELS["paired_sums"], launches=launches["paired_sums"],
        max_abs_err=err_main, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
