"""The operator row of ``bench.py``: subspace VI-HMC on the Bayesian DeepONet.

The port's counterpart of ``bench.py``'s operator row in every configuration
its flags reach (``build_problem`` :312-417, ``bench_jax`` :419-880, the warm
start and the Lanczos metric :883-996, ``bench_grad_path`` :999-1028 and the
CPU baseline ``bench_torch_baseline`` :1510-1603). The command line is
:mod:`vihmc_torch.bench`, which resolves ``bench.py``'s flags to the keyword
arguments of :func:`bench_operator` (JAX's ``bench_jax`` keywords).

* :func:`build_problem`: the reference DeepONet (172,401 parameters) on the
  Burgers data of a stage-1/2 bundle (``prod``, ``stress`` or a ``.npz``
  path; every bundle of ``assets/`` has ``data_seed`` 0 on the 101 x 101
  grid, so the exported initial conditions serve them all), the top-k
  subspace by sensitivity score or the bundle's 90 % index set; or, with
  ``quick``, JAX's small synthetic posterior from ``np.random.default_rng(0)``.
  The frozen 'draw' vector is JAX's ``draw_full(jax.random.key(0), spec) =
  mu + sigma eps``, with ``eps`` exported by
  ``scripts/export_bench_normals.py``.
* :func:`bench_operator`: the row. Density precision ``float32``/``highest``
  runs the forward in IEEE f32; ``default`` on bf16-rounded matmul operands
  with f32 accumulation (:func:`default_precision_apply`). Trajectory field:
  the VI-Gaussian score, the Gram field (full grid or stride subsets, f32 or
  bf16) or autograd, each clipped at ``BENCH_CLIP sqrt(d / 2048)`` in the
  preconditioned norm. MH test: the fused paired delta (one ``paired_sums``
  launch per draw for all chains), the composed paired delta, or the
  unpaired test. Metric: the VI variances or the conditional-Laplace
  diagonal, optionally the Hutchinson diagonal and a Lanczos low-rank or
  two-sided eigen metric. Sampler: coupled dual averaging, the legacy
  adaptive recipe, or the fixed jittered step. Then one run per key and
  JAX's headline: the median ESS over keys divided by the median wall.
* Where it differs from JAX: no compile warm-up run (the CUDA kernels are
  built before the first key instead, so no key's wall holds a build); the
  ``mfu`` block is not wrapped in a ``try``; the FLOP count runs one more
  transition (one more ``paired_sums`` launch); the paired delta defaults to
  the fused form (``fused_delta=True``); the random streams are torch's
  (seeded with JAX's key numbers); the Lanczos cache lives in
  ``runs/torch_lanczos_cache`` and its name also carries the chain count
  (the warm-start centre depends on it); a missing bundle raises where JAX
  falls back to the synthetic posterior; the CPU baseline unpacks the
  port's own flat layout (JAX's reads each weight before its bias).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from vihmc_torch.bench_mfu import mfu_stats, sampling_flops
from vihmc_torch.bench_nn import torch_hmc_timing
from vihmc_torch.chains.diagnostics import (effective_sample_size_np,
                                            ess_bulk_np, rhat_rank_np)
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core import profiling
from vihmc_torch.core.device import resolve_device, sync
from vihmc_torch.core.precision import true_f32
from vihmc_torch.data.burgers import (ASSETS, STAGE12_ASSET, get_burgers_train,
                                      load_port_inputs)
from vihmc_torch.dists.likelihoods import nll_log_likelihood
from vihmc_torch.dists.priors import DiagonalGaussianPrior, IsotropicGaussianPrior
from vihmc_torch.hmc.kernel import (HMCConfig, clipped_grad_fn, gaussian_field_grad,
                                    value_and_grad)
from vihmc_torch.hmc.metric import (eigen_metric_from_eigs, hutchinson_diag, hvp_fn,
                                    lanczos_eigs, lowrank_from_eigs, preconditioned_hvp)
from vihmc_torch.hmc.subspace import (FrozenPolicy, SubspaceSpec, draw_full,
                                      make_aux_refresh, make_subspace_grad,
                                      make_subspace_log_prob)
from vihmc_torch.models.deeponet import (DeepONetConfig, bc_embedding, deeponet_apply,
                                         unravel_deeponet)
from vihmc_torch.models.mlp import get_activation
from vihmc_torch.ops import cuda_build
from vihmc_torch.ops.gram_merge import (grid_stride_subset, infer_grid_shape,
                                        make_gram_grad_full)
from vihmc_torch.pipelines.common import (conditional_warm_start,
                                          make_deeponet_nll_log_posterior,
                                          make_flat_deeponet,
                                          make_fused_paired_subspace_delta,
                                          make_log_posterior, make_nll_log_likelihood,
                                          make_paired_subspace_delta)

# the row's constants (bench.py:51-79)
BENCH_L = 31
BENCH_STEP = 0.12          # the fixed step of the jittered recipe
BENCH_JITTER_LOW = 0.5     # trajectory length ~ U[L/2, L]
BENCH_CLIP = 600.0         # preconditioned grad-norm clip at 2048 dims
BENCH_STRIDE = 5           # query-grid stride of the surrogate field
BENCH_FN_STRIDE = 5        # function stride of the surrogate field
BENCH_GAUSS_ALPHA = 1.0
BENCH_KEYS = (2, 3, 4, 5, 6)
BENCH_TARGET_ACCEPT = 0.55  # the legacy adaptive recipe
TAU_VAR = 1.0              # NLL variance of the operator row
WARM_SEED = 0xA11          # JAX's key numbers, reused as torch seeds
LANCZOS_SEED = 0x10E
HUTCH_SEED = 0x42D
#: the stage-1/2 bundles by regime (bench.py:289-292); any other value is a path
OPERATOR_ASSETS = {"prod": STAGE12_ASSET,
                   "stress": os.path.join(ASSETS, "burgers_stage12.npz")}
#: JAX's standard normals of the frozen 'draw' vector (scripts/export_bench_normals.py)
DRAW_NORMALS = os.path.join(ASSETS, "bench_draw_normals.npz")
#: bench.py --quick's DeepONet (bench.py:337-338)
QUICK_CFG = DeepONetConfig(in_branch=21, in_trunk=5, width_branch=32, width_trunk=32,
                           depth_branch=3, depth_trunk=3)
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "runs", "torch_lanczos_cache")


@dataclasses.dataclass
class BenchProblem:
    """The posterior of one ``bench.py`` invocation, on one device."""

    cfg: DeepONetConfig
    branch_x: torch.Tensor      # (B, in_branch)
    trunk_x: torch.Tensor       # (P, 2)
    y: torch.Tensor             # (B, P)
    spec: SubspaceSpec
    eps: torch.Tensor           # (D,) the standard normals of the 'draw' vector
    n_chains: int
    n_samples: int
    provenance: dict
    scores: Optional[np.ndarray] = None   # the bundle's sensitivity scores
    compute_dtype: Optional[torch.dtype] = None

    @property
    def idx(self) -> np.ndarray:
        return self.spec.idx.cpu().numpy()

    @property
    def frozen(self) -> torch.Tensor:
        """JAX's ``draw_full(jax.random.key(0), spec)``."""
        return draw_full(self.spec, self.eps)


def _bundle_path(asset: str) -> str:
    return OPERATOR_ASSETS.get(asset, asset)


def build_problem(quick: bool, compute_dtype=None, draws=None, sub_dim=None,
                  asset: str = "prod", device="cuda") -> BenchProblem:
    """``bench.py``'s ``build_problem`` (:312-417) on ``device``: the bundle's
    posterior at reference scale (48 chains, 360 draws; 32 chains for
    ``sub_dim='90pct'``), or JAX's quick synthetic one (4 chains, 20 draws).
    ``sub_dim``: an int (top-k by score, default 2048; 128 quick) or
    ``'90pct'`` (the bundle's index set). ``compute_dtype`` is recorded for
    the forward the row builds."""
    dev = resolve_device(device)
    with np.load(DRAW_NORMALS) as z:
        eps = z["eps_quick" if quick else "eps_full"]
    if quick:
        cfg = QUICK_CFG
        n_fn, n_pts, sd, n_chains, n_samples = 32, 256, 128, 4, 20
    else:
        cfg = DeepONetConfig()
        n_fn, n_pts, sd, n_chains, n_samples = 1000, 10201, 2048, 48, 360
        if sub_dim == "90pct":
            n_chains = 32
    sub_dim = sd if sub_dim is None else sub_dim
    if draws is not None:
        n_samples = draws
    d = cfg.num_params
    if eps.shape[0] != d:
        raise ValueError(f"{DRAW_NORMALS} holds {eps.shape[0]} normals for {d} parameters")
    eps = torch.as_tensor(eps, device=dev)

    if not quick:
        path = _bundle_path(asset)
        if not os.path.exists(path):
            raise FileNotFoundError(f"stage-1/2 bundle {path} is missing")
        with np.load(path) as z:
            bundle = {k: z[k] for k in z.files}
        grid = load_port_inputs()
        for k in ("data_seed", "n_train", "nx", "nt"):
            if int(bundle[k]) != int(grid[k]):
                raise ValueError(f"{path} has {k} {int(bundle[k])}; the exported Burgers "
                                 f"inputs have {int(grid[k])}")
        data = get_burgers_train(dev)
        if sub_dim == "90pct":
            idx = np.sort(np.asarray(bundle["indices"]))
            sub_desc = (f"90%-captured-variance set ({len(idx)} of "
                        f"{len(bundle['scores'])})")
        else:
            idx = np.sort(np.argsort(-bundle["scores"])[:sub_dim])
            sub_desc = f"top-{sub_dim} of {len(bundle['scores'])} by sensitivity score"
        provenance = {"posterior": "vi_fit", "assets": os.path.basename(path),
                      "asset_regime": asset, "asset_path": path,
                      "vi_valid_mse_best": float(np.min(bundle["vi_valid_mse"])),
                      "subspace": sub_desc}
        spec = SubspaceSpec(idx=torch.as_tensor(idx, dtype=torch.int64, device=dev),
                            mu=torch.as_tensor(bundle["mu"], device=dev),
                            sigma=torch.as_tensor(bundle["sigma"], device=dev))
        return BenchProblem(cfg, data["branch_in"], data["trunk_in"],
                            data["solution"].contiguous(), spec, eps, n_chains, n_samples,
                            provenance, scores=bundle["scores"], compute_dtype=compute_dtype)

    if sub_dim == "90pct":
        raise FileNotFoundError("--subspace 90pct needs the stage-1/2 asset bundle; the "
                                "synthetic problem has no captured-variance index set")
    rng = np.random.default_rng(0)
    branch_x = rng.normal(size=(n_fn, cfg.in_branch)).astype(np.float32)
    nt = int(round(n_pts ** 0.5))
    tt, xx = np.meshgrid(np.linspace(0, 1, nt), np.linspace(0, 1, n_pts // nt),
                         indexing="ij")
    trunk_x = np.stack([tt.ravel(), xx.ravel()], -1).astype(np.float32)
    y = rng.normal(size=(n_fn, trunk_x.shape[0])).astype(np.float32)
    mu = (0.05 * rng.normal(size=d)).astype(np.float32)
    sigma = (0.01 + 0.02 * rng.random(d)).astype(np.float32)
    idx = np.sort(rng.choice(d, size=sub_dim, replace=False))
    spec = SubspaceSpec(idx=torch.as_tensor(idx, dtype=torch.int64, device=dev),
                        mu=torch.as_tensor(mu, device=dev),
                        sigma=torch.as_tensor(sigma, device=dev))
    return BenchProblem(cfg, torch.as_tensor(branch_x, device=dev),
                        torch.as_tensor(trunk_x, device=dev), torch.as_tensor(y, device=dev),
                        spec, eps, n_chains, n_samples, {"posterior": "synthetic"},
                        compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# The row's density, fields and MH test
# ---------------------------------------------------------------------------

def _bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def default_precision_apply(cfg: DeepONetConfig):
    """``apply_flat(flat (C, D), branch_x, trunk_x) -> (C, B, P)`` with every
    matmul operand rounded to bf16 and the products accumulated in IEEE f32
    (elementwise work in f32): the nearest the card comes to JAX's one-pass
    bf16 ``default`` matmul precision of ``--density-precision default``.
    The products of bf16 values are exact in f32, so only the operand
    rounding and the accumulation order differ from JAX's."""
    act = get_activation(cfg.activation)

    def stack(layers, x):
        h = x
        for i, (w, b) in enumerate(layers):
            h = torch.matmul(_bf16_rounded(h), _bf16_rounded(w).transpose(-1, -2))
            h = h if b is None else h + b.unsqueeze(-2)
            if i < len(layers) - 1:
                h = act(h)
        return h

    def apply_flat(flat, branch_x, trunk_x):
        params = unravel_deeponet(cfg, flat)
        trunk_in = bc_embedding(trunk_x) if cfg.impose_bc else trunk_x
        with true_f32():
            bout = stack(params["branch"], branch_x)
            tout = stack(params["trunk"], trunk_in)
            pred = torch.matmul(_bf16_rounded(bout), _bf16_rounded(tout).transpose(-1, -2))
        return pred + params["b"][:, None, None]

    return apply_flat


def density_log_likelihood(problem: BenchProblem, density_precision: str = "float32"):
    """``full_ll(flat (C, D)) -> (C,)`` of the row's MH density
    (``bench.py:459-481``): the forward in ``problem.compute_dtype`` when set,
    else at ``density_precision`` ('float32'/'highest': IEEE f32; 'default':
    :func:`default_precision_apply`), then ``-sum`` Gaussian NLL at variance 1."""
    cfg, bx, tx, y = problem.cfg, problem.branch_x, problem.trunk_x, problem.y
    if problem.compute_dtype is not None:
        apply_flat = make_flat_deeponet(cfg, problem.compute_dtype)
    elif density_precision == "default":
        apply_flat = default_precision_apply(cfg)
    elif density_precision in ("float32", "highest"):
        return make_nll_log_likelihood(cfg, bx, tx, y, TAU_VAR)
    else:
        raise ValueError(f"density_precision {density_precision!r}")

    def full_ll(flat):
        return nll_log_likelihood(apply_flat(flat, bx, tx), y, TAU_VAR)

    return full_ll


def laplace_inv_mass(scores, sigma, idx, n_eff) -> np.ndarray:
    """Diagonal conditional-Laplace variances (``bench.py:500-507``), in the
    same numpy arithmetic as the JAX bench."""
    g2 = scores[idx] / np.maximum(sigma[idx] ** 2, 1e-30)
    return (1.0 / (1.0 / np.maximum(sigma[idx] ** 2, 1e-30) + n_eff * g2)).astype(np.float32)


def problem_laplace_inv_mass(problem: BenchProblem) -> torch.Tensor:
    """:func:`laplace_inv_mass` of the bundle behind ``problem``."""
    if problem.provenance.get("posterior") != "vi_fit":
        raise ValueError("--laplace-mass needs the real stage-1/2 asset posterior "
                         "(scores are per-parameter artifacts)")
    idx = problem.idx
    n_eff = problem.branch_x.shape[0] * problem.trunk_x.shape[0]
    sigma = problem.spec.sigma.cpu().numpy()
    return torch.as_tensor(laplace_inv_mass(problem.scores, sigma, idx, n_eff),
                           device=problem.y.device)


def trajectory_field(problem: BenchProblem, prior, inv_mass_vec, use_gram: bool = True,
                     stride=None, fn_stride=None, gauss_alpha=None,
                     grad_dtype: str = "float32", quick: bool = False) -> Optional[Callable]:
    """The row's clipped trajectory field (``bench.py:515-563``): the
    VI-Gaussian score (``gauss_alpha``), the Gram field on the full grid or on
    the stride subsets (default strides 5, 2 at ``quick``; 1 = every point)
    in f32 or bf16, or None (autograd of the density; also under
    ``compute_dtype``). Clipped at ``BENCH_CLIP sqrt(d / 2048)``."""
    spec = problem.spec
    clip = BENCH_CLIP * (spec.subspace_dim / 2048.0) ** 0.5
    if problem.compute_dtype is not None:
        return None
    if gauss_alpha is not None:
        field = gaussian_field_grad(spec.sub_mu(), spec.sub_sigma(), gauss_alpha)
        return clipped_grad_fn(field, clip, inv_mass=inv_mass_vec)
    if not use_gram:
        return None
    stride = (2 if quick else BENCH_STRIDE) if stride is None else stride
    fn_stride = (2 if quick else BENCH_FN_STRIDE) if fn_stride is None else fn_stride
    subset = fn_subset = None
    if stride and stride > 1:
        subset = grid_stride_subset(*infer_grid_shape(problem.trunk_x), stride)
    if fn_stride and fn_stride > 1:
        fn_subset = np.arange(0, problem.branch_x.shape[0], fn_stride)
    grad_full = make_gram_grad_full(
        problem.cfg, problem.branch_x, problem.trunk_x, problem.y, TAU_VAR,
        compute_dtype=torch.bfloat16 if grad_dtype == "bfloat16" else None,
        query_subset=subset, fn_subset=fn_subset)
    return clipped_grad_fn(make_subspace_grad(grad_full, spec, prior=prior), clip,
                           inv_mass=inv_mass_vec)


def mh_delta(problem: BenchProblem, prior, paired_delta: bool = True,
             fused_delta: bool = True) -> Optional[Callable]:
    """The row's paired MH delta (``bench.py:565-585``): the fused form (one
    ``paired_sums`` launch for all chains), the composed f32 form, or None
    (the unpaired test on the density; also under ``compute_dtype``)."""
    if not paired_delta or problem.compute_dtype is not None:
        return None
    args = (problem.branch_x, problem.trunk_x, problem.y, TAU_VAR, problem.spec.idx, prior)
    if fused_delta:
        return make_fused_paired_subspace_delta(problem.cfg, *args)
    return make_paired_subspace_delta(make_flat_deeponet(problem.cfg), *args)


# ---------------------------------------------------------------------------
# The metric
# ---------------------------------------------------------------------------

def lowrank_metric(log_prob, aux, q_center, inv_mass_diag, rank: int,
                   iters: Optional[int] = None, cache_file: Optional[str] = None,
                   two_sided: bool = False):
    """Rank-``rank`` Lanczos metric at ``q_center`` (``bench.py:925-996``):
    eigenpairs of the preconditioned HVP of ``log_prob`` in IEEE f32; the
    top ones floored at 1 through :func:`lowrank_from_eigs`, or with
    ``two_sided`` the ``rank/2`` stiffest and softest through
    :func:`eigen_metric_from_eigs`. Returns ``(metric, extras)`` with JAX's
    extras; with ``cache_file`` the eigenpairs are read from or written to
    that ``.npz``."""
    dim = q_center.shape[0]
    iters = int(iters) if iters else max(2 * rank, rank + 10)
    dev = q_center.device
    diag = torch.as_tensor(inv_mass_diag, dtype=torch.float32, device=dev) \
        * torch.ones(dim, device=dev)
    cached = cache_file is not None and os.path.exists(cache_file)
    if cached:
        with np.load(cache_file) as z:
            eigvals = torch.as_tensor(z["eigvals"], device=dev)
            eigvecs = torch.as_tensor(z["eigvecs"], device=dev)
            lanczos_s = float(z["lanczos_s"]) if "lanczos_s" in z.files else 0.0
    else:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(LANCZOS_SEED)
        with profiling.span("vihmc.lanczos", dev), true_f32():
            mv = preconditioned_hvp(log_prob, q_center, diag, aux=aux)
            eigvals, eigvecs = lanczos_eigs(mv, dim, rank, num_iters=iters, generator=gen,
                                            device=dev, which="both" if two_sided else "top")
        sync(dev)
        lanczos_s = time.perf_counter() - t0
        if cache_file is not None:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            np.savez(cache_file, eigvals=eigvals.cpu().numpy(),
                     eigvecs=eigvecs.cpu().numpy(), lanczos_s=lanczos_s)
        print(f"# lanczos: rank {rank}, {iters} iters in {lanczos_s:.1f}s", file=sys.stderr)
    if two_sided:
        metric = eigen_metric_from_eigs(diag, eigvals, eigvecs, min_eig=0.01)
    else:
        metric = lowrank_from_eigs(diag, torch.clamp(eigvals, min=1.0), eigvecs)
    ev = np.sort(eigvals.cpu().numpy())[::-1]
    extras = {
        "rank": rank, "iters": iters, "lanczos_s": round(lanczos_s, 1),
        "two_sided": two_sided, "cached": cached,
        "cache": os.path.basename(cache_file) if cache_file else None,
        "eig_top8": [round(float(x), 1) for x in ev[:8]],
        "eig_min_kept": round(float(ev.min()), 2),
        "n_above_10": int((ev > 10).sum()),
        "n_above_100": int((ev > 100).sum()),
        "n_above_1000": int((ev > 1000).sum()),
        "eig_bottom4": [float(f"{x:.3g}") for x in ev[-4:]],
        "n_below_0.5": int((ev < 0.5).sum()),
    }
    return metric, extras


def hutchinson_metric(log_prob, aux, q_center, inv_mass_vec, spec: SubspaceSpec,
                      n_probes: int):
    """The measured conditional diagonal (``bench.py:604-632``): ``n_probes``
    Hutchinson HVP probes at ``q_center``, the precision floored at a quarter
    of the prior precision. Returns ``(inverse mass (d,), extras)``."""
    t0 = time.perf_counter()
    dev = q_center.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(HUTCH_SEED)
    with true_f32():
        est = hutchinson_diag(hvp_fn(log_prob, q_center, aux=aux), q_center.shape[0],
                              n_probes, generator=gen, device=dev).cpu().numpy()
    prior_prec = 1.0 / np.maximum(spec.sub_sigma().cpu().numpy() ** 2, 1e-30)
    prec = np.maximum(est, 0.25 * prior_prec)
    ratio = (inv_mass_vec * torch.ones_like(q_center)).cpu().numpy() * prec
    extras = {"probes": n_probes, "wall_s": round(time.perf_counter() - t0, 1),
              "floored_frac": float(np.mean(est < 0.25 * prior_prec)),
              "vs_prev_diag_ratio_quantiles": [float(f"{np.quantile(ratio, q):.3g}")
                                               for q in (0.05, 0.5, 0.95)]}
    print(f"# hutch diag: {n_probes} probes in {extras['wall_s']}s; prev-diag ratio "
          f"q05/50/95 {extras['vs_prev_diag_ratio_quantiles']}", file=sys.stderr)
    return torch.as_tensor(1.0 / prec, dtype=torch.float32, device=dev), extras


def segment_walls(t0_ns: int) -> list:
    """Seconds (to the millisecond) of each sampler segment that started after
    ``t0_ns`` (``perf_counter_ns``), from the recorder's ``vihmc.segment``
    spans: each from the end of the one before, the first from ``t0_ns``."""
    ends = [r["host_t1"] for r in profiling.records()
            if r["name"] == "vihmc.segment" and r["host_t0"] >= t0_ns
            and r["host_t1"] is not None]
    return [round((b - a) * 1e-9, 3) for a, b in zip([t0_ns] + ends, ends)]


def sampler_config(n_samples: int, n_burn: int, num_leapfrog: int, coupled: bool = False,
                   adaptive: bool = False, target_accept=None, windowed_mass: bool = False,
                   persist: float = 0.0) -> HMCConfig:
    """The row's three recipes (``bench.py:657-693``): coupled dual averaging
    with ``adapt_forever`` and step jitter (``windowed_mass``: the pooled
    windowed metric), the legacy adaptive one, or the fixed jittered step."""
    if coupled:
        return HMCConfig(num_samples=n_samples, num_leapfrog=num_leapfrog, step_size=0.1,
                         burn=n_burn, sampler="hmc_nuts",
                         target_accept=0.65 if target_accept is None else target_accept,
                         da_axis="chains", adapt_forever=True, jitter_eps=True,
                         jitter_low_frac=0.5, adapt_mass=windowed_mass,
                         mass_schedule="windowed" if windowed_mass else "half",
                         metric_axis="chains" if windowed_mass else None,
                         momentum_persistence=persist)
    if adaptive:
        return HMCConfig(num_samples=n_samples, num_leapfrog=num_leapfrog, step_size=1e-4,
                         burn=n_burn, sampler="hmc_nuts", target_accept=BENCH_TARGET_ACCEPT)
    return HMCConfig(num_samples=n_samples, num_leapfrog=num_leapfrog, step_size=BENCH_STEP,
                     burn=n_burn, sampler="hmc", jitter_l=True,
                     jitter_low_frac=BENCH_JITTER_LOW, momentum_persistence=persist)


# ---------------------------------------------------------------------------
# The key loop and the headline
# ---------------------------------------------------------------------------

def key_stats(res, key: int, elapsed: float, n_chains: int, n_samples: int, n_burn: int,
              thin: int) -> dict:
    """One key's statistics (``bench.py:768-813``) from its result."""
    post = res.samples[:, n_burn // thin:, :]
    ess, raw_tau, tau_floor = effective_sample_size_np(post, return_tau=True)
    half = post.shape[1] // 2
    step_tr = np.asarray(res.step_sizes)
    if step_tr.ndim == 2:
        step_tr = np.median(step_tr, axis=0)
    n4 = len(step_tr)
    qs = ([float(np.median(step_tr[i * n4 // 4:(i + 1) * n4 // 4])) for i in range(4)]
          if n4 >= 4 else [])
    return {
        "key": key,
        "elapsed_s": elapsed,
        "step_quartiles": [float(f"{q:.3g}") for q in qs],
        "samples_per_s": n_chains * n_samples / elapsed,
        "ess_median": float(np.median(ess)),
        "ess_bulk_median": float(np.median(ess_bulk_np(post))),
        "ess_min": float(np.min(ess)),
        "ess_median_half1": float(np.median(effective_sample_size_np(post[:, :half]))),
        "ess_median_half2": float(np.median(effective_sample_size_np(post[:, half:]))),
        "rhat_max": float(np.max(rhat_rank_np(post))) if post.shape[0] > 1 else None,
        "tau_floor_frac": float(np.mean(raw_tau < tau_floor)),
        "ess_per_s": float(np.median(ess)) / elapsed,
        "acceptance": float(res.acceptance_rate),
    }


def aggregate_keys(per_key: list) -> dict:
    """The headline over keys (``bench.py:830-858``): the representative key
    is the one of median ESS; ``ess_per_s`` is the median ESS over the median
    wall, with both lists, the wall spread, the median min-ESS rate and the
    worst R-hat beside it. Sorts ``per_key`` by ESS in place."""
    per_key.sort(key=lambda s: s["ess_median"])
    stats = dict(per_key[len(per_key) // 2])
    ess_k = sorted(s["ess_median"] for s in per_key)
    wall_k = sorted(s["elapsed_s"] for s in per_key)
    med_ess, med_wall = float(np.median(ess_k)), float(np.median(wall_k))
    rhats = [s["rhat_max"] for s in per_key if s.get("rhat_max") is not None]
    ess_mins = sorted(s["ess_min"] for s in per_key)
    stats.update({
        "ess_per_s": med_ess / med_wall,
        "ess_median_by_key": [round(e, 1) for e in ess_k],
        "wall_s_by_key": [round(w, 2) for w in wall_k],
        "wall_s_median": round(med_wall, 3),
        "wall_spread_frac": (round((wall_k[-1] - wall_k[0]) / med_wall, 3)
                             if len(wall_k) > 1 else 0.0),
        "ess_min_per_s": round(float(np.median(ess_mins)) / med_wall, 4),
        "rhat_max": round(max(rhats), 4) if rhats else None,
        "ess_per_s_by_key": [round(s["ess_per_s"], 3) for s in per_key],
    })
    return stats


def bench_operator(quick: bool = False, compute_dtype=None, draws=None, burn=None,
                   use_gram: bool = True, adaptive: bool = False, keys=None, stride=None,
                   fn_stride=None, gauss_alpha=None, coupled: bool = False, sub_dim=None,
                   chains=None, segment=None, windowed_mass: bool = False, thin: int = 1,
                   num_leapfrog=None, frozen_policy: str = "draw",
                   laplace_mass: bool = False, asset: str = "prod", lowrank_rank: int = 0,
                   lowrank_iters=None, init_opt: int = 0, density_precision: str = "float32",
                   target_accept=None, hutch_diag: int = 0, eigen_two_sided: bool = False,
                   paired_delta: bool = True, grad_dtype: str = "float32",
                   persist: float = 0.0, fused_delta: bool = True, device="cuda",
                   problem: Optional[BenchProblem] = None):
    """Run the operator row with ``bench_jax``'s keywords and return
    ``(stats, problem)``: JAX's statistics (module doc) plus ``draws_per_s``
    (draws over the median sampling wall, each draw moving every chain),
    ``phases_s``, ``device``, ``samples_finite`` and the representative key's
    ``samples_shape``. ``problem`` reuses a built posterior on ``device``
    (``draws`` and ``chains`` still override its counts)."""
    dev = resolve_device(device)
    phases = {}
    if dev.type == "cuda":
        t0 = time.perf_counter()
        cuda_build.build_all()
        phases["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if problem is None:
        problem = build_problem(quick, compute_dtype, draws=draws, sub_dim=sub_dim,
                                asset=asset, device=dev)
    sync(dev)
    phases["problem_s"] = time.perf_counter() - t0
    spec = problem.spec
    d = spec.subspace_dim
    n_chains = problem.n_chains if chains is None else chains
    n_samples = problem.n_samples if draws is None else draws
    bench_l = BENCH_L if num_leapfrog is None else num_leapfrog
    n_burn = n_samples // 5 if burn is None else burn

    policy = FrozenPolicy(frozen_policy)
    lp_like, aux0 = make_subspace_log_prob(
        density_log_likelihood(problem, density_precision), spec, problem.frozen, policy)
    refresh = make_aux_refresh(spec, policy)
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())

    def log_prob(q, aux):
        return lp_like(q, aux) + prior.log_prob(q)

    inv_mass_vec = spec.sub_sigma() ** 2
    if laplace_mass:
        inv_mass_vec = problem_laplace_inv_mass(problem)
    grad_fn = trajectory_field(problem, prior, inv_mass_vec, use_gram, stride, fn_stride,
                               gauss_alpha, grad_dtype, quick)
    delta_fn = mh_delta(problem, prior, paired_delta, fused_delta)

    t0 = time.perf_counter()
    inits = spec.sub_mu().expand(n_chains, -1).clone()
    q_center = spec.sub_mu()
    if init_opt:
        oracle = grad_fn or (lambda q, a: value_and_grad(log_prob, q, a)[1])
        gen = torch.Generator(device=dev)
        gen.manual_seed(WARM_SEED)
        inits = conditional_warm_start(oracle, aux0, spec.sub_mu(), inv_mass_vec, init_opt,
                                       n_chains, gen)
        q_center = inits.mean(0)
    sync(dev)
    warm_s = time.perf_counter() - t0
    phases["warm_start_s"] = warm_s
    if init_opt:
        print(f"# warm start: {init_opt} preconditioned Adam steps in {warm_s:.1f}s",
              file=sys.stderr)

    hutch_extras = None
    if hutch_diag and problem.compute_dtype is None:
        t0 = time.perf_counter()
        inv_mass_vec, hutch_extras = hutchinson_metric(log_prob, aux0, q_center, inv_mass_vec,
                                                       spec, hutch_diag)
        phases["hutch_s"] = time.perf_counter() - t0

    kinetic_metric, lowrank_extras = inv_mass_vec, None
    if lowrank_rank and problem.compute_dtype is None:
        t0 = time.perf_counter()
        iters = int(lowrank_iters) if lowrank_iters else max(2 * lowrank_rank, lowrank_rank + 10)
        tag = (f"{problem.provenance.get('assets', 'synth')}_d{d}"
               f"_{'lap' if laplace_mass else 'vi'}{f'_h{hutch_diag}' if hutch_diag else ''}"
               f"_{frozen_policy}_w{init_opt}_c{n_chains}")
        cache = os.path.join(CACHE_DIR, f"{tag}_k{lowrank_rank}_i{iters}"
                                         f"{'_2s' if eigen_two_sided else ''}.npz")
        kinetic_metric, lowrank_extras = lowrank_metric(
            log_prob, aux0, q_center, inv_mass_vec, lowrank_rank, iters, cache,
            two_sided=eigen_two_sided)
        phases["lanczos_s"] = time.perf_counter() - t0

    hmc_cfg = sampler_config(n_samples, n_burn, bench_l, coupled, adaptive, target_accept,
                             windowed_mass, persist)
    seg = segment if segment is not None else (120 if d <= 16384 else 60)
    if thin > 1 and (seg % thin or n_burn % thin):
        raise ValueError("--thin must divide the segment size and burn")
    segmented = n_samples > seg
    if not segmented and thin > 1:
        raise ValueError("thin requires the segmented path (draws > segment)")

    if keys is None:
        keys = (BENCH_KEYS[0],) if quick else BENCH_KEYS
    per_key, sampling_s = [], []
    for k in keys:
        t0_ns = time.perf_counter_ns()
        res = sample_chains_resumable(
            log_prob, inits, hmc_cfg, seg if segmented else n_samples, kinetic_metric, aux0,
            grad_fn, delta_fn, thin=thin, seed=k, aux_refresh=refresh)
        sync(dev)
        sampling_s.append((time.perf_counter_ns() - t0_ns) * 1e-9)
        stats_k = key_stats(res, k, sampling_s[-1] + warm_s, n_chains, n_samples, n_burn, thin)
        stats_k.update(samples_finite=bool(np.isfinite(res.samples).all()),
                       samples_shape=list(res.samples.shape))
        walls = segment_walls(t0_ns)
        if segmented and walls:
            stats_k["seg_wall_s"] = walls
        if stats_k["tau_floor_frac"] > 0.01:
            print(f"# WARNING key {k}: tau floor binds on "
                  f"{100 * stats_k['tau_floor_frac']:.1f}% of dims -- raw ESS unreliable, "
                  f"see ess_bulk_median", file=sys.stderr)
        if gauss_alpha is None:
            # (L + 1) likelihood gradients per draw; none under the Gaussian field
            stats_k["grad_evals_per_s"] = n_chains * n_samples * (bench_l + 1) / stats_k[
                "elapsed_s"]
        per_key.append(stats_k)
        del res

    stats = aggregate_keys(per_key)
    stats.update({
        "subspace_dim": d,
        "chains": n_chains,
        "draws": n_samples,
        "burn": n_burn,
        "frozen_policy": frozen_policy,
        "density_precision": density_precision,
        "grad_dtype": grad_dtype,
        "paired_delta": delta_fn is not None,
        "fused_delta": bool(fused_delta and delta_fn is not None),
        "init_opt": init_opt,
        "warm_start_s": round(warm_s, 2),
        "posterior_provenance": dict(problem.provenance),
        "samples_finite": all(s["samples_finite"] for s in per_key),
        "draws_per_s": n_samples / float(np.median(sampling_s)),
        "phases_s": {**phases, "sampling_s_median": float(np.median(sampling_s))},
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    })
    if lowrank_extras is not None:
        stats["lowrank_metric"] = lowrank_extras
    if hutch_extras is not None:
        stats["hutch_diag"] = hutch_extras
    total_flops = sampling_flops(log_prob, hmc_cfg, inits, kinetic_metric, aux0, n_samples,
                                 grad_fn=grad_fn, delta_fn=delta_fn, aux_refresh=refresh)
    stats["mfu"] = mfu_stats(total_flops, stats["wall_s_median"], n_chains, n_samples, dev)
    return stats, problem


# ---------------------------------------------------------------------------
# --extras' gradient path and the CPU baseline
# ---------------------------------------------------------------------------

def grad_path_log_posteriors(problem: BenchProblem):
    """``(composed, fused, flat0)``: the full-parameter log posterior of
    ``bench_grad_path`` (``bench.py:1011-1016``: NLL at variance 1 plus an
    isotropic N(0, 0.1^2) prior) through the materialized f32 forward and
    through ``fused_merge_nll`` (one ``merge_sums`` launch at C = 1 per
    evaluation, the composed backward), and the point the gradients are
    taken at: the VI mean (JAX takes its init parameters, which the port
    does not draw), as ``(1, D)``."""
    cfg, bx, tx, y = problem.cfg, problem.branch_x, problem.trunk_x, problem.y
    prior = IsotropicGaussianPrior(scale=0.1)
    apply_flat = make_flat_deeponet(cfg)

    def forward(flat):
        with true_f32():
            return apply_flat(flat, bx, tx)

    composed = make_log_posterior(forward, y, "NLL", TAU_VAR, prior)
    fused = make_deeponet_nll_log_posterior(cfg, bx, tx, y, TAU_VAR, prior=prior)
    return composed, fused, problem.spec.mu[None].clone()


def log_posterior_grad(log_prob, flat):
    """The gradient of ``log_prob(flat (1, D)).sum()`` by autograd."""
    with torch.enable_grad():
        x = flat.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(log_prob(x).sum(), x)
    return g


def bench_grad_path(quick: bool = False, iters: int = 30, device="cuda",
                    problem: Optional[BenchProblem] = None) -> dict:
    """Composed vs fused gradient evaluations per second of the full log
    posterior (``bench.py:999-1028``), ``iters`` serialized evaluations each."""
    dev = resolve_device(device)
    if problem is None:
        problem = build_problem(quick, device=dev)
    composed, fused, flat0 = grad_path_log_posteriors(problem)
    out = {}
    for name, lp in (("composed", composed), ("fused", fused)):
        log_posterior_grad(lp, flat0)
        sync(dev)
        t0 = time.perf_counter()
        x = flat0
        for _ in range(iters):
            x = x + 0.0 * log_posterior_grad(lp, x)
        sync(dev)
        out[f"grad_evals_per_s_{name}"] = iters / (time.perf_counter() - t0)
    return out


def baseline_log_prob(problem: BenchProblem):
    """The CPU baseline's one-chain log density ``log_prob(q_sub (d,), frozen
    (D,)) -> scalar`` (``bench.py:1541-1591``) on ``problem`` (CPU tensors):
    the DeepONet unpacked by the port's own flat layout, ``-sum``
    GaussianNLLLoss at variance 1, the VI-posterior prior on the subspace; a
    non-finite state gets -inf (a rejection, as the reference's
    ``LogProbError``)."""
    cfg, idx = problem.cfg, problem.spec.idx
    mu, sigma = problem.spec.mu, problem.spec.sigma
    nll = torch.nn.GaussianNLLLoss(reduction="sum")
    prior = torch.distributions.Normal(mu[idx], sigma[idx])

    def log_prob(q_sub, frozen):
        if not torch.isfinite(q_sub).all():
            return (torch.nan_to_num(q_sub) * 0.0).sum() + float("-inf")
        full = frozen.clone()
        full[idx] = q_sub
        pred = deeponet_apply(cfg, unravel_deeponet(cfg, full[None]), problem.branch_x,
                              problem.trunk_x)[0]
        return -nll(pred, problem.y, torch.ones_like(pred)) + prior.log_prob(q_sub).sum()

    return log_prob


def bench_torch_baseline(quick: bool = False, max_seconds: float = 120.0,
                         collect: bool = False, step: float = 1e-4, jitter_low_frac=None,
                         sub_dim=None, asset: str = "prod", L=None,
                         problem: Optional[BenchProblem] = None) -> dict:
    """The operator row's posterior and trajectory cost in a one-chain torch
    loop on the CPU (``bench.py:1510-1603``): the frozen coordinates redrawn
    from the VI posterior before every draw, the VI variances as the metric,
    ``L`` (default ``BENCH_L``) steps of ``step`` from the VI mean, the field
    clipped as the row's with ``collect``. Stops after the problem's draws or
    ``max_seconds``; returns :func:`~vihmc_torch.bench_nn.torch_hmc_timing`'s
    dict. ``problem`` (on the CPU) replaces the one built from ``quick``,
    ``sub_dim`` and ``asset``."""
    torch.manual_seed(0)
    if problem is None:
        problem = build_problem(quick, sub_dim=sub_dim, asset=asset, device="cpu")
    mu, sigma, idx = problem.spec.mu, problem.spec.sigma, problem.spec.idx
    clip = BENCH_CLIP * (len(idx) / 2048.0) ** 0.5 if collect else None
    return torch_hmc_timing(
        baseline_log_prob(problem), lambda: mu + sigma * torch.randn_like(mu), mu[idx],
        sigma[idx] ** 2, step, BENCH_L if L is None else L, problem.n_samples, max_seconds,
        collect=collect, jitter_low_frac=jitter_low_frac, clip_norm=clip)
