"""The NN row: subspace VI-HMC on the 141-parameter regression MLP.

The port's counterpart of ``bench.py``'s second headline row
(``build_nn_problem`` + ``bench_nn``, bench.py:1030-1300):

* model and data: ``MLPConfig()`` (1 -> 10 -> 10 -> 1 tanh, 141 parameters) on JAX's 20
  training points (``regression_data(jax.random.key(0), 20, 300)``, exported
  to ``assets/nn_port_inputs.npz`` by ``scripts/export_nn_port_inputs.py``),
  NLL at tau = 5e-2^2;
* subspace: ``assets/nn_stage12.npz``'s VI mu and sigma and its 73
  sensitive indices, the rest frozen per ``frozen_policy`` -- DRAW (the
  default) at JAX's exported frozen draw ``draw_full(jax.random.key(0),
  spec)``, MEAN at mu, REFRESH redrawn per chain before every draw -- plus
  the VI-posterior subspace prior;
* setup: autograd trajectory gradients clipped at preconditioned norm
  13 sqrt(d), a 400-step preconditioned-Adam warm start, the VI variances as
  the metric (``rank`` > 0: plus a rank-k Lanczos low-rank term at the
  warm-start mean);
* sampling: 1024 chains, L = 96, chain-coupled dual averaging at 0.65 with
  ``adapt_forever`` and step jitter over [0.5, 1] (``step``: the fixed-step
  mode with trajectory-length jitter over [L/2, L] instead), optional
  momentum persistence; 2880 draws, burn 576, in segments of 480 thinned by
  24 on the device (``draws <= segment``: one :func:`sample_chains` call);
* output: a warm run, then one run per key of ``BENCH_KEYS``; the headline is
  function-space ESS/s over the 20 training-point probe outputs
  (``function_space_diagnostics``), with the weight-space ESS, its
  chain-floor flag and both R-hats beside it; the keys of JAX's row;
* instruments (bench.py:1307-1340): the ``mfu`` block
  (:mod:`vihmc_torch.bench_mfu`: the draws' matmul FLOPs counted from one
  transition at the row's chains, over the median wall, against the card's
  bf16 peak) and the CPU torch baseline (:func:`bench_torch_baseline_nn`:
  one chain of the same posterior and trajectory on the CPU, capped at
  ``baseline_seconds``), with ``torch_cpu_samples_per_s``, ``vs_baseline``,
  and, when the baseline chain reached 100 draws, ``torch_cpu_ess_per_s``
  and ``vs_baseline_ess_like_for_like``. Unlike JAX's, the ``mfu`` block is
  not wrapped in a ``try``: a failure stops the row.

Run on the card::

    python -m vihmc_torch.bench_nn [--frozen-policy draw|refresh|mean]
        [--step S] [--L 96] [--chains 1024] [--rank K] [--draws 2880]
        [--thin 24] [--segment 480] [--persist ALPHA] [--keys 2,3,4,5,6]
        [--skip-baseline] [--baseline-seconds 120]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Optional

import numpy as np
import torch

from vihmc_torch.chains.diagnostics import effective_sample_size_np, rhat_rank_np
from vihmc_torch.chains.parallel import sample_chains
from vihmc_torch.bench_mfu import mfu_stats, sampling_flops
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core.device import resolve_device, stream_generator, sync
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.dists.likelihoods import nll_log_likelihood
from vihmc_torch.dists.priors import DiagonalGaussianPrior
from vihmc_torch.hmc.kernel import HMCConfig, clipped_grad_fn
from vihmc_torch.hmc.subspace import (FrozenPolicy, SubspaceSpec, make_aux_refresh,
                                      make_subspace_log_prob)
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.pipelines.common import conditional_warm_start, make_flat_mlp
from vihmc_torch.pipelines.postprocess import function_space_diagnostics

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
NN_STAGE12_ASSET = os.path.join(_ASSETS, "nn_stage12.npz")
NN_PORT_INPUTS = os.path.join(_ASSETS, "nn_port_inputs.npz")
#: headline = median ESS/s over these keys (bench.py BENCH_KEYS)
BENCH_KEYS = (2, 3, 4, 5, 6)
#: the warm run's key and the warm start's generator stream (JAX: key 0xA12)
WARM_KEY, WARM_START_STREAM = 1, 0xA12
WARM_STEPS = 400
TAU_OUT = 5e-2 ** 2
JITTER_LOW = 0.5
CLIP_SCALE = 13.0


def build_nn_problem(device="cuda", frozen_policy: str = "draw"):
    """``(log_prob, aux0, refresh, spec, apply_flat, x, y, provenance)``:
    the NN row's posterior over the asset's subspace (module doc)."""
    dev = resolve_device(device)
    with np.load(NN_STAGE12_ASSET) as z:
        mu, sigma, idx = z["mu"], z["sigma"], z["indices"]
        provenance = {"posterior": "vi_fit", "assets": os.path.basename(NN_STAGE12_ASSET),
                      "vi_valid_mse_best": float(np.min(z["vi_valid_mse"])),
                      "subspace": f"{len(idx)}/{len(mu)} at the 90% sensitivity threshold"}
    with np.load(NN_PORT_INPUTS) as z:
        x = torch.as_tensor(z["x_train"], device=dev)
        y = torch.as_tensor(z["y_train"], device=dev)
        frozen = torch.as_tensor(z["frozen_draw"], device=dev)
    spec = SubspaceSpec(idx=torch.as_tensor(idx, dtype=torch.int64, device=dev),
                        mu=torch.as_tensor(mu, device=dev),
                        sigma=torch.as_tensor(sigma, device=dev))
    apply_flat = make_flat_mlp(MLPConfig())
    policy = FrozenPolicy(frozen_policy)

    def full_ll(flat):
        with true_f32():
            return nll_log_likelihood(apply_flat(flat, x), y, TAU_OUT)

    lp_like, aux0 = make_subspace_log_prob(full_ll, spec, frozen, policy)
    prior = DiagonalGaussianPrior(loc=spec.sub_mu(), scale=spec.sub_sigma())

    def log_prob(q, aux):
        return lp_like(q, aux) + prior.log_prob(q)

    return (log_prob, aux0, make_aux_refresh(spec, policy), spec, apply_flat, x, y,
            provenance)


def nn_config(draws: int, L: int, step: float, fixed_step: bool,
              persist: float = 0.0) -> HMCConfig:
    """The row's sampler settings: burn ``draws // 5``; the fixed-step mode
    with length jitter, or the coupled dual-averaging recipe with step
    jitter (bench.py:1168-1186)."""
    burn = draws // 5
    if fixed_step:
        return HMCConfig(num_samples=draws, num_leapfrog=L, step_size=step, burn=burn,
                         sampler="hmc", jitter_l=True, jitter_low_frac=JITTER_LOW,
                         momentum_persistence=persist)
    return HMCConfig(num_samples=draws, num_leapfrog=L, step_size=step, burn=burn,
                     sampler="hmc_nuts", target_accept=0.65, da_axis="chains",
                     adapt_forever=True, jitter_eps=True, jitter_low_frac=0.5,
                     momentum_persistence=persist)


def bench_nn(device="cuda", frozen_policy: str = "draw", step: Optional[float] = None,
             L: int = 96, chains: int = 1024, rank: int = 0, draws: int = 2880,
             thin: int = 24, segment: int = 480, persist: float = 0.0,
             keys=BENCH_KEYS, skip_baseline: bool = False,
             baseline_seconds: float = 120.0) -> dict:
    """Run the NN row and return its statistics (JAX's keys plus
    ``draws_per_s``, ``phases_s`` and ``device``; module doc)."""
    dev = resolve_device(device)
    phases = {}
    t0 = time.perf_counter()
    log_prob, aux0, refresh, spec, apply_flat, x, y, provenance = build_nn_problem(
        dev, frozen_policy)
    d = spec.subspace_dim
    inv_mass = spec.sub_sigma() ** 2
    grad_fn = clipped_grad_fn(log_prob, CLIP_SCALE * d ** 0.5, inv_mass=inv_mass,
                              is_grad=False)
    phases["problem_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    inits = conditional_warm_start(grad_fn, aux0, spec.sub_mu(), inv_mass, WARM_STEPS, chains,
                                   stream_generator(dev, 0, WARM_START_STREAM))
    sync(dev)
    warm_s = time.perf_counter() - t0
    metric, lowrank_extras = inv_mass, None
    if rank:
        from vihmc_torch.bench_operator import lowrank_metric

        metric, lowrank_extras = lowrank_metric(log_prob, aux0, inits.mean(0), inv_mass, rank)
        sync(dev)
    fixed_step = step is not None
    step = 0.1 if step is None else step
    cfg = nn_config(draws, L, step, fixed_step, persist)
    n_burn = cfg.burn
    if thin > 1 and (segment % thin or n_burn % thin):
        raise ValueError("NN thin must divide the segment size and burn")

    def run(key):
        if draws > segment:
            return sample_chains_resumable(log_prob, inits, cfg, segment, metric, aux0,
                                           grad_fn=grad_fn, thin=thin, seed=key,
                                           aux_refresh=refresh)
        res_ = sample_chains(log_prob, inits, cfg, inv_mass=metric, aux=aux0,
                             aux_refresh=refresh, grad_fn=grad_fn, seed=key)
        res_.samples = res_.samples[:, thin - 1::thin]
        return res_

    t0 = time.perf_counter()
    warm_state = run(WARM_KEY).final_state
    sync(dev)
    phases["warm_run_s"] = time.perf_counter() - t0
    adapted_step = float(np.exp(np.median(warm_state.da.log_step.cpu().numpy())))
    idx = spec.idx

    def predict_probe(q):
        with true_f32():
            return apply_flat(scatter_subspace(aux0, q, idx), x).reshape(q.shape[0], -1)

    per_key, sampling_s = [], []
    for k in keys:
        t0 = time.perf_counter()
        res = run(k)
        sync(dev)
        sampling_s.append(time.perf_counter() - t0)
        elapsed = sampling_s[-1] + warm_s
        post = res.samples[:, n_burn // thin:, :]
        ess_w = effective_sample_size_np(post)
        probes = function_space_diagnostics(post, predict_probe, chunk=8192,
                                            device=dev)["probes"]
        ess_fs = effective_sample_size_np(probes)
        multi = post.shape[0] > 1
        per_key.append({
            "key": k,
            "elapsed_s": elapsed,
            "samples_per_s": chains * draws / elapsed,
            "ess_median": float(np.median(ess_fs)),
            "ess_min": float(np.min(ess_fs)),
            "rhat_max": float(np.max(rhat_rank_np(probes))) if multi else None,
            "ess_weight_median": float(np.median(ess_w)),
            "ess_weight_at_chain_floor": bool(np.median(ess_w) <= 0.6 * post.shape[0]),
            "rhat_weight_max": float(np.max(rhat_rank_np(post))) if multi else None,
            "ess_per_s": float(np.median(ess_fs)) / elapsed,
            "acceptance": float(res.acceptance_rate),
        })
    # pooled ESS per key / median wall (bench.py's split-metric schema)
    per_key.sort(key=lambda s_: s_["ess_median"])
    stats = dict(per_key[len(per_key) // 2])
    ess_k = sorted(s_["ess_median"] for s_ in per_key)
    wall_k = sorted(s_["elapsed_s"] for s_ in per_key)
    med_ess, med_wall = float(np.median(ess_k)), float(np.median(wall_k))
    rhats = [s_["rhat_max"] for s_ in per_key if s_.get("rhat_max") is not None]
    rhats_w = [s_["rhat_weight_max"] for s_ in per_key
               if s_.get("rhat_weight_max") is not None]
    ess_mins = sorted(s_["ess_min"] for s_ in per_key)
    stats.update({
        "ess_per_s": med_ess / med_wall,
        "ess_kind": "function_space_probes",
        "ess_median_by_key": [round(e, 1) for e in ess_k],
        "wall_s_by_key": [round(w, 2) for w in wall_k],
        "wall_s_median": round(med_wall, 3),
        "wall_spread_frac": (round((wall_k[-1] - wall_k[0]) / med_wall, 3)
                             if len(wall_k) > 1 else 0.0),
        "ess_min_per_s": round(float(np.median(ess_mins)) / med_wall, 4),
        "rhat_max": round(max(rhats), 4) if rhats else None,
        "ess_weight_median_by_key": [round(s_["ess_weight_median"], 1) for s_ in per_key],
        "ess_weight_at_chain_floor": any(s_["ess_weight_at_chain_floor"] for s_ in per_key),
        "rhat_weight_max": round(max(rhats_w), 4) if rhats_w else None,
        "subspace_dim": d,
        "chains": chains,
        "draws": draws,
        "thin": thin,
        "L": L, "step": step if fixed_step else "coupled-da",
        "adapted_step": round(adapted_step, 6),
        "warm_start_s": round(warm_s, 2),
        "ess_per_s_by_key": [round(s_["ess_per_s"], 3) for s_ in per_key],
        "frozen_policy": frozen_policy,
        "posterior_provenance": provenance,
        # the port's additions: draws/s of the sampling alone (each draw
        # advances every chain), the phase walls and the device
        "draws_per_s": draws / float(np.median(sampling_s)),
        "phases_s": {**phases, "warm_start_s": warm_s,
                     "sampling_s_median": float(np.median(sampling_s))},
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    })
    if lowrank_extras is not None:
        stats["lowrank_metric"] = lowrank_extras
    total_flops = sampling_flops(log_prob, cfg, inits, metric, aux0, draws, grad_fn=grad_fn,
                                 aux_refresh=refresh)
    stats["mfu"] = mfu_stats(total_flops, med_wall, chains, draws, dev)
    if not skip_baseline:
        with np.load(NN_STAGE12_ASSET) as z:
            mu, sigma = z["mu"], z["sigma"]
        tb = bench_torch_baseline_nn(
            x.cpu().numpy(), y.cpu().numpy(), mu, sigma, idx.cpu().numpy(), L, adapted_step,
            draws, ref_forward=lambda f: apply_flat(f.to(x.device)[None], x)[0].cpu(),
            max_seconds=baseline_seconds, collect=True, jitter_low_frac=JITTER_LOW,
            frozen_policy=frozen_policy, init=inits[0].cpu().numpy(),
            frozen_vec=aux0.cpu().numpy())
        if tb is not None:
            stats["torch_cpu_samples_per_s"] = tb["samples_per_s"]
            stats["vs_baseline"] = stats["samples_per_s"] / tb["samples_per_s"]
            sam = tb.get("samples")
            if sam is not None and sam.shape[0] >= 100:
                # the baseline chain's draws through the same probe map
                t_probes = function_space_diagnostics(
                    sam[None, sam.shape[0] // 5:, :], predict_probe, chunk=8192,
                    device=dev)["probes"]
                t_ess = float(np.median(effective_sample_size_np(t_probes)))
                stats["torch_cpu_ess_per_s"] = t_ess / tb["elapsed_s"]
                stats["vs_baseline_ess_like_for_like"] = round(
                    stats["ess_per_s"] / stats["torch_cpu_ess_per_s"], 2)
    return stats


# ---------------------------------------------------------------------------
# The CPU torch baseline (bench.py:1346-1510): one chain, a plain loop
# ---------------------------------------------------------------------------

def torch_hmc_timing(log_prob, draw_frozen, q0, inv_mass, step, L, n_samples,
                     max_seconds, collect: bool = False, jitter_low_frac=None,
                     clip_norm=None) -> dict:
    """Time a one-chain HMC loop on the CPU (bench.py's ``_torch_hmc_timing``):
    the frozen vector from ``draw_frozen()`` before each draw, momentum
    ``N(0, 1 / inv_mass)``, ``L`` leapfrog steps (with ``jitter_low_frac`` a
    length uniform over [frac L, L], the masked steps skipped), the MH test.
    Stops after ``n_samples`` draws or ``max_seconds``. Returns
    ``elapsed_s``, ``samples_per_s`` (1 / the median draw time), ``draws``
    and, with ``collect``, the chain's ``samples`` (n, d)."""
    def grad_lp(q, frozen):
        q = q.detach().requires_grad_(True)
        lp = log_prob(q, frozen)
        (g,) = torch.autograd.grad(lp, q)
        g = torch.nan_to_num(g)
        if clip_norm is not None:
            norm = torch.sqrt((inv_mass * g * g).sum())
            g = g * torch.clamp(clip_norm / (norm + 1e-30), max=1.0)
        return lp.detach(), g

    q = q0.clone()
    n_done = 0
    draw_times = []
    chain = [] if collect else None
    t0 = time.perf_counter()
    while n_done < n_samples and time.perf_counter() - t0 < max_seconds:
        td = time.perf_counter()
        l_eff = L
        if jitter_low_frac:
            lo = max(1, int(jitter_low_frac * L))
            l_eff = int(torch.randint(lo, L + 1, ()).item())
        frozen = draw_frozen()
        lp0, g = grad_lp(q, frozen)
        p = torch.randn_like(q) / inv_mass.sqrt()
        q_new, p_new, g_new = q.clone(), p.clone(), g.clone()
        lp1 = lp0
        for _ in range(l_eff):
            p_new = p_new + 0.5 * step * g_new
            q_new = q_new + step * inv_mass * p_new
            lp1, g_new = grad_lp(q_new, frozen)
            p_new = p_new + 0.5 * step * g_new
        delta = (lp1 - 0.5 * (inv_mass * p_new * p_new).sum()) - \
            (lp0 - 0.5 * (inv_mass * p * p).sum())
        if torch.isfinite(delta) and torch.log(torch.rand(())) < delta:
            q = q_new
        n_done += 1
        if collect:
            chain.append(q.detach().to(torch.float32).clone())
        draw_times.append(time.perf_counter() - td)
    per_draw = statistics.median(draw_times) if draw_times else float("inf")
    out = {"elapsed_s": time.perf_counter() - t0, "samples_per_s": 1.0 / per_draw,
           "draws": n_done}
    if collect and chain:
        out["samples"] = torch.stack(chain).numpy()
    return out


def bench_torch_baseline_nn(x, y, mu, sigma, idx, L, step, n_samples, ref_forward=None,
                            max_seconds: float = 120.0, collect: bool = False,
                            jitter_low_frac=None, frozen_policy: str = "refresh",
                            init=None, frozen_vec=None) -> Optional[dict]:
    """The NN row's posterior and trajectory cost in a one-chain torch loop on
    the CPU, the reference's substrate (bench.py's ``bench_torch_baseline_nn``):
    the 141-parameter tanh MLP unpacked by hand from the flat vector, the NLL
    at tau 5e-2^2, the VI-posterior prior on the subspace ``idx``, the frozen
    coordinates per ``frozen_policy`` (DRAW: ``frozen_vec``, the row's own),
    ``L`` steps of ``step`` from ``init``; with ``collect`` the trajectory
    field is clipped as the row's. ``ref_forward(flat) -> (N, 1)`` checks the
    hand unpack against the port's forward first (None if they differ)."""
    torch.manual_seed(0)
    dims = MLPConfig().layer_dims
    x_t, y_t, mu_t, sigma_t = (torch.tensor(np.asarray(a, np.float32))
                               for a in (x, y, mu, sigma))
    idx_t = torch.tensor(np.asarray(idx), dtype=torch.long)

    def forward(flat):
        # ravel_pytree order: per layer the bias, then the row-major (out, in) weight
        i, h = 0, x_t
        for li, (d_in, d_out) in enumerate(dims):
            b = flat[i:i + d_out]
            i += d_out
            w = flat[i:i + d_in * d_out].view(d_out, d_in)
            i += d_in * d_out
            h = torch.nn.functional.linear(h, w, b)
            if li < len(dims) - 1:
                h = torch.tanh(h)
        return h

    if ref_forward is not None:
        want = np.asarray(ref_forward(mu_t))
        # an ordering fault gives O(1) differences
        if not np.allclose(want, forward(mu_t).detach().numpy(), rtol=1e-2, atol=1e-2):
            print("# torch NN baseline forward mismatch; skipping baseline", file=sys.stderr)
            return None

    nll = torch.nn.GaussianNLLLoss(reduction="sum")

    def log_prob(q_sub, frozen):
        if not torch.isfinite(q_sub).all():
            # a non-finite state is rejected (the reference raises LogProbError)
            return (torch.nan_to_num(q_sub) * 0.0).sum() + float("-inf")
        full = frozen.clone()
        full[idx_t] = q_sub
        pred = forward(full)
        ll = -nll(pred, y_t, TAU_OUT * torch.ones_like(pred))
        pr = torch.distributions.Normal(mu_t[idx_t], sigma_t[idx_t]).log_prob(q_sub).sum()
        return ll + pr

    clip = CLIP_SCALE * len(idx) ** 0.5 if collect else None
    if frozen_policy == "refresh":
        def draw_frozen():
            return mu_t + sigma_t * torch.randn_like(mu_t)
    elif frozen_policy == "draw":
        frozen0 = (torch.tensor(np.asarray(frozen_vec, np.float32)) if frozen_vec is not None
                   else mu_t + sigma_t * torch.randn_like(mu_t))

        def draw_frozen():
            return frozen0
    else:
        def draw_frozen():
            return mu_t
    q0 = mu_t[idx_t] if init is None else torch.tensor(np.asarray(init, np.float32))
    return torch_hmc_timing(log_prob, draw_frozen, q0, sigma_t[idx_t] ** 2, step, L,
                            n_samples, max_seconds, collect=collect,
                            jitter_low_frac=jitter_low_frac, clip_norm=clip)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frozen-policy", default="draw", choices=("draw", "refresh", "mean"))
    ap.add_argument("--step", type=float, default=None,
                    help="fixed step with trajectory-length jitter (default: coupled DA)")
    ap.add_argument("--L", type=int, default=96)
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--rank", type=int, default=0, help="Lanczos low-rank metric rank")
    ap.add_argument("--draws", type=int, default=2880)
    ap.add_argument("--thin", type=int, default=24)
    ap.add_argument("--segment", type=int, default=480)
    ap.add_argument("--persist", type=float, default=0.0, metavar="ALPHA",
                    help="momentum persistence (Horowitz partial refresh)")
    ap.add_argument("--keys", default=",".join(map(str, BENCH_KEYS)),
                    help="comma-separated run keys (seeds) after the warm run")
    ap.add_argument("--skip-baseline", action="store_true",
                    help="leave out the CPU torch baseline")
    ap.add_argument("--baseline-seconds", type=float, default=120.0,
                    help="the CPU baseline's time cap")
    args = ap.parse_args(argv)
    stats = bench_nn(device=args.device, frozen_policy=args.frozen_policy, step=args.step,
                     L=args.L, chains=args.chains, rank=args.rank, draws=args.draws,
                     thin=args.thin, segment=args.segment, persist=args.persist,
                     keys=tuple(int(k) for k in args.keys.split(",")),
                     skip_baseline=args.skip_baseline,
                     baseline_seconds=args.baseline_seconds)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
