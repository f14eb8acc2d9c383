"""VI-HMC over the sensitivity-selected subspace: the stage-3 pipelines.

Counterpart of ``vihmc_tpu/pipelines/vi_hmc.py`` (``make_spec``,
``make_subspace_prior``, ``build_subspace_posterior``, ``chain_inits``,
``evaluate_samples``, ``run_subspace_hmc``, ``run_nn`` and
``run_operator``), on the paths the stage-3 runs take
(``scripts/run_operator_stage3.py --variant autodiff``, the reference's
``main_VI_HMC_burgers.py`` and ``main_VI_HMC.py``):

* the posterior: the likelihood over the full flat vector with the
  insensitive coordinates frozen per ``frozen_policy`` -- at the VI mean
  (MEAN), at one VI draw (DRAW), or redrawn for every chain before every draw
  (REFRESH, the configs' default) -- plus the VI-posterior subspace prior;
  with ``use_fused`` the Burgers likelihood is the fused merge-NLL
  (``ops.deeponet_merge.fused_merge_nll``: one ``merge_sums`` kernel launch
  per evaluation for all chains);
* the trajectory field: the full-grid Gram gradient (``use_gram``, f32 by
  default) or autograd through the density, clipped at a preconditioned norm;
* plain HMC with a fixed step and step jitter, the unpaired MH test with lp0
  recomputed in every transition (under REFRESH, at the new frozen vectors),
  segments thinned on the device;
* posterior-predictive scoring of the pooled samples on the validation split
  against the frozen vectors the samples were drawn with (DRAW: the draw;
  REFRESH: each chain's last one; MEAN: the VI mean) and the numpy
  diagnostics battery.

Not ported yet -- the pipeline raises ``NotImplementedError`` on them:
``algorithm`` other than 'hmc', the Gaussian trajectory field
(``gauss_field*``), ``lowrank_rank``, ``adapt_mass``, the Gram stride
surrogates (``coarse_stride``/``fn_stride``), query subsampling
(``sample_data``), ``save_vi_trace``, ``jitter_l``, losses other than NLL,
and dual averaging other than the operator recipe's (``adapt_forever``
coupled over ``da_axis='chains'``, no ``max_step``).

JAX draws the DRAW/REFRESH initial frozen vector from a threefry key, which
PyTorch cannot replay: the port draws ``mu + sigma N(0, 1)`` from a
``torch.Generator`` seeded from the run's ``seed``, and takes ``frozen=`` so
that a test can inject JAX's vector. The refresh normals come from each
segment's generator after the transition's other draws.

The stage-3 entry point runs the configuration of ``run_operator_stage3.py
--variant autodiff`` on the card (reference DeepONet, B = 1000 x P = 10,201,
the 81,131-dim 90 % subspace, 16 chains, L = 31, step 1e-4 with jitter,
450 draws, burn 90, segments of 90, thin 3; DRAW unless ``--frozen-policy``
says otherwise) and prints one JSON line with the script's summary keys,
``draws_per_s`` and the phase walls::

    python -m vihmc_torch.pipelines.vi_hmc [--draws N] [--no-gram]
        [--frozen-policy draw|refresh|mean] [--device cuda]

One difference from the script: it reads ``assets/burgers_stage12.npz``; the
port reads ``assets/burgers_stage12_r2.npz`` (mu, sigma, indices, scores),
whose Burgers initial conditions it already holds in
``assets/burgers_r2_port_inputs.npz`` (the 200 validation functions are rows
1000:1200 of the exported ``u0``), so no new export is needed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from vihmc_torch.chains.diagnostics import summarize_np
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core.device import resolve_device, split_to, stream_generator, to_f32
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.data.burgers import (get_burgers, load_port_inputs,
                                      load_stage12_artifacts)
from vihmc_torch.data.synthetic import regression_data
from vihmc_torch.dists.likelihoods import nll_log_likelihood
from vihmc_torch.dists.priors import DiagonalGaussianPrior, IsotropicGaussianPrior
from vihmc_torch.hmc.kernel import HMCConfig, clipped_grad_fn, value_and_grad
from vihmc_torch.hmc.subspace import (FrozenPolicy, SubspaceSpec, make_aux_refresh,
                                      make_subspace_grad, make_subspace_log_prob)
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.ops.gram_merge import make_gram_grad_full
from vihmc_torch.pipelines.common import (conditional_warm_start,
                                          make_deeponet_nll_log_posterior,
                                          make_flat_deeponet, make_flat_mlp)
from vihmc_torch.pipelines.configs import VIHMCRunConfig
from vihmc_torch.pipelines.postprocess import error_report, error_sigma_correlation
from vihmc_torch.pipelines.predict import (posterior_predictive,
                                           streaming_predictive_metrics)

#: samples per chained forward in the evaluation (JAX's posterior_predictive chunk)
EVAL_CHUNK = 32
#: generator streams of a run's seed (core/device.stream_generator; the
#: sampler's segments are streams 0, 1, ...)
_FROZEN_STREAM, _INIT_STREAM, _DATA_STREAM = 700_001, 700_002, 700_003


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_spec(artifacts, device="cpu") -> SubspaceSpec:
    """The subspace of the stage-2 artifacts, in their index order."""
    dev = torch.device(device)
    return SubspaceSpec(
        idx=torch.as_tensor(np.asarray(artifacts["indices"]).ravel(), dtype=torch.int64,
                            device=dev),
        mu=torch.as_tensor(np.asarray(artifacts["mu"]), dtype=torch.float32, device=dev),
        sigma=torch.as_tensor(np.asarray(artifacts["sigma"]), dtype=torch.float32,
                              device=dev))


def make_subspace_prior(cfg: VIHMCRunConfig, spec: SubspaceSpec):
    """The VI posterior over the subspace (``load_prior``; with fixed stds
    ``sqrt(prior_var)`` unless ``load_std``), or ``N(0, prior_var)``."""
    if cfg.load_prior:
        scale = spec.sub_sigma() if cfg.load_std else torch.full(
            (spec.subspace_dim,), cfg.prior_var ** 0.5, device=spec.mu.device)
        return DiagonalGaussianPrior(loc=spec.sub_mu(), scale=scale)
    return IsotropicGaussianPrior(scale=cfg.prior_var ** 0.5)


def _check_ported(cfg: VIHMCRunConfig):
    """Raise ``NotImplementedError`` on the settings the port does not run yet."""
    unported = {
        "algorithm": cfg.algorithm != "hmc",
        "gauss_field": cfg.gauss_field is not None or cfg.gauss_field_auto,
        "lowrank_rank": bool(cfg.lowrank_rank),
        "adapt_mass": cfg.adapt_mass,
        "coarse_stride/fn_stride": bool(cfg.coarse_stride or cfg.fn_stride),
        "sample_data": cfg.sample_data,
        "save_vi_trace": cfg.save_vi_trace,
        "jitter_l": cfg.jitter_l,
        "loss": cfg.loss != "NLL",
        "adapt_step_size": cfg.adapt_step_size and not (
            cfg.adapt_forever and cfg.da_axis == "chains" and cfg.max_step is None),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)} "
                                  f"(see vihmc_torch/pipelines/vi_hmc.py)")


def build_subspace_posterior(cfg: VIHMCRunConfig, full_forward, y, artifacts,
                             frozen=None, seed: int = 0, full_ll=None, device="cpu"):
    """``(log_prob(q (C, d), aux) -> (C,), aux0, spec, prior, inv_mass)``.

    ``full_ll(flat (C, D)) -> (C,)`` overrides the composed likelihood (the
    fused merge-NLL path). ``aux0`` is the VI mean under MEAN; under DRAW and
    REFRESH it is ``frozen`` when given, else ``mu + sigma N(0, 1)`` from a
    generator seeded with ``seed``. The REFRESH hook is
    :func:`~vihmc_torch.hmc.subspace.make_aux_refresh` of ``spec``.
    ``inv_mass`` is the VI variances (``vi_mass``), the diagonal
    conditional-Laplace variances (``laplace_mass``) or 1.
    """
    _check_ported(cfg)
    dev = torch.device(device)
    spec = make_spec(artifacts, dev)
    if full_ll is None:
        def full_ll(flat):
            with true_f32():
                pred = full_forward(flat)
            return nll_log_likelihood(pred.reshape(flat.shape[0], *y.shape), y, cfg.tau_out)

    policy = FrozenPolicy(cfg.frozen_policy)
    if policy is not FrozenPolicy.MEAN:
        if frozen is None:
            gen = stream_generator(dev, seed, _FROZEN_STREAM)
            frozen = spec.mu + spec.sigma * torch.randn(spec.mu.shape, generator=gen,
                                                        device=dev)
        frozen = to_f32(frozen, dev)
    lp_like, aux0 = make_subspace_log_prob(full_ll, spec, frozen, policy)
    prior = make_subspace_prior(cfg, spec)

    def log_prob(q_sub, aux):
        return lp_like(q_sub, aux) + prior.log_prob(q_sub)

    inv_mass = spec.sub_sigma() ** 2 if cfg.vi_mass else 1.0
    if cfg.laplace_mass:
        # posterior precision ~ prior precision + n E[J_i^2] / tau, with
        # E[J^2] recovered from the sensitivity scores (scores = E[J^2] sigma^2)
        scores = artifacts.get("scores")
        if scores is None:
            raise ValueError("laplace_mass needs 'scores' (the sensitivity-"
                             "score artifact) in artifacts")
        if cfg.laplace_n_data is None:
            raise ValueError("laplace_mass needs laplace_n_data (number of "
                             "likelihood observations)")
        idx_np = np.sort(np.asarray(artifacts["indices"]).ravel())
        sig_np = np.asarray(artifacts["sigma"]).ravel()[idx_np]
        g2 = np.asarray(scores).ravel()[idx_np] / np.maximum(sig_np ** 2, 1e-30)
        prior_scale = np.broadcast_to(np.asarray(prior.scale.cpu() if isinstance(
            prior.scale, torch.Tensor) else prior.scale), idx_np.shape)
        lap_var = 1.0 / (1.0 / np.maximum(prior_scale ** 2, 1e-30)
                         + cfg.laplace_n_data * g2 / cfg.tau_out)
        inv_mass = torch.as_tensor(lap_var, dtype=torch.float32, device=dev)
    return log_prob, aux0, spec, prior, inv_mass


def chain_inits(cfg: VIHMCRunConfig, spec: SubspaceSpec, generator: torch.Generator):
    """``(C, d)`` initial subspace vectors: a VI draw (``init_prior`` and
    ``sample_prior``), the VI mean (``init_prior``), or ``0.1 N(0, 1)``."""
    c, d = cfg.num_chains, spec.subspace_dim
    dev = spec.mu.device
    if cfg.init_prior and cfg.sample_prior:
        z = torch.randn((c, d), generator=generator, device=dev)
        return spec.sub_mu() + spec.sub_sigma() * z
    if cfg.init_prior:
        return spec.sub_mu().expand(c, -1).clone()
    return 0.1 * torch.randn((c, d), generator=generator, device=dev)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return float(x) if x.ndim == 0 else x.numpy()
    return x


def evaluate_samples(cfg: VIHMCRunConfig, spec: SubspaceSpec, prior, eval_forward,
                     y_eval, samples, keep_predictions: int = 64,
                     max_metric_samples: int = 4096, frozen_base=None):
    """Posterior-predictive evaluation of ``(C, S, d)`` or ``(S, d)`` samples.

    ``eval_forward(full (S_c, D)) -> (S_c, N, P)``. ``frozen_base`` is the
    full vector the samples scatter into -- the one the sampler conditioned
    on -- ``(D,)``, or ``(C, D)`` to score each chain against its own base
    (default: the VI mean). Metrics stream over all pooled post-burn samples
    (at most ``max_metric_samples``, uniformly thinned); ``predictions`` keeps
    at most ``keep_predictions`` of them. Returns ``metrics``,
    ``diagnostics`` (:func:`summarize_np`), ``ess``, ``predictions`` and
    ``mean_prediction``, on the host.
    """
    dev = y_eval.device
    idx = spec.idx
    base = spec.mu if frozen_base is None else torch.as_tensor(
        frozen_base, dtype=torch.float32, device=dev)
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[None]
    burn = cfg.burn_
    per_chain_base = base.ndim == 2

    def lp_and_pred(chunk):
        q_sub, cid = chunk
        if per_chain_base:
            full = base[cid].clone()
            full[:, idx] = q_sub
        else:
            full = scatter_subspace(base, q_sub, idx)
        with true_f32():
            pred = eval_forward(full)
        lp = nll_log_likelihood(pred.reshape(q_sub.shape[0], *y_eval.shape), y_eval,
                                cfg.tau_out) + prior.log_prob(q_sub)
        return lp, pred

    n_chains, n_kept = samples.shape[0], samples.shape[1] - burn
    pooled = samples[:, burn:, :].reshape(-1, spec.subspace_dim)
    # chain id of each pooled row (chain-major reshape)
    cids = np.repeat(np.arange(n_chains), n_kept)
    if pooled.shape[0] > max_metric_samples:
        stride = -(-pooled.shape[0] // max_metric_samples)
        pooled, cids = pooled[::stride], cids[::stride]
    rows = torch.as_tensor(pooled, dtype=torch.float32, device=dev)
    cid_t = torch.as_tensor(cids, dtype=torch.int64, device=dev)
    metrics = streaming_predictive_metrics(lp_and_pred, (rows, cid_t), y_eval,
                                           chunk_size=EVAL_CHUNK)
    mean_prediction = metrics.pop("mean_prediction")

    preds = None
    if keep_predictions:
        stride = max(1, rows.shape[0] // keep_predictions)
        _, preds = posterior_predictive(
            lp_and_pred, (rows[::stride][:keep_predictions],
                          cid_t[::stride][:keep_predictions]), chunk_size=EVAL_CHUNK)
    diag = summarize_np(samples[:, burn:, :])
    return {
        "metrics": {k: _to_host(v) for k, v in metrics.items()},
        "diagnostics": diag,
        "ess": diag["ess"],
        "predictions": _to_host(preds),
        "mean_prediction": _to_host(mean_prediction),
    }


def run_subspace_hmc(cfg: VIHMCRunConfig, full_forward, y_train, artifacts,
                     eval_forward=None, y_eval=None, store: Optional[RunStore] = None,
                     full_ll=None, full_grad=None, segment_size=None, progress=None,
                     sample_thin: int = 1, evaluate: bool = True, seed: int = 0,
                     frozen=None, device="cuda"):
    """Subspace HMC, ``algorithm='hmc'`` (see module doc for what is ported).

    ``full_ll``: the likelihood override (fused merge-NLL); ``full_grad``: a
    full-flat-vector likelihood-gradient oracle for the trajectory (the Gram
    gradient) instead of autograd -- the exact density still decides MH.
    ``segment_size`` draws per segment (all draws in one when None), every
    ``sample_thin``-th kept. Returns ``result`` (:class:`SampleResult`),
    ``spec``, ``prior``, ``frozen``, the sampler's ``log_prob`` and
    ``grad_fn``, ``phases_s``, and with ``evaluate`` the outputs of
    :func:`evaluate_samples`.
    """
    dev = resolve_device(device)
    phases = {}
    t0 = time.perf_counter()
    log_prob, aux0, spec, prior, inv_mass = build_subspace_posterior(
        cfg, full_forward, y_train, artifacts, frozen=frozen, seed=seed,
        full_ll=full_ll, device=dev)

    grad_fn = None
    if full_grad is not None:
        grad_fn = make_subspace_grad(full_grad, spec, prior=prior)
    if cfg.clip_grad is not None:
        if grad_fn is not None:
            grad_fn = clipped_grad_fn(grad_fn, cfg.clip_grad, inv_mass=inv_mass)
        else:
            grad_fn = clipped_grad_fn(log_prob, cfg.clip_grad, inv_mass=inv_mass,
                                      is_grad=False)

    aux_refresh = make_aux_refresh(spec, FrozenPolicy(cfg.frozen_policy))
    gen_init = stream_generator(dev, seed, _INIT_STREAM)
    inits = chain_inits(cfg, spec, gen_init)
    if cfg.init_optimize:
        # warm start at the conditional's approximate mode (the VI mean can
        # sit far below the typical set of the DRAW conditional)
        oracle = grad_fn if grad_fn is not None else (
            lambda q, a: value_and_grad(log_prob, q, a)[1])
        inits = conditional_warm_start(oracle, aux0, spec.sub_mu(), inv_mass,
                                       cfg.init_optimize, cfg.num_chains, gen_init,
                                       spread=0.5, lr=cfg.init_optimize_lr)
    _sync(dev)
    phases["setup_s"] = time.perf_counter() - t0

    hmc_cfg = HMCConfig(num_samples=cfg.num_samples, num_leapfrog=cfg.L,
                        step_size=cfg.step_size, target_accept=cfg.target_accept,
                        jitter_low_frac=cfg.jitter_low_frac,
                        sampler="hmc_nuts" if cfg.adapt_step_size else "hmc",
                        jitter_eps=cfg.jitter_eps)
    t0 = time.perf_counter()
    res = sample_chains_resumable(log_prob, inits, hmc_cfg,
                                  segment_size or cfg.num_samples, inv_mass, aux0,
                                  grad_fn=grad_fn, thin=sample_thin, seed=seed,
                                  progress=progress, aux_refresh=aux_refresh)
    _sync(dev)
    phases["sampling_s"] = time.perf_counter() - t0

    out = {"result": res, "spec": spec, "prior": prior, "frozen": aux0,
           "log_prob": log_prob, "grad_fn": grad_fn, "phases_s": phases}
    if evaluate and eval_forward is not None and y_eval is not None:
        t0 = time.perf_counter()
        eval_cfg = cfg
        if sample_thin > 1:
            eval_cfg = dataclasses.replace(cfg, burn=cfg.burn_ // sample_thin)
        # score against the frozen vectors the samples were drawn with: DRAW
        # the fixed draw, REFRESH each chain's last draw (C, D), MEAN the VI mean
        base = {"draw": aux0, "refresh": res.final_state.aux, "mean": None}[cfg.frozen_policy]
        evald = evaluate_samples(eval_cfg, spec, prior, eval_forward, y_eval,
                                 res.samples, frozen_base=base)
        evald["metrics"]["acceptance_rate"] = res.acceptance_rate
        evald["metrics"]["num_divergent"] = res.num_divergent
        out.update(evald)
        _sync(dev)
        phases["evaluate_s"] = time.perf_counter() - t0

    if store is not None:
        store.save_config(cfg)
        store.save_array("hmc_params", res.samples)
        if "metrics" in out:
            store.save_array("sample_mse", out["metrics"]["sample_mse"])
    return out


def run_nn(cfg: VIHMCRunConfig, mlp_cfg: MLPConfig, artifacts, data=None,
           store: Optional[RunStore] = None, segment_size=None, progress=None,
           sample_thin: int = 1, evaluate: bool = True, seed: int = 0, frozen=None,
           device="cuda"):
    """NN regression VI-HMC (the reference's ``main_VI_HMC.py``): autograd
    trajectories through the MLP likelihood on the synthetic data.

    ``data``: the dict of :func:`~vihmc_torch.data.synthetic.regression_data`
    (tensors or arrays), or None to make it here with noise std
    ``sqrt(tau_out)`` from a generator seeded with ``seed``.
    """
    dev = resolve_device(device)
    if cfg.coarse_stride or cfg.fn_stride or cfg.grad_dtype == "bfloat16":
        raise ValueError("coarse_stride/fn_stride/grad_dtype apply to the "
                         "operator workload's Gram gradient only")
    _check_ported(cfg)
    if data is None:
        data = regression_data(noise_std=cfg.tau_out ** 0.5,
                               generator=stream_generator(dev, seed, _DATA_STREAM), device=dev)
    else:
        data = split_to(data, dev)
    apply_flat = make_flat_mlp(mlp_cfg)
    out = run_subspace_hmc(
        cfg, full_forward=lambda flat: apply_flat(flat, data["x_train"]),
        y_train=data["y_train"], artifacts=artifacts,
        eval_forward=lambda flat: apply_flat(flat, data["x_val"]), y_eval=data["y_val"],
        store=store, segment_size=segment_size, progress=progress, sample_thin=sample_thin,
        evaluate=evaluate, seed=seed, frozen=frozen, device=dev)
    out["data"] = data
    out["apply_flat"] = apply_flat
    return out


def run_operator(cfg: VIHMCRunConfig, deeponet_cfg: DeepONetConfig, artifacts,
                 data=None, store: Optional[RunStore] = None, use_fused: bool = False,
                 use_gram: Optional[bool] = None, segment_size=None, progress=None,
                 sample_thin: int = 1, evaluate: bool = True, seed: int = 0,
                 frozen=None, device="cuda"):
    """Operator VI-HMC on Burgers (the reference's ``main_VI_HMC_burgers.py``).

    ``data``: ``(train, valid)`` dicts of ``branch_in`` (N, nx), ``trunk_in``
    (P, 2), ``solution`` (N, P) -- tensors or arrays -- or None for
    :func:`~vihmc_torch.data.burgers.get_burgers` on ``device``.
    ``use_fused``: the fused merge-NLL density (one ``merge_sums`` launch per
    evaluation for all chains). ``use_gram``: the full-grid Gram trajectory
    gradient; None enables it when eligible (plain HMC, NLL, homoscedastic
    shared-grid merge), False takes autograd through the density. The device
    is the card unless the caller asks for the CPU.
    """
    dev = resolve_device(device)
    _check_ported(cfg)
    t0 = time.perf_counter()
    if data is None:
        train, valid = get_burgers(dev)
    else:
        train, valid = (split_to(s, dev) for s in data)
    _sync(dev)
    t_data = time.perf_counter() - t0
    apply_flat = make_flat_deeponet(deeponet_cfg)
    bx, tx, y = train["branch_in"], train["trunk_in"], train["solution"]

    full_ll = None
    if use_fused:
        full_ll = make_deeponet_nll_log_posterior(deeponet_cfg, bx, tx, y, cfg.tau_out)
    full_grad = None
    if use_gram is not False:  # None: eligible, since _check_ported passed
        full_grad = make_gram_grad_full(
            deeponet_cfg, bx, tx, y, cfg.tau_out,
            compute_dtype=torch.bfloat16 if cfg.grad_dtype == "bfloat16" else None)
    elif cfg.grad_dtype == "bfloat16":
        raise ValueError("grad_dtype='bfloat16' applies to the Gram trajectory-"
                         "gradient path (operator NLL, shared grid, use_gram)")

    out = run_subspace_hmc(
        cfg, full_forward=lambda flat: apply_flat(flat, bx, tx), y_train=y,
        artifacts=artifacts,
        eval_forward=lambda flat: apply_flat(flat, valid["branch_in"], valid["trunk_in"]),
        y_eval=valid["solution"], store=store, full_ll=full_ll, full_grad=full_grad,
        segment_size=segment_size, progress=progress, sample_thin=sample_thin,
        evaluate=evaluate, seed=seed, frozen=frozen, device=dev)
    out["phases_s"] = {"data_s": t_data, **out["phases_s"]}
    out["data"] = (train, valid)
    out["apply_flat"] = apply_flat
    return out


# ---------------------------------------------------------------------------
# The stage-3 entry point (scripts/run_operator_stage3.py --variant autodiff)
# ---------------------------------------------------------------------------

#: the stage-3 script's trajectory clip: 13 sqrt(subspace dim)
STAGE3_CLIP_SCALE = 13.0


def stage3_config(d_sub: int, n_data: int, draws: int = 450, burn=None,
                  chains: int = 16, L: int = 31,
                  frozen_policy: str = "draw") -> VIHMCRunConfig:
    """The ``run_operator_stage3.py --variant autodiff`` config with its
    defaults: fixed step 1e-4 with eps-jitter, DRAW policy (the script's
    ``--frozen-policy`` default), VI-variance mass, clip ``13 sqrt(d_sub)``,
    no warm start."""
    return VIHMCRunConfig(
        step_size=1e-4, num_samples=draws, burn=burn, post_std=0.0214,
        num_chains=chains, num_leapfrog=L, loss="NLL", tau_out=1.0,
        frozen_policy=frozen_policy, vi_mass=True, laplace_mass=False, laplace_n_data=n_data,
        init_optimize=0, clip_grad=STAGE3_CLIP_SCALE * d_sub ** 0.5,
        jitter_l=False, jitter_eps=True, jitter_low_frac=0.5,
        adapt_step_size=False, target_accept=0.65, da_axis=None,
        adapt_forever=False, max_step=None)


def run_stage3(device="cuda", draws: int = 450, burn=None, chains: int = 16,
               L: int = 31, segment: int = 90, thin: int = 3, use_gram=None,
               seed: int = 0, data=None, artifacts=None, frozen_policy: str = "draw"):
    """Run the stage-3 configuration and return ``(summary, out)``: the
    script's summary keys plus ``draws_per_s``, ``phases_s`` and the
    trajectory field; ``out`` is :func:`run_operator`'s result. ``data`` and
    ``artifacts`` reuse already loaded ones (default: the port's assets)."""
    dev = resolve_device(device)
    artifacts = load_stage12_artifacts() if artifacts is None else artifacts
    grid = load_port_inputs()
    nx, nt = int(grid["nx"]), int(grid["nt"])
    cfg = stage3_config(len(artifacts["indices"]), int(grid["n_train"]) * nx * nt,
                        draws=draws, burn=burn, chains=chains, L=L,
                        frozen_policy=frozen_policy)
    out = run_operator(cfg, DeepONetConfig(), artifacts, data=data, use_fused=True,
                       use_gram=use_gram, segment_size=segment, sample_thin=thin,
                       seed=seed, device=dev)
    res, met, diag = out["result"], out["metrics"], out["diagnostics"]
    truth = out["data"][1]["solution"].cpu().numpy()
    preds = np.asarray(out["predictions"]).reshape(-1, *truth.shape)
    rep = error_report(preds, truth, log_probs=np.asarray(met["expected_log_prob"])[None])
    corr = error_sigma_correlation(preds, truth, nt=nt, nx=nx)
    phases = out["phases_s"]
    summary = {
        "variant": "autodiff",
        "frozen_policy": frozen_policy,
        "trajectory_field": "autograd" if use_gram is False else "gram_f32",
        "chains": chains, "draws": draws, "thin": thin, "burn": int(cfg.burn_),
        "L": cfg.L, "step": float(cfg.step_size), "adapt": False,
        "da_axis": False, "jitter": "eps",
        "acceptance": float(met["acceptance_rate"]),
        "acceptance_post_burn": float(np.mean(res.accept_probs[:, cfg.burn_:])),
        "expected_mse_of_mean": float(met["expected_mse_of_mean"]),
        "mean_relative_l2": rep["mean_relative_l2"],
        "mean_error_sigma_correlation": corr["mean_correlation"],
        "ess_median": float(np.median(diag["ess"])),
        "ess_bulk_median": float(np.median(diag["ess_bulk"])),
        "ess_tail_median": float(np.median(diag["ess_tail"])),
        "ess_bulk_min": float(np.min(diag["ess_bulk"])),
        "r_hat_max": float(np.nanmax(diag["r_hat"])),
        "r_hat_rank_max": float(np.nanmax(diag["r_hat_rank"])),
        "tau_floor_frac": float(diag["tau_floor_frac"]),
        "sampling_seconds": phases["sampling_s"],
        "draws_per_s": draws / phases["sampling_s"],
        "phases_s": phases,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    return summary, out


def main(argv=None):
    ap = argparse.ArgumentParser(description="stage-3 operator VI-HMC (fused merge-NLL)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=450)
    ap.add_argument("--burn", type=int, default=None, help="default draws // 5")
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--L", type=int, default=31)
    ap.add_argument("--segment", type=int, default=90)
    ap.add_argument("--thin", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frozen-policy", default="draw", choices=("draw", "refresh", "mean"))
    field = ap.add_mutually_exclusive_group()
    field.add_argument("--use-gram", dest="use_gram", action="store_const", const=True,
                       help="Gram trajectory gradient (the default when eligible)")
    field.add_argument("--no-gram", dest="use_gram", action="store_const", const=False,
                       help="autograd trajectory gradient through the fused density")
    args = ap.parse_args(argv)
    summary, _ = run_stage3(device=args.device, draws=args.draws, burn=args.burn,
                            chains=args.chains, L=args.L, segment=args.segment,
                            thin=args.thin, use_gram=args.use_gram, seed=args.seed,
                            frozen_policy=args.frozen_policy)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
