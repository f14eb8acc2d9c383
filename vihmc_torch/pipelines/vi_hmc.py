"""VI-HMC over the sensitivity-selected subspace: the stage-3 pipelines.

Counterpart of ``vihmc_tpu/pipelines/vi_hmc.py`` (``make_spec``,
``make_subspace_prior``, ``build_subspace_posterior``, ``chain_inits``,
``evaluate_samples``, ``run_subspace_hmc``, ``run_nn`` and
``run_operator``), on the paths the stage-3 runs take
(``scripts/run_operator_stage3.py``, all three variants, the reference's
``main_VI_HMC_burgers.py`` and ``main_VI_HMC.py``):

* the posterior: the likelihood (any ``loss``) over the full flat vector
  with the insensitive coordinates frozen per ``frozen_policy`` -- at the VI
  mean (MEAN), at one VI draw (DRAW), or redrawn for every chain before every
  draw (REFRESH, the configs' default) -- plus the VI-posterior subspace
  prior; with ``use_fused`` the Burgers likelihood is the fused merge-NLL
  (``ops.deeponet_merge.fused_merge_nll``: one ``merge_sums`` kernel launch
  per evaluation for all chains);
* the metric: VI variances, conditional Laplace, or either plus the Lanczos
  low-rank term (``lowrank_rank``);
* the trajectory field: the Gram gradient (``use_gram``, f32 by default) on
  the full grid or on the stride subsets (``coarse_stride``/``fn_stride``),
  the VI-Gaussian score (``gauss_field``), or autograd through the density,
  clipped at a preconditioned norm;
* the sampler (``algorithm``): HMC with a fixed step or any dual-averaging
  mode, step or length jitter and the adaptive metric (``adapt_mass`` under
  the ``'half'`` or ``'windowed'`` ``mass_schedule``), the unpaired MH test
  with lp0 recomputed in every transition (under REFRESH, at the new frozen
  vectors); NUTS (``'nuts'``, ``nuts_max_depth`` doublings, every leaf one
  exact density evaluation); ChEES-HMC (``'chees'``, ``chees_max_steps``);
  or ``'auto'``, the stiffness probe (an 8-iteration Lanczos on the
  preconditioned Hessian at the VI mean: NUTS if its largest eigenvalue
  exceeds ``auto_stiffness_threshold`` and there is no low-rank metric, else
  HMC; vi_hmc.py:237-265); segments thinned on the device for all three;
* ``gauss_field_auto`` (vi_hmc.py:306-311, :408-431): a short HMC probe with
  the VI-Gaussian field, kept when its mean acceptance reaches
  ``gauss_field_floor``, else the configured field;
* query subsampling (``sample_data``, vi_hmc.py:614-626): a set of ``p``
  of the shared grid's points, redrawn for every chain before every draw
  and fixed within a trajectory, as sampler state: the aux becomes
  ``{'frozen', 'tidx'}`` (REFRESH redraws both); the Gram field and the
  fused density are off (vi_hmc.py:641-660), as in JAX;
* per-example query points (the Cone dataset, ``trunk_in`` (B, p, 2)): the
  composed density on the per-example merge, never subsampled, no Gram
  field and no fused density (the merge kernels need a shared grid, as in
  JAX); a DeepONet with the heteroscedastic head is refused;
* ``save_vi_trace`` (HMC only): every draw's frozen vectors, stored as
  ``vi_params`` (C, S, D) -- under subsampling the trace's ``frozen`` part;
* ``checkpoint_dir``: the HMC sampler saves after every segment and resumes
  from the latest (:mod:`vihmc_torch.chains.resume`); JAX runs NUTS and
  ChEES in one call and ignores ``segment_size`` and ``checkpoint_dir``
  there, so the port ignores ``checkpoint_dir`` for them too (it still runs
  them in segments, for the thinning);
* ``mesh`` (a chain mesh over ``torch.distributed`` ranks): each rank
  samples its C/N chains, then the chains are gathered, so every rank
  evaluates and reports the whole run; ``segment_size`` with a mesh raises
  JAX's ``ValueError`` (vi_hmc.py:485-489);
* posterior-predictive scoring of the pooled samples on the validation split
  against the frozen vectors the samples were drawn with (DRAW: the draw;
  REFRESH: each chain's last one; MEAN: the VI mean) and the numpy
  diagnostics battery; :func:`reevaluate_nn` and :func:`reevaluate_operator`
  re-score a run store's ``hmc_params`` (vi_hmc.py:733-766).

It raises JAX's ``ValueError`` on the combinations JAX rejects
(``lowrank_rank`` or ``gauss_field_auto`` with NUTS/ChEES or subsampling,
ChEES with ``adapt_mass``, ``save_vi_trace`` with segments or another
algorithm than HMC).

JAX draws the DRAW/REFRESH initial frozen vector and the Lanczos start
vectors from threefry keys, which PyTorch cannot replay: the port draws them
from ``torch.Generator`` streams of the run's ``seed``, and takes
``frozen=``, ``lanczos_v0=`` and ``probe_v0=`` (the 'auto' probe's) so that
a test can inject JAX's. The refresh normals come from each segment's
generator after the transition's other draws. JAX runs NUTS and ChEES in one
unthinned call; the port runs them in the same segments as HMC and thins
them too, so the evaluation's ``burn // sample_thin`` counts kept draws on
every path.

Under ``use_fused`` the low-rank metric's Hessian-vector products
differentiate the fused density twice: its backward is composed torch
matmuls, so autograd differentiates it again, and the products are those of
the composed density -- what the JAX package computes off the TPU, where its
``fused_merge_nll`` is the composed reference (on the TPU its ``custom_vjp``
admits no forward-mode derivative, and JAX raises there).

The stage-3 entry point runs the configuration of ``run_operator_stage3.py``
on the card (reference DeepONet, B = 1000 x P = 10,201, the 81,131-dim 90 %
subspace, 16 chains, L = 31, step 1e-4 with jitter, 450 draws, burn 90,
segments of 90, thin 3; DRAW unless ``--frozen-policy`` says otherwise), by
default the script's default variant ``stride`` (the Gram field on every 3rd
query point per grid dimension and every 3rd function), and prints one JSON
line with the script's summary keys, ``draws_per_s`` and the phase walls::

    python -m vihmc_torch.pipelines.vi_hmc [--variant stride|gauss|autodiff]
        [--algorithm hmc|nuts|chees|auto] [--nuts-max-depth 6]
        [--stride 3] [--fn-stride 3] [--draws N] [--step S] [--adapt]
        [--da-axis] [--adapt-forever] [--target-accept 0.65] [--max-step S]
        [--jitter l|eps|none] [--laplace-mass] [--init-optimize N]
        [--clip-scale 13] [--no-gram] [--frozen-policy draw|refresh|mean]
        [--device cuda]

The flags it shares with ``python -m vihmc_torch.scripts.run_operator_stage3``
(which adds the script's own: ``--artifacts``, ``--ckpt``, ``--key``, ...)
are :func:`add_stage3_flags`'. One difference from the script: it reads
``assets/burgers_stage12.npz``; the port reads ``assets/burgers_stage12_r2.npz`` (mu, sigma, indices, scores),
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
from vihmc_torch.chains.parallel import (gather_chains, sample_chains, sample_chains_chees,
                                         sample_chains_nuts)
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core.device import resolve_device, split_to, stream_generator, sync, to_f32
from vihmc_torch.core.mesh import is_lead
from vihmc_torch.core.precision import true_f32
from vihmc_torch.core.ravel import scatter_subspace
from vihmc_torch.data.burgers import (get_burgers, load_port_inputs,
                                      load_stage12_artifacts)
from vihmc_torch.data.synthetic import regression_data
from vihmc_torch.dists.likelihoods import get_likelihood
from vihmc_torch.dists.priors import DiagonalGaussianPrior, IsotropicGaussianPrior
from vihmc_torch.hmc.chees import ChEESConfig
from vihmc_torch.hmc.kernel import (HMCConfig, clipped_grad_fn, gaussian_field_grad,
                                    value_and_grad)
from vihmc_torch.hmc.metric import (estimate_lowrank_metric, lanczos_eigs,
                                    preconditioned_hvp)
from vihmc_torch.hmc.nuts import NUTSConfig
from vihmc_torch.hmc.subspace import (FrozenPolicy, SubspaceSpec, make_aux_refresh,
                                      make_subspace_grad, make_subspace_log_prob)
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.ops.gram_merge import (grid_stride_subset, infer_grid_shape,
                                        make_gram_grad_full)
from vihmc_torch.pipelines.common import (conditional_warm_start,
                                          make_deeponet_nll_log_posterior,
                                          make_flat_deeponet, make_flat_mlp,
                                          query_index_sets, subsampled_forward)
from vihmc_torch.pipelines.configs import VIHMCRunConfig
from vihmc_torch.pipelines.postprocess import error_report, error_sigma_correlation
from vihmc_torch.pipelines.predict import (posterior_predictive,
                                           streaming_predictive_metrics)

#: samples per chained forward in the evaluation (JAX's posterior_predictive chunk)
EVAL_CHUNK = 32
#: generator streams of a run's seed (core/device.stream_generator; the
#: sampler's segments are streams 0, 1, ...)
_FROZEN_STREAM, _INIT_STREAM, _DATA_STREAM = 700_001, 700_002, 700_003
_LANCZOS_STREAM, _AUTO_STREAM, _SUBSAMPLE_STREAM = 700_004, 700_005, 700_006
#: the gauss_field_auto probe samples with the streams of seed + this
_PROBE_SEED_OFFSET = 500_000
#: the sampling algorithms of stage 3
ALGORITHMS = ("hmc", "nuts", "chees", "auto")


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


def _check_algorithm(cfg: VIHMCRunConfig):
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm {cfg.algorithm!r}: one of {ALGORITHMS}")


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
    _check_algorithm(cfg)
    dev = torch.device(device)
    spec = make_spec(artifacts, dev)
    if full_ll is None:
        like = get_likelihood(cfg.loss)

        def full_ll(flat):
            with true_f32():
                pred = full_forward(flat)
            return like(pred.reshape(flat.shape[0], *y.shape), y, cfg.tau_out)

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
    like = get_likelihood(cfg.loss)

    def lp_and_pred(chunk):
        q_sub, cid = chunk
        if per_chain_base:
            full = base[cid].clone()
            full[:, idx] = q_sub
        else:
            full = scatter_subspace(base, q_sub, idx)
        with true_f32():
            pred = eval_forward(full)
        lp = like(pred.reshape(q_sub.shape[0], *y_eval.shape), y_eval,
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


def _auto_probe(cfg: VIHMCRunConfig, log_prob, aux0, spec: SubspaceSpec, inv_mass,
                probe_v0, seed: int, dev) -> dict:
    """The 'auto' stiffness probe (vi_hmc.py:237-265): the largest eigenvalue
    of the preconditioned conditional curvature at the VI mean, from an
    8-iteration Lanczos (``min(8, d)``), picks NUTS when it exceeds
    ``auto_stiffness_threshold`` and no low-rank metric absorbs it, else HMC."""
    d = spec.subspace_dim
    diag_p = inv_mass * torch.ones(d, device=dev)
    mv = preconditioned_hvp(log_prob, spec.sub_mu(), diag_p, aux=aux0)
    vals, _ = lanczos_eigs(mv, d, 1, num_iters=min(8, d), v0=probe_v0,
                           generator=stream_generator(dev, seed, _AUTO_STREAM), device=dev)
    lam_max = float(vals[0])
    stiff = lam_max > cfg.auto_stiffness_threshold
    return {"lambda_max": lam_max,
            "algorithm": "nuts" if (stiff and not cfg.lowrank_rank) else "hmc"}


def run_subspace_hmc(cfg: VIHMCRunConfig, full_forward, y_train, artifacts,
                     eval_forward=None, y_eval=None, store: Optional[RunStore] = None,
                     full_ll=None, full_grad=None, segment_size=None, progress=None,
                     sample_thin: int = 1, evaluate: bool = True, seed: int = 0,
                     frozen=None, lanczos_v0=None, probe_v0=None, subsample=None,
                     checkpoint_dir=None, tidx0=None, mesh=None, device="cuda"):
    """Subspace VI-HMC with ``cfg.algorithm`` (see the module doc).

    ``full_ll``: the likelihood override (fused merge-NLL); ``full_grad``: a
    full-flat-vector likelihood-gradient oracle for the trajectory (the Gram
    gradient or its stride surrogate) instead of autograd -- the exact
    density still decides MH (and weights NUTS's leaves). ``gauss_field``
    takes the VI-Gaussian score as the field instead, or with
    ``gauss_field_auto`` probes it first. ``lowrank_rank`` builds the
    low-rank metric by Lanczos at the VI mean from ``lanczos_v0`` (default:
    normals of the run's seed); ``probe_v0`` is the 'auto' probe's start.
    ``subsample``: ``{'n_points', 'p', 'forward'(flat (C, D), tidx (C, p))
    -> (C, ...), 'y_fn'(tidx (C, p)) -> (C, ...)}`` turns on per-draw query
    subsampling (the first set ``tidx0``, else drawn from the run's seed).
    ``segment_size`` draws per segment (all draws in one when None), every
    ``sample_thin``-th kept; ``checkpoint_dir`` saves and resumes the HMC
    sampler there. ``mesh`` (:func:`~vihmc_torch.chains.make_chain_mesh`):
    each rank samples its rows of the chains, then the chains are gathered
    (``phases_s['gather_s']``), so the result, the evaluation and the
    diagnostics are the whole run's on every rank; the run store is written
    by the mesh's first rank; with ``segment_size`` HMC raises JAX's
    ``ValueError``. Returns ``result`` (:class:`SampleResult`),
    ``spec``, ``prior``, ``frozen``, the sampler's ``log_prob``, ``grad_fn``
    and ``inv_mass``, ``algorithm``, ``phases_s``, ``auto_probe`` (under
    'auto'), ``gauss_field_used`` and ``gauss_field_probe_acceptance``
    (under ``gauss_field_auto``), and with ``evaluate`` the outputs of
    :func:`evaluate_samples`.
    """
    dev = resolve_device(device)
    phases = {}
    t0 = time.perf_counter()
    log_prob, aux0, spec, prior, inv_mass = build_subspace_posterior(
        cfg, full_forward, y_train, artifacts, frozen=frozen, seed=seed,
        full_ll=full_ll, device=dev)

    auto_probe = None
    if cfg.algorithm == "auto":
        t_a = time.perf_counter()
        auto_probe = _auto_probe(cfg, log_prob, aux0, spec, inv_mass, probe_v0, seed, dev)
        cfg = dataclasses.replace(cfg, algorithm=auto_probe["algorithm"])
        phases["auto_probe_s"] = time.perf_counter() - t_a

    # the diagonal view of the metric: the clip and the warm start stay
    # diagonal when the kinetic metric is low-rank + diagonal
    inv_mass_diag = inv_mass
    if cfg.algorithm != "hmc" and cfg.save_vi_trace:
        raise ValueError("save_vi_trace is supported for algorithm='hmc' only (the "
                         "reference's VI-HMC uses plain HMC)")
    if cfg.save_vi_trace and segment_size is not None:
        raise ValueError("save_vi_trace is not recorded across resumable segments; drop "
                         "segment_size")
    if cfg.lowrank_rank:
        if cfg.algorithm != "hmc" or subsample is not None:
            raise ValueError("lowrank_rank requires algorithm='hmc' and no query subsampling")
        diag = inv_mass * torch.ones(spec.subspace_dim, device=dev)
        inv_mass_diag = diag
        t_l = time.perf_counter()
        inv_mass = estimate_lowrank_metric(
            log_prob, spec.sub_mu(), diag, cfg.lowrank_rank, num_iters=cfg.lowrank_iters,
            v0=lanczos_v0, generator=stream_generator(dev, seed, _LANCZOS_STREAM), aux=aux0)
        sync(dev)
        phases["lanczos_s"] = time.perf_counter() - t_l

    grad_fn = None
    if full_grad is not None:
        if subsample is not None:
            raise ValueError("full_grad requires no query subsampling")
        if cfg.gauss_field is not None and not cfg.gauss_field_auto:
            raise ValueError("gauss_field and a full_grad oracle are mutually exclusive "
                             "trajectory fields (set gauss_field_auto to probe-and-fall-back)")
        grad_fn = make_subspace_grad(full_grad, spec, prior=prior)
    elif cfg.gauss_field is not None and not cfg.gauss_field_auto:
        grad_fn = gaussian_field_grad(spec.sub_mu(), spec.sub_sigma(), cfg.gauss_field)
    gauss_fn = None
    if cfg.gauss_field_auto:
        if cfg.algorithm != "hmc" or subsample is not None:
            raise ValueError("gauss_field_auto requires algorithm='hmc' and no query "
                             "subsampling")
        gauss_fn = gaussian_field_grad(spec.sub_mu(), spec.sub_sigma(),
                                       1.0 if cfg.gauss_field is None else cfg.gauss_field)
    aux_refresh = make_aux_refresh(spec, FrozenPolicy(cfg.frozen_policy))
    aux_draw = None
    if subsample is not None:
        log_prob, aux0, aux_refresh, aux_draw = _subsampled_posterior(
            cfg, subsample, spec, prior, aux0, aux_refresh, tidx0, seed, dev)
    if cfg.clip_grad is not None:
        # after the subsample rebinding, so the clip wraps the sampled target
        if grad_fn is not None:
            grad_fn = clipped_grad_fn(grad_fn, cfg.clip_grad, inv_mass=inv_mass_diag)
        else:
            grad_fn = clipped_grad_fn(log_prob, cfg.clip_grad, inv_mass=inv_mass_diag,
                                      is_grad=False)
        if gauss_fn is not None:
            gauss_fn = clipped_grad_fn(gauss_fn, cfg.clip_grad, inv_mass=inv_mass_diag)

    gen_init = stream_generator(dev, seed, _INIT_STREAM)
    inits = chain_inits(cfg, spec, gen_init)
    if cfg.init_optimize:
        # warm start at the conditional's approximate mode (the VI mean can
        # sit far below the typical set of the DRAW conditional)
        oracle = grad_fn if grad_fn is not None else (
            lambda q, a: value_and_grad(log_prob, q, a)[1])
        inits = conditional_warm_start(oracle, aux0, spec.sub_mu(), inv_mass_diag,
                                       cfg.init_optimize, cfg.num_chains, gen_init,
                                       spread=0.5, lr=cfg.init_optimize_lr)
    sync(dev)
    phases["setup_s"] = time.perf_counter() - t0

    gauss_used = probe_acceptance = None
    if gauss_fn is not None:
        # a short fixed-step HMC probe on the VI-Gaussian field: kept when its
        # mean MH probability reaches the floor, else the configured field
        t_p = time.perf_counter()
        probe_cfg = HMCConfig(num_samples=max(1, cfg.gauss_field_probe_draws),
                              num_leapfrog=cfg.L, step_size=cfg.step_size, burn=0,
                              sampler="hmc", jitter_l=cfg.jitter_l, jitter_eps=cfg.jitter_eps,
                              jitter_low_frac=cfg.jitter_low_frac, max_step=cfg.max_step)
        probe = gather_chains(mesh, sample_chains(
            log_prob, inits, probe_cfg, inv_mass=inv_mass, aux=aux0, aux_refresh=aux_refresh,
            grad_fn=gauss_fn, seed=seed + _PROBE_SEED_OFFSET, mesh=mesh))
        probe_acceptance = float(np.mean(probe.accept_probs))
        gauss_used = probe_acceptance >= cfg.gauss_field_floor
        if gauss_used:
            grad_fn = gauss_fn
        phases["gauss_probe_s"] = time.perf_counter() - t_p

    t0 = time.perf_counter()
    seg = segment_size or cfg.num_samples
    if cfg.algorithm == "chees":
        if cfg.adapt_mass:
            raise ValueError("adapt_mass is not supported with algorithm='chees' (ChEES "
                             "adapts step size and trajectory length; use vi_mass for a "
                             "fixed preconditioner)")
        chees_cfg = ChEESConfig(num_samples=cfg.num_samples, step_size=cfg.step_size,
                                init_traj_length=max(cfg.L, 1) * cfg.step_size,
                                burn=cfg.burn_, max_steps=cfg.chees_max_steps,
                                target_accept=min(cfg.target_accept, 0.651))
        res = sample_chains_chees(log_prob, inits, chees_cfg, inv_mass=inv_mass, aux=aux0,
                                  aux_refresh=aux_refresh, grad_fn=grad_fn, seed=seed,
                                  thin=sample_thin, segment_size=seg, progress=progress,
                                  aux_draw=aux_draw, mesh=mesh)
    elif cfg.algorithm == "nuts":
        nuts_cfg = NUTSConfig(num_samples=cfg.num_samples, max_depth=cfg.nuts_max_depth,
                              step_size=cfg.step_size, burn=cfg.burn_, adapt_step_size=True,
                              target_accept=cfg.target_accept, adapt_mass=cfg.adapt_mass,
                              mass_schedule=cfg.mass_schedule)
        res = sample_chains_nuts(log_prob, inits, nuts_cfg, inv_mass=inv_mass, aux=aux0,
                                 aux_refresh=aux_refresh, grad_fn=grad_fn, seed=seed,
                                 thin=sample_thin, segment_size=seg, progress=progress,
                                 aux_draw=aux_draw, mesh=mesh)
    else:
        hmc_cfg = HMCConfig(num_samples=cfg.num_samples, num_leapfrog=cfg.L,
                            step_size=cfg.step_size, burn=cfg.burn_,
                            sampler="hmc_nuts" if cfg.adapt_step_size else "hmc",
                            target_accept=cfg.target_accept, adapt_mass=cfg.adapt_mass,
                            mass_schedule=cfg.mass_schedule, jitter_l=cfg.jitter_l,
                            jitter_eps=cfg.jitter_eps, jitter_low_frac=cfg.jitter_low_frac,
                            max_step=cfg.max_step, da_axis=cfg.da_axis,
                            adapt_forever=cfg.adapt_forever,
                            store_aux_trace=cfg.save_vi_trace)
        if segment_size is not None and mesh is not None:
            raise ValueError("segment_size (resumable sampling) does not compose with a "
                             "mesh yet; shard chains via separate per-host runs instead")
        res = sample_chains_resumable(log_prob, inits, hmc_cfg, seg, inv_mass, aux0,
                                      grad_fn=grad_fn, thin=sample_thin, seed=seed,
                                      progress=progress, aux_refresh=aux_refresh,
                                      aux_draw=aux_draw, checkpoint_dir=checkpoint_dir,
                                      mesh=mesh)
    sync(dev)
    phases["sampling_s"] = time.perf_counter() - t0
    if mesh is not None:
        t0 = time.perf_counter()
        res = gather_chains(mesh, res)
        phases["gather_s"] = time.perf_counter() - t0

    out = {"result": res, "spec": spec, "prior": prior, "frozen": aux0,
           "log_prob": log_prob, "grad_fn": grad_fn, "inv_mass": inv_mass,
           "algorithm": cfg.algorithm, "phases_s": phases}
    if auto_probe is not None:
        out["auto_probe"] = auto_probe
    if gauss_used is not None:
        out["gauss_field_used"] = gauss_used
        out["gauss_field_probe_acceptance"] = probe_acceptance
    if evaluate and eval_forward is not None and y_eval is not None:
        t0 = time.perf_counter()
        eval_cfg = cfg
        if sample_thin > 1:
            eval_cfg = dataclasses.replace(cfg, burn=cfg.burn_ // sample_thin)
        # score against the frozen vectors the samples were drawn with: DRAW
        # the fixed draw, REFRESH each chain's last draw (C, D), MEAN the VI mean
        base = {"draw": aux0, "refresh": res.final_state.aux, "mean": None}[cfg.frozen_policy]
        if isinstance(base, dict):  # subsampled: {'frozen', 'tidx'}
            base = base["frozen"]
        evald = evaluate_samples(eval_cfg, spec, prior, eval_forward, y_eval,
                                 res.samples, frozen_base=base)
        evald["metrics"]["acceptance_rate"] = res.acceptance_rate
        evald["metrics"]["num_divergent"] = res.num_divergent
        out.update(evald)
        sync(dev)
        phases["evaluate_s"] = time.perf_counter() - t0

    if store is not None and is_lead(mesh):
        store.save_config(cfg)
        store.save_array("hmc_params", res.samples)
        if cfg.save_vi_trace and res.aux_trace is not None:
            trace = res.aux_trace
            # the frozen VI draw in effect at each draw, per chain (the
            # reference's vi_params); under subsampling the 'frozen' part
            store.save_array("vi_params", trace["frozen"] if isinstance(trace, dict)
                             else trace)
        if "metrics" in out:
            store.save_array("sample_mse", out["metrics"]["sample_mse"])
    return out


def _subsampled_posterior(cfg: VIHMCRunConfig, subsample: dict, spec: SubspaceSpec, prior,
                          frozen0, frozen_refresh, tidx0, seed: int, dev):
    """The query-subsampled target (vi_hmc.py:382-404): ``(log_prob, aux0,
    aux_refresh, aux_draw)`` with the aux ``{'frozen', 'tidx'}``; every
    draw redraws each chain's index set (and under REFRESH its frozen
    vector, from the normals drawn first)."""
    like = get_likelihood(cfg.loss)
    forward, y_fn = subsample["forward"], subsample["y_fn"]
    n_points, p = int(subsample["n_points"]), int(subsample["p"])
    idx = spec.idx
    n_chains, big_d = cfg.num_chains, spec.mu.shape[0]

    def log_prob(q_sub, aux):
        tidx = aux["tidx"]
        tidx = tidx.expand(q_sub.shape[0], -1) if tidx.ndim == 1 else tidx
        with true_f32():
            pred = forward(scatter_subspace(aux["frozen"], q_sub, idx), tidx)
        y = y_fn(tidx)
        return like(pred.reshape(y.shape), y, cfg.tau_out) + prior.log_prob(q_sub)

    def aux_draw(gen):
        z = (torch.randn((n_chains, big_d), generator=gen, device=dev)
             if frozen_refresh is not None else None)
        return z, query_index_sets(gen, n_chains, n_points, p, dev)

    def aux_refresh(draw):
        z, tidx = draw
        return {"frozen": frozen_refresh(z) if frozen_refresh is not None else frozen0,
                "tidx": tidx}

    if tidx0 is None:
        tidx0 = query_index_sets(stream_generator(dev, seed, _SUBSAMPLE_STREAM), 1,
                                 n_points, p, dev)[0]
    tidx0 = torch.as_tensor(np.asarray(tidx0.cpu() if isinstance(tidx0, torch.Tensor)
                                       else tidx0), dtype=torch.int64, device=dev)
    return log_prob, {"frozen": frozen0, "tidx": tidx0}, aux_refresh, aux_draw


def run_nn(cfg: VIHMCRunConfig, mlp_cfg: MLPConfig, artifacts, data=None,
           store: Optional[RunStore] = None, segment_size=None, progress=None,
           sample_thin: int = 1, evaluate: bool = True, seed: int = 0, frozen=None,
           lanczos_v0=None, probe_v0=None, checkpoint_dir=None, mesh=None, device="cuda"):
    """NN regression VI-HMC (the reference's ``main_VI_HMC.py``): autograd
    trajectories through the MLP likelihood on the synthetic data.

    ``data``: the dict of :func:`~vihmc_torch.data.synthetic.regression_data`
    (tensors or arrays), or None to make it here with noise std
    ``sqrt(tau_out)`` under NLL (a variance), ``tau_out^-1/2`` otherwise (a
    precision), from a generator seeded with ``seed``. ``mesh`` splits the
    chains over ranks (:func:`run_subspace_hmc`).
    """
    dev = resolve_device(device)
    if cfg.coarse_stride or cfg.fn_stride or cfg.grad_dtype == "bfloat16":
        raise ValueError("coarse_stride/fn_stride/grad_dtype apply to the "
                         "operator workload's Gram gradient only")
    _check_algorithm(cfg)
    data = _nn_data(cfg, data, seed, dev)
    apply_flat = make_flat_mlp(mlp_cfg)
    out = run_subspace_hmc(
        cfg, full_forward=lambda flat: apply_flat(flat, data["x_train"]),
        y_train=data["y_train"], artifacts=artifacts,
        eval_forward=lambda flat: apply_flat(flat, data["x_val"]), y_eval=data["y_val"],
        store=store, segment_size=segment_size, progress=progress, sample_thin=sample_thin,
        evaluate=evaluate, seed=seed, frozen=frozen, lanczos_v0=lanczos_v0,
        probe_v0=probe_v0, checkpoint_dir=checkpoint_dir, mesh=mesh, device=dev)
    out["data"] = data
    out["apply_flat"] = apply_flat
    return out


def _nn_data(cfg: VIHMCRunConfig, data, seed: int, dev) -> dict:
    """``data`` on ``dev``, or the synthetic regression data of ``seed``."""
    if data is not None:
        return split_to(data, dev)
    return regression_data(noise_std=cfg.tau_out ** (0.5 if cfg.loss == "NLL" else -0.5),
                           generator=stream_generator(dev, seed, _DATA_STREAM), device=dev)


def run_operator(cfg: VIHMCRunConfig, deeponet_cfg: DeepONetConfig, artifacts,
                 data=None, store: Optional[RunStore] = None, use_fused: bool = False,
                 use_gram: Optional[bool] = None, segment_size=None, progress=None,
                 sample_thin: int = 1, evaluate: bool = True, seed: int = 0,
                 frozen=None, lanczos_v0=None, probe_v0=None, checkpoint_dir=None,
                 mat_path=None, tidx0=None, mesh=None, device="cuda"):
    """Operator VI-HMC on Burgers (the reference's ``main_VI_HMC_burgers.py``).

    ``data``: ``(train, valid)`` dicts of ``branch_in`` (N, nx), ``trunk_in``
    (P, 2), ``solution`` (N, P) -- tensors or arrays -- or None for
    :func:`~vihmc_torch.data.burgers.get_burgers` on ``device`` (of the
    ``.mat`` at ``mat_path`` when given). With ``cfg.sample_data`` and
    ``cfg.p`` below the grid's points, each chain draws ``p`` of them before
    every draw (the first set ``tidx0``, else from the run's seed), and the
    composed density replaces the fused one.
    ``use_fused``: the fused merge-NLL density (one ``merge_sums`` launch per
    evaluation for all chains; NLL only). ``use_gram``: the Gram trajectory
    gradient, on the stride subsets of ``coarse_stride``/``fn_stride`` when
    set; None enables it when eligible (algorithm 'hmc' or 'auto', NLL,
    homoscedastic shared-grid merge, no ``gauss_field`` unless
    ``gauss_field_auto``), False takes autograd through the density.
    ``mesh`` splits the chains over ranks (:func:`run_subspace_hmc`): each
    rank's fused density launches ``merge_sums`` on its own C/N chains. The
    device is the card unless the caller asks for the CPU.
    """
    dev = resolve_device(device)
    _check_algorithm(cfg)
    _check_homoscedastic(deeponet_cfg)
    gauss_only = cfg.gauss_field is not None and not cfg.gauss_field_auto
    if gauss_only and (cfg.coarse_stride or cfg.fn_stride):
        raise ValueError("gauss_field replaces the Gram trajectory oracle; drop "
                         "coarse_stride/fn_stride (or set gauss_field_auto to "
                         "probe-and-fall-back)")
    t0 = time.perf_counter()
    train, valid = _operator_data(data, mat_path, dev)
    sync(dev)
    t_data = time.perf_counter() - t0
    apply_flat = make_flat_deeponet(deeponet_cfg)
    bx, tx, y = train["branch_in"], train["trunk_in"], train["solution"]

    subsample = None
    # a shared (P, 2) grid only (the reference: sample_data "Always false for cone")
    if cfg.sample_data and tx.ndim == 2 and cfg.p < tx.shape[0]:
        subsample = {"n_points": tx.shape[0], "p": cfg.p,
                     "forward": lambda flat, tidx: subsampled_forward(deeponet_cfg, flat, bx,
                                                                      tx[tidx]),
                     "y_fn": lambda tidx: y[:, tidx].transpose(0, 1)}
    full_ll = None
    if use_fused and cfg.loss == "NLL" and subsample is None:
        full_ll = make_deeponet_nll_log_posterior(deeponet_cfg, bx, tx, y, cfg.tau_out)
    # 'auto' resolves to HMC unless the probe picks NUTS, and the Gram field
    # is the gauss_field_auto probe's fallback: both are Gram-eligible
    gram_eligible = (cfg.algorithm in ("hmc", "auto") and cfg.loss == "NLL"
                     and subsample is None and not deeponet_cfg.noise_neurons
                     and tx.ndim == 2 and not gauss_only)
    full_grad = None
    if (use_gram and not gauss_only) or (use_gram is None and gram_eligible):
        subset = fn_subset = None
        if cfg.coarse_stride and cfg.coarse_stride > 1:
            subset = grid_stride_subset(*infer_grid_shape(tx), cfg.coarse_stride)
        if cfg.fn_stride and cfg.fn_stride > 1:
            fn_subset = np.arange(0, bx.shape[0], cfg.fn_stride)
        full_grad = make_gram_grad_full(
            deeponet_cfg, bx, tx, y, cfg.tau_out, query_subset=subset, fn_subset=fn_subset,
            compute_dtype=torch.bfloat16 if cfg.grad_dtype == "bfloat16" else None)
    elif cfg.coarse_stride or cfg.fn_stride:
        raise ValueError("coarse_stride/fn_stride require the Gram trajectory-gradient "
                         "path (plain HMC, NLL, shared grid, use_gram)")
    elif cfg.grad_dtype == "bfloat16":
        raise ValueError("grad_dtype='bfloat16' applies to the Gram trajectory-"
                         "gradient path (operator NLL, shared grid, use_gram)")

    out = run_subspace_hmc(
        cfg, full_forward=lambda flat: apply_flat(flat, bx, tx), y_train=y,
        artifacts=artifacts,
        eval_forward=lambda flat: apply_flat(flat, valid["branch_in"], valid["trunk_in"]),
        y_eval=valid["solution"], store=store, full_ll=full_ll, full_grad=full_grad,
        segment_size=segment_size, progress=progress, sample_thin=sample_thin,
        evaluate=evaluate, seed=seed, frozen=frozen, lanczos_v0=lanczos_v0,
        probe_v0=probe_v0, subsample=subsample, checkpoint_dir=checkpoint_dir, tidx0=tidx0,
        mesh=mesh, device=dev)
    out["phases_s"] = {"data_s": t_data, **out["phases_s"]}
    out["data"] = (train, valid)
    out["apply_flat"] = apply_flat
    return out


def _check_homoscedastic(deeponet_cfg: DeepONetConfig):
    """Stage 3's likelihood reads one output: a DeepONet with the
    heteroscedastic head, whose forward returns ``(y, noise)``, is refused
    (JAX's stage 3 fails on that output too)."""
    if deeponet_cfg.noise_neurons:
        raise ValueError("stage 3 samples the homoscedastic likelihood: a DeepONet with "
                         "the heteroscedastic head (noise_neurons > 0) is refused")


def _operator_data(data, mat_path, dev):
    if data is None:
        return get_burgers(dev, mat_path=mat_path)
    return tuple(split_to(s, dev) for s in data)


# ---------------------------------------------------------------------------
# Re-evaluation: reload saved samples and re-score them without sampling
# ---------------------------------------------------------------------------

def _rescore(cfg, artifacts, store: RunStore, eval_forward, y_eval, frozen_base,
             keep_predictions, dev):
    spec = make_spec(artifacts, dev)
    prior = make_subspace_prior(cfg, spec)
    return evaluate_samples(cfg, spec, prior, eval_forward, y_eval,
                            store.load_array("hmc_params"), keep_predictions=keep_predictions,
                            frozen_base=frozen_base)


def reevaluate_nn(cfg: VIHMCRunConfig, mlp_cfg: MLPConfig, artifacts, store: RunStore,
                  data=None, seed: int = 0, frozen_base=None, keep_predictions: int = 64,
                  device="cuda"):
    """Reload ``hmc_params`` from ``store`` and re-score them on the
    validation data (the reference's ``validate``, main_VI_HMC.py:384-447):
    ``data`` as :func:`run_nn` takes it (by default the same synthetic data
    as a :func:`run_nn` of ``seed``). ``frozen_base`` (D,) or (C, D) is the
    base the samples scatter into (default: the VI mean, as in JAX)."""
    dev = resolve_device(device)
    data = _nn_data(cfg, data, seed, dev)
    apply_flat = make_flat_mlp(mlp_cfg)
    return _rescore(cfg, artifacts, store, lambda flat: apply_flat(flat, data["x_val"]),
                    data["y_val"], frozen_base, keep_predictions, dev)


def reevaluate_operator(cfg: VIHMCRunConfig, deeponet_cfg: DeepONetConfig, artifacts,
                        store: RunStore, data=None, mat_path=None, frozen_base=None,
                        keep_predictions: int = 64, device="cuda"):
    """Operator twin (the reference's ``eval_VI_HMC``,
    main_VI_HMC_burgers.py:304-349): ``data`` or ``mat_path`` as
    :func:`run_operator` takes them."""
    dev = resolve_device(device)
    _check_homoscedastic(deeponet_cfg)
    _, valid = _operator_data(data, mat_path, dev)
    apply_flat = make_flat_deeponet(deeponet_cfg)
    return _rescore(cfg, artifacts, store,
                    lambda flat: apply_flat(flat, valid["branch_in"], valid["trunk_in"]),
                    valid["solution"], frozen_base, keep_predictions, dev)


# ---------------------------------------------------------------------------
# The stage-3 entry point (scripts/run_operator_stage3.py --variant autodiff)
# ---------------------------------------------------------------------------

#: the stage-3 script's trajectory clip: 13 sqrt(subspace dim)
STAGE3_CLIP_SCALE = 13.0


#: the script's trajectory-field variants (``--variant``); ``stride`` is its default
STAGE3_VARIANTS = ("stride", "gauss", "autodiff")


def stage3_config(d_sub: int, n_data: int, variant: str = "stride", draws: int = 450,
                  burn=None, chains: int = 16, L: int = 31, step=None, stride: int = 3,
                  fn_stride: int = 3, adapt: bool = False, da_axis: bool = False,
                  adapt_forever: bool = False, target_accept: float = 0.65,
                  max_step=None, jitter: str = "eps", frozen_policy: str = "draw",
                  init_optimize: int = 0, laplace_mass: bool = False,
                  clip_scale: float = STAGE3_CLIP_SCALE,
                  lowrank_rank: int = 0, algorithm: str = "hmc", nuts_max_depth: int = 6,
                  chees_max_steps: int = 256, adapt_mass: bool = False,
                  mass_schedule: str = "half") -> VIHMCRunConfig:
    """The ``run_operator_stage3.py`` config of one ``variant`` with the
    script's defaults (:36-81, :117-140): step 1e-4 (``gauss``:
    ``0.8 d_sub^-1/4`` unless ``step`` is given), fixed unless ``adapt``,
    eps-jitter, DRAW policy, VI-variance mass, clip ``13 sqrt(d_sub)``, no
    warm start; ``stride`` keeps every 3rd query point in both grid
    dimensions and every 3rd function in the Gram field, ``gauss`` leapfrogs
    on the VI-Gaussian score (alpha 1). ``lowrank_rank`` (no script flag)
    adds the Lanczos low-rank metric; ``algorithm`` and ``nuts_max_depth``
    (the entry point's flags), ``chees_max_steps``, ``adapt_mass`` and
    ``mass_schedule`` select the sampler and the adaptive metric."""
    if variant not in STAGE3_VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {STAGE3_VARIANTS}")
    if jitter not in ("l", "eps", "none"):
        raise ValueError(f"jitter {jitter!r}: 'l', 'eps' or 'none'")
    if step is None:
        step = 0.8 * d_sub ** -0.25 if variant == "gauss" else 1e-4
    return VIHMCRunConfig(
        step_size=step, num_samples=draws, burn=burn, post_std=0.0214,
        num_chains=chains, num_leapfrog=L, loss="NLL", tau_out=1.0,
        frozen_policy=frozen_policy, vi_mass=True, laplace_mass=laplace_mass,
        laplace_n_data=n_data, init_optimize=init_optimize,
        clip_grad=clip_scale * d_sub ** 0.5 if clip_scale else None,
        jitter_l=jitter == "l", jitter_eps=jitter == "eps",
        jitter_low_frac=0.5 if jitter != "none" else 0.0,
        adapt_step_size=adapt, target_accept=target_accept,
        da_axis="chains" if da_axis else None, adapt_forever=adapt_forever,
        max_step=max_step, lowrank_rank=lowrank_rank, algorithm=algorithm,
        nuts_max_depth=nuts_max_depth, chees_max_steps=chees_max_steps,
        adapt_mass=adapt_mass, mass_schedule=mass_schedule,
        gauss_field=1.0 if variant == "gauss" else None,
        coarse_stride=stride if variant == "stride" else None,
        fn_stride=fn_stride if variant == "stride" else None)


def trajectory_field_name(cfg: VIHMCRunConfig, use_gram=None) -> str:
    if cfg.gauss_field is not None:
        return f"gauss_alpha_{cfg.gauss_field:g}"
    if use_gram is False:
        return "autograd"
    if cfg.coarse_stride or cfg.fn_stride:
        return f"gram_stride_{cfg.coarse_stride or 1}x{cfg.fn_stride or 1}_f32"
    return "gram_f32"


def run_stage3(device="cuda", variant: str = "stride", draws: int = 450, burn=None,
               chains: int = 16, L: int = 31, segment: int = 90, thin: int = 3,
               use_gram=None, seed: int = 0, data=None, artifacts=None,
               frozen_policy: str = "draw", model: Optional[DeepONetConfig] = None,
               grid: Optional[dict] = None, store: Optional[RunStore] = None,
               checkpoint_dir=None, progress=None, evaluate: bool = True, **cfg_kw):
    """Run the stage-3 configuration of ``variant`` and return ``(summary,
    out)``: the script's summary keys plus ``draws_per_s``, ``phases_s`` and
    the trajectory field; ``out`` is :func:`run_operator`'s result.
    ``cfg_kw`` are :func:`stage3_config`'s other settings (the script's
    flags, and ``algorithm`` etc.). ``data`` and ``artifacts`` reuse already
    loaded ones (default: the port's assets); ``model`` is the DeepONet they
    belong to (default ``DeepONetConfig()``) and ``grid`` their ``nx``,
    ``nt`` and ``n_train`` (default: the exported inputs'). ``store``,
    ``checkpoint_dir`` and ``progress`` go to :func:`run_operator`; without
    ``evaluate`` the summary is the script's ``--no-eval`` one
    (``acceptance_post_burn``, ``ess_median_head`` over the first 4096
    subspace coordinates, ``wall_seconds``). The stride variant's field is
    the Gram field, which JAX builds by default for HMC only: under NUTS or
    ChEES it is asked for (``use_gram=True``) unless ``use_gram`` says
    otherwise."""
    dev = resolve_device(device)
    artifacts = load_stage12_artifacts() if artifacts is None else artifacts
    grid = load_port_inputs() if grid is None else grid
    model = DeepONetConfig() if model is None else model
    nx, nt = int(grid["nx"]), int(grid["nt"])
    cfg = stage3_config(len(artifacts["indices"]), int(grid["n_train"]) * nx * nt,
                        variant=variant, draws=draws, burn=burn, chains=chains, L=L,
                        frozen_policy=frozen_policy, **cfg_kw)
    if use_gram is None and variant == "stride" and cfg.algorithm in ("nuts", "chees"):
        use_gram = True
    t0 = time.perf_counter()
    out = run_operator(cfg, model, artifacts, data=data, use_fused=True,
                       use_gram=use_gram, segment_size=segment, sample_thin=thin,
                       seed=seed, store=store, checkpoint_dir=checkpoint_dir,
                       progress=progress, evaluate=evaluate, device=dev)
    wall = time.perf_counter() - t0
    res, phases = out["result"], out["phases_s"]
    # a resumed run holds only the draws run in this call, the last ones of the
    # chain (none after a finished checkpoint): burn counts from the chain's start
    accept = np.asarray(res.accept_probs)
    ran = accept[:, max(cfg.burn_ - (cfg.num_samples - accept.shape[1]), 0):]
    acc_post = float(ran.mean()) if ran.size else float("nan")
    if not evaluate:
        kept = res.samples[:, cfg.burn_ // thin:, :min(4096, len(artifacts["indices"]))]
        summary = {"acceptance_post_burn": acc_post,
                   "ess_median_head": float(np.median(summarize_np(kept)["ess"])),
                   "wall_seconds": wall, "draws_per_s": draws / phases["sampling_s"],
                   "phases_s": phases}
        return summary, out
    met, diag = out["metrics"], out["diagnostics"]
    truth = out["data"][1]["solution"].cpu().numpy()
    preds = np.asarray(out["predictions"]).reshape(-1, *truth.shape)
    rep = error_report(preds, truth, log_probs=np.asarray(met["expected_log_prob"])[None])
    corr = error_sigma_correlation(preds, truth, nt=nt, nx=nx)
    jitter = "l" if cfg.jitter_l else ("eps" if cfg.jitter_eps else "none")
    summary = {
        "variant": variant,
        "algorithm": out["algorithm"],
        "frozen_policy": frozen_policy,
        "trajectory_field": trajectory_field_name(cfg, use_gram),
        "lowrank_rank": cfg.lowrank_rank,
        "chains": chains, "draws": draws, "thin": thin, "burn": int(cfg.burn_),
        "L": cfg.L, "step": float(cfg.step_size), "adapt": cfg.adapt_step_size,
        "da_axis": cfg.da_axis == "chains", "jitter": jitter,
        "step_final_median": (float(np.median(np.asarray(res.step_sizes)[..., -1]))
                              if np.asarray(res.step_sizes).size else float("nan")),
        "acceptance": float(met["acceptance_rate"]),
        "acceptance_post_burn": acc_post,
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
    if "auto_probe" in out:
        summary["auto_probe"] = out["auto_probe"]
    if res.aux_trace is not None and "tree_leaves" in res.aux_trace:
        summary["tree_leaves_mean"] = float(np.mean(res.aux_trace["tree_leaves"]))
    if res.aux_trace is not None and "n_steps" in res.aux_trace:
        summary["chees_n_steps_mean"] = float(np.mean(res.aux_trace["n_steps"]))
        summary["chees_traj_length_final"] = float(res.aux_trace["traj_length"][-1])
    return summary, out


def add_stage3_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags this module's entry point shares with
    ``python -m vihmc_torch.scripts.run_operator_stage3`` (the script's
    names and defaults, plus ``--device``)."""
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variant", default="stride", choices=STAGE3_VARIANTS,
                    help="trajectory field: dual-stride Gram surrogate (default), "
                         "VI-Gaussian score, or the full-grid field")
    ap.add_argument("--stride", type=int, default=3)
    ap.add_argument("--fn-stride", type=int, default=3)
    ap.add_argument("--draws", type=int, default=450)
    ap.add_argument("--burn", type=int, default=None, help="default draws // 5")
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--L", type=int, default=31)
    ap.add_argument("--adapt", action="store_true", help="dual-averaging step adaptation")
    ap.add_argument("--da-axis", action="store_true",
                    help="couple dual averaging across chains")
    ap.add_argument("--adapt-forever", action="store_true",
                    help="dual averaging past burn with the adapting iterate")
    ap.add_argument("--target-accept", type=float, default=0.65)
    ap.add_argument("--max-step", type=float, default=None)
    ap.add_argument("--jitter", choices=("l", "eps", "none"), default="eps")
    ap.add_argument("--frozen-policy", default="draw", choices=("draw", "refresh", "mean"))
    ap.add_argument("--init-optimize", type=int, default=0,
                    help="warm-start Adam steps on the conditional before sampling")
    ap.add_argument("--laplace-mass", action="store_true",
                    help="conditional-Laplace kinetic metric instead of VI sigma^2")
    ap.add_argument("--clip-scale", type=float, default=STAGE3_CLIP_SCALE,
                    help="clip = scale * sqrt(subspace dim); 0 disables")
    ap.add_argument("--segment", type=int, default=90)
    ap.add_argument("--thin", type=int, default=3,
                    help="keep every thin-th draw (must divide --segment)")
    return ap


def stage3_kwargs(args) -> dict:
    """:func:`run_stage3`'s keywords from the flags of :func:`add_stage3_flags`."""
    return dict(device=args.device, variant=args.variant, draws=args.draws, burn=args.burn,
                chains=args.chains, L=args.L, segment=args.segment, thin=args.thin,
                frozen_policy=args.frozen_policy, stride=args.stride,
                fn_stride=args.fn_stride, adapt=args.adapt, da_axis=args.da_axis,
                adapt_forever=args.adapt_forever, target_accept=args.target_accept,
                max_step=args.max_step, jitter=args.jitter, laplace_mass=args.laplace_mass,
                init_optimize=args.init_optimize, clip_scale=args.clip_scale)


def main(argv=None):
    ap = add_stage3_flags(argparse.ArgumentParser(
        description="stage-3 operator VI-HMC (fused merge-NLL)"))
    ap.add_argument("--algorithm", default="hmc", choices=ALGORITHMS,
                    help="sampler: HMC, NUTS, ChEES-HMC, or the stiffness probe's choice")
    ap.add_argument("--nuts-max-depth", type=int, default=6,
                    help="NUTS tree depth (2^depth - 1 density evaluations per draw)")
    ap.add_argument("--step", type=float, default=None,
                    help="initial step (default 1e-4; gauss: 0.8 d^-1/4)")
    ap.add_argument("--seed", type=int, default=0)
    field = ap.add_mutually_exclusive_group()
    field.add_argument("--use-gram", dest="use_gram", action="store_const", const=True,
                       help="Gram trajectory gradient (the default when eligible)")
    field.add_argument("--no-gram", dest="use_gram", action="store_const", const=False,
                       help="autograd trajectory gradient through the fused density")
    args = ap.parse_args(argv)
    summary, _ = run_stage3(**stage3_kwargs(args), use_gram=args.use_gram, seed=args.seed,
                            step=args.step, algorithm=args.algorithm,
                            nuts_max_depth=args.nuts_max_depth)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
