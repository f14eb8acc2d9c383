"""Full-parameter DeepONet HMC with dual-averaging step adaptation.

Counterpart of ``vihmc_tpu/pipelines/hmc_nuts.py`` (``score_on_validation``,
``run``, ``reevaluate``; :35-165), the reference's
``Operator_network/HMC/NUTS_DeepOnets.py``: the whole 172,401-parameter
vector under an isotropic ``N(0, prior_var)`` prior, dual averaging of each
chain's step toward ``target_accept`` during the first ``burn`` draws, then
its averaged step, frozen. The density is one of

* ``use_fused``: the fused merge-NLL (one ``merge_sums`` launch per
  evaluation for all chains);
* the composed forward and ``cfg.loss``;
* ``sample_data``: the composed forward on a random subset of ``p`` query
  points, redrawn for every chain before every draw (the aux of the
  transition is the index set: ``(p,)`` at init, ``(C, p)`` after the first
  refresh, as JAX's vmapped refresh leaves it). Each chain's points differ,
  so the trunk runs on ``(C, p)`` points, one batched matmul per layer.

and the trajectory field is the Gram gradient with the prior's
(:func:`~vihmc_torch.ops.gram_merge.make_gram_grad_full`) when eligible
(NLL, shared grid, no subsampling), else autograd of the density. Sampling
goes through :func:`~vihmc_torch.chains.resume.sample_chains_resumable` in
one segment, every draw kept (burn draws too, as JAX's ``sample`` keeps
them); the pooled post-burn draws are scored on the validation split.

The chain inits (``0.1 N(0, 1)``) and the index sets come from
``torch.Generator`` streams of ``seed``; JAX draws them from keys, which
PyTorch cannot replay, so ``inits=`` and ``tidx0=`` take JAX's for a test.
The entry point runs ``OperatorHMCRunConfig``'s defaults on the card (10
training functions, L = 7, 10 draws) with the fused density and prints one
JSON line::

    python -m vihmc_torch.pipelines.hmc_nuts [--draws N] [--chains C]
        [--composed] [--sample-data] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from vihmc_torch.chains.diagnostics import summarize_np
from vihmc_torch.chains.parallel import gather_chains
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core.mesh import is_lead
from vihmc_torch.core.device import resolve_device, split_to, stream_generator, sync, to_f32
from vihmc_torch.core.precision import true_f32
from vihmc_torch.data.burgers import get_burgers_baseline
from vihmc_torch.dists.likelihoods import get_likelihood
from vihmc_torch.dists.priors import IsotropicGaussianPrior
from vihmc_torch.hmc.kernel import HMCConfig
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.ops.gram_merge import make_gram_grad_full
from vihmc_torch.pipelines.common import (make_deeponet_nll_log_posterior, make_flat_deeponet,
                                          query_index_sets, subsampled_forward)
from vihmc_torch.pipelines.configs import OperatorHMCRunConfig
from vihmc_torch.pipelines.hmc_full import divergence_note, host_metrics, summarize_run
from vihmc_torch.pipelines.predict import posterior_predictive, predictive_metrics

#: generator streams of a run's seed (the sampler's segment is stream 0)
_INIT_STREAM, _SUBSAMPLE_STREAM = 720_001, 720_002
#: samples per forward in the evaluation (JAX's chunk)
EVAL_CHUNK = 16


def load_data(cfg, device):
    """``(train, valid, n_valid)``: the first ``cfg.n_train`` exported
    functions and validation rows from row 1000 on, at most the 200 exported."""
    return get_burgers_baseline(device, cfg.n_train, cfg.n_valid)


def score_on_validation(cfg, apply_flat, prior, valid, samples, burn):
    """Pooled posterior predictive of ``(C, S, D)`` full-parameter samples on
    the validation split: ``(metrics, preds, log_probs)`` (shared by the
    NUTS-style and split runs and their re-evaluation)."""
    like = get_likelihood(cfg.loss)
    y = valid["solution"]
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[None]
    pooled = torch.as_tensor(samples[:, burn:, :].reshape(-1, samples.shape[-1]),
                             dtype=torch.float32, device=y.device)

    def lp_and_pred(flat):
        with true_f32():
            pred = apply_flat(flat, valid["branch_in"], valid["trunk_in"])
        lp = like(pred.reshape(flat.shape[0], *y.shape), y, cfg.tau_out) + prior.log_prob(flat)
        return lp, pred

    log_probs, preds = posterior_predictive(lp_and_pred, pooled, chunk_size=EVAL_CHUNK)
    return predictive_metrics(preds, y, log_probs), preds, log_probs


def run(cfg: OperatorHMCRunConfig = OperatorHMCRunConfig(), data=None, num_chains: int = 1,
        store: Optional[RunStore] = None, use_fused: bool = False,
        use_gram: Optional[bool] = None, inits=None, tidx0=None, seed: int = 0,
        mesh=None, device="cuda"):
    """Sample, score on validation and (optionally) persist (see module doc).

    ``data``: ``(train, valid)`` dicts (tensors or arrays), or None for
    :func:`load_data`. Returns ``result``, ``metrics`` (with
    ``acceptance_rate`` and each chain's ``adapted_step_size``),
    ``diagnostics``, ``data``, ``apply_flat``, ``phases_s`` and the sampler's
    ``log_prob`` and ``grad_fn``.

    ``mesh`` (:func:`~vihmc_torch.chains.make_chain_mesh`) splits the chains
    over ranks and gathers them before the scoring, so every rank reports
    the whole run; the run store is written by its first rank.
    """
    dev = resolve_device(device)
    phases = {}
    t0 = time.perf_counter()
    if data is None:
        train, valid, _ = load_data(cfg, dev)
    else:
        train, valid = (split_to(s, dev) for s in data)
    sync(dev)
    phases["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = cfg.model
    bx, tx, y = train["branch_in"], train["trunk_in"], train["solution"]
    apply_flat = make_flat_deeponet(model)
    like = get_likelihood(cfg.loss)
    prior = IsotropicGaussianPrior(scale=cfg.prior_var ** 0.5)
    n_grid = tx.shape[0]
    subsample = cfg.sample_data and cfg.p < n_grid

    aux0 = aux_refresh = aux_draw = None
    if subsample:
        def log_prob(flat, tidx):
            idx = tidx.expand(flat.shape[0], -1) if tidx.ndim == 1 else tidx
            with true_f32():
                pred = subsampled_forward(model, flat, bx, tx[idx])
            return like(pred, y[:, idx].transpose(0, 1), cfg.tau_out) + prior.log_prob(flat)

        def aux_draw(gen):
            return query_index_sets(gen, num_chains, n_grid, cfg.p, dev)

        def aux_refresh(z):
            return z

        if tidx0 is None:
            gen = stream_generator(dev, seed, _SUBSAMPLE_STREAM)
            tidx0 = torch.randperm(n_grid, generator=gen, device=dev)[:cfg.p]
        aux0 = torch.as_tensor(np.asarray(tidx0.cpu() if isinstance(tidx0, torch.Tensor)
                                          else tidx0), dtype=torch.int64, device=dev)
    elif use_fused and cfg.loss == "NLL":
        fused_ll = make_deeponet_nll_log_posterior(model, bx, tx, y, cfg.tau_out)

        def log_prob(flat, aux=None):
            return fused_ll(flat) + prior.log_prob(flat)
    else:
        def log_prob(flat, aux=None):
            with true_f32():
                pred = apply_flat(flat, bx, tx)
            return like(pred.reshape(flat.shape[0], *y.shape), y, cfg.tau_out) \
                + prior.log_prob(flat)

    gram_eligible = (cfg.loss == "NLL" and not subsample and not model.noise_neurons
                     and tx.ndim == 2)
    grad_fn = None
    if use_gram or (use_gram is None and gram_eligible):
        grad_full = make_gram_grad_full(model, bx, tx, y, cfg.tau_out, prior=prior)

        def grad_fn(flat, aux=None):
            return grad_full(flat)

    if inits is None:
        gen = stream_generator(dev, seed, _INIT_STREAM)
        inits = 0.1 * torch.randn((num_chains, model.num_params), generator=gen, device=dev)
    inits = to_f32(inits, dev)
    hmc_cfg = HMCConfig(num_samples=cfg.num_samples, num_leapfrog=cfg.L,
                        step_size=cfg.step_size, burn=cfg.burn, sampler="hmc_nuts",
                        target_accept=cfg.target_accept)
    sync(dev)
    phases["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sample_chains_resumable(log_prob, inits, hmc_cfg, cfg.num_samples, 1.0, aux0,
                                  grad_fn=grad_fn, seed=seed, aux_refresh=aux_refresh,
                                  aux_draw=aux_draw, mesh=mesh)
    sync(dev)
    phases["sampling_s"] = time.perf_counter() - t0
    res = gather_chains(mesh, res)

    t0 = time.perf_counter()
    metrics, _, _ = score_on_validation(cfg, apply_flat, prior, valid, res.samples, cfg.burn)
    metrics = host_metrics(metrics)
    metrics["acceptance_rate"] = res.acceptance_rate
    metrics["adapted_step_size"] = res.step_sizes[:, -1]
    diag = summarize_np(res.samples[:, cfg.burn:, :])
    sync(dev)
    phases["evaluate_s"] = time.perf_counter() - t0
    if store is not None and is_lead(mesh):
        store.save_config(cfg)
        store.save_array("hmc_params", res.samples)
        store.save_array("sample_mse", metrics["sample_mse"])
    return {"result": res, "metrics": metrics, "diagnostics": diag, "data": (train, valid),
            "apply_flat": apply_flat, "phases_s": phases, "log_prob": log_prob,
            "grad_fn": grad_fn}


def reevaluate(cfg, store: RunStore, data=None, device="cuda"):
    """Reload saved full-parameter samples and re-score them on the
    validation split (the reference's ``evaluate`` mode; the NUTS-style and
    split configs share it)."""
    dev = resolve_device(device)
    if data is None:
        _, valid, _ = load_data(cfg, dev)
    else:
        valid = split_to(data[1], dev)
    apply_flat = make_flat_deeponet(cfg.model)
    prior = IsotropicGaussianPrior(scale=cfg.prior_var ** 0.5)
    samples = np.asarray(store.load_array("hmc_params"))
    if samples.ndim == 2:
        samples = samples[None]
    metrics, preds, _ = score_on_validation(cfg, apply_flat, prior, valid, samples, cfg.burn)
    return {"metrics": host_metrics(metrics), "predictions": preds.cpu().numpy(),
            "diagnostics": summarize_np(samples[:, cfg.burn:, :])}


def cap_note(cfg, n_valid_used: int):
    """Say on stderr when the config asks for more validation rows than the
    export holds."""
    if n_valid_used < cfg.n_valid:
        print(f"n_valid {cfg.n_valid} capped at the {n_valid_used} exported validation "
              f"rows", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(description="full-parameter DeepONet HMC, dual averaging")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=None, help="default: the config's 10")
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--composed", action="store_true",
                    help="the composed density instead of the fused merge-NLL")
    ap.add_argument("--sample-data", action="store_true",
                    help="a random subset of p query points per chain and draw")
    ap.add_argument("--p", type=int, default=None, help="query points kept with --sample-data")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = OperatorHMCRunConfig(sample_data=args.sample_data)
    if args.draws is not None:
        cfg = dataclasses.replace(cfg, num_samples=args.draws)
    if args.p is not None:
        cfg = dataclasses.replace(cfg, p=args.p)
    dev = resolve_device(args.device)
    train, valid, used = load_data(cfg, dev)
    cap_note(cfg, used)
    out = run(cfg, data=(train, valid), num_chains=args.chains, use_fused=not args.composed,
              seed=args.seed, device=dev)
    divergence_note(out)
    line = summarize_run(out, cfg, dev)
    line.update(use_fused=not args.composed, sample_data=cfg.sample_data, n_valid=used,
                trajectory_field="gram_f32" if out["grad_fn"] is not None else "autograd")
    print(json.dumps(line))


if __name__ == "__main__":
    main()
