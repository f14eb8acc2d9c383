"""Split-Hamiltonian HMC of the full DeepONet over data shards.

Counterpart of ``vihmc_tpu/pipelines/hmc_split.py`` (``run``,
``reevaluate``; :33-89), the reference's
``Operator_network/HMC/main_HMC_splitting.py``: the training functions cut
into ``num_splits`` equal shards, one potential per shard with the prior
divided among them, integrated by the split leapfrog
(:func:`~vihmc_torch.hmc.integrators.split_leapfrog`, the kernel's
``integrator='splitting'``) with a fixed step, or dual averaging per chain
under ``is_nuts``; the endpoint's full density decides MH. Every density and
gradient is the composed forward and autograd, as in JAX, so this path
launches no kernel of the port.

The chain inits (``0.1 N(0, 1)``) come from a ``torch.Generator`` stream of
``seed`` (``inits=`` takes JAX's for a test). The entry point runs
``SplitHMCRunConfig``'s defaults on the card (1000 training functions in 2
shards, L = 2, 1001 draws); the config's 1000 validation functions exceed
the 200 exported, so it scores on those 200 and says so on stderr::

    python -m vihmc_torch.pipelines.hmc_split [--draws N] [--chains C] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from vihmc_torch.chains.diagnostics import summarize_np
from vihmc_torch.chains.parallel import gather_chains
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core.mesh import is_lead
from vihmc_torch.core.device import resolve_device, split_to, stream_generator, sync, to_f32
from vihmc_torch.core.precision import true_f32
from vihmc_torch.data.burgers import split_shards
from vihmc_torch.dists.likelihoods import get_likelihood
from vihmc_torch.dists.priors import IsotropicGaussianPrior
from vihmc_torch.hmc.kernel import HMCConfig
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.pipelines.common import make_flat_deeponet
from vihmc_torch.pipelines.configs import SplitHMCRunConfig
from vihmc_torch.pipelines.hmc_full import divergence_note, host_metrics, summarize_run
from vihmc_torch.pipelines.hmc_nuts import (cap_note, load_data, reevaluate,  # noqa: F401
                                            score_on_validation)

#: generator stream of the chain inits (the sampler's segment is stream 0)
_INIT_STREAM = 730_001


def make_shard_log_prob(cfg: SplitHMCRunConfig, trunk: torch.Tensor):
    """``shard_log_prob(flat (C, d), (branch, solution), aux) -> (C,)``: one
    shard's likelihood on the query points ``trunk`` plus its share of the
    prior (hmc_split.py:49-53)."""
    apply_flat = make_flat_deeponet(cfg.model)
    like = get_likelihood(cfg.loss)
    prior = IsotropicGaussianPrior(scale=cfg.prior_var ** 0.5)

    def shard_log_prob(flat, shard, aux=None):
        branch, sol = shard
        with true_f32():
            pred = apply_flat(flat, branch, trunk)
        return like(pred.reshape(flat.shape[0], *sol.shape), sol, cfg.tau_out) \
            + prior.log_prob(flat) / cfg.num_splits

    return shard_log_prob


def run(cfg: SplitHMCRunConfig = SplitHMCRunConfig(), data=None, num_chains: int = 1,
        store: Optional[RunStore] = None, inits=None, seed: int = 0, mesh=None,
        device="cuda", mat_path: Optional[str] = None):
    """Sample, score on validation and (optionally) persist (see module doc).

    ``data``: ``(train, valid)`` dicts (tensors or arrays), or None for
    :func:`~vihmc_torch.pipelines.hmc_nuts.load_data` (of ``mat_path`` when
    given). Returns ``result``,
    ``metrics``, ``diagnostics``, ``data``, ``apply_flat``, ``phases_s`` and
    the sampler's ``log_prob``, ``shard_log_prob`` and ``shard_data``.

    ``mesh`` (:func:`~vihmc_torch.chains.make_chain_mesh`) splits the chains
    over ranks and gathers them before the scoring, so every rank reports
    the whole run; the run store is written by its first rank.
    The split integrator's data shards stay whole on every rank.
    """
    dev = resolve_device(device)
    phases = {}
    t0 = time.perf_counter()
    if data is None:
        train, valid, _ = load_data(cfg, dev, mat_path)
    else:
        train, valid = (split_to(s, dev) for s in data)
    sync(dev)
    phases["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = split_shards(train, cfg.num_splits)
    apply_flat = make_flat_deeponet(cfg.model)
    like = get_likelihood(cfg.loss)
    prior = IsotropicGaussianPrior(scale=cfg.prior_var ** 0.5)
    trunk = train["trunk_in"]
    shard_log_prob = make_shard_log_prob(cfg, trunk)

    def log_prob(flat, aux=None):
        with true_f32():
            pred = apply_flat(flat, train["branch_in"], trunk)
        y = train["solution"]
        return like(pred.reshape(flat.shape[0], *y.shape), y, cfg.tau_out) \
            + prior.log_prob(flat)

    shard_data = (shards["branch_in"], shards["solution"])
    if inits is None:
        gen = stream_generator(dev, seed, _INIT_STREAM)
        inits = 0.1 * torch.randn((num_chains, cfg.model.num_params), generator=gen,
                                  device=dev)
    inits = to_f32(inits, dev)
    hmc_cfg = HMCConfig(num_samples=cfg.num_samples, num_leapfrog=cfg.L,
                        step_size=cfg.step_size, burn=cfg.burn,
                        sampler="hmc_nuts" if cfg.is_nuts else "hmc",
                        integrator="splitting", target_accept=cfg.target_accept)
    sync(dev)
    phases["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sample_chains_resumable(log_prob, inits, hmc_cfg, cfg.num_samples, 1.0, None,
                                  seed=seed, shard_log_prob_fn=shard_log_prob,
                                  shard_data=shard_data, mesh=mesh)
    sync(dev)
    phases["sampling_s"] = time.perf_counter() - t0
    res = gather_chains(mesh, res)

    t0 = time.perf_counter()
    metrics, _, _ = score_on_validation(cfg, apply_flat, prior, valid, res.samples, cfg.burn)
    metrics = host_metrics(metrics)
    metrics["acceptance_rate"] = res.acceptance_rate
    diag = summarize_np(res.samples[:, cfg.burn:, :])
    sync(dev)
    phases["evaluate_s"] = time.perf_counter() - t0
    if store is not None and is_lead(mesh):
        store.save_config(cfg)
        store.save_array("hmc_params", res.samples)
        store.save_array("sample_mse", metrics["sample_mse"])
    return {"result": res, "metrics": metrics, "diagnostics": diag, "data": (train, valid),
            "apply_flat": apply_flat, "phases_s": phases, "log_prob": log_prob,
            "shard_log_prob": shard_log_prob, "shard_data": shard_data}


def main(argv=None):
    ap = argparse.ArgumentParser(description="split-Hamiltonian full-parameter DeepONet HMC")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=None, help="default: the config's 1001")
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = SplitHMCRunConfig()
    if args.draws is not None:
        cfg = dataclasses.replace(cfg, num_samples=args.draws)
    dev = resolve_device(args.device)
    train, valid, used = load_data(cfg, dev)
    cap_note(cfg, used)
    out = run(cfg, data=(train, valid), num_chains=args.chains, seed=args.seed, device=dev)
    divergence_note(out)
    line = summarize_run(out, cfg, dev)
    line.update(num_splits=cfg.num_splits, is_nuts=cfg.is_nuts, n_valid=used)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
