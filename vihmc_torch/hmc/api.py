"""hamiltorch-style convenience API: one call to sample a model, one to predict.

Counterpart of ``vihmc_tpu/hmc/api.py`` (``sample_model``, ``predict_model``;
:25-111), the JAX twins of the reference's ``hamiltorch.sample_model`` and
``hamiltorch.predict_model``: the model is a pure ``apply_fn(params, x)`` and
a parameter tree (nested dicts, lists or tuples of tensors), raveled in the
JAX package's ``ravel_pytree`` order (:func:`~vihmc_torch.core.ravel.ravel_tree`);
``tau_list`` holds per-tensor prior PRECISIONS, ``model_loss`` names the
likelihood (:func:`~vihmc_torch.dists.likelihoods.get_likelihood`).

One chain, run through :func:`~vihmc_torch.chains.resume.sample_chains_resumable`
in one segment; the result's arrays drop the chain axis, so ``samples`` is
``(num_samples, D)`` with the burn draws included, as hamiltorch returns them.
The draws come from the ``torch.Generator`` of ``seed``'s first segment. The
device is the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from vihmc_torch.chains.resume import SampleResult, sample_chains_resumable
from vihmc_torch.core.device import resolve_device
from vihmc_torch.core.ravel import per_segment_vector, ravel_tree, tree_leaves
from vihmc_torch.dists.likelihoods import get_likelihood
from vihmc_torch.dists.priors import PerSegmentGaussianPrior
from vihmc_torch.hmc.kernel import HMCConfig
from vihmc_torch.pipelines.predict import posterior_predictive

#: samples per call in ``predict_model`` (JAX's chunk)
PREDICT_CHUNK = 256


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return torch.as_tensor(tree, dtype=torch.float32, device=dev)


def _flat_posterior(apply_fn, params, x, y, model_loss, tau_out, tau_list,
                    normalizing_const=None):
    """``(log_prob(flat (C, D)) -> (C,), flat0 (D,), unravel, prior)``."""
    flat0, unravel = ravel_tree(params)
    like = get_likelihood(model_loss)
    n_leaves = len(tree_leaves(params))
    taus = list(tau_list) if tau_list is not None else [1.0] * n_leaves
    prior = PerSegmentGaussianPrior(
        per_segment_vector(params, [t ** -0.5 for t in taus]).to(flat0.device))
    # hamiltorch's normalizing_const rescales a minibatch likelihood to the
    # full data; None leaves it unscaled
    ll_scale = 1.0 if normalizing_const is None else normalizing_const / y.shape[0]

    def outputs(flat):
        outs = []
        for row in flat:
            out = apply_fn(unravel(row), x)
            if out.numel() == y.numel() and out.shape != y.shape:
                out = out.reshape(y.shape)
            outs.append(out)
        return torch.stack(outs)

    def log_prob(flat):
        return like(outputs(flat), y, tau_out) * ll_scale + prior.log_prob(flat)

    return log_prob, flat0, unravel, prior


def sample_model(apply_fn: Callable, params, x, y, model_loss: str = "regression",
                 num_samples: int = 100, num_steps_per_sample: int = 10,
                 step_size: float = 0.1, burn: int = 0, tau_out: float = 1.0,
                 tau_list: Optional[Sequence[float]] = None, sampler: str = "hmc",
                 inv_mass=1.0, normalizing_const: Optional[float] = None, seed: int = 0,
                 device="cuda") -> SampleResult:
    """Build the flat log-posterior of ``(apply_fn, params)`` on ``(x, y)``
    and run one HMC chain from ``params`` (``hamiltorch.sample_model``)."""
    dev = resolve_device(device)
    params, x, y = _to(params, dev), _to(x, dev), _to(y, dev)
    log_prob, flat0, _, _ = _flat_posterior(apply_fn, params, x, y, model_loss, tau_out,
                                            tau_list, normalizing_const)
    cfg = HMCConfig(num_samples=num_samples, num_leapfrog=num_steps_per_sample,
                    step_size=step_size, burn=burn, sampler=sampler)
    res = sample_chains_resumable(lambda q, aux: log_prob(q), flat0[None].clone(), cfg,
                                  num_samples, inv_mass, None, seed=seed)
    return dataclasses.replace(
        res, samples=res.samples[0], log_probs=res.log_probs[0],
        accept_probs=res.accept_probs[0], accepted=res.accepted[0],
        step_sizes=res.step_sizes[0], divergent=res.divergent[0])


def predict_model(apply_fn: Callable, params, samples, x, y, model_loss: str = "regression",
                  tau_out: float = 1.0, tau_list: Optional[Sequence[float]] = None,
                  device="cuda"):
    """``(predictions (S, ...), log_probs (S,))`` of flat ``samples`` (S, D)
    on ``(x, y)`` (``hamiltorch.predict_model``)."""
    dev = resolve_device(device)
    params, x, y = _to(params, dev), _to(x, dev), _to(y, dev)
    log_prob, _, unravel, _ = _flat_posterior(apply_fn, params, x, y, model_loss, tau_out,
                                              tau_list)

    def lp_and_pred(rows):
        return log_prob(rows), torch.stack([apply_fn(unravel(r), x) for r in rows])

    log_probs, preds = posterior_predictive(
        lp_and_pred, torch.as_tensor(samples, dtype=torch.float32, device=dev),
        chunk_size=PREDICT_CHUNK)
    return preds, log_probs
