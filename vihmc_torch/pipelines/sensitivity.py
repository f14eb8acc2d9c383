"""Sensitivity pipelines: rank VI-posterior parameters, select the HMC subspace.

Counterpart of ``vihmc_tpu/pipelines/sensitivity.py`` (:30-104), with the
same artifact names (``means_flattened``, ``stds_flattened``,
``gradient_indices``, ``sensitivity_scores`` and the ``config_sens``
snapshot): the filesystem contract the VI-HMC stage reads. The operator
stage scores ``p_subsample`` random trunk points per example of a shared
grid; the points come from a generator seeded with ``seed`` (JAX: a
threefry key), or are injected as ``trunk_idx`` (B, p). Per-example query
points (Cone, ``trunk_in`` (B, p, 2)) are scored as they are. A DeepONet
with the heteroscedastic head is scored on its mean output, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vihmc_torch.core.device import stream_generator, to_f32
from vihmc_torch.data.burgers import subsample_trunk
from vihmc_torch.io.artifacts import RunStore
from vihmc_torch.models.deeponet import DeepONetConfig
from vihmc_torch.models.mlp import MLPConfig
from vihmc_torch.pipelines.common import make_flat_deeponet, make_flat_mlp
from vihmc_torch.pipelines.configs import SensitivityRunConfig
from vihmc_torch.sensitivity import (captured_variance_count, flatten_mean_std,
                                     select_sensitive_indices, sensitivity_scores)
from vihmc_torch.vi.train import split_prediction

#: the trunk subsample's generator stream (core/device.stream_generator)
_TRUNK_STREAM = 800_001


def _finish(cfg: SensitivityRunConfig, scores, flat_mu, flat_sigma,
            store: Optional[RunStore]) -> dict:
    scores = scores.detach().cpu().numpy().astype(np.float32)
    indices = select_sensitive_indices(scores, cfg.importance_threshold)
    out = {
        "scores": scores,
        "indices": indices,
        "mu": flat_mu.detach().cpu().numpy(),
        "sigma": flat_sigma.detach().cpu().numpy(),
        "num_sensitive": len(indices),
        "captured_count": captured_variance_count(scores, cfg.importance_threshold),
    }
    if store is not None:
        store.save_config(cfg, name="config_sens")
        store.save_array("means_flattened", out["mu"])
        store.save_array("stds_flattened", out["sigma"])
        store.save_array("gradient_indices", indices)
        store.save_array("sensitivity_scores", out["scores"])
    return out


def run_nn(vp: dict, mlp_cfg: MLPConfig, inputs: torch.Tensor,
           cfg: SensitivityRunConfig = SensitivityRunConfig(),
           store: Optional[RunStore] = None) -> dict:
    """NN sensitivity. ``vp`` = trained ``{'mu', 'rho'}``; ``inputs`` (N, in)."""
    flat_mu, flat_sigma = flatten_mean_std(vp)
    return run_nn_flat(flat_mu, flat_sigma, mlp_cfg, inputs, cfg, store)


def run_nn_flat(flat_mu, flat_sigma, mlp_cfg: MLPConfig, inputs: torch.Tensor,
                cfg: SensitivityRunConfig = SensitivityRunConfig(),
                store: Optional[RunStore] = None) -> dict:
    """NN sensitivity from flat VI mu/sigma vectors (tensors or arrays, put on
    ``inputs``' device) -- the standalone stage against a finished VI run."""
    dev = inputs.device
    flat_mu, flat_sigma = to_f32(flat_mu, dev), to_f32(flat_sigma, dev)
    apply_flat = make_flat_mlp(mlp_cfg)

    def apply_one(flat, x):
        return apply_flat(flat[None], x[None, :])[0, 0]

    scores = sensitivity_scores(apply_one, flat_mu, flat_sigma, inputs,
                                chunk_size=cfg.batch_chunk)
    return _finish(cfg, scores, flat_mu, flat_sigma, store)


def run_operator(vp: dict, deeponet_cfg: DeepONetConfig, split: dict,
                 cfg: SensitivityRunConfig = SensitivityRunConfig(), seed: int = 0,
                 store: Optional[RunStore] = None, trunk_idx=None) -> dict:
    """Operator sensitivity over ``cfg.p_subsample`` random trunk points per
    example of ``split`` (``branch_in`` (B, nx), ``trunk_in`` (P, 2),
    ``solution`` (B, P), on one device), or over its per-example points
    (``trunk_in`` (B, p, 2))."""
    flat_mu, flat_sigma = flatten_mean_std(vp)
    return run_operator_flat(flat_mu, flat_sigma, deeponet_cfg, split, cfg, seed=seed,
                             store=store, trunk_idx=trunk_idx)


def run_operator_flat(flat_mu, flat_sigma, deeponet_cfg: DeepONetConfig, split: dict,
                      cfg: SensitivityRunConfig = SensitivityRunConfig(), seed: int = 0,
                      store: Optional[RunStore] = None, trunk_idx=None) -> dict:
    """Operator twin of :func:`run_nn_flat`. The trunk subsample is drawn from
    a generator seeded with ``seed`` unless ``trunk_idx`` (B, p) is given;
    per-example points are used as they are."""
    dev = split["branch_in"].device
    flat_mu, flat_sigma = to_f32(flat_mu, dev), to_f32(flat_sigma, dev)
    apply_flat = make_flat_deeponet(deeponet_cfg)
    if split["trunk_in"].ndim == 3:
        trunk_sub = split["trunk_in"]        # per-example points (Cone): no grid to subsample
    else:
        p = min(cfg.p_subsample, split["trunk_in"].shape[0])
        gen = stream_generator(dev, seed, _TRUNK_STREAM)
        trunk_sub, _ = subsample_trunk(split, p, generator=gen, idx=trunk_idx)   # (B, p, 2)
    inputs = {"branch": split["branch_in"], "trunk": trunk_sub}

    def apply_one(flat, x):
        out = apply_flat(flat[None], x["branch"][None, :], x["trunk"][None])
        return split_prediction(out)[0][0, 0]

    scores = sensitivity_scores(apply_one, flat_mu, flat_sigma, inputs,
                                chunk_size=cfg.batch_chunk)
    return _finish(cfg, scores, flat_mu, flat_sigma, store)
