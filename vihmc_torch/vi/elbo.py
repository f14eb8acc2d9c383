"""ELBO losses and KL-annealing schedules.

Counterpart of ``vihmc_tpu/vi/elbo.py`` (:28-88). Two reductions of the
Gaussian NLL data term: ``'sum'`` (the NN variant) and ``'mean_x_n'`` (the
operator variant: the mean times the training-set size, so a minibatch loss
is an unbiased estimate of the full-data NLL). The noise variance is
``fixed_noise_var``; a learned log-variance (``learn_noise``) and the
heteroscedastic head (``noise_type=1``) are not ported yet and raise
``NotImplementedError``. :func:`get_beta` and :func:`accuracy` are
verbatim copies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from vihmc_torch.dists.likelihoods import gaussian_nll


@dataclasses.dataclass(frozen=True)
class ELBOConfig:
    reduction: str = "sum"        # 'sum' (NN variant) | 'mean_x_n' (operator variant)
    learn_noise: bool = False     # noise_param is a learned log-variance (not ported)
    noise_type: int = 0           # 0 = homoscedastic scalar, 1 = heteroscedastic (not ported)
    fixed_noise_var: float = 1.0  # used when not learning noise


def check_elbo(cfg: ELBOConfig):
    if cfg.learn_noise:
        raise NotImplementedError("learn_noise (a learned noise log-variance) is not ported")
    if cfg.noise_type != 0:
        raise NotImplementedError("noise_type=1 (the heteroscedastic head) is not ported")
    if cfg.reduction not in ("sum", "mean_x_n"):
        raise ValueError(f"unknown reduction {cfg.reduction!r}")


def elbo_loss(cfg: ELBOConfig, prediction: torch.Tensor, target: torch.Tensor, kl,
              beta: float, train_size) -> torch.Tensor:
    """Negative ELBO of each ensemble member: ``(E,)`` for ``prediction``
    ``(E, *target.shape)`` (any leading shape that reshapes to it)."""
    check_elbo(cfg)
    pred = prediction.reshape(-1, *target.shape)
    nll = gaussian_nll(pred, target, cfg.fixed_noise_var).flatten(1)
    if cfg.reduction == "sum":
        data_term = nll.sum(-1)
    else:
        data_term = nll.mean(-1) * train_size
    return data_term + beta * kl


def accuracy(outputs, targets) -> float:
    """Classification accuracy (the reference's ``acc``): argmax over the
    last axis against integer targets; numpy, as JAX's."""
    import numpy as np

    pred = np.asarray(outputs).argmax(axis=-1)
    return float(np.mean(pred == np.asarray(targets).reshape(pred.shape)))


def get_beta(batch_idx: int, m: int, beta_type: Union[float, str],
             epoch: Optional[int] = None, num_epochs: Optional[int] = None) -> float:
    """KL weight schedule; semantics identical to the reference ``get_beta``."""
    if isinstance(beta_type, float):
        return beta_type
    if beta_type == "Blundell":
        return 2 ** (m - (batch_idx + 1)) / (2 ** m - 1)
    if beta_type == "linear":
        return min(1.0, (1 - 1e-4) / num_epochs * epoch + 1e-4)
    if beta_type == "step":
        return min(1.0, 1e-4 * 10 ** ((epoch + 1) // num_epochs))
    if beta_type == "Soenderby":
        if epoch is None or num_epochs is None:
            raise ValueError("Soenderby method requires both epoch and num_epochs to be passed.")
        return min(epoch / (num_epochs // 4), 1)
    if beta_type == "Standard":
        return 1.0 / m
    return 0.0
