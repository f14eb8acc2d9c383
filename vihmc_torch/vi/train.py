"""VI training: ensemble-averaged ELBO, Adam with reduce-on-plateau, metrics.

Counterpart of ``vihmc_tpu/vi/train.py`` (:37-249) on the paths the shipped
configs take (a constant float ``beta_type``):

* the per-step loss is the mean over ``num_ens`` stochastic forwards of the
  negative ELBO; the ensemble is one chain-batched forward of ``(E, D)``
  weight draws (:class:`~vihmc_torch.models.bayesian.BayesianFlat`);
* the optimizer is ``torch.optim.Adam`` with optax's ``adam`` defaults (b1
  0.9, b2 0.999, eps 1e-8 added to ``sqrt(v_hat)``); the plateau scale
  multiplies the step, as ``plateau_update`` does in JAX (a copy of the rule:
  relative threshold 1e-4, reduce when ``num_bad > patience``, floor
  ``min_lr / lr_start``, evaluated in float32 like the JAX state);
* each epoch's metric row is ``[train_loss, valid_loss, train_mse,
  valid_mse]``: ``valid_loss`` is the stochastic ELBO on the validation
  batch, both MSEs use the mean weights; the plateau rule reads
  ``valid_loss`` and the best state is the one with the lowest.

The Python-loop ``train`` of the JAX package (string ``beta_type``
schedules, checkpoint and restart) and a learned noise variance are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from vihmc_torch.models.bayesian import BayesianFlat
from vihmc_torch.vi.elbo import ELBOConfig, check_elbo, elbo_loss

ADAM_BETAS = (0.9, 0.999)   # optax.adam defaults
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class VIConfig:
    epochs: int = 1000
    lr_start: float = 1e-2
    min_lr: float = 1e-5
    patience: int = 100
    plateau_factor: float = 0.1
    num_ens: int = 10
    beta_type: Any = 1.0
    prior_mu: float = 0.0
    prior_sigma: float = 1.0
    elbo: ELBOConfig = dataclasses.field(default_factory=ELBOConfig)
    kl_direction: str = "reference"
    n_save: int = 0        # checkpoint every n_save epochs (not ported: 0 only)
    log_every: int = 100


@dataclasses.dataclass(frozen=True)
class PlateauState:
    best: np.float32
    num_bad: int
    scale: np.float32


def plateau_init() -> PlateauState:
    return PlateauState(best=np.float32(np.inf), num_bad=0, scale=np.float32(1.0))


def plateau_update(st: PlateauState, value, patience, factor, min_scale,
                   threshold=1e-4) -> PlateauState:
    """torch ReduceLROnPlateau (mode 'min', relative threshold) as the JAX
    package's pure rule, in float32."""
    value = np.float32(value)
    improved = value < st.best * np.float32(1.0 - threshold)
    best = np.minimum(st.best, value)
    num_bad = 0 if improved else st.num_bad + 1
    scale = st.scale
    if num_bad > patience:
        scale = np.maximum(st.scale * np.float32(factor), np.float32(min_scale))
        num_bad = 0
    return PlateauState(best=best, num_bad=num_bad, scale=scale)


@dataclasses.dataclass
class VIState:
    """A snapshot of training: the variational parameters (detached copies),
    the plateau state and the epoch count."""

    vp: dict
    plateau: PlateauState
    epoch: int


def check_vi_config(cfg: VIConfig):
    check_elbo(cfg.elbo)
    if not isinstance(cfg.beta_type, float):
        raise NotImplementedError("string beta_type schedules (the Python-loop trainer) "
                                  "are not ported; use a constant float")
    if cfg.n_save:
        raise NotImplementedError("periodic checkpoints (n_save) are not ported")


class VITrainer:
    """One Bayesian model, its Adam optimizer and plateau state.

    ``step`` takes one ELBO gradient step on a batch dict (``'y'`` the
    targets); ``evaluate`` returns the stochastic loss and the mean-weight
    MSE; ``end_epoch`` applies the plateau rule to a validation loss. The
    ensemble normals come from ``generator`` unless ``eps`` (E, D) is given.
    """

    def __init__(self, model: BayesianFlat, cfg: VIConfig, train_size,
                 generator: Optional[torch.Generator] = None):
        check_vi_config(cfg)
        self.model, self.cfg, self.train_size = model, cfg, train_size
        self.generator = generator
        self.beta = float(cfg.beta_type)
        self.opt = torch.optim.Adam(model.parameters(), lr=cfg.lr_start, betas=ADAM_BETAS,
                                    eps=ADAM_EPS)
        self.plateau = plateau_init()
        self.epoch = 0

    def loss(self, batch, eps: torch.Tensor) -> torch.Tensor:
        """Mean over the ensemble of the negative ELBO (differentiable)."""
        cfg = self.cfg
        kl = self.model.kl(cfg.prior_mu, cfg.prior_sigma, cfg.kl_direction)
        pred = self.model(batch, eps=eps)
        return elbo_loss(cfg.elbo, pred, batch["y"], kl, self.beta, self.train_size).mean()

    def _eps(self, eps):
        return self.model.draw_eps(self.cfg.num_ens, self.generator) if eps is None else eps

    def step(self, batch, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One Adam step at ``lr_start * plateau.scale``; returns the loss."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(batch, self._eps(eps))
        loss.backward()
        for group in self.opt.param_groups:
            group["lr"] = self.cfg.lr_start * float(self.plateau.scale)
        self.opt.step()
        return loss.detach()

    def mse(self, batch) -> torch.Tensor:
        with torch.no_grad():
            pred = self.model(batch, sample=False)
            return torch.mean((pred.reshape(batch["y"].shape) - batch["y"]) ** 2)

    def evaluate(self, batch, eps: Optional[torch.Tensor] = None):
        """``(stochastic loss, mean-weight MSE)`` on one batch."""
        with torch.no_grad():
            return self.loss(batch, self._eps(eps)), self.mse(batch)

    def end_epoch(self, valid_loss: float):
        cfg = self.cfg
        self.plateau = plateau_update(self.plateau, valid_loss, cfg.patience,
                                      cfg.plateau_factor, cfg.min_lr / cfg.lr_start)
        self.epoch += 1

    def snapshot(self) -> VIState:
        return VIState(vp={k: v.detach().clone() for k, v in self.model.vp().items()},
                       plateau=self.plateau, epoch=self.epoch)


def run_epochs(trainer: VITrainer, batches_fn: Callable[[int], Iterable], valid_batch,
               train_eval_batch, epochs: Optional[int] = None,
               callback: Optional[Callable] = None):
    """The epoch loop of ``train_fullbatch_scan`` and ``_run_operator_scan``.

    Each epoch takes a step on every batch of ``batches_fn(epoch)`` (its
    train loss is their mean), then evaluates the validation batch (the
    stochastic ELBO and the mean-weight MSE) and the train-side MSE, applies
    the plateau rule to the validation loss and keeps the state of the
    lowest one. ``callback(epoch, row, trainer)`` runs after each epoch.
    Returns ``(final VIState, best VIState, metrics (epochs, 4))``.
    """
    epochs = trainer.cfg.epochs if epochs is None else epochs
    rows = []
    best_state, best_valid = trainer.snapshot(), float("inf")
    for epoch in range(epochs):
        losses = [trainer.step(batch) for batch in batches_fn(epoch)]
        valid_loss, valid_mse = trainer.evaluate(valid_batch)
        train_mse = trainer.mse(train_eval_batch)
        row = torch.stack([torch.stack(losses).mean(), valid_loss, train_mse,
                           valid_mse]).cpu().numpy().astype(np.float64)
        trainer.end_epoch(row[1])
        rows.append(row)
        if row[1] < best_valid:
            best_valid, best_state = row[1], trainer.snapshot()
        if callback is not None:
            callback(epoch, row, trainer)
    return trainer.snapshot(), best_state, np.asarray(rows).reshape(-1, 4)


def predictive_samples(model: BayesianFlat, batch, n: int,
                       generator: Optional[torch.Generator] = None,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n`` stochastic forwards (the reference's ``do_uq``) as one batched
    forward: ``(n, ...)``."""
    with torch.no_grad():
        return model(batch, eps=eps, num_samples=n, generator=generator)
