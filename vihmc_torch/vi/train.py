"""VI training: ensemble-averaged ELBO, Adam with reduce-on-plateau, metrics.

Counterpart of ``vihmc_tpu/vi/train.py`` (:37-338). Two forms of one
training rule:

* :class:`VITrainer` and :func:`run_epochs`, the epoch loop of JAX's
  ``train_fullbatch_scan`` and ``_run_operator_scan`` (a constant float
  ``beta_type``, the shipped configs);
* the functional trainer of JAX's Python loop: :class:`VITrainState` (the
  flat ``vp``, JAX's unused ``noise_param``, the Adam moments, the plateau
  state, the epoch), :func:`init_train_state`, :func:`make_train_step`,
  :func:`make_eval_fn` and :func:`train`, which takes the KL weight of
  every step from ``get_beta`` (string ``beta_type`` schedules too), writes
  the best state to ``<ckpt_dir>/best`` whenever it improves and the state
  every ``n_save`` epochs and at the end (:mod:`vihmc_torch.io.checkpoint`),
  and with ``restart`` resumes from the latest; the checkpoint holds the
  generator's state too, so a restarted run equals the uninterrupted one.

Both:

* the per-step loss is the mean over ``num_ens`` stochastic forwards of the
  negative ELBO; the ensemble is one chain-batched forward of ``(E, D)``
  weight draws (:class:`~vihmc_torch.models.bayesian.BayesianFlat`);
* the optimizer is Adam with optax's ``adam`` defaults (b1 0.9, b2 0.999,
  eps 1e-8 added to ``sqrt(v_hat)``: ``torch.optim.Adam`` in
  :class:`VITrainer`, optax's update written out in :func:`adam_update`);
  the plateau scale multiplies the step, as ``plateau_update`` does in JAX
  (a copy of the rule: relative threshold 1e-4, reduce when ``num_bad >
  patience``, floor ``min_lr / lr_start``, evaluated in float32 like the
  JAX state);
* each epoch's metric row is ``[train_loss, valid_loss, train_mse,
  valid_mse]``: ``valid_loss`` is the stochastic ELBO on the validation
  batch, both MSEs use the mean weights; the plateau rule reads
  ``valid_loss`` and the best state is the one with the lowest.

A learned noise variance is not ported (``NotImplementedError``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from vihmc_torch.io.checkpoint import latest_step, load_checkpoint, save_checkpoint
from vihmc_torch.models.bayesian import BayesianFlat, kl_divergence
from vihmc_torch.vi.elbo import ELBOConfig, check_elbo, elbo_loss, get_beta

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
    n_save: int = 0        # checkpoint every n_save epochs (0 = best/final only)
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

    def loss(self, batch, eps=None) -> torch.Tensor:
        """Mean over the ensemble of the negative ELBO (differentiable)."""
        cfg = self.cfg
        kl = self.model.kl(cfg.prior_mu, cfg.prior_sigma, cfg.kl_direction)
        pred = self.model(batch, eps=eps, num_samples=cfg.num_ens, generator=self.generator)
        return elbo_loss(cfg.elbo, pred, batch["y"], kl, self.beta, self.train_size).mean()

    def step(self, batch, eps=None) -> torch.Tensor:
        """One Adam step at ``lr_start * plateau.scale``; returns the loss."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(batch, eps)
        loss.backward()
        for group in self.opt.param_groups:
            group["lr"] = self.cfg.lr_start * float(self.plateau.scale)
        self.opt.step()
        return loss.detach()

    def mse(self, batch) -> torch.Tensor:
        with torch.no_grad():
            pred = self.model(batch, sample=False)
            return torch.mean((pred.reshape(batch["y"].shape) - batch["y"]) ** 2)

    def evaluate(self, batch, eps=None):
        """``(stochastic loss, mean-weight MSE)`` on one batch."""
        with torch.no_grad():
            return self.loss(batch, eps), self.mse(batch)

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
                       eps=None) -> torch.Tensor:
    """``n`` stochastic forwards (the reference's ``do_uq``) as one batched
    forward: ``(n, ...)``."""
    with torch.no_grad():
        return model(batch, eps=eps, num_samples=n, generator=generator)


# ---------------------------------------------------------------------------
# The functional trainer (JAX's Python-loop ``train``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and the two moments of
    ``{'mu', 'rho'}``."""

    count: int
    mu: dict
    nu: dict


@dataclasses.dataclass
class VITrainState:
    vp: dict                    # {'mu': (D,), 'rho': (D,)}
    noise_param: torch.Tensor   # () log-variance (JAX's; used iff learn_noise)
    opt_state: AdamState
    plateau: PlateauState
    epoch: int


def init_train_state(vp: dict, cfg: VIConfig) -> VITrainState:
    """The state at ``vp`` with zero Adam moments (train.py:89-94)."""
    check_vi_config(cfg)
    vp = {k: vp[k].detach().clone().float() for k in ("mu", "rho")}
    zeros = {k: torch.zeros_like(v) for k, v in vp.items()}
    return VITrainState(vp=vp, noise_param=torch.zeros((), device=vp["mu"].device),
                        opt_state=AdamState(0, zeros, {k: v.clone() for k, v in zeros.items()}),
                        plateau=plateau_init(), epoch=0)


def adam_update(params: dict, grads: dict, st: AdamState, lr: float, scale=1.0):
    """optax's ``adam(lr)`` update, then multiplied by the plateau ``scale``:
    ``(params, state)``."""
    b1, b2 = ADAM_BETAS
    count = st.count + 1
    mu = {k: (1 - b1) * grads[k] + b1 * st.mu[k] for k in params}
    nu = {k: (1 - b2) * grads[k] * grads[k] + b2 * st.nu[k] for k in params}
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    new = {}
    for k in params:
        update = -lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS))
        new[k] = params[k] + update * float(scale)
    return new, AdamState(count, mu, nu)


def make_loss_fn(apply_fn: Callable, cfg: VIConfig, train_size):
    """``loss_fn(vp, batch, eps, beta, generator) -> ()``: the ensemble mean
    of the negative ELBO (``apply_fn(vp, batch, eps, sample, num_samples,
    generator)``, :func:`~vihmc_torch.pipelines.common.mlp_vi_apply`)."""

    def loss_fn(vp, batch, eps, beta, generator=None):
        kl = kl_divergence(vp, cfg.prior_mu, cfg.prior_sigma, cfg.kl_direction)
        pred = apply_fn(vp, batch, eps, True, cfg.num_ens, generator)
        return elbo_loss(cfg.elbo, pred, batch["y"], kl, beta, train_size).mean()

    return loss_fn


def make_train_step(apply_fn: Callable, cfg: VIConfig, train_size):
    """``step(state, batch, eps=None, beta=1.0, generator=None) -> (state,
    loss)``: one Adam step on the loss at the ensemble normals ``eps`` (or
    drawn from ``generator``), at ``lr_start * plateau.scale``."""
    loss_fn = make_loss_fn(apply_fn, cfg, train_size)

    def step(state: VITrainState, batch, eps=None, beta=1.0, generator=None):
        with torch.enable_grad():
            vp = {k: v.detach().requires_grad_(True) for k, v in state.vp.items()}
            loss = loss_fn(vp, batch, eps, beta, generator)
            g_mu, g_rho = torch.autograd.grad(loss, [vp["mu"], vp["rho"]])
        new_vp, opt = adam_update(state.vp, {"mu": g_mu, "rho": g_rho}, state.opt_state,
                                  cfg.lr_start, state.plateau.scale)
        return dataclasses.replace(state, vp=new_vp, opt_state=opt), loss.detach()

    return step


def _mean_mse(apply_fn, vp, batch) -> torch.Tensor:
    pred = apply_fn(vp, batch, None, False)
    return torch.mean((pred.reshape(batch["y"].shape) - batch["y"]) ** 2)


def make_eval_fn(apply_fn: Callable, cfg: VIConfig, train_size):
    """``evaluate(state, batch, eps=None, beta=1.0, generator=None) -> (loss,
    mse)``: the stochastic loss and the mean-weight MSE on one batch."""
    loss_fn = make_loss_fn(apply_fn, cfg, train_size)

    def evaluate(state: VITrainState, batch, eps=None, beta=1.0, generator=None):
        with torch.no_grad():
            return (loss_fn(state.vp, batch, eps, beta, generator),
                    _mean_mse(apply_fn, state.vp, batch))

    return evaluate


def _save(ckpt_dir, step, state, epoch, generator):
    save_checkpoint(ckpt_dir, step, {
        "state": state, "epoch": epoch,
        "generator": None if generator is None else generator.get_state()})


def train(apply_fn: Callable, state: VITrainState, cfg: VIConfig,
          train_batches_fn: Callable, valid_batch, train_eval_batch, train_size,
          generator: Optional[torch.Generator] = None, callback: Optional[Callable] = None,
          ckpt_dir: Optional[str] = None, restart: bool = False,
          eps_fn: Optional[Callable] = None):
    """The epoch loop of JAX's ``train`` (train.py:252-338). Returns
    ``(final state, best state, metrics (epochs run, 4))``.

    Each epoch: ``train_batches_fn(generator, epoch)`` gives the batches; a
    step on each with the KL weight ``get_beta(i, m, beta_type, epoch,
    epochs)``; the validation batch's stochastic loss and mean-weight MSE and
    the train-side MSE at ``get_beta(0, m, ...)``; the plateau rule on the
    validation loss. The ensemble normals come from ``generator`` unless
    ``eps_fn(epoch, kind, i)`` gives them (``kind`` 'train' with the batch
    index, or 'valid'). ``callback(epoch, row, state)`` runs after each epoch.
    With ``ckpt_dir``, see the module doc.
    """
    start = 0
    if ckpt_dir is not None and restart:
        done = latest_step(ckpt_dir)
        if done is not None:
            payload = load_checkpoint(ckpt_dir, done, map_location=state.vp["mu"].device)
            state, start = payload["state"], int(payload["epoch"])
            if generator is not None and payload.get("generator") is not None:
                generator.set_state(payload["generator"])
    step = make_train_step(apply_fn, cfg, train_size)
    evaluate = make_eval_fn(apply_fn, cfg, train_size)

    def eps_of(epoch, kind, i=0):
        return None if eps_fn is None else eps_fn(epoch, kind, i)

    rows, best_state, best_valid = [], state, float("inf")
    for epoch in range(start, cfg.epochs):
        batches = list(train_batches_fn(generator, epoch))
        m = len(batches)
        losses = []
        for i, batch in enumerate(batches):
            state, loss = step(state, batch, eps_of(epoch, "train", i),
                               get_beta(i, m, cfg.beta_type, epoch, cfg.epochs), generator)
            losses.append(float(loss))
        beta_eval = get_beta(0, m, cfg.beta_type, epoch, cfg.epochs)
        valid_loss, valid_mse = evaluate(state, valid_batch, eps_of(epoch, "valid"), beta_eval,
                                         generator)
        with torch.no_grad():
            train_mse = _mean_mse(apply_fn, state.vp, train_eval_batch)
        valid_loss = float(valid_loss)
        state = dataclasses.replace(
            state, epoch=state.epoch + 1,
            plateau=plateau_update(state.plateau, valid_loss, cfg.patience,
                                   cfg.plateau_factor, cfg.min_lr / cfg.lr_start))
        row = [sum(losses) / m, valid_loss, float(train_mse), float(valid_mse)]
        rows.append(row)
        improved = valid_loss < best_valid
        if improved:
            best_valid, best_state = valid_loss, state
        if ckpt_dir is not None:
            if improved:
                _save(os.path.join(ckpt_dir, "best"), 0, state, epoch + 1, generator)
            if cfg.n_save and (epoch + 1) % cfg.n_save == 0:
                _save(ckpt_dir, epoch + 1, state, epoch + 1, generator)
        if callback is not None:
            callback(epoch, row, state)
    if ckpt_dir is not None:
        _save(ckpt_dir, cfg.epochs, state, cfg.epochs, generator)
    return state, best_state, np.asarray(rows, dtype=np.float64).reshape(-1, 4)
