"""VI training: ensemble-averaged ELBO, Adam with reduce-on-plateau, metrics.

Counterpart of ``vihmc_tpu/vi/train.py`` (:37-338). Two forms of one
training rule:

* :class:`VITrainer` and :func:`run_epochs`, the epoch loop of JAX's
  ``train_fullbatch_scan`` and ``_run_operator_scan`` (a constant float
  ``beta_type``, the shipped configs);
* the functional trainer of JAX's Python loop: :class:`VITrainState` (the
  flat ``vp``, the noise log-variance ``noise_param``, the Adam moments, the
  plateau state, the epoch), :func:`init_train_state`, :func:`make_train_step`,
  :func:`make_eval_fn` and :func:`train`, which takes the KL weight of
  every step from ``get_beta`` (string ``beta_type`` schedules too), writes
  the best state to ``<ckpt_dir>/best`` whenever it improves and the state
  every ``n_save`` epochs and at the end (:mod:`vihmc_torch.io.checkpoint`),
  and with ``restart`` resumes from the latest; the checkpoint holds the
  generator's state too, so a restarted run equals the uninterrupted one.

Both:

* the per-step loss is the mean over ``num_ens`` stochastic forwards of the
  negative ELBO; the ensemble is one chain-batched forward of ``(E, D)``
  weight draws (:class:`~vihmc_torch.models.bayesian.BayesianFlat`); a
  model with the heteroscedastic head returns ``(pred, noise)``, and under
  ``noise_type=1`` the head's output is the ELBO's log-variance;
* with ``learn_noise`` the scalar log-variance ``noise_param`` (0 at the
  start) is a trained parameter under the same Adam and plateau scale as
  ``vp``, the best state keeps its ``noise_param``, the metric rows gain an
  ``exp(noise_param)`` column and the checkpoints carry it. JAX's full-batch
  scan (``train_fullbatch_scan``, the NN pipeline's constant-beta path)
  writes no such column; :func:`run_epochs` leaves it out there too
  (``noise_column``);
* the optimizer is Adam with optax's ``adam`` defaults (b1 0.9, b2 0.999,
  eps 1e-8 added to ``sqrt(v_hat)``: ``torch.optim.Adam`` in
  :class:`VITrainer`, optax's update written out in :func:`adam_update`);
  the plateau scale multiplies the step, as ``plateau_update`` does in JAX
  (a copy of the rule: relative threshold 1e-4, reduce when ``num_bad >
  patience``, floor ``min_lr / lr_start``, evaluated in float32 like the
  JAX state);
* each epoch's metric row is ``[train_loss, valid_loss, train_mse,
  valid_mse]`` (+ ``exp(noise_param)``): ``valid_loss`` is the stochastic
  ELBO on the validation batch, both MSEs use the mean weights; the plateau
  rule reads ``valid_loss`` and the best state is the one with the lowest.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

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
    """A snapshot of training: the variational parameters and the noise
    log-variance (detached copies), the plateau state and the epoch count."""

    vp: dict
    plateau: PlateauState
    epoch: int
    noise_param: torch.Tensor


def split_prediction(out):
    """A model's output as ``(pred, noise_head)``: the head is None without one."""
    return out if isinstance(out, tuple) else (out, None)


def check_vi_config(cfg: VIConfig):
    check_elbo(cfg.elbo)


class VITrainer:
    """One Bayesian model, its Adam optimizer and plateau state.

    ``step`` takes one ELBO gradient step on a batch dict (``'y'`` the
    targets); ``evaluate`` returns the stochastic loss and the mean-weight
    MSE; ``end_epoch`` applies the plateau rule to a validation loss. The
    ensemble normals come from ``generator`` unless ``eps`` (E, D) is given.
    ``noise_param`` is the scalar log-variance, trained with ``vp`` under
    ``learn_noise``.
    """

    def __init__(self, model: BayesianFlat, cfg: VIConfig, train_size,
                 generator: Optional[torch.Generator] = None):
        check_vi_config(cfg)
        self.model, self.cfg, self.train_size = model, cfg, train_size
        self.generator = generator
        self.beta = float(cfg.beta_type)
        self.noise_param = torch.zeros((), device=model.mu.device)
        params = list(model.parameters())
        if cfg.elbo.learn_noise:
            self.noise_param = nn.Parameter(self.noise_param)
            params.append(self.noise_param)
        self.opt = torch.optim.Adam(params, lr=cfg.lr_start, betas=ADAM_BETAS, eps=ADAM_EPS)
        self.plateau = plateau_init()
        self.epoch = 0

    def loss(self, batch, eps=None) -> torch.Tensor:
        """Mean over the ensemble of the negative ELBO (differentiable)."""
        cfg = self.cfg
        kl = self.model.kl(cfg.prior_mu, cfg.prior_sigma, cfg.kl_direction)
        pred, head = split_prediction(
            self.model(batch, eps=eps, num_samples=cfg.num_ens, generator=self.generator))
        noise = head if cfg.elbo.noise_type == 1 else self.noise_param
        return elbo_loss(cfg.elbo, pred, batch["y"], kl, self.beta, self.train_size,
                         noise).mean()

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
            pred, _ = split_prediction(self.model(batch, sample=False))
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
                       plateau=self.plateau, epoch=self.epoch,
                       noise_param=self.noise_param.detach().clone())


def run_epochs(trainer: VITrainer, batches_fn: Callable[[int], Iterable], valid_batch,
               train_eval_batch, epochs: Optional[int] = None,
               callback: Optional[Callable] = None, noise_column: Optional[bool] = None):
    """The epoch loop of ``train_fullbatch_scan`` and ``_run_operator_scan``.

    Each epoch takes a step on every batch of ``batches_fn(epoch)`` (its
    train loss is their mean), then evaluates the validation batch (the
    stochastic ELBO and the mean-weight MSE) and the train-side MSE, applies
    the plateau rule to the validation loss and keeps the state of the
    lowest one. ``callback(epoch, row, trainer)`` runs after each epoch.
    ``noise_column`` (default: ``learn_noise``) appends ``exp(noise_param)``
    to each row. Returns ``(final VIState, best VIState, metrics (epochs, 4
    or 5))``.
    """
    epochs = trainer.cfg.epochs if epochs is None else epochs
    if noise_column is None:
        noise_column = trainer.cfg.elbo.learn_noise
    rows = []
    best_state, best_valid = trainer.snapshot(), float("inf")
    for epoch in range(epochs):
        losses = [trainer.step(batch) for batch in batches_fn(epoch)]
        valid_loss, valid_mse = trainer.evaluate(valid_batch)
        train_mse = trainer.mse(train_eval_batch)
        row = torch.stack([torch.stack(losses).mean(), valid_loss, train_mse,
                           valid_mse]).cpu().numpy().astype(np.float64)
        trainer.end_epoch(row[1])
        if noise_column:
            row = np.append(row, float(torch.exp(trainer.noise_param.detach())))
        rows.append(row)
        if row[1] < best_valid:
            best_valid, best_state = row[1], trainer.snapshot()
        if callback is not None:
            callback(epoch, row, trainer)
    return trainer.snapshot(), best_state, np.asarray(rows).reshape(len(rows), -1)


def predictive_samples(model: BayesianFlat, batch, n: int,
                       generator: Optional[torch.Generator] = None,
                       eps=None) -> torch.Tensor:
    """``n`` stochastic forwards (the reference's ``do_uq``) as one batched
    forward: ``(n, ...)``."""
    with torch.no_grad():
        return split_prediction(model(batch, eps=eps, num_samples=n, generator=generator))[0]


# ---------------------------------------------------------------------------
# The functional trainer (JAX's Python-loop ``train``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and the two moments of
    ``{'mu', 'rho'}`` (and ``'noise'``, the log-variance, under ``learn_noise``)."""

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


def _trained(state: VITrainState, cfg: VIConfig) -> dict:
    """The parameters Adam trains: ``vp``, plus the noise under ``learn_noise``."""
    params = dict(state.vp)
    if cfg.elbo.learn_noise:
        params["noise"] = state.noise_param
    return params


def init_train_state(vp: dict, cfg: VIConfig) -> VITrainState:
    """The state at ``vp`` and ``noise_param`` 0 with zero Adam moments
    (train.py:89-94)."""
    check_vi_config(cfg)
    vp = {k: vp[k].detach().clone().float() for k in ("mu", "rho")}
    noise = torch.zeros((), device=vp["mu"].device)
    zeros = {k: torch.zeros_like(v) for k, v in vp.items()}
    if cfg.elbo.learn_noise:
        zeros["noise"] = torch.zeros_like(noise)
    return VITrainState(vp=vp, noise_param=noise,
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
    """``loss_fn(vp, batch, eps, beta, generator, noise_param) -> ()``: the
    ensemble mean of the negative ELBO (``apply_fn(vp, batch, eps, sample,
    num_samples, generator)``, :func:`~vihmc_torch.pipelines.common.mlp_vi_apply`;
    ``noise_param`` the scalar log-variance, the head's under ``noise_type=1``)."""

    def loss_fn(vp, batch, eps, beta, generator=None, noise_param=None):
        kl = kl_divergence(vp, cfg.prior_mu, cfg.prior_sigma, cfg.kl_direction)
        pred, head = split_prediction(apply_fn(vp, batch, eps, True, cfg.num_ens, generator))
        noise = head if cfg.elbo.noise_type == 1 else noise_param
        return elbo_loss(cfg.elbo, pred, batch["y"], kl, beta, train_size, noise).mean()

    return loss_fn


def make_train_step(apply_fn: Callable, cfg: VIConfig, train_size):
    """``step(state, batch, eps=None, beta=1.0, generator=None) -> (state,
    loss)``: one Adam step on the loss at the ensemble normals ``eps`` (or
    drawn from ``generator``), at ``lr_start * plateau.scale``."""
    loss_fn = make_loss_fn(apply_fn, cfg, train_size)

    def step(state: VITrainState, batch, eps=None, beta=1.0, generator=None):
        params = _trained(state, cfg)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = loss_fn({k: leaves[k] for k in ("mu", "rho")}, batch, eps, beta, generator,
                           leaves.get("noise", state.noise_param))
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        new, opt = adam_update(params, grads, state.opt_state, cfg.lr_start,
                               state.plateau.scale)
        new_vp = {k: new[k] for k in ("mu", "rho")}
        return dataclasses.replace(state, vp=new_vp, noise_param=new.get("noise",
                                                                          state.noise_param),
                                   opt_state=opt), loss.detach()

    return step


def _mean_mse(apply_fn, vp, batch) -> torch.Tensor:
    pred, _ = split_prediction(apply_fn(vp, batch, None, False))
    return torch.mean((pred.reshape(batch["y"].shape) - batch["y"]) ** 2)


def make_eval_fn(apply_fn: Callable, cfg: VIConfig, train_size):
    """``evaluate(state, batch, eps=None, beta=1.0, generator=None) -> (loss,
    mse)``: the stochastic loss and the mean-weight MSE on one batch."""
    loss_fn = make_loss_fn(apply_fn, cfg, train_size)

    def evaluate(state: VITrainState, batch, eps=None, beta=1.0, generator=None):
        with torch.no_grad():
            return (loss_fn(state.vp, batch, eps, beta, generator, state.noise_param),
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
    ``(final state, best state, metrics (epochs run, 4, or 5 under
    learn_noise))``.

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
        if cfg.elbo.learn_noise:
            row.append(float(torch.exp(state.noise_param)))
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
    return state, best_state, np.asarray(rows, dtype=np.float64).reshape(
        len(rows), 5 if cfg.elbo.learn_noise else 4)
