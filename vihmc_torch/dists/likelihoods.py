"""The likelihood switch of the reference, chain-batched.

Counterpart of ``vihmc_tpu/dists/likelihoods.py`` (:34-91). Every likelihood
maps ``(output (C, ...), target, tau_out) -> (C,)`` log-likelihoods, one per
chain:

``binary_class_linear_output``     ll = -tau_out * BCEWithLogits(sum)
``multi_class_linear_output``      ll = -tau_out * CrossEntropy(sum)  (logits)
``multi_class_log_softmax_output`` ll = -tau_out * NLL(sum)  (log-probs in)
``regression``                     ll = -0.5 * tau_out * sum(err^2)  (tau = precision)
``NLL``                            ll = -sum GaussianNLL(var=tau_out)  (tau = VARIANCE)
custom callable                    ll = -sum(loss(output, target)), per chain

``NLL`` has torch ``GaussianNLLLoss`` semantics: variance clamped at 1e-6,
no ``0.5 log 2 pi`` constant.
"""

from __future__ import annotations

import torch

GNLL_EPS = 1e-6


def gaussian_nll(pred: torch.Tensor, target: torch.Tensor, var: float) -> torch.Tensor:
    """Elementwise ``0.5 (log var + (pred - target)^2 / var)``."""
    v = max(float(var), GNLL_EPS)
    return 0.5 * (torch.log(torch.tensor(v, dtype=pred.dtype, device=pred.device))
                  + (pred - target) ** 2 / v)


def gaussian_nll_var(pred: torch.Tensor, target: torch.Tensor,
                     var: torch.Tensor) -> torch.Tensor:
    """:func:`gaussian_nll` with a variance tensor (broadcast to ``pred``),
    clamped at the same floor: the learned-noise ELBO's data term."""
    v = torch.clamp(var, min=GNLL_EPS)
    return 0.5 * (torch.log(v) + (pred - target) ** 2 / v)


def nll_log_likelihood(pred: torch.Tensor, target: torch.Tensor,
                       tau: float) -> torch.Tensor:
    """``-sum gaussian_nll`` over every axis but the leading chain axis: (C,)."""
    return -gaussian_nll(pred, target, tau).flatten(1).sum(-1)


def _ll_binary(output, target, tau_out):
    # stable BCE with logits: max(x, 0) - x y + log1p(exp(-|x|))
    bce = torch.clamp(output, min=0.0) - output * target + torch.log1p(torch.exp(-output.abs()))
    return -tau_out * bce.flatten(1).sum(-1)


def _picked(logp, target):
    c, k = logp.shape[0], logp.shape[-1]
    idx = target.to(torch.int64).reshape(1, -1, 1).expand(c, -1, 1)
    return torch.gather(logp.reshape(c, -1, k), -1, idx).flatten(1).sum(-1)


def _ll_multiclass(output, target, tau_out):
    return tau_out * _picked(torch.log_softmax(output, dim=-1), target)


def _ll_log_softmax(output, target, tau_out):
    return tau_out * _picked(output, target)


def _ll_regression(output, target, tau_out):
    return -0.5 * tau_out * ((output - target) ** 2).flatten(1).sum(-1)


LIKELIHOODS = {
    "binary_class_linear_output": _ll_binary,
    "multi_class_linear_output": _ll_multiclass,
    "multi_class_log_softmax_output": _ll_log_softmax,
    "regression": _ll_regression,
    "NLL": nll_log_likelihood,
}


def get_likelihood(model_loss):
    """A likelihood by the reference's name, or a custom elementwise loss
    callable ``loss(output, target)`` wrapped as ``-sum loss`` per chain."""
    if callable(model_loss):
        def _custom(output, target, tau_out):
            del tau_out
            return torch.stack([-model_loss(o, target).sum() for o in output])

        return _custom
    try:
        return LIKELIHOODS[model_loss]
    except KeyError:
        raise NotImplementedError(f"model_loss {model_loss!r} not implemented") from None
