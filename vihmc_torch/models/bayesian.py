"""Bayes-by-Backprop (mean-field Gaussian) models in weight space and with the
local reparameterization trick.

Counterpart of ``vihmc_tpu/models/bayesian.py`` (:48-260). The variational
parameters of a model are two flat ``(D,)`` vectors, ``mu`` and ``rho``, in
the model's ``ravel_pytree`` layout (the DeepONet's merge bias is coordinate
0), with ``sigma = softplus(rho) = log1p(exp(rho))``. ``F.softplus`` returns
``rho`` itself above 20, where ``log1p(exp(rho))`` equals ``rho`` in float32
anyway; the VI runs start at ``rho ~ -5``.

Two sampling modes, as in JAX:

* ``'bbb'``: weight space. A forward draws ``E`` weight vectors ``w = mu +
  sigma eps`` (``(E, D)``) and runs them through the chain-batched flat
  forward with ``C = E`` (the JAX trainer's ``vmap`` over ``num_ens`` keys
  is one batched forward here). JAX draws one normal per coordinate, so the
  law is the same.
* ``'lrt'``: activation space. Each linear layer's output is
  ``N(x mu_W^T + mu_b, x^2 sigma_W^2^T + sigma_b^2)``, one normal per
  output activation (``eps``: a list of ``(E, ..., out)`` per layer); the
  DeepONet's merge bias stays weight-space (one normal per member).

The normals are explicit arguments or come from a ``torch.Generator``, so a
test can inject JAX's. The layer-level applies take JAX's layer dicts
``{'w': (out, in), 'b': (out,)}`` (conv: ``(O, I, kh, kw)`` and ``NCHW``
inputs -- JAX's ``_conv2d`` uses those layouts too, which are torch's). The
heteroscedastic head is not ported (``NotImplementedError``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vihmc_torch.models.deeponet import (DeepONetConfig, bc_embedding, deeponet_apply,
                                         unravel_deeponet)
from vihmc_torch.models.mlp import MLPConfig, get_activation, mlp_apply, unravel_mlp

#: ``{'mu': ..., 'rho': ...}`` (flat ``(D,)`` tensors for the models here)
VariationalParams = Dict[str, Any]
MODES = ("bbb", "lrt")
_LRT_EPS = 1e-16  # activation-variance floor (the reference's BBB_LRT layers)


def check_mode(mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown sampling mode {mode!r}")


def softplus_sigma(rho: torch.Tensor) -> torch.Tensor:
    """``sigma = log1p(exp(rho))`` (``F.softplus``: ``rho`` itself above 20)."""
    return F.softplus(rho)


def init_variational(num_params: int, generator: Optional[torch.Generator] = None,
                     posterior_mu_initial=(0.0, 0.1), posterior_rho_initial=(-3.0, 0.1),
                     device="cpu") -> dict:
    """``{'mu': (D,), 'rho': (D,)}`` normal inits (the reference's priors
    dict): ``mu ~ N(loc, scale)``, then ``rho`` likewise, from ``generator``."""
    def draw(loc, scale):
        return loc + scale * torch.randn(num_params, generator=generator, device=device)

    return {"mu": draw(*posterior_mu_initial), "rho": draw(*posterior_rho_initial)}


def sample_params(vp: dict, eps: torch.Tensor) -> torch.Tensor:
    """Weight-space draws ``mu + eps softplus(rho)``; ``eps`` (..., D)."""
    return vp["mu"] + eps * softplus_sigma(vp["rho"])


def mean_params(vp: VariationalParams):
    return vp["mu"]


def kl_gaussian(mu_q, sig_q, mu_p, sig_p) -> torch.Tensor:
    """KL(N(mu_q, sig_q) || N(mu_p, sig_p)) summed (the reference's closed form)."""
    return 0.5 * torch.sum(2 * torch.log(sig_p / sig_q) - 1 + (sig_q / sig_p) ** 2
                           + ((mu_p - mu_q) / sig_p) ** 2)


def kl_divergence(vp: dict, prior_mu=0.0, prior_sigma=1.0,
                  direction: str = "reference") -> torch.Tensor:
    """KL between the factorized posterior and the Gaussian prior.

    ``'reference'`` is KL(prior || posterior), the reference's argument
    order; ``'standard'`` is KL(posterior || prior). One sum over the flat
    vector (JAX sums per leaf, then over leaves).
    """
    mu, sigma = vp["mu"], softplus_sigma(vp["rho"])
    p_mu = torch.as_tensor(prior_mu, dtype=mu.dtype, device=mu.device)
    p_sig = torch.as_tensor(prior_sigma, dtype=mu.dtype, device=mu.device)
    if direction == "reference":
        return kl_gaussian(p_mu, p_sig, mu, sigma)
    if direction == "standard":
        return kl_gaussian(mu, sigma, p_mu, p_sig)
    raise ValueError(f"unknown KL direction {direction!r}")


def _normals(eps, shape, generator, device):
    return torch.randn(shape, generator=generator, device=device) if eps is None else eps


# ---------------------------------------------------------------------------
# Layer-level applies (JAX's layer dicts)
# ---------------------------------------------------------------------------

def bbb_linear_apply(layer_mu: dict, layer_rho: dict, x: torch.Tensor, sample: bool = True,
                     eps=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Weight-space BBB linear layer ``x @ w.T + b`` (bayesian.py:123-136);
    ``eps`` = ``(eps_w, eps_b)`` normals of the weight's and bias's shapes
    (``eps_b`` None without a bias), else drawn from ``generator``."""
    w, b = layer_mu["w"], layer_mu.get("b")
    if sample:
        ew, eb = (None, None) if eps is None else eps
        w = w + _normals(ew, w.shape, generator, w.device) * softplus_sigma(layer_rho["w"])
        if b is not None:
            b = b + _normals(eb, b.shape, generator, w.device) * softplus_sigma(layer_rho["b"])
    y = x @ w.T
    return y if b is None else y + b


def lrt_linear_apply(layer_mu: dict, layer_rho: dict, x: torch.Tensor, sample: bool = True,
                     eps=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Local-reparameterization linear layer (bayesian.py:139-151): mean
    ``x mu_W^T + mu_b`` plus ``eps sqrt(1e-16 + x^2 sigma_W^2^T + sigma_b^2)``,
    ``eps`` of the output's shape (else drawn from ``generator``)."""
    act_mu = x @ layer_mu["w"].T
    if "b" in layer_mu:
        act_mu = act_mu + layer_mu["b"]
    if not sample:
        return act_mu
    act_var = (x * x) @ (softplus_sigma(layer_rho["w"]) ** 2).T
    if "b" in layer_mu:
        act_var = act_var + softplus_sigma(layer_rho["b"]) ** 2
    return act_mu + _normals(eps, act_mu.shape, generator, act_mu.device) \
        * torch.sqrt(_LRT_EPS + act_var)


def _conv2d(x, w, stride: int, padding):
    """JAX's ``conv_general_dilated`` (NCHW, OIHW) with ``'SAME'`` (XLA's
    split: the smaller half of the padding before), ``'VALID'`` or explicit
    ``((lo, hi), (lo, hi))`` padding."""
    if padding == "VALID":
        pads = ((0, 0), (0, 0))
    elif padding == "SAME":
        pads = []
        for n, k in zip(x.shape[-2:], w.shape[-2:]):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads.append((total // 2, total - total // 2))
    else:
        pads = padding
    (h_lo, h_hi), (w_lo, w_hi) = pads
    return F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)), w, stride=stride)


def bbb_conv2d_apply(layer_mu: dict, layer_rho: dict, x: torch.Tensor, stride: int = 1,
                     padding="SAME", sample: bool = True, eps=None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Weight-space BBB conv2d (bayesian.py:163-176): ``x`` (N, C, H, W),
    ``w`` (O, I, kh, kw); ``eps`` as :func:`bbb_linear_apply`'s."""
    w, b = layer_mu["w"], layer_mu.get("b")
    if sample:
        ew, eb = (None, None) if eps is None else eps
        w = w + _normals(ew, w.shape, generator, w.device) * softplus_sigma(layer_rho["w"])
        if b is not None:
            b = b + _normals(eb, b.shape, generator, w.device) * softplus_sigma(layer_rho["b"])
    y = _conv2d(x, w, stride, padding)
    return y if b is None else y + b[None, :, None, None]


def lrt_conv2d_apply(layer_mu: dict, layer_rho: dict, x: torch.Tensor, stride: int = 1,
                     padding="SAME", sample: bool = True, eps=None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Local-reparameterization conv2d (bayesian.py:179-193): the output's
    mean and variance are convolutions of ``x`` and ``x^2``."""
    act_mu = _conv2d(x, layer_mu["w"], stride, padding)
    if "b" in layer_mu:
        act_mu = act_mu + layer_mu["b"][None, :, None, None]
    if not sample:
        return act_mu
    act_var = _conv2d(x * x, softplus_sigma(layer_rho["w"]) ** 2, stride, padding)
    if "b" in layer_mu:
        act_var = act_var + (softplus_sigma(layer_rho["b"]) ** 2)[None, :, None, None]
    return act_mu + _normals(eps, act_mu.shape, generator, act_mu.device) \
        * torch.sqrt(_LRT_EPS + act_var)


# ---------------------------------------------------------------------------
# Model-level applies on the flat variational vectors
# ---------------------------------------------------------------------------

def _weights(vp: dict, eps: Optional[torch.Tensor], sample: bool, num_samples: int,
             generator) -> torch.Tensor:
    if not sample:
        return vp["mu"][None]
    d = vp["mu"].shape[-1]
    eps = _normals(eps, (num_samples, d), generator, vp["mu"].device)
    return sample_params(vp, eps.reshape(-1, d))


def _layer_dicts(layers):
    """JAX layer dicts of the ``(w (1, out, in), b (1, out))`` views."""
    return [{"w": w[0]} if b is None else {"w": w[0], "b": b[0]} for w, b in layers]


def _lrt_stack(mu_layers, rho_layers, h, eps, activation: str, generator):
    act = get_activation(activation)
    n = len(mu_layers)
    for i, (lm, lr) in enumerate(zip(mu_layers, rho_layers)):
        h = lrt_linear_apply(lm, lr, h, True, None if eps is None else eps[i], generator)
        if i < n - 1:
            h = act(h)
    return h


def bayesian_mlp_apply(cfg: MLPConfig, vp: dict, x: torch.Tensor, eps=None,
                       sample: bool = True, mode: str = "bbb",
                       generator: Optional[torch.Generator] = None,
                       num_samples: int = 1) -> torch.Tensor:
    """``(E, N, out)`` outputs of ``E`` members, or ``(1, N, out)`` at the
    mean weights when ``sample`` is False. ``'bbb'``: ``eps`` (E, D) weight
    normals; ``'lrt'``: a list of per-layer ``(E, N, out_l)`` activation
    normals. Without ``eps``, ``num_samples`` members' normals come from
    ``generator``."""
    check_mode(mode)
    if mode == "bbb" or not sample:
        return mlp_apply(cfg, _weights(vp, eps, sample, num_samples, generator), x)
    e = num_samples if eps is None else eps[0].shape[0]
    mu_l = _layer_dicts(unravel_mlp(cfg, vp["mu"][None]))
    rho_l = _layer_dicts(unravel_mlp(cfg, vp["rho"][None]))
    return _lrt_stack(mu_l, rho_l, x.expand(e, *x.shape), eps, cfg.activation, generator)


def bayesian_deeponet_apply(cfg: DeepONetConfig, vp: dict, branch_x: torch.Tensor,
                            trunk_x: torch.Tensor, eps=None, sample: bool = True,
                            mode: str = "bbb", generator: Optional[torch.Generator] = None,
                            num_samples: int = 1) -> torch.Tensor:
    """``(E, B, P)`` DeepONet outputs of ``E`` members, or ``(1, B, P)`` at the
    mean weights; ``trunk_x`` is a shared grid ``(P, 2)`` or per-example
    points ``(B, p, 2)``. ``'bbb'``: ``eps`` (E, D) (the merge bias drawn as
    coordinate 0); ``'lrt'``: ``{'branch': [...], 'trunk': [...], 'b': (E,)}``
    (per-layer activation normals and the merge bias's weight normal)."""
    check_mode(mode)
    if cfg.noise_neurons:
        raise NotImplementedError("the heteroscedastic head is not ported")
    if mode == "bbb" or not sample:
        w = _weights(vp, eps, sample, num_samples, generator)
        return deeponet_apply(cfg, unravel_deeponet(cfg, w), branch_x, trunk_x)
    e = num_samples if eps is None else eps["b"].shape[0]
    mu_p = unravel_deeponet(cfg, vp["mu"][None])
    rho_p = unravel_deeponet(cfg, vp["rho"][None])
    get = (lambda k: None) if eps is None else eps.get
    trunk_in = bc_embedding(trunk_x) if cfg.impose_bc else trunk_x
    bout = _lrt_stack(_layer_dicts(mu_p["branch"]), _layer_dicts(rho_p["branch"]),
                      branch_x.expand(e, *branch_x.shape), get("branch"), cfg.activation,
                      generator)
    tout = _lrt_stack(_layer_dicts(mu_p["trunk"]), _layer_dicts(rho_p["trunk"]),
                      trunk_in.expand(e, *trunk_in.shape), get("trunk"), cfg.activation,
                      generator)
    eb = _normals(get("b"), (e,), generator, branch_x.device)
    b = mu_p["b"] + eb * softplus_sigma(rho_p["b"])
    if trunk_x.ndim == 2:
        y = torch.matmul(bout, tout.transpose(-1, -2))
    else:
        y = torch.einsum("ebk,ebpk->ebp", bout, tout)
    return y + b[:, None, None]


class BayesianFlat(nn.Module):
    """A model's mean-field Gaussian posterior over its flat weight vector.

    ``vi_apply(vp, batch, eps, sample, num_samples, generator) -> (E, ...)``
    is the model's Bayesian
    forward on a batch dict (``pipelines.common.mlp_vi_apply`` or
    ``deeponet_vi_apply``); ``mu`` and ``rho`` are ``(D,)``
    :class:`~torch.nn.Parameter` s. The forward draws ``num_samples``
    members' normals from ``generator`` unless ``eps`` is given (the
    apply's: (E, D) weight normals under ``'bbb'``).
    """

    def __init__(self, vi_apply: Callable, mu: torch.Tensor, rho: torch.Tensor):
        super().__init__()
        self.vi_apply = vi_apply
        self.mu = nn.Parameter(mu.detach().clone().float())
        self.rho = nn.Parameter(rho.detach().clone().float())

    @property
    def num_params(self) -> int:
        return int(self.mu.shape[0])

    def vp(self) -> dict:
        return {"mu": self.mu, "rho": self.rho}

    def kl(self, prior_mu=0.0, prior_sigma=1.0, direction="reference") -> torch.Tensor:
        return kl_divergence(self.vp(), prior_mu, prior_sigma, direction)

    def forward(self, batch, eps=None, sample: bool = True, num_samples: int = 1,
                generator: Optional[torch.Generator] = None):
        return self.vi_apply(self.vp(), batch, eps, sample, num_samples, generator)
