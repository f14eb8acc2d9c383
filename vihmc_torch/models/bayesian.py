"""Bayes-by-Backprop (mean-field Gaussian) models in weight space.

Counterpart of ``vihmc_tpu/models/bayesian.py`` in its ``'bbb'`` mode
(:48-118, :201-260). The variational parameters are two flat ``(D,)``
vectors, ``mu`` and ``rho``, in the model's ``ravel_pytree`` layout (the
DeepONet's merge bias is coordinate 0 and is drawn with the rest), with
``sigma = softplus(rho) = log1p(exp(rho))``. ``F.softplus`` returns ``rho``
itself above 20, where ``log1p(exp(rho))`` equals ``rho`` in float32 anyway;
the VI runs start at ``rho ~ -5``.

A forward draws ``E`` weight vectors ``w = mu + sigma eps`` (``(E, D)``) and
runs them through the chain-batched flat forward with ``C = E``: the JAX
trainer's ``vmap`` over ``num_ens`` keys is one batched forward here. JAX
draws one normal per coordinate (one ``normal`` per leaf), so the law is the
same; the normals ``eps`` come from a ``torch.Generator`` or are injected.

Not ported yet (they raise ``NotImplementedError``): the local
reparameterization mode ``'lrt'``, the conv2d layers and the
heteroscedastic head.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vihmc_torch.models.deeponet import DeepONetConfig, deeponet_apply, unravel_deeponet
from vihmc_torch.models.mlp import MLPConfig, mlp_apply

MODES = ("bbb",)


def check_mode(mode: str):
    if mode == "lrt":
        raise NotImplementedError("the local-reparameterization mode 'lrt' is not ported")
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


def _weights(vp: dict, eps: Optional[torch.Tensor], sample: bool) -> torch.Tensor:
    if not sample:
        return vp["mu"][None]
    if eps is None:
        raise ValueError("a sampled forward needs eps (E, D)")
    return sample_params(vp, eps.reshape(-1, vp["mu"].shape[-1]))


def bayesian_mlp_apply(cfg: MLPConfig, vp: dict, x: torch.Tensor,
                       eps: Optional[torch.Tensor] = None, sample: bool = True,
                       mode: str = "bbb") -> torch.Tensor:
    """``(E, N, out)`` outputs at the draws ``mu + sigma eps`` (``eps`` (E, D)),
    or ``(1, N, out)`` at the mean weights when ``sample`` is False."""
    check_mode(mode)
    return mlp_apply(cfg, _weights(vp, eps, sample), x)


def bayesian_deeponet_apply(cfg: DeepONetConfig, vp: dict, branch_x: torch.Tensor,
                            trunk_x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                            sample: bool = True, mode: str = "bbb") -> torch.Tensor:
    """``(E, B, P)`` DeepONet outputs at the draws (the merge bias drawn as
    coordinate 0), or ``(1, B, P)`` at the mean weights; ``trunk_x`` is a
    shared grid ``(P, 2)`` or per-example points ``(B, p, 2)``."""
    check_mode(mode)
    if cfg.noise_neurons:
        raise NotImplementedError("the heteroscedastic head is not ported")
    w = _weights(vp, eps, sample)
    return deeponet_apply(cfg, unravel_deeponet(cfg, w), branch_x, trunk_x)


class BayesianFlat(nn.Module):
    """A model's mean-field Gaussian posterior over its flat weight vector.

    ``vi_apply(vp, batch, eps, sample) -> (E, ...)`` is the model's Bayesian
    forward on a batch dict (``pipelines.common.mlp_vi_apply`` or
    ``deeponet_vi_apply``); ``mu`` and ``rho`` are ``(D,)``
    :class:`~torch.nn.Parameter` s. The forward draws ``num_samples`` weight
    vectors from ``generator`` unless the normals ``eps`` (E, D) are given.
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

    def draw_eps(self, num_samples: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(E, D)`` standard normals for one ensemble forward."""
        return torch.randn((num_samples, self.num_params), generator=generator,
                           device=self.mu.device)

    def kl(self, prior_mu=0.0, prior_sigma=1.0, direction="reference") -> torch.Tensor:
        return kl_divergence(self.vp(), prior_mu, prior_sigma, direction)

    def forward(self, batch, eps: Optional[torch.Tensor] = None, sample: bool = True,
                num_samples: int = 1, generator: Optional[torch.Generator] = None):
        if sample and eps is None:
            eps = self.draw_eps(num_samples, generator)
        return self.vi_apply(self.vp(), batch, eps, sample)
