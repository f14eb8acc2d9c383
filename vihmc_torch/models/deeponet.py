"""Chain-batched DeepONet (shared query grid).

Counterpart of ``vihmc_tpu/models/deeponet.py``: branch MLP over the sensed
initial condition, trunk MLP over the boundary-condition embedding of the
(t, x) query points, dot-product merge over the latent width plus one scalar
bias. Parameters are a ``(C, D)`` flat batch in the JAX package's
``ravel_pytree`` order (:mod:`vihmc_torch.core.ravel`):
``[b, branch[0].b, branch[0].w, ..., trunk[0].b, trunk[0].w, ...]``.

Both query paths are ported: a grid shared by every example (``trunk_x``
of shape ``(P, 2)``, one matmul per chain) and per-example points
(``(B, p, 2)``, the VI trainer's and the sensitivity stage's subsampled
trunks, merged as ``einsum("bk,bpk->bp")`` per chain). With
``noise_neurons = n > 0`` the last ``n`` latent channels are the
heteroscedastic head: the forward returns ``(y, noise)``, ``y`` merged over
the first ``K - n`` channels plus the bias, ``noise`` (a per-point
log-variance) over the last ``n`` with no bias. The head only splits K, so
the flat layout is the same.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from vihmc_torch.core.ravel import stack_slices, unravel_stack
from vihmc_torch.models.mlp import mlp_stack


@dataclasses.dataclass(frozen=True)
class DeepONetConfig:
    in_branch: int = 101
    in_trunk: int = 5          # effective trunk input dim (5 with BC embedding of (x,t))
    width_branch: int = 100
    width_trunk: int = 100
    depth_branch: int = 9      # number of Linear layers in the branch
    depth_trunk: int = 9
    output_neurons: int | None = None  # latent merge width K; default width_branch
    activation: str = "tanh"
    impose_bc: bool = True
    noise_neurons: int = 0

    @property
    def latent(self) -> int:
        return self.width_branch if self.output_neurons is None else self.output_neurons

    @property
    def branch_dims(self):
        dims = [(self.in_branch, self.width_branch)]
        dims += [(self.width_branch, self.width_branch)] * (self.depth_branch - 2)
        dims += [(self.width_branch, self.latent)]
        return dims

    @property
    def trunk_dims(self):
        dims = [(self.in_trunk, self.width_trunk)]
        dims += [(self.width_trunk, self.width_trunk)] * (self.depth_trunk - 2)
        dims += [(self.width_trunk, self.latent)]
        return dims

    @property
    def num_params(self) -> int:
        return param_slices(self)["size"]


def param_slices(cfg: DeepONetConfig) -> dict:
    """Flat offsets: the merge bias at 0, then the branch, then the trunk."""
    branch, end = stack_slices(cfg.branch_dims, 1)
    trunk, end = stack_slices(cfg.trunk_dims, end)
    return {"branch": branch, "trunk": trunk, "size": end}


def unravel_deeponet(cfg: DeepONetConfig, flat: torch.Tensor) -> dict:
    """``{'b': (C,), 'branch': [(w, b), ...], 'trunk': [...]}`` views of ``flat`` (C, D)."""
    sl = param_slices(cfg)
    if flat.shape[-1] != sl["size"]:
        raise ValueError(f"flat width {flat.shape[-1]} != {sl['size']} params")
    return {"b": flat[:, 0],
            "branch": unravel_stack(flat, sl["branch"]),
            "trunk": unravel_stack(flat, sl["trunk"])}


def init_deeponet(cfg: DeepONetConfig, generator: Optional[torch.Generator] = None,
                  device="cpu") -> torch.Tensor:
    """A flat ``(D,)`` vector: the merge bias 0 (the reference's init), each
    linear layer ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` as torch.nn.Linear.
    JAX draws the same law from its key; the values differ."""
    sl = param_slices(cfg)
    flat = torch.zeros(sl["size"], device=device)
    for s in sl["branch"] + sl["trunk"]:
        flat[s.b:s.end].uniform_(-1.0 / math.sqrt(s.d_in), 1.0 / math.sqrt(s.d_in),
                                 generator=generator)
    return flat


def bc_embedding(xy: torch.Tensor) -> torch.Tensor:
    """``[t, sin 2 pi x, sin 4 pi x, cos 2 pi x, cos 4 pi x]`` of (..., 2) points."""
    keep = xy[..., 0:1]
    x = xy[..., 1]
    two_pi = 2 * math.pi
    feats = torch.stack([torch.sin(two_pi * x), torch.sin(2 * two_pi * x),
                         torch.cos(two_pi * x), torch.cos(2 * two_pi * x)],
                        dim=-1)
    return torch.cat([keep, feats], dim=-1)


def deeponet_features(cfg: DeepONetConfig, params: dict, branch_x: torch.Tensor,
                      trunk_x: torch.Tensor):
    """Latent features before the merge: ``(bout (C, B, K), tout (C, P, K))``,
    or ``tout (C, B, p, K)`` for per-example points ``trunk_x`` (B, p, 2).

    ``branch_x`` (B, in_branch) and ``trunk_x`` are shared by every chain;
    they must have the parameters' dtype.
    """
    trunk_in = bc_embedding(trunk_x) if cfg.impose_bc else trunk_x
    bout = mlp_stack(params["branch"], branch_x, cfg.activation)
    if trunk_x.ndim == 2:
        return bout, mlp_stack(params["trunk"], trunk_in, cfg.activation)
    # per-example points: one (B p, in) stack, shared by the chains
    tout = mlp_stack(params["trunk"], trunk_in.reshape(-1, trunk_in.shape[-1]),
                     cfg.activation)
    return bout, tout.reshape(tout.shape[0], *trunk_x.shape[:-1], tout.shape[-1])


def merge(cfg: DeepONetConfig, bout: torch.Tensor, tout: torch.Tensor, bias: torch.Tensor):
    """The dot-product merge of the features of :func:`deeponet_features`
    (``bout`` (E, B, K), ``tout`` (E, P, K) or (E, B, p, K)) plus ``bias``
    (E,): ``y``, or ``(y, noise)`` with the heteroscedastic head."""
    n = cfg.noise_neurons
    k_main = bout.shape[-1] - n

    def dot(lo, hi):
        if tout.ndim == 3:
            return torch.matmul(bout[..., lo:hi], tout[..., lo:hi].transpose(-1, -2))
        return torch.einsum("cbk,cbpk->cbp", bout[..., lo:hi], tout[..., lo:hi])

    y = dot(0, k_main) + bias[:, None, None]
    return (y, dot(k_main, None)) if n else y


def deeponet_apply(cfg: DeepONetConfig, params: dict, branch_x: torch.Tensor,
                   trunk_x: torch.Tensor):
    """``(C, B, P)`` predictions on a shared query grid ``(P, 2)``, or
    ``(C, B, p)`` on per-example points ``(B, p, 2)``; with the
    heteroscedastic head ``(y, noise)`` of those shapes."""
    bout, tout = deeponet_features(cfg, params, branch_x, trunk_x)
    return merge(cfg, bout, tout, params["b"])
