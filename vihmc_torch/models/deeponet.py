"""Chain-batched DeepONet (shared query grid).

Counterpart of ``vihmc_tpu/models/deeponet.py``: branch MLP over the sensed
initial condition, trunk MLP over the boundary-condition embedding of the
(t, x) query points, dot-product merge over the latent width plus one scalar
bias. Parameters are a ``(C, D)`` flat batch in the JAX package's
``ravel_pytree`` order (:mod:`vihmc_torch.core.ravel`):
``[b, branch[0].b, branch[0].w, ..., trunk[0].b, trunk[0].w, ...]``.

Only the shared-grid path (``trunk_x`` of shape ``(P, 2)``) and the
homoscedastic head (``noise_neurons = 0``) are ported: the operator row uses
nothing else.
"""

from __future__ import annotations

import dataclasses
import math

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
    if cfg.noise_neurons:
        raise NotImplementedError("the heteroscedastic head is not ported")
    sl = param_slices(cfg)
    if flat.shape[-1] != sl["size"]:
        raise ValueError(f"flat width {flat.shape[-1]} != {sl['size']} params")
    return {"b": flat[:, 0],
            "branch": unravel_stack(flat, sl["branch"]),
            "trunk": unravel_stack(flat, sl["trunk"])}


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
    """Latent features before the merge: ``(bout (C, B, K), tout (C, P, K))``.

    ``branch_x`` (B, in_branch) and ``trunk_x`` (P, 2) are shared by every
    chain; they must have the parameters' dtype.
    """
    trunk_in = bc_embedding(trunk_x) if cfg.impose_bc else trunk_x
    return (mlp_stack(params["branch"], branch_x, cfg.activation),
            mlp_stack(params["trunk"], trunk_in, cfg.activation))


def deeponet_apply(cfg: DeepONetConfig, params: dict, branch_x: torch.Tensor,
                   trunk_x: torch.Tensor) -> torch.Tensor:
    """``(C, B, P)`` predictions on a shared query grid."""
    if trunk_x.ndim != 2:
        raise NotImplementedError("only the shared-query-grid path is ported")
    bout, tout = deeponet_features(cfg, params, branch_x, trunk_x)
    return torch.matmul(bout, tout.transpose(-1, -2)) + params["b"][:, None, None]
