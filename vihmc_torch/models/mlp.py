"""Chain-batched MLP: linear layers, activations, init and the flat layout.

Counterpart of ``vihmc_tpu/models/mlp.py`` (``get_activation``,
``MLPConfig``, ``init_mlp``, ``linear_apply``, ``mlp_apply``). A layer is a
``(w (C, out, in), b (C, out) or None)`` pair of views into the flat
``(C, D)`` parameter batch (:mod:`vihmc_torch.core.ravel`); the MLP's flat
vector is its layers in order, each bias before its weight, as
``ravel_pytree`` lays out the JAX list of ``{'w', 'b'}`` dicts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from vihmc_torch.core.ravel import stack_slices, unravel_stack


def get_activation(name: str) -> Callable:
    if name == "relu":
        return torch.relu
    if name == "tanh":
        return torch.tanh
    if name == "sine":
        return torch.sin
    raise ValueError("Activation should be relu, sine or tanh")


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """The regression MLP (default 1 -> 10 -> 10 -> 1 tanh, 141 parameters)."""

    in_dim: int = 1
    widths: tuple = (10, 10)
    out_dim: int = 1
    activation: str = "tanh"
    last_bias: bool = True  # the reference's `bias` flag for the output layer

    @property
    def layer_dims(self) -> tuple:
        dims = (self.in_dim,) + tuple(self.widths) + (self.out_dim,)
        return tuple(zip(dims[:-1], dims[1:]))

    @property
    def num_params(self) -> int:
        return mlp_slices(self)[1]


def mlp_slices(cfg: MLPConfig):
    """``(slices, size)`` of the MLP's flat vector (no bias on the last layer
    unless ``last_bias``)."""
    n = len(cfg.layer_dims)
    return stack_slices(cfg.layer_dims, 0,
                        biases=[cfg.last_bias or i < n - 1 for i in range(n)])


def unravel_mlp(cfg: MLPConfig, flat: torch.Tensor):
    """Per-layer ``(w, b)`` views of a ``(C, D)`` flat batch."""
    slices, size = mlp_slices(cfg)
    if flat.shape[-1] != size:
        raise ValueError(f"flat width {flat.shape[-1]} != {size} params")
    return unravel_stack(flat, slices)


def init_mlp(cfg: MLPConfig, generator: Optional[torch.Generator] = None,
             device="cpu") -> torch.Tensor:
    """A flat ``(D,)`` parameter vector with torch.nn.Linear's default init:
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` for each weight and bias. JAX
    draws the same law from its key; the values differ."""
    slices, size = mlp_slices(cfg)
    flat = torch.empty(size, device=device)
    for s in slices:
        bound = 1.0 / math.sqrt(s.d_in)
        seg = flat[s.b:s.end]
        seg.uniform_(-bound, bound, generator=generator)
    return flat


def linear_apply(layer, x: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` per chain.

    ``x`` is ``(C, N, in)`` or, for an input shared by every chain (the data),
    ``(N, in)``; the result is ``(C, N, out)``.
    """
    w, b = layer
    y = torch.matmul(x, w.transpose(-1, -2))
    return y if b is None else y + b.unsqueeze(-2)


def mlp_stack(layers, x: torch.Tensor, activation: str = "tanh") -> torch.Tensor:
    """Activation after every layer except the last (``_mlp_stack`` in JAX)."""
    act = get_activation(activation)
    h = x
    for layer in layers[:-1]:
        h = act(linear_apply(layer, h))
    return linear_apply(layers[-1], h)


def mlp_apply(cfg: MLPConfig, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(C, N, out)`` outputs of the ``(C, D)`` flat batch on ``x`` (N, in)."""
    return mlp_stack(unravel_mlp(cfg, flat), x, cfg.activation)
