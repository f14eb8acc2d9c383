"""Chain-batched linear layers and activations.

Counterpart of ``vihmc_tpu/models/mlp.py`` (``get_activation``,
``linear_apply``). A layer is a ``(w (C, out, in), b (C, out))`` pair of
views into the flat ``(C, D)`` parameter batch (:mod:`vihmc_torch.core.ravel`).
"""

from __future__ import annotations

from typing import Callable

import torch


def get_activation(name: str) -> Callable:
    if name == "relu":
        return torch.relu
    if name == "tanh":
        return torch.tanh
    if name == "sine":
        return torch.sin
    raise ValueError("Activation should be relu, sine or tanh")


def linear_apply(layer, x: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` per chain.

    ``x`` is ``(C, N, in)`` or, for an input shared by every chain (the data),
    ``(N, in)``; the result is ``(C, N, out)``.
    """
    w, b = layer
    return torch.matmul(x, w.transpose(-1, -2)) + b.unsqueeze(-2)


def mlp_stack(layers, x: torch.Tensor, activation: str = "tanh") -> torch.Tensor:
    """Activation after every layer except the last (``_mlp_stack`` in JAX)."""
    act = get_activation(activation)
    h = x
    for layer in layers[:-1]:
        h = act(linear_apply(layer, h))
    return linear_apply(layers[-1], h)
