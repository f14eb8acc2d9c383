"""Synthetic 1-D regression data: y = 4 sin(4x) + 5 cos(12x) + noise.

Counterpart of ``vihmc_tpu/data/synthetic.py`` (``regression_data``):
validation on a uniform grid over [-1.2, 1.2], training on the two segments
[-1, -0.2] and [0.2, 1] (a gap around 0), Gaussian noise of std
``noise_std`` on the training targets. The grids follow ``jnp.linspace``'s
float32 formula ``start (1 - i/n) + stop i/n``; the JAX package's compiled
CPU version may differ from it in the last bit. The noise comes from a
``torch.Generator``, or is injected (``noise``, the standard normals).
"""

from __future__ import annotations

from typing import Optional

import torch

from vihmc_torch.core.device import resolve_device


def _f(x):
    return 4.0 * torch.sin(4.0 * x) + 5.0 * torch.cos(12.0 * x)


def linspace_f32(start: float, stop: float, num: int, device="cpu") -> torch.Tensor:
    """``num`` points from ``start`` to ``stop`` (both included), in float32."""
    a = torch.tensor(start, dtype=torch.float32, device=device)
    b = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return a[None]
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    return torch.cat([a * (1 - step) + b * step, b[None]])


def regression_data(n_train: int = 20, n_val: int = 300, noise_std: float = 0.05,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None, device="cuda") -> dict:
    """``x_train`` (N, 1), ``y_train`` (N, 1), ``x_val`` (M, 1), ``y_val`` (M, 1).

    ``noise``: the (N, 1) standard normals of the training targets (a test
    injects JAX's); otherwise drawn from ``generator``.
    """
    dev = resolve_device(device)
    x_val = linspace_f32(-1.2, 1.2, n_val, dev).reshape(-1, 1)
    x_train = torch.cat([linspace_f32(-1.0, -0.2, n_train // 2, dev),
                         linspace_f32(0.2, 1.0, n_train // 2, dev)]).reshape(-1, 1)
    if noise is None:
        noise = torch.randn(x_train.shape, generator=generator, device=dev)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=dev).reshape(x_train.shape)
    return {"x_train": x_train, "y_train": _f(x_train) + noise_std * noise,
            "x_val": x_val, "y_val": _f(x_val)}


def load_reference_regression_data(data_dir: str, device="cuda") -> dict:
    """The reference's saved tensors (``torch.save`` files ``x_train``,
    ``y_train``, ``x_val``, ``y_val`` in ``data_dir``: 20 training and 300
    validation points) as :func:`regression_data`'s dict of float32 tensors
    on ``device``."""
    import os

    return {name: torch.load(os.path.join(data_dir, name), map_location="cpu")
            .detach().to(device=resolve_device(device), dtype=torch.float32)
            for name in ("x_train", "y_train", "x_val", "y_val")}
