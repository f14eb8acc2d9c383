"""The FNO2d's flat layout and the seeded posterior of ``fno2d-burgers``, made
by the benchmark.

The layout is ``fourier_2d.FNO2d.parameters()``'s order, each complex weight
as its ``torch.view_as_real`` (real, imaginary) pairs: ``fc0`` (weight,
bias), each layer's ``weights1`` and ``weights2`` (width, width, modes1,
modes2, 2), each layer's 1x1 convolution (weight (width, width, 1, 1), bias),
``fc1``, ``fc2``. The posterior is drawn from one CPU generator seeded with
the config's ``init_seed``, in this order: ``mu`` by ``fourier_2d.py``'s
initialisation laws (one ``torch.rand`` per tensor: a linear or 1x1
convolution's weight and bias ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, each
spectral weight ``U(0, 1) / width^2`` in both parts), ``rho ~ N(loc,
scale)`` of ``rho_initial``, then the frozen draw's standard normals ``eps``;
``sigma = softplus(rho)``.
"""

from __future__ import annotations

import math

import torch


def layout(model: dict) -> list:
    """``[(name, start, stop, shape)]`` of the flat vector."""
    w, m1, m2, f = model["width"], model["modes1"], model["modes2"], model["fc_dim"]
    shapes = [("fc0.weight", (w, model["in_channels"])), ("fc0.bias", (w,))]
    for lay in range(model["n_layers"]):
        shapes += [(f"conv{lay}.weights1", (w, w, m1, m2, 2)),
                   (f"conv{lay}.weights2", (w, w, m1, m2, 2))]
    for lay in range(model["n_layers"]):
        shapes += [(f"w{lay}.weight", (w, w, 1, 1)), (f"w{lay}.bias", (w,))]
    shapes += [("fc1.weight", (f, w)), ("fc1.bias", (f,)), ("fc2.weight", (1, f)),
               ("fc2.bias", (1,))]
    out, pos = [], 0
    for name, shape in shapes:
        out.append((name, pos, pos + math.prod(shape), shape))
        pos += math.prod(shape)
    if pos != model["num_params"]:
        raise ValueError(f"layout gives {pos} parameters, the config {model['num_params']}")
    return out


def posterior(model: dict, post: dict, device) -> dict:
    """``mu``, ``sigma`` and ``eps`` (D,) float32 on ``device`` (module doc)."""
    gen = torch.Generator()
    gen.manual_seed(int(post["init_seed"]))
    w = model["width"]
    fan_in = {"fc0": model["in_channels"], "fc2": model["fc_dim"]}
    parts = []
    for name, a, b, _ in layout(model):
        u = torch.rand(b - a, generator=gen)
        layer = name.split(".")[0]
        if layer.startswith("conv"):
            parts.append(u / (w * w))
        else:
            parts.append((2.0 * u - 1.0) / math.sqrt(fan_in.get(layer, w)))
    mu = torch.cat(parts)
    loc, scale = post["rho_initial"]
    rho = loc + scale * torch.randn(mu.shape[0], generator=gen)
    eps = torch.randn(mu.shape[0], generator=gen)
    sigma = torch.nn.functional.softplus(rho)
    return {k: v.to(device) for k, v in (("mu", mu), ("sigma", sigma), ("eps", eps))}
