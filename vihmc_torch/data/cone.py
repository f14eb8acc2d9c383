"""The Cone dataset: the reference's second operator workload, on the
per-example query path.

Counterpart of ``vihmc_tpu/data/cone.py`` (:41-172). The reference never
shipped its Cone data; what it does define, and what is kept here:

* batches of a branch input ``Xf`` (a sensed profile), a *per-example*
  2-feature query ``Xp`` and a scalar target ``Y``;
* min-max normalization with the recorded dataset statistics
  (:class:`ConeStats`). The reference's convention is ``(x - max) / (max -
  min)``, which maps the recorded box to [-1, 0], not [0, 1]. It is kept as
  it is, so that normalized data and trained models mean the same thing in
  both packages;
* no query subsampling: each example has its one query point.

:func:`generate_cone_dataset` is the synthetic stand-in (smooth profiles, a
query uniform over the recorded physical box, a smooth functional of both in
the recorded output range), drawn from a ``torch.Generator`` or from injected
draws (a test gives JAX's). :func:`load_cone` reads a user's ``.mat`` or
``.npz``; :func:`cone_to_operator_splits` gives the operator pipelines'
layout, where ``trunk_in`` is ``(N, 1, 2)``: the DeepONet's per-example
merge.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from vihmc_torch.core.device import resolve_device, to_f32
from vihmc_torch.data.synthetic import linspace_f32


@dataclasses.dataclass(frozen=True)
class ConeStats:
    """Min/max normalization statistics: the reference's recorded Cone
    dataset statistics."""

    xp_min: tuple = (0.241, 50.0)
    xp_max: tuple = (3.16e-01, 5.00e+02)
    xf_min: tuple = (-3.38642632,)
    xf_max: tuple = (3.09895004,)
    y_min: tuple = (-0.66139158,)
    y_max: tuple = (2.27885358,)


CONE_STATS = ConeStats()


def _norm(x, lo, hi):
    """``(x - max) / (max - min)`` in float32, for arrays or tensors."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    if isinstance(x, torch.Tensor):
        lo = torch.as_tensor(lo, device=x.device)
        hi = torch.as_tensor(hi, device=x.device)
    return (x - hi) / (hi - lo)


def normalize_cone(feat: dict, stats: ConeStats = CONE_STATS) -> dict:
    """Normalize a ``{'Xf', 'Xp', 'Y'}`` dict (the reference's ``normalize_data``)."""
    out = dict(feat)
    out["Xf"] = _norm(feat["Xf"], stats.xf_min, stats.xf_max)
    out["Xp"] = _norm(feat["Xp"], stats.xp_min, stats.xp_max)
    out["Y"] = _norm(feat["Y"], stats.y_min, stats.y_max)
    return out


def normalize_cone_inputs(Xf, Xp, stats: ConeStats = CONE_STATS):
    """The inputs only (the reference's ``data_normalize``)."""
    return (_norm(Xf, stats.xf_min, stats.xf_max),
            _norm(Xp, stats.xp_min, stats.xp_max))


def generate_cone_dataset(generator: Optional[torch.Generator], n: int, in_branch: int = 101,
                          draws: Optional[dict] = None, device="cpu") -> dict:
    """A synthetic dataset in physical units: ``Xf`` (n, in_branch), ``Xp``
    (n, 2), ``Y`` (n,), float32 tensors on ``device``.

    ``Xf`` sums 6 random Fourier modes over the sensor grid (amplitudes
    ``N(0, 1) / mode``, uniform phases), clipped to [-3.3, 3.0]; ``Xp`` is
    uniform over [0.241, 0.316] x [50, 500]; ``Y`` is a smooth functional of
    both plus 0.01 N(0, 1) noise. The draws come from ``generator`` (the
    amplitude normals, the phases, the box uniforms, the noise, in that
    order), or from ``draws``: ``{'amp': (n, 6) normals, 'phase': (n, 6) in
    radians, 'u': (n, 2) in [0, 1), 'noise': (n,) normals}``.
    """
    if draws is None:
        draws = {
            "amp": torch.randn((n, 6), generator=generator, device=device),
            "phase": 2 * math.pi * torch.rand((n, 6), generator=generator, device=device),
            "u": torch.rand((n, 2), generator=generator, device=device),
            "noise": torch.randn((n,), generator=generator, device=device),
        }
    amp_z, phase, u, noise = (to_f32(draws[k], device) for k in ("amp", "phase", "u", "noise"))
    grid = linspace_f32(0.0, 1.0, in_branch, device)
    modes = torch.arange(1, 7, dtype=torch.float32, device=device)
    amp = amp_z / modes
    xf = torch.sum(amp[:, :, None] * torch.sin(
        2 * math.pi * modes[None, :, None] * grid[None, None, :] + phase[:, :, None]), dim=1)
    xf = torch.clamp(xf, -3.3, 3.0)

    xp = torch.stack([0.241 + u[:, 0] * (0.316 - 0.241),
                      50.0 + u[:, 1] * (500.0 - 50.0)], dim=-1)
    xp0n = (xp[:, 0] - 0.241) / (0.316 - 0.241)
    xp1n = torch.log(xp[:, 1] / 50.0) / math.log(10.0)
    y = (0.8 + 0.9 * torch.tanh(xf.mean(-1))
         + 0.45 * xp0n * xp1n
         + 0.3 * torch.sin(2 * math.pi * xp0n)
         + 0.15 * torch.sqrt(torch.mean(xf * xf, -1)))
    return {"Xf": xf, "Xp": xp, "Y": y + 0.01 * noise}


def load_cone(path: Optional[str], n_train: int, n_valid: int):
    """A user's Cone dataset (``.mat`` or ``.npz`` with keys ``Xf``, ``Xp``,
    ``Y`` in physical units), normalized with the recorded statistics and
    split into ``(train, valid)`` numpy dicts. ``path=None`` raises the
    reference's error word for word: the original data was never shipped."""
    if path is None:
        raise NotImplementedError("Cone dataset is not available")
    if str(path).endswith(".mat"):
        import scipy.io

        raw = scipy.io.loadmat(path)
    else:
        raw = np.load(path)
    feat = {k: np.asarray(raw[k], np.float32) for k in ("Xf", "Xp", "Y")}
    n = feat["Xf"].shape[0]
    if n < n_train + n_valid:
        raise ValueError(f"Cone dataset has {n} examples; "
                         f"n_train + n_valid = {n_train + n_valid} requested")
    feat["Y"] = feat["Y"].reshape(n)
    feat = normalize_cone(feat)
    train = {k: v[:n_train] for k, v in feat.items()}
    valid = {k: v[n_train:n_train + n_valid] for k, v in feat.items()}
    return train, valid


def cone_to_operator_splits(feat: dict, device="cpu") -> dict:
    """The operator pipelines' layout of a ``{'Xf', 'Xp', 'Y'}`` dict:
    ``branch_in`` (N, F), per-example ``trunk_in`` (N, 1, 2) and ``solution``
    (N, 1), float32 tensors on ``device``."""
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return {"branch_in": f32(feat["Xf"]),
            "trunk_in": f32(feat["Xp"])[:, None, :].contiguous(),
            "solution": f32(feat["Y"])[:, None].contiguous()}


def get_cone(generator: Optional[torch.Generator], n_train: int, n_valid: int,
             path: Optional[str] = None, in_branch: int = 101, device="cuda", draws=None):
    """``(train, valid)`` in the operator layout: read from ``path`` when
    given, else generated (from ``generator`` or ``draws``, see
    :func:`generate_cone_dataset`) and normalized; rows ``[0:n_train]`` train,
    the rest validate. The splits live on ``device``, the card unless the
    caller asks for the CPU."""
    device = resolve_device(device)
    if path is not None:
        train, valid = load_cone(path, n_train, n_valid)
    else:
        feat = normalize_cone(generate_cone_dataset(generator, n_train + n_valid, in_branch,
                                                    draws=draws, device=device))
        train = {k: v[:n_train] for k, v in feat.items()}
        valid = {k: v[n_train:] for k, v in feat.items()}
    return cone_to_operator_splits(train, device), cone_to_operator_splits(valid, device)
