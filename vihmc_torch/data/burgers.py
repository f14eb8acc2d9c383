"""Burgers operator-learning data, solved on the device with ``torch.fft``.

Counterpart of ``vihmc_tpu/data/burgers.py``: the integrating-factor RK4
pseudo-spectral solver of periodic viscous Burgers (``solve_burgers``), the
dataset assembly, ``generate_burgers_dataset`` (the periodic GRF initial
conditions, 12 modes with decay 2, drawn from a ``torch.Generator`` or
given as coefficients) and ``load_burgers_mat``, the reference's
``DeepOnet_data.mat`` loader.

The pipelines' data are not drawn here: the JAX package draws its GRF from
``jax.random``, which PyTorch cannot replay, so ``scripts/export_port_inputs.py``
exported JAX's initial conditions once to ``assets/burgers_r2_port_inputs.npz``
(``u0``), next to the frozen VI draw of the operator row and the first rows
of the JAX solution, and :func:`get_burgers` solves those (or reads a
``.mat`` when given one), where JAX's generates a new GRF from its key.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from vihmc_torch.core.device import resolve_device

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")
STAGE12_ASSET = os.path.join(ASSETS, "burgers_stage12_r2.npz")
PORT_INPUTS = os.path.join(ASSETS, "burgers_r2_port_inputs.npz")


def solve_burgers(u0: torch.Tensor, nu: float = 0.05, t_final: float = 1.0,
                  nt_save: int = 101, steps_per_save: int = 20) -> torch.Tensor:
    """Integrate periodic viscous Burgers from ``u0`` (..., nx); returns
    (..., nt_save, nx) snapshots at uniform times including t = 0.

    Pseudo-spectral in x with 2/3 dealiasing, integrating-factor RK4 in time
    (the diffusion term is integrated exactly). The JAX ``lax.scan`` over
    steps becomes a Python loop; every step runs on ``u0``'s device.
    """
    nx = u0.shape[-1]
    dev = u0.device
    k = (2 * math.pi * torch.fft.rfftfreq(nx, d=1.0 / nx)).to(dev, u0.dtype)
    mask = (torch.arange(k.shape[0], device=dev) < (nx // 3 + 1)).to(u0.dtype)
    dt = t_final / ((nt_save - 1) * steps_per_save)
    e_half = torch.exp(-nu * k * k * dt / 2.0)
    e_full = e_half * e_half
    ik = -1j * k

    def nonlinear(u_hat):
        u = torch.fft.irfft(u_hat * mask, n=nx, dim=-1)
        return ik * torch.fft.rfft(0.5 * u * u, dim=-1) * mask

    u_hat = torch.fft.rfft(u0, dim=-1)
    frames = [u0]
    for _ in range(nt_save - 1):
        for _ in range(steps_per_save):
            k1 = nonlinear(u_hat)
            k2 = nonlinear(e_half * (u_hat + 0.5 * dt * k1))
            k3 = nonlinear(e_half * u_hat + 0.5 * dt * k2)
            k4 = nonlinear(e_full * u_hat + dt * e_half * k3)
            u_hat = e_full * u_hat + dt / 6.0 * (e_full * k1 + 2 * e_half * (k2 + k3) + k4)
        frames.append(torch.fft.irfft(u_hat, n=nx, dim=-1))
    return torch.stack(frames, dim=-2)


def trunk_grid(nx: int = 101, nt: int = 101, device="cpu") -> torch.Tensor:
    """(nt*nx, 2) query points with columns (t, x), t-major."""
    t = torch.linspace(0.0, 1.0, nt, device=device)
    x = torch.linspace(0.0, 1.0, nx, device=device)
    tt, xx = torch.meshgrid(t, x, indexing="ij")
    return torch.stack([tt.reshape(-1), xx.reshape(-1)], dim=-1)


def burgers_dataset(u0: torch.Tensor, nx: int = 101, nt: int = 101,
                    nu: float = 0.05) -> dict:
    """Reference-shaped dataset from periodic-interior initial conditions
    ``u0`` (N, nx - 1): branch_in (N, nx), trunk_in (nt*nx, 2), solution
    (N, nt*nx)."""
    if u0.shape[-1] != nx - 1:
        raise ValueError(f"u0 has {u0.shape[-1]} points, expected nx - 1 = {nx - 1}")
    sol = solve_burgers(u0, nu=nu, nt_save=nt)                     # (N, nt, nx-1)
    sol_full = torch.cat([sol, sol[..., :1]], dim=-1)              # wrap point
    return {"branch_in": sol_full[:, 0, :].contiguous(),
            "trunk_in": trunk_grid(nx, nt, device=u0.device),
            "solution": sol_full.reshape(u0.shape[0], nt * nx)}


def grf_initial_conditions(a: torch.Tensor, b: torch.Tensor, n_grid: int,
                           decay: float = 2.0, amplitude: float = 1.0) -> torch.Tensor:
    """Periodic GRF samples ``sum_k s_k (a_k sin 2 pi k x + b_k cos 2 pi k x)``
    on ``n_grid`` points of [0, 1) from standard normal coefficients ``a``,
    ``b`` (N, modes), ``s_k = amplitude / k^decay`` (JAX's
    ``_grf_initial_conditions``, burgers.py:36-47)."""
    dev = a.device
    x = torch.arange(n_grid, device=dev, dtype=torch.float32) / n_grid
    k = torch.arange(1, a.shape[-1] + 1, device=dev, dtype=torch.float32)
    scale = amplitude / k ** decay
    phases = 2 * math.pi * k[None, :, None] * x[None, None, :]
    return torch.sum((a * scale)[..., None] * torch.sin(phases)
                     + (b * scale)[..., None] * torch.cos(phases), dim=1)


def generate_burgers_dataset(generator: Optional[torch.Generator], n_functions: int,
                             nx: int = 101, nt: int = 101, nu: float = 0.05,
                             n_modes: int = 12, coefficients=None, device="cpu") -> dict:
    """A reference-shaped dataset from new GRF initial conditions: branch_in
    (N, nx), trunk_in (nt*nx, 2) with columns (t, x), solution (N, nt*nx)
    (burgers.py:88-111). The coefficients ``(a, b)`` (N, n_modes) each are
    standard normals from ``generator`` (``a`` first), or ``coefficients``
    (JAX's, for a test)."""
    if coefficients is None:
        a = torch.randn((n_functions, n_modes), generator=generator, device=device)
        b = torch.randn((n_functions, n_modes), generator=generator, device=device)
    else:
        a, b = (torch.as_tensor(np.array(c), dtype=torch.float32, device=device)
                for c in coefficients)
    return burgers_dataset(grf_initial_conditions(a, b, nx - 1), nx=nx, nt=nt, nu=nu)


def load_burgers_mat(path: str, device="cpu") -> dict:
    """The reference's ``DeepOnet_data.mat`` (keys ``branch_in``,
    ``trunk_in``, ``solution``) as float32 tensors on ``device``."""
    import scipy.io

    mat = scipy.io.loadmat(path)
    return {k: torch.as_tensor(np.asarray(mat[k], dtype=np.float32), device=device)
            for k in ("branch_in", "trunk_in", "solution")}


def load_port_inputs(path: str = PORT_INPUTS) -> dict:
    """The exported JAX draws (numpy): ``u0``, ``frozen_draw``, ``solution_rows``."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing; it is made by scripts/export_port_inputs.py")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_stage12_artifacts(path: str = STAGE12_ASSET) -> dict:
    """``mu``, ``sigma``, ``indices`` (the 90 % set) and ``scores`` of the
    stage-1/2 asset, as numpy arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in ("mu", "sigma", "indices", "scores")}


def get_burgers_train(device="cuda", n_rows=None, path: str = PORT_INPUTS) -> dict:
    """The operator row's training split (rows ``[0:n_train]``), solved on ``device``.

    ``n_rows`` solves only the first rows (each row's solve is independent).
    """
    dev = resolve_device(device)
    z = load_port_inputs(path)
    n_train = int(z["n_train"])
    n = n_train if n_rows is None else min(int(n_rows), n_train)
    u0 = torch.as_tensor(z["u0"][:n], device=dev)
    return burgers_dataset(u0, nx=int(z["nx"]), nt=int(z["nt"]))


def get_burgers(device="cuda", n_train=None, n_valid=None, path: str = PORT_INPUTS,
                valid_from=None, mat_path: Optional[str] = None):
    """``(train, valid)`` splits: rows ``[0:n_train]`` and ``[n_train:n_train +
    n_valid]`` (the reference loader's slicing, ``get_burgers`` of the JAX
    package), or validation rows from ``valid_from`` on.

    With ``mat_path`` the rows are the ``.mat``'s (defaults 1000 and 1000,
    clipped to its rows as numpy slicing clips, as in JAX); else they are
    solved on ``device`` from the exported ``u0`` (defaults: the export's
    ``n_train`` 1000 and ``n_valid`` 200)."""
    dev = resolve_device(device)
    if mat_path is not None:
        data = load_burgers_mat(mat_path, dev)
        n_train = 1000 if n_train is None else int(n_train)
        n_valid = 1000 if n_valid is None else int(n_valid)
        lo = n_train if valid_from is None else int(valid_from)
    else:
        z = load_port_inputs(path)
        n_train = int(z["n_train"]) if n_train is None else int(n_train)
        n_valid = int(z["n_valid"]) if n_valid is None else int(n_valid)
        lo = n_train if valid_from is None else int(valid_from)
        if max(n_train, lo + n_valid) > z["u0"].shape[0]:
            raise ValueError(f"rows up to {max(n_train, lo + n_valid)} asked, "
                             f"{z['u0'].shape[0]} exported")
        u0 = torch.as_tensor(np.concatenate([z["u0"][:n_train], z["u0"][lo:lo + n_valid]]),
                             device=dev)
        data = burgers_dataset(u0, nx=int(z["nx"]), nt=int(z["nt"]))
        lo = n_train

    def rows(a, b):
        return {"branch_in": data["branch_in"][a:b].contiguous(),
                "trunk_in": data["trunk_in"],
                "solution": data["solution"][a:b].contiguous()}

    return rows(0, n_train), rows(lo, lo + n_valid)


def get_burgers_baseline(device="cuda", n_train: int = 1000, n_valid: int = 200,
                         path: str = PORT_INPUTS):
    """``(train, valid, n_valid_used)`` for the full-parameter baselines:
    training rows from the front of the export, validation rows from its
    ``n_train`` (row 1000) on, as every stage-3 run scores; ``n_valid`` is
    capped at the exported validation rows (200)."""
    z = load_port_inputs(path)
    first_valid, n_exported = int(z["n_train"]), int(z["n_valid"])
    if n_train > first_valid:
        raise ValueError(f"{n_train} training rows asked, {first_valid} exported")
    used = min(int(n_valid), n_exported)
    train, valid = get_burgers(device, n_train, used, path=path, valid_from=first_valid)
    return train, valid, used


def subsample_trunk(split: dict, p: int, generator: Optional[torch.Generator] = None,
                    idx: Optional[torch.Tensor] = None):
    """Per-example random choice of ``p`` query points without replacement
    (the reference's stochastic trunk subsampling). ``split`` holds
    ``trunk_in`` (P, 2) and ``solution`` (B, P); ``idx`` (B, p) injects the
    chosen indices, else they are the ``p`` largest of B x P uniforms from
    ``generator`` (a uniformly random ``p``-subset per row). Returns
    ``(trunk (B, p, 2), y (B, p))``."""
    trunk, sol = split["trunk_in"], split["solution"]
    if idx is None:
        u = torch.rand(sol.shape, generator=generator, device=sol.device)
        idx = u.topk(p, dim=-1).indices
    idx = torch.as_tensor(idx, dtype=torch.int64, device=sol.device)
    return trunk[idx], torch.gather(sol, 1, idx)


def split_shards(split: dict, num_splits: int) -> dict:
    """The function axis cut into ``num_splits`` equal shards (ValueError if
    they cannot be equal, as the reference's splitting script): ``branch_in``
    and ``solution`` gain a leading shard axis, ``trunk_in`` stays shared."""
    n = split["branch_in"].shape[0]
    if n % num_splits != 0:
        raise ValueError(f"{n} examples cannot be split into {num_splits} equal shards")
    per = n // num_splits
    return {"branch_in": split["branch_in"].reshape(num_splits, per, -1),
            "trunk_in": split["trunk_in"],
            "solution": split["solution"].reshape(num_splits, per, -1)}
