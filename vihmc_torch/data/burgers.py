"""Burgers operator-learning data, solved on the device with ``torch.fft``.

Counterpart of ``vihmc_tpu/data/burgers.py``: the integrating-factor RK4
pseudo-spectral solver of periodic viscous Burgers (``solve_burgers``) and the
dataset assembly of ``generate_burgers_dataset``. The GRF initial conditions
are NOT drawn here: the JAX package draws them from ``jax.random``, which
PyTorch cannot replay, so ``scripts/export_port_inputs.py`` exported them once
to ``assets/burgers_r2_port_inputs.npz`` (``u0``), next to the frozen VI draw
of the operator row and the first rows of the JAX solution.
"""

from __future__ import annotations

import math
import os

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


def load_port_inputs(path: str = PORT_INPUTS) -> dict:
    """The exported JAX draws (numpy): ``u0``, ``frozen_draw``, ``solution_rows``."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing; it is made by scripts/export_port_inputs.py")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


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
