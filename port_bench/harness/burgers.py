"""The Burgers data of the operator cells, made by the benchmark.

A copy of the program's integrating-factor RK4 pseudo-spectral solver of
periodic viscous Burgers (``vihmc_torch/data/burgers.py``), so that the
benchmark makes the data itself and hands the same tensors to the program
and to the reference. The initial conditions are the committed draws of
``assets/burgers_r2_port_inputs.npz``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def solve(u0: torch.Tensor, nu: float, nt_save: int, steps_per_save: int,
          t_final: float = 1.0) -> torch.Tensor:
    """``(N, nt_save, nx)`` snapshots of periodic viscous Burgers from ``u0`` (N, nx)."""
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


def dataset(root: str, data: dict, device) -> dict:
    """``branch_x`` (B, nx), ``trunk_x`` (nt nx, 2) with columns (t, x),
    t-major, and ``y`` (B, nt nx) from the first ``n_functions`` initial
    conditions of ``data['inputs']``; ``grid_stride`` > 1 keeps every
    ``grid_stride``-th point of the grid in t and in x (a size for tests)."""
    with np.load(os.path.join(root, data["inputs"])) as z:
        u0 = torch.as_tensor(z["u0"][:data["n_functions"]], device=device)
        nx, nt = int(z["nx"]), int(z["nt"])
    if (nx, nt) != (data["nx"], data["nt"]):
        raise ValueError(f"{data['inputs']} is on a {nx} x {nt} grid, the config "
                         f"says {data['nx']} x {data['nt']}")
    sol = solve(u0, data["nu"], nt, data["steps_per_save"])       # (N, nt, nx - 1)
    sol = torch.cat([sol, sol[..., :1]], dim=-1)                    # the wrap point
    t = torch.linspace(0.0, 1.0, nt, device=device)
    x = torch.linspace(0.0, 1.0, nx, device=device)
    s = int(data.get("grid_stride", 1))
    ti, xi = torch.arange(0, nt, s, device=device), torch.arange(0, nx, s, device=device)
    tt, xx = torch.meshgrid(t[ti], x[xi], indexing="ij")
    return {"branch_x": sol[:, 0, :].contiguous(),
            "trunk_x": torch.stack([tt.reshape(-1), xx.reshape(-1)], dim=-1),
            "y": sol[:, ti][:, :, xi].reshape(sol.shape[0], -1).contiguous()}
