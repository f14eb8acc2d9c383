"""Export the operator row's random posterior inputs for the PyTorch port.

Two inputs that define the operator-row posterior come from ``jax.random`` and
cannot be replayed in PyTorch (threefry vs Philox):

* the GRF initial conditions of the Burgers data
  (``data/burgers.py:_grf_initial_conditions`` under ``data_seed = 0``,
  ``n_train + n_valid = 1200`` rows of 100 grid points), and
* the frozen VI draw of the 'draw' policy, ``draw_full(jax.random.key(0),
  spec)`` (``hmc/subspace.py``), as ``bench.py`` makes it.

This script writes them, plus the first rows of the JAX Burgers solution (the
port's solver is held against them on the GPU), to
``assets/burgers_r2_port_inputs.npz``. The port reads only that file and
``assets/burgers_stage12_r2.npz``.

Run once, on the CPU:

    JAX_PLATFORMS=cpu python scripts/export_port_inputs.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ASSET = os.path.join(ROOT, "assets", "burgers_stage12_r2.npz")
OUT = os.path.join(ROOT, "assets", "burgers_r2_port_inputs.npz")
N_SOLUTION_ROWS = 4


def main():
    import jax
    import jax.numpy as jnp

    from vihmc_tpu.data import get_burgers
    from vihmc_tpu.data.burgers import _grf_initial_conditions
    from vihmc_tpu.hmc import SubspaceSpec
    from vihmc_tpu.hmc.subspace import draw_full

    z = np.load(ASSET)
    n_rows = int(z["n_train"]) + int(z["n_valid"])
    nx, nt = int(z["nx"]), int(z["nt"])
    key = jax.random.key(int(z["data_seed"]))
    # the same call generate_burgers_dataset makes (periodic interior grid)
    u0 = np.asarray(_grf_initial_conditions(key, n_rows, nx - 1), np.float32)
    train, _ = get_burgers(key, int(z["n_train"]), int(z["n_valid"]), nx=nx,
                           nt=nt)
    solution_rows = np.asarray(train["solution"][:N_SOLUTION_ROWS], np.float32)
    # bench.py builds the spec from the asset's mu/sigma and draws the frozen
    # vector with make_subspace_log_prob(..., init_key=jax.random.key(0));
    # the draw does not depend on the subspace indices
    spec = SubspaceSpec(idx=(0,), mu=jnp.asarray(z["mu"]),
                        sigma=jnp.asarray(z["sigma"]))
    frozen = np.asarray(draw_full(jax.random.key(0), spec), np.float32)
    np.savez_compressed(OUT, u0=u0, frozen_draw=frozen,
                        solution_rows=solution_rows,
                        data_seed=z["data_seed"], nx=z["nx"], nt=z["nt"],
                        n_train=z["n_train"], n_valid=z["n_valid"])
    print(f"wrote {OUT}: u0 {u0.shape}, frozen_draw {frozen.shape}, "
          f"solution_rows {solution_rows.shape}")


if __name__ == "__main__":
    main()
