"""Export the NN bench row's random inputs for the PyTorch port.

Two inputs of ``bench.py``'s NN row (``build_nn_problem`` and ``bench_nn``)
come from ``jax.random`` and cannot be replayed in PyTorch (threefry vs
Philox):

* the 20 training points, ``regression_data(jax.random.key(0), 20, 300,
  noise_std=5e-2)`` (their targets carry JAX-drawn noise), and
* the frozen VI draw of the 'draw' policy, ``draw_full(jax.random.key(0),
  spec)`` over ``assets/nn_stage12.npz``'s mu and sigma, as
  ``make_subspace_log_prob(..., init_key=jax.random.key(0))`` makes it.

This script writes them to ``assets/nn_port_inputs.npz`` (under 4 KB). The
port's NN row (``python -m vihmc_torch.bench_nn``) reads only that file and
``assets/nn_stage12.npz``.

Run once, on the CPU:

    JAX_PLATFORMS=cpu python scripts/export_nn_port_inputs.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ASSET = os.path.join(ROOT, "assets", "nn_stage12.npz")
OUT = os.path.join(ROOT, "assets", "nn_port_inputs.npz")


def main():
    import jax
    import jax.numpy as jnp

    from vihmc_tpu.data.synthetic import regression_data
    from vihmc_tpu.hmc import SubspaceSpec
    from vihmc_tpu.hmc.subspace import draw_full

    z = np.load(ASSET)
    data = regression_data(jax.random.key(0), 20, 300, noise_std=5e-2)
    # the draw does not depend on the subspace indices
    spec = SubspaceSpec(idx=(0,), mu=jnp.asarray(z["mu"]), sigma=jnp.asarray(z["sigma"]))
    frozen = np.asarray(draw_full(jax.random.key(0), spec), np.float32)
    x_train = np.asarray(data["x_train"], np.float32)
    y_train = np.asarray(data["y_train"], np.float32)
    np.savez_compressed(OUT, x_train=x_train, y_train=y_train, frozen_draw=frozen,
                        noise_std=np.float32(5e-2))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): x_train {x_train.shape}, "
          f"y_train {y_train.shape}, frozen_draw {frozen.shape}")


if __name__ == "__main__":
    main()
