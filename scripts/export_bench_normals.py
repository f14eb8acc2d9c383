"""Export the standard normals behind the bench's frozen 'draw' vector.

``bench.py`` freezes the coordinates outside the subspace at
``draw_full(jax.random.key(0), spec) = mu + sigma * eps`` (``hmc/subspace.py``),
where ``eps = jax.random.normal(jax.random.key(0), mu.shape)``. ``eps`` does
not depend on the bundle, only on the flat width, so one draw per width
serves every stage-1/2 bundle of ``assets/``: the reference DeepONet's
172,401 parameters (``eps_full``) and the small DeepONet of ``bench.py
--quick`` (``eps_quick``). PyTorch cannot replay ``jax.random``, so this
script writes both to ``assets/bench_draw_normals.npz``.

Run once, on the CPU:

    JAX_PLATFORMS=cpu python scripts/export_bench_normals.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "assets", "bench_draw_normals.npz")
#: bench.py --quick's DeepONet (bench.py:337-338)
QUICK_CFG = dict(in_branch=21, in_trunk=5, width_branch=32, width_trunk=32,
                 depth_branch=3, depth_trunk=3)


def main():
    import jax

    from vihmc_tpu.models import DeepONetConfig
    from vihmc_tpu.pipelines.common import make_flat_deeponet

    normals = {}
    for name, cfg in (("eps_full", DeepONetConfig()),
                      ("eps_quick", DeepONetConfig(**QUICK_CFG))):
        d = make_flat_deeponet(cfg)[1].shape[0]
        normals[name] = np.asarray(jax.random.normal(jax.random.key(0), (d,)), np.float32)
    np.savez_compressed(OUT, **normals)
    print(f"wrote {OUT}: " + ", ".join(f"{k} {v.shape}" for k, v in normals.items()))


if __name__ == "__main__":
    main()
