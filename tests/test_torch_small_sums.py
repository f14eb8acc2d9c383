"""The merge kernels' small-problem path, on the CPU: the wrappers' (C, B)
rule, a model of the small kernels' tiling, and parity of the port's plain
sums with the unbatched Pallas kernels they replace.

``vihmc_torch/csrc/merge_sums.cu`` and ``paired_sums.cu`` each hold a tiled
kernel (128 x 128 tiles walking every chain) and a small-problem kernel (one
chain and 64 P rows x 16-64 B rows per block); ``merge_sums`` and
``paired_sums`` pick one by ``_sums_path(C, B)``. The kernels run only on a
card (``tests/test_torch_cuda.py``); here the CPU path takes the plain
versions, so these tests hold the rule, the tiling's geometry and the plain
sums against JAX's unbatched ``_merge_sums_pallas`` and
``_paired_sums_pallas`` in interpret mode, as ``tests/test_ops.py`` runs them.
Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vihmc_tpu.ops.deeponet_merge import _merge_sums_pallas, _paired_sums_pallas
from vihmc_torch.core.profiling import counter
from vihmc_torch.ops.deeponet_merge import (SMALL_P_ROWS, _small_blocks, _small_tile_n,
                                            _sums_path, merge_sums, merge_sums_reference,
                                            paired_sums, paired_sums_reference)

# f32 sums of the Pallas kernels against the port's (f64 merge sums, f32
# paired sums): each within this fraction of the sum of its terms' magnitudes
SUM_RTOL_MAG = 1e-5
LAST_BLOCK_THREADS = 128  # threads of the block that adds the slots


@pytest.mark.parametrize("c,b,path", [
    (1, 10, "small"), (1, 63, "small"), (1, 64, "small"), (1, 65, "small"), (1, 127, "small"),
    (1, 128, "small"), (1, 1000, "small"),
    (2, 10, "small"), (2, 63, "small"), (2, 64, "small"), (2, 65, "small"), (2, 127, "small"),
    (2, 128, "small"), (2, 1000, "small"),
    (3, 127, "small"), (3, 128, "tiled"), (4, 10, "small"), (4, 1000, "tiled"),
    (8, 1000, "tiled"), (16, 1000, "tiled"), (32, 1000, "tiled"), (48, 1000, "tiled"),
])
def test_sums_path_rule_at_the_edges(c, b, path):
    """The small kernel at one or two chains (any B) and below 128 B rows (any
    C); the tiled one from three chains at 128 rows up: stage 3 (C = 16), the
    row (C = 48) and the 90 % row (C = 32) stay tiled, hmc_nuts (B = 10) and
    --extras' gradient (C = 1) go small."""
    assert _sums_path(c, b) == path


@pytest.mark.parametrize("b,n", [(1, 16), (10, 16), (16, 16), (17, 32), (32, 32), (33, 64),
                                 (127, 64), (1000, 64)])
def test_small_tile_width_and_block_count(b, n):
    """wgmma's N side takes the B rows in tiles of 16, 32 or 64; a chain has
    ceil(P / 64) x ceil(B / N) blocks (160 at hmc_nuts's B = 10, P = 10,201;
    2560 at B = 1000)."""
    assert _small_tile_n(b) == n
    assert _small_blocks(b, 10201) == 160 * -(-b // n)


def _tiled_merge_model(bout, tout, y):
    """The small merge kernel's decomposition on the CPU: per chain, per
    block of 64 P rows x N B rows (zero-padded past the edges), the f32
    terms m (m - 2 y) and m summed in f64 into the block's slot; then the
    slots added in the last block's fixed order (thread t adds slots t,
    t + 128, ... in turn, then a tree over the threads). Returns the (C, 2)
    sums and the number of slots per chain."""
    c_, b_, _ = bout.shape
    p_ = tout.shape[1]
    n = _small_tile_n(b_)
    pb, bb = -(-p_ // SMALL_P_ROWS), -(-b_ // n)
    pad_b = torch.zeros((c_, bb * n, bout.shape[2]))
    pad_b[:, :b_] = bout
    pad_t = torch.zeros((c_, pb * SMALL_P_ROWS, tout.shape[2]))
    pad_t[:, :p_] = tout
    pad_y = torch.zeros((bb * n, pb * SMALL_P_ROWS))
    pad_y[:b_, :p_] = y
    out = []
    for c in range(c_):
        slots = []
        for j in range(bb):          # B tiles (the grid's y)
            for i in range(pb):      # P tiles (the grid's x, fastest)
                bo = pad_b[c, j * n:(j + 1) * n]
                to = pad_t[c, i * SMALL_P_ROWS:(i + 1) * SMALL_P_ROWS]
                yy = pad_y[j * n:(j + 1) * n, i * SMALL_P_ROWS:(i + 1) * SMALL_P_ROWS]
                m = bo @ to.T
                slots.append(torch.stack([(m * (m - 2.0 * yy)).double().sum(),
                                          m.double().sum()]))
        slots = torch.stack(slots)
        lanes = torch.zeros((LAST_BLOCK_THREADS, 2), dtype=torch.float64)
        for s, v in enumerate(slots):
            lanes[s % LAST_BLOCK_THREADS] += v
        h = LAST_BLOCK_THREADS // 2
        while h:
            lanes[:h] += lanes[h:2 * h]
            h //= 2
        out.append(lanes[0])
    return torch.stack(out), len(slots)


@pytest.mark.parametrize("c,b,p,k", [(1, 10, 301, 12), (2, 37, 129, 33), (1, 130, 65, 7),
                                     (3, 1, 1, 1)])
def test_small_tiling_covers_every_cell_once(c, b, p, k):
    """The modelled tiling (the kernels' tile widths, zero padding and
    fixed-order slot sum) gives the plain version's sums within 1e-12 of the
    terms' magnitudes (f64 sums of the same f32 terms in another order), with
    the wrapper's count of slots per chain."""
    rng = np.random.default_rng(40 + b)
    bout, tout, y = (torch.as_tensor(a.astype(np.float32)) for a in
                     (rng.normal(size=(c, b, k)), rng.normal(size=(c, p, k)),
                      rng.normal(size=(b, p))))
    got, nslot = _tiled_merge_model(bout, tout, y)
    want = merge_sums_reference(bout, tout, y)
    m = (bout.double() @ tout.double().transpose(-1, -2))
    mag = torch.stack([(m * m + 2 * (m * y.double()).abs()).sum((1, 2)),
                       m.abs().sum((1, 2))], -1)
    assert nslot == _small_blocks(b, p)
    assert float(((got - want).abs() / mag).max()) < 1e-12


def _pallas_inputs(seed, b, p, k):
    """Features at q0 and at q1 one small step away, and y, one chain, at a
    shape of whole 256 x 256 Pallas tiles (as tests/test_ops.py runs them)."""
    rng = np.random.default_rng(seed)
    bout0 = rng.normal(scale=0.5, size=(1, b, k)).astype(np.float32)
    tout0 = rng.normal(scale=0.5, size=(1, p, k)).astype(np.float32)
    bout1 = (bout0 + 1e-3 * rng.normal(size=bout0.shape)).astype(np.float32)
    tout1 = (tout0 + 1e-3 * rng.normal(size=tout0.shape)).astype(np.float32)
    y = rng.normal(scale=1.3, size=(b, p)).astype(np.float32)
    return bout1, tout1, bout0, tout0, y


@pytest.mark.parametrize("b,p,k", [(256, 256, 32), (256, 512, 100)])
def test_merge_sums_match_unbatched_pallas_kernel(b, p, k):
    """The port's merge_sums at C = 1 on the CPU (the plain version) against
    the unbatched ``_merge_sums_pallas`` in interpret mode: S1 and S2 each
    within 1e-5 of the sum of their terms' magnitudes (f32 products on both
    sides; JAX sums in f32, the port in f64)."""
    bout, tout, _, _, y = _pallas_inputs(41, b, p, k)
    s1, s2 = _merge_sums_pallas(jnp.asarray(bout[0]), jnp.asarray(tout[0]), jnp.asarray(y),
                                interpret=True)
    t = [torch.as_tensor(a) for a in (bout, tout, y)]
    n = counter("merge_sums.launches")
    got = merge_sums(*t)
    assert counter("merge_sums.launches") == n  # the CPU path launches no kernel
    m = t[0][0].double() @ t[1][0].double().T
    y64 = t[2].double()
    mag = [float((m * m + 2 * (m * y64).abs()).sum()), float(m.abs().sum())]
    for i, want in enumerate((float(s1), float(s2))):
        assert abs(float(got[0, i]) - want) <= SUM_RTOL_MAG * mag[i], (i, float(got[0, i]), want)


@pytest.mark.parametrize("b,p,k", [(256, 256, 32), (256, 512, 100)])
def test_paired_sums_match_unbatched_pallas_kernel(b, p, k):
    """The port's paired_sums at C = 1 on the CPU (the plain version) against
    the unbatched ``_paired_sums_pallas`` in interpret mode: D, Bd, Sm, Q1,
    C1 each within 1e-5 of the sum of its terms' operand magnitudes (f32 on
    both sides; D and Bd add small differences, so a bound relative to the
    sums themselves would not hold)."""
    feats = _pallas_inputs(42, b, p, k)
    want = _paired_sums_pallas(*(jnp.asarray(a[0]) for a in feats[:4]), jnp.asarray(feats[4]),
                               interpret=True)
    t = [torch.as_tensor(a) for a in feats]
    n = counter("paired_sums.launches")
    got = paired_sums(*t)
    assert counter("paired_sums.launches") == n
    assert torch.equal(got, paired_sums_reference(*t))
    b1, t1, b0, t0, y64 = (a.double() for a in t)
    m1, m0 = b1[0] @ t1[0].T, b0[0] @ t0[0].T
    both = m1.abs() + m0.abs()
    mags = [both * (both + 2 * y64.abs()), both, both, m1 * m1, (m1 * y64).abs()]
    for i, w in enumerate(want):
        assert abs(float(got[0, i]) - float(w)) <= SUM_RTOL_MAG * float(mags[i].sum()), i


def test_launch_helpers_take_cuda_tensors_only():
    """``_merge_launch`` and ``_paired_launch`` (the kernels' launches, which
    the card checks call by path) refuse CPU tensors before building or
    loading anything, and count no launch."""
    from vihmc_torch.ops.deeponet_merge import _merge_launch, _paired_launch

    bout, tout, y = torch.zeros((1, 3, 4)), torch.zeros((1, 5, 4)), torch.zeros((3, 5))
    counts = (counter("merge_sums.launches"), counter("paired_sums.launches"))
    for path in ("small", "tiled"):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            _merge_launch(path, bout, tout, y)
        with pytest.raises(ValueError, match="CUDA or CPU"):
            _paired_launch(path, bout, tout, bout, tout, y)
    assert (counter("merge_sums.launches"), counter("paired_sums.launches")) == counts
