"""CPU model of the split-precision products of the port's merge kernels.

``vihmc_torch/csrc/paired_sums.cu`` and ``merge_sums.cu`` take f32 products
on the tensor cores: each f32 operand is split into bf16 parts and a product
is a sum of part products, each K chunk of 16 into a fresh f32 accumulator
that is then added to the running f32 sum with an IEEE add, after one unit
in its last place is added to its magnitude when that place is odd (the mean
of the tensor cores' truncation; ``csrc/split_mma.cuh``). The card cannot
run here, so this file models that
arithmetic in plain PyTorch and holds it against float64 and against an IEEE
f32 matmul on the same inputs, for the kernel's split (three bf16 parts, six
part products) and for the alternative (3xTF32: two TF32 parts, three
products, K chunks of 8). The tensor cores' own rounding of an accumulation is
modelled both to nearest and toward zero (the card showed the latter).
Inputs are made with numpy from a seed, and include features of the JAX
DeepONet at a small shape.
"""

import jax
import numpy as np
import pytest
import torch

from vihmc_tpu.models.deeponet import DeepONetConfig, deeponet_features, init_deeponet

# (part products in the kernel's order, smallest first; K chunk)
SPLITS = {
    "bf16x3": ([(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)], 16),
    "tf32x2": ([(1, 0), (0, 1), (0, 0)], 8),
}
IEEE_FACTOR = 2.0  # the split's error against float64 may be twice an IEEE f32 matmul's


def bf16_parts(x: torch.Tensor):
    """x = x0 + x1 + x2, each part the bf16 rounding (to nearest) of what is left."""
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    x2 = (r - x1.float()).to(torch.bfloat16)
    return [x0, x1, x2]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10 mantissa bits, to nearest with ties away
    (``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_parts(x: torch.Tensor):
    big = _tf32(x)
    return [big, _tf32(x - big)]


def _round_nearest(x64: torch.Tensor) -> torch.Tensor:
    return x64.float()


def _round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


ROUNDINGS = {"nearest": _round_nearest, "toward_zero": _round_toward_zero}


def _unbias(t: torch.Tensor) -> torch.Tensor:
    """One unit in the last place more magnitude when that place is odd."""
    bits = t.view(torch.int32)
    return (bits + (bits & 1)).view(torch.float32)


def split_product(a, b, split, rounding, fresh_chunks=True, unbias=True,
                  order=None) -> torch.Tensor:
    """``a @ b.T`` as the kernel forms it: per K chunk, every part product of
    the chunk (exact in float64: part products are short) is added to the
    chunk's accumulator, which rounds to f32 after each; the chunk's sum,
    with ``unbias`` given one unit in its last place when that place is odd,
    is then added to the running f32 sum to nearest. ``fresh_chunks=False``
    chains every part product into one accumulator instead; ``order`` (pairs
    of a part and b part) replaces the split's order of part products."""
    default, kc = SPLITS[split]
    order = default if order is None else order
    parts = bf16_parts if split == "bf16x3" else tf32_parts
    pa = [p.double() for p in parts(a)]
    pb = [p.double() for p in parts(b)]
    rnd = ROUNDINGS[rounding]
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], kc):
        t = torch.zeros_like(acc) if fresh_chunks else acc
        for i, j in order:
            t = rnd(t.double() + pa[i][:, k0:k0 + kc] @ pb[j][:, k0:k0 + kc].T)
        if fresh_chunks:
            acc = (acc.double() + (_unbias(t) if unbias else t).double()).float()
        else:
            acc = t
    return acc


def _normal(seed, rows, k, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((scale * rng.normal(size=(rows, k))).astype(np.float32))


def _deeponet_features():
    """bout (40, 100), tout (60, 100) of a three-layer reference-width JAX
    DeepONet at its initialization."""
    cfg = DeepONetConfig(depth_branch=3, depth_trunk=3)
    rng = np.random.default_rng(3)
    bx = rng.normal(size=(40, cfg.in_branch)).astype(np.float32)
    tx = rng.random(size=(60, 2)).astype(np.float32)
    params = init_deeponet(jax.random.key(0), cfg)
    return tuple(torch.as_tensor(np.array(f)) for f in deeponet_features(cfg, params, bx, tx))


def _inputs(name):
    if name == "deeponet":
        return _deeponet_features()
    return _normal(1, 64, 100), _normal(2, 96, 100)


@pytest.mark.parametrize("source", ["normal", "deeponet"])
def test_bf16_parts_reconstruct_f32_exactly(source):
    """The three bf16 parts of f32 values (normal data over a wide range of
    exponents, and DeepONet features) sum to each value exactly, and each part
    is below 2^-8 of the one before it."""
    if source == "normal":
        rng = np.random.default_rng(0)
        x = torch.as_tensor((rng.normal(size=4096) * 10.0 ** rng.uniform(-20, 20, 4096))
                            .astype(np.float32))
    else:
        x = torch.cat([f.flatten() for f in _deeponet_features()])
    x0, x1, x2 = (p.double() for p in bf16_parts(x))
    assert torch.equal(x0 + (x1 + x2), x.double())
    assert bool((x1.abs() <= 2.0 ** -8 * x0.abs()).all())
    assert bool((x2.abs() <= 2.0 ** -8 * x1.abs()).all())


@pytest.mark.parametrize("rounding", list(ROUNDINGS))
@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("source", ["normal", "deeponet"])
def test_split_products_within_twice_ieee_error(source, split, rounding):
    """Over K = 100, the modelled kernel product is within twice the largest
    error of an IEEE f32 matmul against float64 on the same inputs (both
    splits pass: bf16x3 at 0.21-0.48x, 3xTF32 at 0.35-0.44x)."""
    a, b = _inputs(source)
    ref = a.double() @ b.double().T
    err_ieee = ((a @ b.T).double() - ref).abs().max().item()
    err = (split_product(a, b, split, rounding).double() - ref).abs().max().item()
    assert err <= IEEE_FACTOR * err_ieee, (err, err_ieee)


@pytest.mark.parametrize("unbias", [False, True])
def test_fresh_chunk_accumulators_remove_the_truncation_bias(unbias):
    """With rounding toward zero, chaining all 42 part products of K = 100
    into one accumulator shrinks every product, and S1 = sum m (m - 2 y)
    moves by more than 5e-7 of its terms' magnitudes; a fresh accumulator per
    chunk, with or without the odd-place unit, keeps it within the 1e-7 the
    stage-3 check allows."""
    a, b = _normal(4, 96, 100, 0.7), _normal(5, 128, 100, 0.7)
    y = torch.as_tensor(np.random.default_rng(6).normal(scale=1.3, size=(96, 128)))
    ref = a.double() @ b.double().T
    mag = (ref * ref + 2 * (ref * y).abs()).sum().item()

    def s1_err(m):
        m = m.double()
        return abs(((m * (m - 2 * y)).sum() - (ref * (ref - 2 * y)).sum()).item()) / mag

    chained = split_product(a, b, "bf16x3", "toward_zero", fresh_chunks=False)
    fresh = split_product(a, b, "bf16x3", "toward_zero", unbias=unbias)
    assert s1_err(chained) > 5e-7
    assert s1_err(fresh) < 1e-7


def test_odd_place_unit_removes_the_chunk_drift():
    """Over many chunk sums truncated toward zero, the odd-place unit brings
    the mean drift of the running sum from about half a unit per chunk to
    near zero: the modelled kernel's mean signed error, relative to the
    products' magnitude, shrinks at least fourfold."""
    a, b = _normal(7, 128, 100, 0.7).abs(), _normal(8, 160, 100, 0.7).abs()  # one sign: drift adds up
    ref = a.double() @ b.double().T
    drift = [((split_product(a, b, "bf16x3", "toward_zero", unbias=u).double() - ref) / ref)
             .mean().item() for u in (False, True)]
    assert drift[0] < 0 and abs(drift[1]) * 4 < abs(drift[0]), drift


@pytest.mark.parametrize("rounding", list(ROUNDINGS))
@pytest.mark.parametrize("source", ["normal", "deeponet"])
def test_swapped_roles_form_each_product_alike(source, rounding):
    """The small kernels put tout on wgmma's A side and bout on its B side
    and run the six part products in the mirror order (tout part j times
    bout part i where the tiled kernels run bout part i times tout part j):
    modelled, every product comes out bit for bit as the tiled order forms
    it."""
    bout, tout = _inputs(source)
    mirrored = [(j, i) for i, j in SPLITS["bf16x3"][0]]
    tiled = split_product(bout, tout, "bf16x3", rounding)
    small = split_product(tout, bout, "bf16x3", rounding, order=mirrored).T
    assert torch.equal(small, tiled)
