"""The port's CUDA kernels on the card, against their plain PyTorch versions.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX). Without a card every
test skips: a CUDA kernel has no CPU or interpret mode.
"""

import numpy as np
import pytest
import torch

from vihmc_torch.ops.deeponet_merge import (close_paired_sums, fused_paired_delta,
                                            paired_sums, paired_sums_reference,
                                            y_sums)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _features(seed, c, b, p, k, device):
    """Features at q0 and at q1 one small step away, and y (B, P)."""
    rng = np.random.default_rng(seed)
    bout0 = rng.normal(size=(c, b, k)).astype(np.float32)
    tout0 = rng.normal(size=(c, p, k)).astype(np.float32)
    bout1 = (bout0 + 1e-3 * rng.normal(size=(c, b, k))).astype(np.float32)
    tout1 = (tout0 + 1e-3 * rng.normal(size=(c, p, k))).astype(np.float32)
    y = rng.normal(size=(b, p)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (bout1, tout1, bout0, tout0, y)]


def _sums_f64(bout1, tout1, bout0, tout0, y):
    """The five sums in float64, and for each the sum of its terms written
    with the magnitudes of their operands (the scale of f32 rounding)."""
    b1, t1, b0, t0, yy = (t.double() for t in (bout1, tout1, bout0, tout0, y))
    m1 = b1 @ t1.transpose(-1, -2)
    m0 = b0 @ t0.transpose(-1, -2)
    dm, sm = m1 - m0, m1 + m0
    terms = [dm * (sm - 2 * yy), dm, sm, m1 * m1, m1 * yy]
    both = m1.abs() + m0.abs()
    mags = [both * (both + 2 * yy.abs()), both, both, m1 * m1, (m1 * yy).abs()]
    return (torch.stack([t.sum((1, 2)) for t in terms], dim=-1),
            torch.stack([t.sum((1, 2)) for t in mags], dim=-1))


def test_paired_sums_kernel_matches_plain_version(cuda_device):
    """Ragged C = 3, 130 x 301 x 12: Delta ll within 1e-2 nats of the plain
    version (the paired form's stated error) and lp1 within rtol 1e-5."""
    bout1, tout1, bout0, tout0, y = _features(5, 3, 130, 301, 12, cuda_device)
    bias1 = torch.tensor([0.34, 0.2, -0.1], device=cuda_device)
    bias0 = torch.tensor([0.31, 0.21, -0.12], device=cuda_device)
    n = paired_sums.launches
    d_k, lp_k = fused_paired_delta(bout1, tout1, bias1, bout0, tout0, bias0, y, 0.7)
    torch.cuda.synchronize()
    assert paired_sums.launches == n + 1
    sums_p = paired_sums_reference(bout1, tout1, bout0, tout0, y)
    d_p, lp_p = close_paired_sums(sums_p, bias1, bias0, y.numel(), 0.7, *y_sums(y))
    np.testing.assert_allclose(d_k.cpu().numpy(), d_p.cpu().numpy(), atol=1e-2, rtol=0)
    np.testing.assert_allclose(lp_k.cpu().numpy(), lp_p.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("b,p,k", [(200, 1000, 100), (64, 64, 16), (1, 1, 1)])
def test_paired_sums_kernel_matches_float64(cuda_device, b, p, k):
    """Against a float64 evaluation: each of the five sums within 1e-5 of
    the sum of its terms' operand magnitudes (f32 products and f32 sums
    inside a block round at that scale; D and Bd add small differences, so a
    bound relative to the sums themselves would not hold). K = 100 leaves a
    ragged last K chunk, 1 x 1 x 1 a block that is all edge."""
    feats = _features(6, 2, b, p, k, cuda_device)
    got = paired_sums(*feats).double()
    want, mag = _sums_f64(*feats)
    torch.cuda.synchronize()
    err = ((got - want).abs() / mag.clamp(min=1e-30)).max().item()
    assert err < 1e-5, err


def test_paired_sums_kernel_is_deterministic_and_checks_inputs(cuda_device):
    """Two launches on the same inputs agree bit for bit (fixed-order
    reduction, no atomics); a non-contiguous or mixed-device input raises
    before any launch."""
    feats = _features(7, 4, 257, 515, 33, cuda_device)
    a = paired_sums(*feats)
    b = paired_sums(*feats)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    n = paired_sums.launches
    bad = feats[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        paired_sums(feats[0], bad, *feats[2:])
    with pytest.raises(ValueError):
        paired_sums(feats[0], feats[1], feats[2], feats[3], feats[4].cpu())
    assert paired_sums.launches == n
