"""The arithmetic of the FNO2d cell's roofline and MFU metrics, reckoned from
the shapes, not from what an implementation launches (a fused kernel is held
to the same count).

``shapes``: ``C`` chains, ``B`` functions, the grid ``S1 x S2`` and its
``pad``, ``width``, ``n_layers``, ``modes1``, ``modes2`` and the draw's
``num_leapfrog`` trajectory fields.

* ``transform_bytes``: an ``rfft2`` and an ``irfft2`` of ``(c, ch, n)`` planes
  of the padded grid, each reading its input once and writing its output
  once (float32 planes, complex64 half spectra);
* ``spectral_bytes_per_draw``: the spectral layers of every field call of a
  draw, forward and backward (the field's spans; the MH test's forwards are
  not in them);
* ``fft_flops``: ``2.5 N log2 N`` for a real transform of ``N`` points;
  ``fft_flops_per_draw``: every transform of a draw, the fields' forward
  and backward and the MH test's forwards of both endpoints, which
  ``FlopCounterMode`` does not count;
* ``mixing_flops``: the per-mode complex channel mixing of ``n`` functions,
  8 real operations per complex multiply-add.
"""

from __future__ import annotations

import math


def transform_bytes(c: int, ch: int, n: int, s1: int, s2: int) -> float:
    planes = c * ch * n
    real = 4.0 * s1 * s2
    half = 8.0 * s1 * (s2 // 2 + 1)
    return 2.0 * planes * (real + half)


def _padded(shapes: dict):
    return shapes["S1"] + shapes["pad"], shapes["S2"] + shapes["pad"]


def spectral_bytes_per_draw(shapes: dict) -> float:
    s1, s2 = _padded(shapes)
    per_call = 2 * shapes["n_layers"] * transform_bytes(shapes["C"], shapes["width"],
                                                        shapes["B"], s1, s2)
    return shapes["num_leapfrog"] * per_call


def fft_flops(s1: int, s2: int) -> float:
    n = s1 * s2
    return 2.5 * n * math.log2(n)


def fft_flops_per_draw(shapes: dict) -> float:
    s1, s2 = _padded(shapes)
    planes = shapes["n_layers"] * shapes["width"] * shapes["C"] * shapes["B"]
    field = 4 * shapes["num_leapfrog"]        # rfft2 + irfft2, forward and backward
    mh = 2 * 2                                # rfft2 + irfft2 of both endpoints
    return planes * (field + mh) * fft_flops(s1, s2)


def mixing_flops(n: int, i: int, o: int, modes: int) -> float:
    return 8.0 * n * i * o * modes
