"""The arithmetic of the roofline and MFU metrics.

``paired_sums_work`` is the operation and byte count of one ``paired_sums``
launch (the counts of ``chip_smoke.paired_sums_bound_ms``): the two products
``bout tout^T`` at each endpoint (4 C B P K) and the epilogue (12 C B P),
each input read once and the five sums per chain written once.
"""

from __future__ import annotations


def paired_sums_work(c: int, b: int, p: int, k: int):
    flops = 4.0 * c * b * p * k + 12.0 * c * b * p
    nbytes = 4.0 * (2 * c * b * k + 2 * c * p * k + b * p + 5 * c)
    return flops, nbytes


def roofline_s(flops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the operations over
    the peak rate and the bytes over the peak bandwidth."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


def roofline_pct(flops: float, nbytes: float, launches: int, device_s: float,
                 peak: dict) -> float:
    """100 x the roofline time of ``launches`` launches over their device time."""
    return 100.0 * launches * roofline_s(flops, nbytes, peak) / device_s


def mfu_pct(flops_per_draw: float, draws: int, wall_s: float, peak: dict) -> float:
    """100 x the achieved FLOP/s of ``draws`` draws in ``wall_s`` over the peak."""
    return 100.0 * flops_per_draw * draws / wall_s / peak["bf16_flops"]
