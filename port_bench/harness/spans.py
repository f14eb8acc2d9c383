"""The program's own spans (``vihmc_torch.core.profiling``) in the measured
window, for the per-layer metrics whose source is ``program_span``.

The metric runs in the window's process, after it. The window is the tail of
the run's one sampler call: its draws are the last ``ctx.untraced_draws +
ctx.stretch_draws`` ``vihmc.draw`` records. Draws flagged ``profiled`` (the
traced stretch) are left out by every reader, so no reading comes from the
profiler's stretch. Stamps are nanoseconds on the host's ``perf_counter``; the
device stamps are the device's, mapped onto that clock (on the CPU they are
the host's). A program without the recorder has no records, and each reader
then returns None.
"""

from __future__ import annotations

import statistics

import numpy as np

NS_PER_MS = 1e6


def program_records() -> list:
    """The recorder's records, or [] where the program has no recorder."""
    try:
        from vihmc_torch.core import profiling
    except ImportError:
        return []
    read = getattr(profiling, "records", None)
    return read() if read is not None else []


def window_draws(ctx, before: int = 0) -> list:
    """``[(draw record, [records inside the draw])]`` of the window's draws
    in order, and of the ``before`` draws just before it; profiled ones
    included (each reader drops them)."""
    recs = program_records()
    n = ctx.untraced_draws + ctx.stretch_draws
    draws = [r for r in recs if r["name"] == "vihmc.draw"]
    if not n or not draws:
        return []
    draws = draws[-(n + before):]
    inside = {r["id"]: [] for r in draws}
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["draw"] is None or r["name"] == "vihmc.draw":
            continue
        p = by_id.get(r["parent"])
        while p is not None and p["name"] != "vihmc.draw":
            p = by_id.get(p["parent"])
        if p is not None and p["id"] in inside:
            inside[p["id"]].append(r)
    return [(d, inside[d["id"]]) for d in draws]


def device_ms(r) -> float | None:
    if r["dev_t0"] is None or r["dev_t1"] is None:
        return None
    return (r["dev_t1"] - r["dev_t0"]) / NS_PER_MS


def median(values: list) -> float | None:
    return float(statistics.median(values)) if values else None


def p95(values: list) -> float | None:
    return float(np.percentile(values, 95)) if values else None


def span_ms_per_draw(ctx, name: str) -> float | None:
    """Device time of the spans ``name`` inside a draw, summed over the draw;
    the median over the window's unprofiled draws that recorded them (the
    detailed draws)."""
    per_draw = []
    for d, inside in window_draws(ctx):
        spans = [r for r in inside if r["name"] == name]
        if d["profiled"] or not spans:
            continue
        times = [device_ms(r) for r in spans]
        if all(t is not None for t in times):
            per_draw.append(sum(times))
    return median(per_draw)
