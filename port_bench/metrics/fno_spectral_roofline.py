"""``fno_spectral_roofline``: the bytes the trajectory field's spectral layers
must move in a draw (``harness/fno_arith.spectral_bytes_per_draw``: every
transform reads its input and writes its output once, forward and backward)
at the card's published HBM bandwidth, over the device time of the operations
launched inside the program's ``vihmc.fno.spectral`` and
``vihmc.fno.spectral.bwd`` spans in the traced stretch, per draw.

The trace keeps the harness's spans only; the program's spans of the stretch
(recorded with host stamps while the profiler ran) are put on the trace's
clock by the harness's ``trajectory_field`` spans, each of which lies inside
the program's ``vihmc.field`` span of the same call: the offset is the median
over the calls of the mean of the two ends' differences."""

import copy
import statistics

from port_bench.harness.fno_arith import spectral_bytes_per_draw
from port_bench.harness.spans import program_records

SPECTRAL = ("vihmc.fno.spectral", "vihmc.fno.spectral.bwd")


def read(ctx):
    if ctx.trace is None or ctx.peak is None or not ctx.stretch_draws:
        return None
    prof = [r for r in program_records() if r["profiled"] and r["host_t1"] is not None]
    fields = sorted((r for r in prof if r["name"] == "vihmc.field"), key=lambda r: r["host_t0"])
    calls = sorted((a, b) for n, a, b in ctx.trace.spans if n == "trajectory_field")
    spans = [r for r in prof if r["name"] in SPECTRAL]
    if not spans or not calls or len(fields) != len(calls):
        return None
    offset = statistics.median(
        0.5 * ((a - r["host_t0"] / 1e3) + (b - r["host_t1"] / 1e3))
        for r, (a, b) in zip(fields, calls))
    # the program's spans on the trace's clock, in a copy (the breakdown
    # labels idle by the harness's spans alone)
    trace = copy.copy(ctx.trace)
    trace.spans = ctx.trace.spans + [
        (r["name"], r["host_t0"] / 1e3 + offset, r["host_t1"] / 1e3 + offset) for r in spans]
    device_us = sum(d[3] for name in SPECTRAL for d in trace.launched_in(name))
    if device_us <= 0:
        return None
    roofline_s = spectral_bytes_per_draw(ctx.shapes) / ctx.peak["hbm_bytes_per_s"]
    return 100.0 * roofline_s * ctx.stretch_draws / (device_us * 1e-6)
