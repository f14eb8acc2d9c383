"""``paired_sums_roofline``: the roofline time of the ``paired_sums``
launches (``harness.arith.paired_sums_work`` at the cell's C, B, P, K; the
published bf16 peak and HBM bandwidth) over their kernels' device time in
the trace (the product kernel and its reduction, launched inside the
harness's ``mh_test`` span). No f32-accurate implementation can beat the
bf16 peak, so the share stays below 100 %."""

from port_bench.harness.arith import paired_sums_work, roofline_pct

PRODUCTS = ("paired_tiles", "paired_small")
KERNELS = PRODUCTS + ("reduce_partials",)


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    ops = [d for d in ctx.trace.launched_in("mh_test")
           if d[0] == "kernel" and any(k in d[1] for k in KERNELS)]
    launches = sum(1 for d in ops if any(k in d[1] for k in PRODUCTS))
    if not launches:
        return None
    s = ctx.shapes
    flops, nbytes = paired_sums_work(s["C"], s["B"], s["P"], s["K"])
    return roofline_pct(flops, nbytes, launches, sum(d[3] for d in ops) * 1e-6, ctx.peak)
