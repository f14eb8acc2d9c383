"""``fno_mh_ms_per_draw``: device time of the program's ``vihmc.fno.density``
spans (the MH test's IEEE-f32 forwards of both endpoints and their float64
sums; ``pipelines/common.py``), summed over a detailed draw; the median over
the window's unprofiled detailed draws."""

from port_bench.harness.spans import span_ms_per_draw


def read(ctx):
    return span_ms_per_draw(ctx, "vihmc.fno.density")
