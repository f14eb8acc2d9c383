"""``fno_pointwise_ms_per_draw``: device time of the program's
``vihmc.fno.pointwise`` spans (the FNO2d's lift, 1x1 convolutions, GELU,
projection and padding, forward and backward, in the trajectory field;
``models/fno.py``), summed over a detailed draw; the median over the window's
unprofiled detailed draws."""

from port_bench.harness.spans import span_ms_per_draw


def read(ctx):
    return span_ms_per_draw(ctx, "vihmc.fno.pointwise")
