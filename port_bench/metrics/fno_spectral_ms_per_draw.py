"""``fno_spectral_ms_per_draw``: device time of the program's
``vihmc.fno.spectral`` and ``vihmc.fno.spectral.bwd`` spans (the FNO2d's
spectral convolutions, forward and backward, in the trajectory field;
``models/fno.py``), summed over a detailed draw; the median over the window's
unprofiled detailed draws."""

from port_bench.harness.spans import span_ms_per_draw


def read(ctx):
    fwd = span_ms_per_draw(ctx, "vihmc.fno.spectral")
    bwd = span_ms_per_draw(ctx, "vihmc.fno.spectral.bwd")
    return None if fwd is None or bwd is None else fwd + bwd
