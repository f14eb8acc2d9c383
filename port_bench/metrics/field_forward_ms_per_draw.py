"""``field_forward_ms_per_draw``: device time of the program's
``vihmc.field.forward`` spans (the Gram field's unravel and feature stacks;
``ops/gram_merge.py``), summed over a detailed draw's calls; the median over
the window's unprofiled detailed draws (index 4 mod 8 in their segment)."""

from port_bench.harness.spans import span_ms_per_draw


def read(ctx):
    return span_ms_per_draw(ctx, "vihmc.field.forward")
