"""``mh_features_ms_per_draw``: device time of the program's
``vihmc.mh.features`` spans (the MH test's two f32 feature stacks; the fused
paired delta of ``pipelines/common.py``), summed over a detailed draw's
calls; the median over the window's unprofiled detailed draws (index 4 mod 8
in their segment)."""

from port_bench.harness.spans import span_ms_per_draw


def read(ctx):
    return span_ms_per_draw(ctx, "vihmc.mh.features")
