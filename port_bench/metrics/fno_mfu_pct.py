"""``fno_mfu_pct``: the FLOPs of one draw of every chain, the matmuls counted by
``torch.utils.flop_counter`` over the plain reference's transition at the
cell's shapes (on meta tensors; the complex mode mixing as real products) plus
the transforms at ``2.5 N log2 N`` each (``harness/fno_arith.py``), which the
counter does not see, times the draws of the window's segments that ran
without the profiler, over their wall, against the card's published bf16
peak."""

from port_bench.harness.arith import mfu_pct
from port_bench.harness.fno_arith import fft_flops_per_draw


def read(ctx):
    if ctx.peak is None or not ctx.flops_per_draw or not ctx.untraced_draws:
        return None
    flops = ctx.flops_per_draw + fft_flops_per_draw(ctx.shapes)
    return mfu_pct(flops, ctx.untraced_draws, ctx.untraced_wall_s, ctx.peak)
