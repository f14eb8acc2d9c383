"""``mfu_pct``: the matmul FLOPs of one draw of every chain, counted by
``torch.utils.flop_counter`` over the plain reference's transition at the
cell's shapes (on meta tensors), times the draws of the window's segments
that ran without the profiler, over their wall, against the card's
published bf16 peak."""

from port_bench.harness.arith import mfu_pct


def read(ctx):
    if ctx.peak is None or not ctx.flops_per_draw or not ctx.untraced_draws:
        return None
    return mfu_pct(ctx.flops_per_draw, ctx.untraced_draws, ctx.untraced_wall_s, ctx.peak)
