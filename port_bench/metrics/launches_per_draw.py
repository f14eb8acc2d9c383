"""``launches_per_draw``: device kernels, copies and sets in the traced
stretch, over the stretch's draws."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch_draws:
        return None
    return len(ctx.trace.device) / ctx.stretch_draws
