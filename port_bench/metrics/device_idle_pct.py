"""``device_idle_pct``: 100 x (1 - the device's busy time per draw over the
wall per draw). The busy time is the union of the device operations'
intervals in the traced stretch; the wall is that of the window's segments
that ran without the profiler, whose host-side recording slows the traced
stretch's dispatch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not ctx.stretch_draws \
            or not ctx.untraced_draws:
        return None
    busy = ctx.trace.busy_s() / ctx.stretch_draws
    return 100.0 * (1.0 - busy / (ctx.untraced_wall_s / ctx.untraced_draws))
