"""``field_ms_per_draw``: device time of the operations launched inside the
harness's ``trajectory_field`` span (tied by correlation id), per draw."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch_draws:
        return None
    ops = ctx.trace.launched_in("trajectory_field")
    if not ops:
        return None
    return sum(d[3] for d in ops) * 1e-3 / ctx.stretch_draws
