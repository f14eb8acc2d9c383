"""``warm_start_s``: host clock around ``conditional_warm_start``, ending in a
synchronize (the set-up's warm start)."""


def read(ctx):
    return ctx.phases.get("warm_start_s")
