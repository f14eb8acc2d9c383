"""``lanczos_s``: host clock around ``lowrank_metric`` with no cache file,
ending in a synchronize (the set-up's Lanczos metric)."""


def read(ctx):
    return ctx.phases.get("lanczos_s")
