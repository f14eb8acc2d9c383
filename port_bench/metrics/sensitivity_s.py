"""``sensitivity_s``: host clock around the set-up's sensitivity stage (the
probe estimator of ``sensitivity/scores.py`` over the sampled functions),
ending in a synchronize. An untimed forward and VJP of a row batch of the
estimator's size runs before it (phase ``first_pass_s``), so the process's
first-use costs at those shapes fall outside and the probes' work is left."""


def read(ctx):
    return ctx.phases.get("sensitivity_s")
