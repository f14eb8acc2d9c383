"""``draw_ms_p95``: the 95th percentile, over the window's unprofiled draws,
of each draw's device time: from the event at its start (the program's
``vihmc.draw`` span in ``chains/resume.run_segments``) to the next draw's
start, or to the event at its segment's end."""

from port_bench.harness.spans import device_ms, p95, window_draws


def read(ctx):
    times = [device_ms(d) for d, _ in window_draws(ctx) if not d["profiled"]]
    return p95([t for t in times if t is not None])
