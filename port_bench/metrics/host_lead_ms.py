"""``host_lead_ms``: the median, over the window's unprofiled draws other than
each segment's first, of how far the host runs ahead of the device: the time
the stream reached a draw's start event less the time the host recorded it
(the program's ``vihmc.draw`` span), both on the host clock. Near 0 the device
waits for the host's dispatch."""

from port_bench.harness.spans import NS_PER_MS, median, window_draws


def read(ctx):
    draws = [d for d, _ in window_draws(ctx)]
    leads = [(b["dev_t0"] - b["host_t0"]) / NS_PER_MS
             for a, b in zip(draws, draws[1:])
             if a["segment"] == b["segment"] and not b["profiled"]
             and b["dev_t0"] is not None]
    return median(leads)
