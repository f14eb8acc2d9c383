"""``boundary_idle_ms``: the median, over the window's segment boundaries
(the one that opens it included) with no profiled draw on either side, of
the device time from the event at a segment's end to the next segment's
first draw-start event (the program's ``vihmc.draw`` spans). The stream holds
nothing queued in between: it covers the host copy (``vihmc.transfer``),
``progress`` and the restart. A traced run's window holds about three
segments, the middle one profiled, so its reading is the opening boundary's."""

from port_bench.harness.spans import NS_PER_MS, median, window_draws


def read(ctx):
    draws = [d for d, _ in window_draws(ctx, before=1)]
    gaps = []
    for a, b in zip(draws, draws[1:]):
        if b["segment"] != a["segment"] + 1 or a["profiled"] or b["profiled"]:
            continue
        if a["dev_t1"] is not None and b["dev_t0"] is not None:
            gaps.append((b["dev_t0"] - a["dev_t1"]) / NS_PER_MS)
    return median(gaps)
