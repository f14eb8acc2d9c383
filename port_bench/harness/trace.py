"""Reduce a ``torch.profiler`` Chrome trace of the traced stretch.

Device operations are the events of categories ``kernel``, ``gpu_memcpy``
and ``gpu_memset``; host launches are ``cuda_runtime`` / ``cuda_driver``
events, tied to the operation they launched by ``args.correlation``; the
harness's spans are ``user_annotation`` events. Times are microseconds on
the trace's clock. Only what lies inside the ``stretch`` span counts.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPANS = ("segment", "density", "trajectory_field", "mh_test")


class Trace:
    def __init__(self, events: list):
        self.device, self.launch, self.spans = [], {}, []
        stretch = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((cat, e.get("name", ""), ts, dur, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = ts
            elif cat == "user_annotation":
                if e.get("name") == "stretch":
                    stretch = (ts, ts + dur)
                elif e.get("name") in SPANS:
                    self.spans.append((e["name"], ts, ts + dur))
        if stretch is None:
            raise ValueError("the trace has no 'stretch' span")
        self.t0, self.t1 = stretch
        self.device = [d for d in self.device if self.t0 <= d[2] < self.t1]
        self.device.sort(key=lambda d: d[2])

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the stretch."""
        out = []
        for _, _, ts, dur, _ in self.device:
            a, b = ts, min(ts + dur, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def launched_in(self, span_name: str) -> list:
        """Device operations whose host launch lies inside a ``span_name``
        span (on any host thread: autograd's backward launches from its own)."""
        spans = sorted((a, b) for n, a, b in self.spans if n == span_name)
        if not spans:
            return []
        starts = [a for a, _ in spans]
        import bisect
        out = []
        for d in self.device:
            t = self.launch.get(d[4])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(d)
        return out

    def host_label(self, t: float) -> str:
        """The innermost harness span open on the host at ``t``."""
        best = None
        for n, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (n, b - a)
        return best[0] if best else "outside the harness's spans"

    def breakdown(self, top: int = 10) -> dict:
        """``device_ops``: the device operations with the most time, by name;
        ``idle_gaps``: the idle time between them, summed by the harness span
        open on the host at each gap's middle. Seconds."""
        by_name = {}
        for _, name, _, dur, _ in self.device:
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + dur * 1e-6
        gaps, prev = {}, self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                label = self.host_label(0.5 * (a + prev))
                gaps[label] = gaps.get(label, 0.0) + (a - prev) * 1e-6
            prev = max(prev, b)
        order = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}
