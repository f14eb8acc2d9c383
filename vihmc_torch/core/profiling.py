"""Phase timers, device traces, sampler throughput, model-FLOP counts, and
the spans and counters of the sampling path.

Counterpart of ``vihmc_tpu/core/profiling.py`` (:17-90): :class:`Timer`,
:func:`device_trace` (``torch.profiler`` to a Chrome trace in place of
``jax.profiler``), :func:`sampler_throughput` and :class:`ProgressPrinter`.
:func:`count_flops` is the port's model-FLOP count of a computation: the
matmuls torch issues, each counted from its shapes
(``torch.utils.flop_counter``), plus the products of the port's CUDA
kernels that ran in it, which torch does not see (each kernel wrapper adds
its products' FLOPs to the counter ``kernel.flops`` where it launches).

The span recorder (:class:`SpanRecorder`; the process's one is
:data:`RECORDER`, driven by :func:`span`, :func:`detail_span`, :func:`count`
and the sampler's hooks) times every layer of the sampling path where its
work happens; each layer names its own spans (``vihmc.<layer>``, listed in
the README) and counters. :func:`span` opens a set-up or segment span,
:func:`detail_span` a per-draw span (the trajectory field's and the MH
test's layers). A record holds the name, an id, the parent's id, the draw id
(the draw's global index), the segment, the rank (in a process group), the
host start and end (``perf_counter_ns``), the device start and end on the
same clock, and whether a ``torch.profiler`` session was active at its
start.

Device stamps come from CUDA events on the sampler's stream, mapped onto the
host clock by an anchor taken after each segment's host copy (the stream is
drained there: record an event, synchronize it, read the clock) and read once
the next segment's first draw is queued, so the reading overlaps the device's
work; on the CPU the work is synchronous and the device stamps are the host
stamps. No span adds a host sync inside a draw. What is recorded, by default: every draw's
span with one event at its start (its device time runs to the next draw's
start, or to the event at the segment's end); the per-draw spans, each with an
event pair, on the draws whose index in the segment is ``DETAIL_AT`` mod
``DETAIL_EVERY``, and in a segment of ``DETAIL_AT`` draws or fewer on its last
(so never the first after a boundary); the set-up's spans on
the host clock, with an event pair on each outer one. While a profiler
session is active every span also opens ``torch.profiler.record_function``
under its name, so it lands in the device trace, and per-draw spans are
recorded outside a draw too (the warm start calls the same field). After
:func:`disable` a span is a shared null context; counters always count.
Records stay in memory (rings of the last ``RING_DRAWS`` draws, their
segments and the set-up) until :func:`records` or :func:`export_chrome`
reads them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import os
import sys
import time
from typing import Callable

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


class Timer:
    """Phase wall-clock timer: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self.start = time.perf_counter()
        self.elapsed = None
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (the CPU, and the card when
    there is one) and write ``<log_dir>/trace.json``, a Chrome trace; yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sampler_throughput(result, elapsed_s: float, num_leapfrog: int, ess=None) -> dict:
    """Throughput counters of a :class:`~vihmc_torch.hmc.kernel.SampleResult`
    (and a precomputed ESS): draws and leapfrog gradients per second."""
    samples = np.asarray(result.samples)
    if samples.ndim == 2:
        samples = samples[None]
    c, s, _ = samples.shape
    out = {
        "chains": c,
        "draws_per_chain": s,
        "samples_per_s": c * s / elapsed_s,
        "leapfrog_grads_per_s": c * s * (num_leapfrog + 1) / elapsed_s,
        "acceptance_rate": float(np.asarray(result.acceptance_rate)),
        "divergences": int(np.asarray(result.num_divergent)),
        "elapsed_s": elapsed_s,
    }
    if ess is not None:
        out["ess_median"] = float(np.median(np.asarray(ess)))
        out["ess_per_s"] = out["ess_median"] / elapsed_s
    return out


class ProgressPrinter:
    """Segment-level progress line (draws done, draws/s, segment): the
    ``progress`` callback of ``sample_chains_resumable``."""

    def __init__(self, total_draws: int, every: int = 1, stream=None):
        self.total = total_draws
        self.every = every
        self.stream = stream or sys.stderr
        self.t0 = time.perf_counter()

    def __call__(self, seg_done: int, n_segments: int, state):
        if seg_done % self.every and seg_done != n_segments:
            return
        done = int(self.total * seg_done / n_segments)
        rate = done / max(time.perf_counter() - self.t0, 1e-9)
        self.stream.write(f"\r[sample] {done}/{self.total} draws  {rate:8.1f} draws/s  "
                          f"segment {seg_done}/{n_segments}")
        if seg_done == n_segments:
            self.stream.write("\n")
        self.stream.flush()


def _product_flops(lead: int):
    """``FlopCounterMode`` formula of a (batched) matrix product whose two
    operands follow ``lead`` other arguments: 2 per multiply-add. It takes
    the ``out_dtype`` overloads (bf16 operands, f32 result) too, whose extra
    argument torch's own formulas mistake for the output's shape."""
    def formula(*shapes, out_shape=None, **kwargs):
        a, b = shapes[lead], shapes[lead + 1]
        return 2 * math.prod(a) * b[-1]
    return formula


def count_flops(fn: Callable, *args, **kwargs):
    """``(flops, fn's result)``: the matmul FLOPs of one call of ``fn``
    (2 per multiply-add, counted from the shapes of the matmuls torch
    issues) plus those of the port's kernels it launched."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    products = {aten.mm: _product_flops(0), aten.bmm: _product_flops(0),
                aten.addmm: _product_flops(1), aten.baddbmm: _product_flops(1)}
    k0 = counter("kernel.flops")
    with FlopCounterMode(display=False, custom_mapping=products) as mode:
        out = fn(*args, **kwargs)
    return int(mode.get_total_flops()) + counter("kernel.flops") - k0, out


# ---------------------------------------------------------------------------
# Spans and counters of the sampling path
# ---------------------------------------------------------------------------

#: draws (with their spans and segments) the rings keep
RING_DRAWS = 4096
#: set-up records kept: warm-start steps, Lanczos HVPs, outer spans
RING_SETUP = 8192
#: the per-draw spans are recorded on draws whose index in the segment is
#: ``DETAIL_AT`` mod ``DETAIL_EVERY`` (a shorter segment: its last draw but the first)
DETAIL_EVERY, DETAIL_AT = 8, 4
SEGMENT_SPANS = frozenset({"vihmc.segment", "vihmc.transfer", "vihmc.progress"})

_NULL = contextlib.nullcontext()


def _profiler_on() -> bool:
    return _autograd_profiler._is_profiler_enabled


class _Span:
    """One recorded span: ``mode`` "host" copies the host stamps into the
    device's (the CPU), "event" records an event pair on ``stream``, None
    leaves the device stamps empty."""

    __slots__ = ("rec", "r", "mode", "stream", "rf", "ev0")

    def __init__(self, rec, r, mode, stream):
        self.rec, self.r, self.mode, self.stream = rec, r, mode, stream
        self.rf = self.ev0 = None

    def __enter__(self):
        rec, r = self.rec, self.r
        stack = rec._stack
        r["parent"] = stack[-1]["id"] if stack else None
        stack.append(r)
        r["host_t0"] = time.perf_counter_ns()
        if r["profiled"]:
            self.rf = torch.profiler.record_function(r["name"])
            self.rf.__enter__()
        if self.mode == "event":
            self.ev0 = rec._event(self.stream)
        return self

    def __exit__(self, *exc):
        rec, r = self.rec, self.r
        ev1 = rec._event(self.stream) if self.mode == "event" else None
        if self.rf is not None:
            self.rf.__exit__(*exc)
        r["host_t1"] = time.perf_counter_ns()
        rec._stack.pop()
        if self.mode == "host":
            r["dev_t0"], r["dev_t1"] = r["host_t0"], r["host_t1"]
        elif ev1 is not None:
            rec._pending += ((r, "dev_t0", self.ev0, self.stream),
                             (r, "dev_t1", ev1, self.stream))
        rec._store(r)
        return False


class _Draw(_Span):
    """The draw's span: one event at its start; its device end is the next
    draw's start or the segment's end, filled in at the anchor."""

    __slots__ = ("index", "size")

    def __init__(self, rec, r, mode, stream, index, size=None):
        super().__init__(rec, r, mode, stream)
        self.index, self.size = index, size

    def __enter__(self):
        rec = self.rec
        rec._draw = [self.r]
        rec._sampled = detailed(self.index, self.size)
        super().__enter__()
        if self.mode == "event":
            rec._pending.append((self.r, "dev_t0", self.ev0, self.stream))
        elif self.mode == "host":
            self.r["dev_t0"] = self.r["host_t0"]
        return self

    def __exit__(self, *exc):
        rec, r = self.rec, self.r
        if self.rf is not None:
            self.rf.__exit__(*exc)
        r["host_t1"] = time.perf_counter_ns()
        rec._stack.pop()
        rec.draws.append(rec._draw)
        rec._seg_draws.append(r)
        rec._draw, rec._sampled = None, False
        if rec._anchored:
            # the last segment's events, read once this draw is queued behind
            # them: the reading overlaps the device's work, not its idle
            rec._flush()
        return False


def detailed(index: int, size=None) -> bool:
    """Whether draw ``index`` of a segment of ``size`` draws records the
    per-draw spans: index ``DETAIL_AT`` mod ``DETAIL_EVERY``, or, in a segment
    too short to reach it, the last draw unless it is the first."""
    if index % DETAIL_EVERY == DETAIL_AT:
        return True
    return size is not None and 0 < index == size - 1 < DETAIL_AT


def _fill_draws(seg: dict, draws: list):
    for a, b in zip(draws, draws[1:]):
        a["dev_t1"] = b["dev_t0"]
    if draws:
        draws[-1]["dev_t1"] = seg["dev_t1"]
        seg["dev_t0"] = draws[0]["dev_t0"]


class SpanRecorder:
    """Spans and counters of the sampling path (module doc). ``enabled``
    False makes every span the shared null context."""

    def __init__(self):
        self.enabled = True
        self.counters = {}
        self._pool = []
        self.reset()

    def reset(self):
        """Drop every record and counter (the event pool stays)."""
        self.draws = collections.deque(maxlen=RING_DRAWS)
        self.segments = collections.deque(maxlen=3 * RING_DRAWS)
        self.setup = collections.deque(maxlen=RING_SETUP)
        self.counters.clear()
        #: (perf_counter_ns, time_ns) read together: the host clock onto the
        #: profiler's (a Chrome trace's ``ts`` + ``baseTimeNanoseconds``/1000
        #: reads as ``time_ns()``/1000)
        self.clock = (time.perf_counter_ns(), time.time_ns())
        self._ids = itertools.count()
        self._stack, self._pending, self._anchored, self._seg_draws = [], [], [], []
        self._draw, self._sampled = None, False
        self._seg = None
        self._mode, self._stream, self._rank = None, None, None

    # -- recording -----------------------------------------------------------

    def _record(self, name: str, draw=None) -> dict:
        return {"name": name, "id": next(self._ids), "parent": None, "draw": draw,
                "segment": None if self._seg is None else self._seg["segment"],
                "rank": self._rank, "host_t0": None, "host_t1": None, "dev_t0": None,
                "dev_t1": None, "profiled": _profiler_on()}

    def _event(self, stream):
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _store(self, r: dict):
        if self._draw is not None and r["draw"] is not None:
            self._draw.append(r)
        elif r["name"] in SEGMENT_SPANS:
            self.segments.append(r)
        else:
            self.setup.append(r)

    @staticmethod
    def _device_mode(device):
        if device is None:
            return None, None
        device = torch.device(device)
        if device.type == "cuda":
            return "event", torch.cuda.current_stream(device)
        return ("host", None) if device.type == "cpu" else (None, None)

    def span(self, name: str, device=None):
        """A set-up or segment span named ``name``. Inside a run's segment the
        device is the sampler's; outside, ``device`` (None: host stamps only)
        gives the outer set-up spans their event pair."""
        if not self.enabled:
            return _NULL
        if self._seg is not None:
            mode, stream = ("host", None) if self._mode == "host" else (None, None)
        elif not self._stack:
            mode, stream = self._device_mode(device)
        else:
            mode, stream = None, None
        draw = self._draw
        return _Span(self, self._record(name, None if draw is None else draw[0]["draw"]),
                     mode, stream)

    def detail_span(self, name: str):
        """A per-draw span named ``name``: recorded with the sampler's device
        stamps on the draws :func:`detailed` picks, as a :meth:`span` anywhere
        while a profiler session is active, and else the shared null context."""
        draw = self._draw
        if self.enabled and draw is not None and self._sampled:
            return _Span(self, self._record(name, draw[0]["draw"]), self._mode, self._stream)
        return self.span(name) if _profiler_on() else _NULL

    @contextlib.contextmanager
    def _segment(self, segment: int, device):
        self._mode, self._stream = self._device_mode(device)
        dist = torch.distributed
        self._rank = (dist.get_rank() if dist.is_available() and dist.is_initialized()
                      else None)
        r = self._record("vihmc.segment")
        r["segment"] = segment
        self._seg, self._seg_draws = r, []
        try:
            with _Span(self, r, None, None):
                yield
        finally:
            self._seg, self._mode, self._stream = None, None, None

    def segment(self, segment: int, device):
        """The span of sampler segment ``segment`` on ``device``."""
        if not self.enabled:
            return _NULL
        return self._segment(segment, device)

    def draw(self, draw_id: int, index: int, size=None):
        """The span of one draw: ``draw_id`` its global index, ``index`` its
        place in the segment of ``size`` draws (which pick the detailed draws,
        :func:`detailed`)."""
        if not self.enabled or self._seg is None:
            return _NULL
        return _Draw(self, self._record("vihmc.draw", draw_id), self._mode, self._stream,
                     index, size)

    def segment_end(self):
        """Mark the end of the segment's last draw on the device (one event)."""
        seg = self._seg
        if not self.enabled or seg is None:
            return
        if self._mode == "event":
            self._pending.append((seg, "dev_t1", self._event(self._stream), self._stream))
        elif self._mode == "host":
            seg["dev_t1"] = time.perf_counter_ns()

    def _take_anchor(self, stream, seg=None, draws=()):
        """Record an event on ``stream``, wait for it and read the clock: the
        anchor of every pending event (the caller has drained the stream, or
        the wait does). They are mapped later, by :meth:`_flush`."""
        anchor = self._event(stream)
        anchor.synchronize()
        now = time.perf_counter_ns()
        self._anchored.append((anchor, now, self._pending, seg, draws))
        self._pending = []
        self.clock = (time.perf_counter_ns(), time.time_ns())

    def _flush(self):
        """Map the anchored events onto the host clock and fill the draws'
        device ends."""
        for anchor, now, pending, seg, draws in self._anchored:
            for r, key, ev, _ in pending:
                try:
                    r[key] = now - round(ev.elapsed_time(anchor) * 1e6)
                except RuntimeError:   # an event of another device
                    r[key] = None
                self._pool.append(ev)
            self._pool.append(anchor)
            if seg is not None:
                _fill_draws(seg, draws)
        self._anchored = []

    def anchor(self):
        """After the segment's host copy, where the stream is drained: the
        anchor of its events (read after the next draw is queued, or when the
        records are read); each draw's device end is the next draw's start,
        or the segment's end."""
        seg = self._seg
        if not self.enabled or seg is None:
            return
        if self._mode == "event":
            self._take_anchor(self._stream, seg, self._seg_draws)
        else:
            _fill_draws(seg, self._seg_draws)
            self.clock = (time.perf_counter_ns(), time.time_ns())
        self._seg_draws = []

    def count(self, name: str, n: int = 1):
        """Add ``n`` to counter ``name`` (counted also while disabled)."""
        self.counters[name] = self.counters.get(name, 0) + n

    # -- reading -------------------------------------------------------------

    def records(self) -> list:
        """Copies of every kept record, by id (start order)."""
        if self._pending and self._seg is None:
            self._take_anchor(self._pending[0][3])
        if self._anchored:
            self._flush()
        out = list(self.setup) + list(self.segments)
        for d in self.draws:
            out.extend(d)
        return [dict(r) for r in sorted(out, key=lambda r: r["id"])]

    def to_trace_us(self, ns: int) -> float:
        """A host-clock stamp in microseconds on the profiler's clock."""
        perf, wall = self.clock
        return (ns - perf + wall) / 1000.0

    def export_chrome(self, path: str):
        """Write the records as a Chrome trace on the profiler's clock: the
        host spans on one track, the device intervals on another, the
        counters as ``vihmc_counters``. Opens in Perfetto or chrome://tracing."""
        events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": name}}
                  for pid, name in ((0, "vihmc host"), (1, "vihmc device"))]
        for r in self.records():
            args = {k: r[k] for k in ("id", "parent", "draw", "segment", "rank", "profiled")}
            for pid, a, b in ((0, r["host_t0"], r["host_t1"]), (1, r["dev_t0"], r["dev_t1"])):
                if a is not None and b is not None:
                    events.append({"ph": "X", "cat": "vihmc", "name": r["name"], "pid": pid,
                                   "tid": 0, "ts": self.to_trace_us(a),
                                   "dur": (b - a) / 1000.0, "args": args})
        if self.counters:
            events.append({"ph": "C", "name": "vihmc counters", "pid": 0, "tid": 0,
                           "ts": self.to_trace_us(time.perf_counter_ns()),
                           "args": dict(self.counters)})
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "vihmc_counters": dict(self.counters)}, f)


#: the process's recorder, which the module-level functions drive
RECORDER = SpanRecorder()


def span(name: str, device=None):
    """``with span("vihmc.<layer>"): ...`` on :data:`RECORDER`."""
    return RECORDER.span(name, device)


def detail_span(name: str):
    """``with detail_span("vihmc.<layer>"): ...``, a per-draw span, on :data:`RECORDER`."""
    return RECORDER.detail_span(name)


def count(name: str, n: int = 1):
    RECORDER.count(name, n)


def disable():
    RECORDER.enabled = False


def enable():
    RECORDER.enabled = True


def reset():
    RECORDER.reset()


def records() -> list:
    return RECORDER.records()


def counters() -> dict:
    return dict(RECORDER.counters)


def counter(name: str) -> int:
    """Counter ``name``'s value (0 before its first count)."""
    return RECORDER.counters.get(name, 0)


def export_chrome(path: str):
    RECORDER.export_chrome(path)
