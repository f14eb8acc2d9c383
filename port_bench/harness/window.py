"""The measured window: the program's segmented sampler, driven from its
``progress`` callback, and the records the comparison reads.

``sample_chains_resumable`` runs the set-up burn (``burn_segments``
segments) and then the window in ONE call, so the adaptation and the chains
carry through: the window opens at the burn's last segment boundary and
closes at the first boundary after ``seconds`` (and after the traced stretch,
if any); the callback raises :class:`WindowClosed` there, after a
``torch.cuda.synchronize()``. Inside the window a seeded sample of the
calls of the field, the MH test and the density, and of the segment-end
states, is kept for the comparison (references to the tensors the program
made; nothing is copied).
"""

from __future__ import annotations

import contextlib
import random
import resource
import time

import torch


class WindowClosed(Exception):
    pass


class Reservoir:
    """A uniform sample of ``k`` of the items offered (reservoir sampling)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, make):
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = make()


class Recorder:
    """Wraps the callables handed to the sampler: a profiler span around each
    call when ``spans``, and, while ``active``, a seeded sample of calls."""

    def __init__(self, rng: random.Random, k: int, spans: bool):
        self.active, self.spans = False, spans
        self.field, self.delta, self.density = (Reservoir(k, rng) for _ in range(3))

    def span(self, name):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def wrap_density(self, fn):
        def density(q, aux):
            with self.span("density"):
                lp = fn(q, aux)
            if self.active:
                self.density.offer(lambda: (q, aux, lp))
            return lp
        return density

    def wrap_field(self, fn):
        if fn is None:
            return None

        def trajectory_field(q, aux):
            with self.span("trajectory_field"):
                g = fn(q, aux)
            if self.active:
                self.field.offer(lambda: (q, aux, g))
            return g
        return trajectory_field

    def wrap_delta(self, fn):
        if fn is None:
            return None

        def mh_test(q1, q0, aux):
            with self.span("mh_test"):
                dlp, lp1 = fn(q1, q0, aux)
            if self.active:
                self.delta.offer(lambda: (q1, q0, aux, dlp, lp1))
            return dlp, lp1
        return mh_test


class Tracer:
    """``torch.profiler`` over window segments ``[start, start + n)``: the
    stretch is marked by a ``stretch`` span, each segment by a ``segment``
    span; the trace goes to ``path`` once the window has closed."""

    def __init__(self, start: int, n: int, sync):
        self.start, self.n, self.sync = start, n, sync
        self.prof, self.stretch, self.seg_span = None, None, None
        self.done, self.draws = False, 0

    def boundary(self, k: int, segment: int):
        """Called at the end of window segment ``k`` (1-based; 0 = the
        window's start), after the sync."""
        if self.seg_span is not None:
            self.seg_span.__exit__(None, None, None)
            self.seg_span = None
        if k == self.start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.sync()
            self.stretch = torch.profiler.record_function("stretch")
            self.stretch.__enter__()
        elif self.prof is not None and not self.done and k == self.start + self.n:
            self.stretch.__exit__(None, None, None)
            self.prof.stop()
            self.done = True
            self.draws = self.n * segment
        if self.prof is not None and not self.done:
            self.seg_span = torch.profiler.record_function("segment")
            self.seg_span.__enter__()

    def export(self, path: str):
        self.prof.export_chrome_trace(path)


class Window:
    """The ``progress`` callback that opens and closes the window."""

    def __init__(self, seconds: float, burn_segments: int, segment: int, recorder: Recorder,
                 rng: random.Random, sync, tracer: Tracer | None = None, k_states: int = 3):
        self.seconds, self.burn, self.segment = seconds, burn_segments, segment
        self.recorder, self.sync, self.tracer = recorder, sync, tracer
        self.states = Reservoir(k_states, rng)
        self.t0 = self.t1 = None
        self.setup_rusage = None
        self.segments = 0
        self.start_position = self.last = None
        self.bad = []
        self.tracer_s = 0.0
        # (wall, traced) of each window segment, the profiler's start and stop left out
        self.seg_walls = []
        self._prev = None

    def __call__(self, done: int, n_segments: int, state):
        self.sync()
        now = time.perf_counter()
        if done == self.burn:
            self.t0 = now
            # the set-up's CPU time and involuntary context switches: a set-up
            # whose wall outgrows its CPU time waited for the shared host
            self.setup_rusage = resource.getrusage(resource.RUSAGE_SELF)
            self.start_position = state.position
            self.recorder.active = True
            self._prev = (now, self.tracer_s)
            if self.tracer is not None:
                t = time.perf_counter()
                self.tracer.boundary(0, self.segment)
                self.tracer_s += time.perf_counter() - t
            return
        if done < self.burn:
            return
        self.segments += 1
        traced = self.tracer is not None and self.tracer.prof is not None \
            and not self.tracer.done
        self.seg_walls.append((now - self._prev[0] - (self.tracer_s - self._prev[1]), traced))
        self._prev = (now, self.tracer_s)
        finite = torch.isfinite(state.position).all(-1) & torch.isfinite(state.log_prob)
        self.bad.append((~finite).sum())
        self.states.offer(lambda: (state.position, state.aux, state.log_prob, state.grad))
        self.last = state
        if self.tracer is not None:
            t = time.perf_counter()
            self.tracer.boundary(self.segments, self.segment)
            self.tracer_s += time.perf_counter() - t
        if (self.tracer is None or self.tracer.done) and now - self.t0 >= self.seconds:
            self.t1 = time.perf_counter()
            self.recorder.active = False
            raise WindowClosed

    @property
    def draws(self) -> int:
        return self.segments * self.segment

    @property
    def wall_s(self) -> float:
        """The window's wall, less the profiler's own start and stop."""
        return self.t1 - self.t0 - self.tracer_s

    @property
    def untraced_draws(self) -> int:
        return sum(1 for _, traced in self.seg_walls if not traced) * self.segment

    @property
    def untraced_wall_s(self) -> float:
        """The wall of the window's segments that ran without the profiler."""
        return sum(w for w, traced in self.seg_walls if not traced)

    def failed_chain_draws(self) -> int:
        """Chain-draws of the window whose chain state is not finite at the
        end of its segment (a state never turns finite again)."""
        return int(sum(int(b) for b in self.bad)) * self.segment
