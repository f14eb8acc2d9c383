"""The port's span recorder (``vihmc_torch/core/profiling.py``) on the CPU.

The sampler's spans and counters on a small Gaussian target through
``sample_chains_resumable``: one ``vihmc.draw`` per draw, the segment's
``vihmc.transfer`` and ``vihmc.progress``, the detailed spans on draws
4 mod 8 alone, nesting by parent id, counters, outputs bit-equal with the
recorder off, the profiler's trace on the recorder's clock, no
``record_function`` without a profiler; the operator row's Gram-field, MH,
warm-start and Lanczos spans through ``bench_operator``, and its
``seg_wall_s`` against a progress timer.
"""

from __future__ import annotations

import ast
import glob
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from vihmc_torch import bench_operator as bop
from vihmc_torch.chains.resume import sample_chains_resumable
from vihmc_torch.core import profiling
from vihmc_torch.hmc.kernel import HMCConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the names the benchmark harness's trace reader keeps (port_bench/harness/trace.py)
HARNESS_SPANS = {"segment", "density", "trajectory_field", "mh_test", "stretch"}
C, D = 3, 5


@pytest.fixture(autouse=True)
def fresh_recorder():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.enable()
    profiling.reset()
    yield
    profiling.enable()
    profiling.reset()
    torch.set_num_threads(prev)


def _target(calls=None):
    def log_prob(q, aux):
        return -0.5 * (q * q).sum(-1)

    def grad_fn(q, aux):
        if calls is not None:
            calls.append(1)
        return -q

    def delta_fn(q1, q0, aux):
        lp1 = log_prob(q1, aux)
        return lp1 - log_prob(q0, aux), lp1

    return log_prob, grad_fn, delta_fn


def _sample(n=16, segment=8, paired=True, progress=None, calls=None, seed=3):
    log_prob, grad_fn, delta_fn = _target(calls)
    cfg = HMCConfig(num_samples=n, num_leapfrog=3, step_size=0.3, burn=4)
    q0 = torch.linspace(-1.0, 1.0, C * D).reshape(C, D)
    return sample_chains_resumable(log_prob, q0, cfg, segment, 1.0, torch.zeros(D),
                                   grad_fn=grad_fn, delta_fn=delta_fn if paired else None,
                                   seed=seed, progress=progress)


def _by_name(recs, name):
    return [r for r in recs if r["name"] == name]


def test_disabled_records_nothing_and_returns_the_null_context():
    profiling.disable()
    assert profiling.detail_span("vihmc.field") is profiling.span("vihmc.warm_start", "cpu")
    assert profiling.RECORDER.draw(0, 4) is profiling.detail_span("vihmc.mh")
    _sample(n=16, segment=8)
    assert profiling.records() == []
    c = profiling.counters()
    assert c["sampler.draws"] == 16 and c["sampler.segments"] == 2


def test_spans_nest_and_share_the_draw_id():
    _sample(n=16, segment=8)
    recs = profiling.records()
    by_id = {r["id"]: r for r in recs}
    parent = {"vihmc.draw": "vihmc.segment", "vihmc.transfer": "vihmc.segment",
              "vihmc.progress": "vihmc.segment", "vihmc.field": "vihmc.draw",
              "vihmc.mh": "vihmc.draw"}
    for r in recs:
        if r["name"] in parent:
            p = by_id[r["parent"]]
            assert p["name"] == parent[r["name"]], r
            assert p["segment"] == r["segment"]
            if p["name"] == "vihmc.draw":
                assert r["draw"] == p["draw"] and p["id"] < r["id"]
                assert p["host_t0"] <= r["host_t0"] <= r["host_t1"] <= p["host_t1"]
        elif r["name"] == "vihmc.segment":
            assert r["parent"] is None and r["draw"] is None
    assert {r["name"] for r in recs} >= set(parent) | {"vihmc.segment", "vihmc.init_state"}


@pytest.mark.parametrize("n,segment", [(16, 8), (30, 10), (24, 24)])
@pytest.mark.parametrize("paired", [True, False])
def test_one_draw_span_per_draw_detail_on_draws_4_mod_8(n, segment, paired):
    calls = []
    _sample(n=n, segment=segment, paired=paired, calls=calls)
    recs = profiling.records()
    draws = _by_name(recs, "vihmc.draw")
    assert [r["draw"] for r in draws] == list(range(n))
    assert [r["segment"] for r in draws] == [i // segment for i in range(n)]
    n_seg = n // segment
    for name in ("vihmc.segment", "vihmc.transfer", "vihmc.progress"):
        assert [r["segment"] for r in _by_name(recs, name)] == list(range(n_seg))
    sampled = {i for i in range(n) if (i % segment) % 8 == 4}
    for name, per_draw in (("vihmc.field", 3), ("vihmc.mh", 1)):
        got = _by_name(recs, name)
        assert {r["draw"] for r in got} == sampled
        assert len(got) == per_draw * len(sampled)
    c = profiling.counters()
    assert c["sampler.draws"] == n and c["sampler.segments"] == n_seg
    # one field call in init_state, then L per draw
    assert c["field.calls"] == len(calls) - 1 == 3 * n
    assert c["mh.calls"] == n
    # unpaired: lp0 recomputed and lp1 at the proposal, every draw
    assert c["density.calls"] == 1 + (0 if paired else 2 * n)
    assert c["sampler.d2h_bytes"] > 0


def test_cpu_device_stamps_are_the_host_stamps():
    _sample(n=16, segment=8)
    recs = profiling.records()
    for r in _by_name(recs, "vihmc.field") + _by_name(recs, "vihmc.mh"):
        assert (r["dev_t0"], r["dev_t1"]) == (r["host_t0"], r["host_t1"])
    draws = _by_name(recs, "vihmc.draw")
    segs = {r["segment"]: r for r in _by_name(recs, "vihmc.segment")}
    for a, b in zip(draws, draws[1:]):
        assert a["dev_t0"] == a["host_t0"]
        want = b["dev_t0"] if a["segment"] == b["segment"] else segs[a["segment"]]["dev_t1"]
        assert a["dev_t1"] == want and a["dev_t1"] >= a["host_t1"]
    last = draws[-1]
    assert last["dev_t1"] == segs[last["segment"]]["dev_t1"]
    for s in segs.values():
        assert s["host_t0"] <= s["dev_t0"] <= s["dev_t1"] <= s["host_t1"]


def test_a_progress_that_raises_still_closes_its_spans():
    class Stop(Exception):
        pass

    def progress(done, n_segments, state):
        if done == 2:
            raise Stop

    with pytest.raises(Stop):
        _sample(n=32, segment=8, progress=progress)
    recs = profiling.records()
    prog = _by_name(recs, "vihmc.progress")
    assert len(prog) == 2 and all(r["host_t1"] is not None for r in prog)
    assert len(_by_name(recs, "vihmc.segment")) == 2
    rec = profiling.RECORDER
    assert rec._stack == [] and rec._seg is None and rec._draw is None
    _sample(n=8, segment=8)   # the recorder is usable after the exception
    assert _by_name(profiling.records(), "vihmc.draw")[-1]["parent"] is not None


@pytest.mark.parametrize("paired", [True, False])
def test_outputs_bit_equal_with_the_recorder_off_and_on(paired):
    profiling.disable()
    off = _sample(n=24, segment=8, paired=paired, seed=11)
    profiling.enable()
    on = _sample(n=24, segment=8, paired=paired, seed=11)
    assert len(_by_name(profiling.records(), "vihmc.draw")) == 24
    for a, b in ((off.samples, on.samples), (off.log_probs, on.log_probs),
                 (off.accepted, on.accepted), (off.step_sizes, on.step_sizes)):
        np.testing.assert_array_equal(a, b)
    for f in ("position", "log_prob", "grad"):
        assert torch.equal(getattr(off.final_state, f), getattr(on.final_state, f))


def test_spans_in_the_profiler_trace_lie_on_the_recorders_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sample(n=16, segment=8)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1000.0
    seen = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("vihmc."):
            seen.setdefault(e["name"], []).append((float(e["ts"]) + base_us, float(e["dur"])))
    recs = [r for r in profiling.records() if r["profiled"]]
    assert recs and all(r["name"] in seen for r in recs)
    to_us = profiling.RECORDER.to_trace_us
    for name, ranges in seen.items():
        mine = sorted((to_us(r["host_t0"]), to_us(r["host_t1"]))
                      for r in recs if r["name"] == name)
        assert len(mine) == len(ranges), name
        # the range opens after the host start and closes before the host end
        # (a preempted host thread only widens that): both within 1 ms
        for (t0, t1), (ts, dur) in zip(mine, sorted(ranges)):
            assert t0 - 1000.0 <= ts and ts + dur <= t1 + 1000.0, name
        offsets = [ts - t0 for (t0, _), (ts, _) in zip(mine, sorted(ranges))]
        assert abs(float(np.median(offsets))) < 1000.0, name
    # under a profiler the detailed spans are recorded on every draw
    assert {r["draw"] for r in _by_name(recs, "vihmc.field")} == set(range(16))


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _sample(n=16, segment=8)
    assert len(_by_name(profiling.records(), "vihmc.draw")) == 16
    assert not any(r["profiled"] for r in profiling.records())


def _span_literals():
    names = set()
    for path in glob.glob(os.path.join(ROOT, "vihmc_torch", "**", "*.py"), recursive=True):
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", None)) in ("span", "detail_span") \
                    and node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return names


def test_every_span_is_named_vihmc_and_none_is_the_harness_s():
    names = _span_literals() | set(profiling.SEGMENT_SPANS)
    assert {"vihmc.field", "vihmc.field.forward", "vihmc.mh", "vihmc.mh.paired_sums",
            "vihmc.fno.spectral", "vihmc.warm_start.step", "vihmc.lanczos.hvp",
            "vihmc.kernel_build", "vihmc.transfer"} <= names
    for n in names:
        assert n.startswith("vihmc.") and n not in HARNESS_SPANS, n


def test_the_rings_keep_the_last_draws(monkeypatch):
    monkeypatch.setattr(profiling, "RING_DRAWS", 10)
    profiling.reset()
    _sample(n=24, segment=8)
    draws = _by_name(profiling.records(), "vihmc.draw")
    assert [r["draw"] for r in draws] == list(range(14, 24))
    assert profiling.counters()["sampler.draws"] == 24


def test_export_chrome_writes_host_and_device_tracks_and_the_counters(tmp_path):
    _sample(n=16, segment=8)
    path = tmp_path / "spans" / "run.json"
    profiling.export_chrome(str(path))
    with open(path) as f:
        out = json.load(f)
    xs = [e for e in out["traceEvents"] if e["ph"] == "X"]
    host = [e for e in xs if e["pid"] == 0]
    dev = [e for e in xs if e["pid"] == 1]
    assert len(host) == len(profiling.records())
    assert sum(e["name"] == "vihmc.draw" for e in dev) == 16
    assert out["vihmc_counters"]["sampler.draws"] == 16
    assert any(e["ph"] == "C" for e in out["traceEvents"])
    r0 = profiling.records()[0]
    e0 = min(host, key=lambda e: e["args"]["id"])
    assert abs(e0["ts"] - profiling.RECORDER.to_trace_us(r0["host_t0"])) < 1e-3
    assert abs(e0["ts"] - time.time_ns() / 1000.0) < 600e6


class _FakeClock:
    """A ``perf_counter_ns``: each reading ``step_ns`` after the one before,
    whatever the host's load."""

    def __init__(self, step_ns: int):
        self.now, self.step_ns = 10 ** 15, step_ns

    def __call__(self):
        self.now += self.step_ns
        return self.now


def _on_fake_clock(monkeypatch, step_ns: int, *modules) -> _FakeClock:
    """Give ``modules``' ``time`` (``perf_counter_ns``, ``perf_counter``) one
    fake clock."""
    clock = _FakeClock(step_ns)
    fake = types.SimpleNamespace(perf_counter_ns=clock, perf_counter=lambda: clock() / 1e9,
                                 time_ns=time.time_ns)
    for m in modules:
        monkeypatch.setattr(m, "time", fake)
    return clock


def test_the_operator_row_s_layers_and_seg_wall_s(monkeypatch, tmp_path):
    """The quick operator row with a warm start and an uncached Lanczos metric:
    the Gram field's three spans under ``vihmc.field``, the fused MH test's two
    under ``vihmc.mh``, the set-up's spans and counters, and ``seg_wall_s``
    from the recorder against a progress timer's, both on one fake clock that
    steps a millisecond a reading: the second segment's equal, the first's
    longer by the three readings between (the timer starts one reading after
    the row; a segment ends two after its mark: the progress span's end, its
    own)."""
    monkeypatch.setattr(bop, "CACHE_DIR", str(tmp_path))
    clock = _on_fake_clock(monkeypatch, 1_000_000, profiling, bop)
    marks = []
    real = bop.sample_chains_resumable

    def timed(*args, **kw):
        t_ref = [clock()]
        marks.append([])

        def mark(seg_i, n_segs, state):
            now = clock()
            marks[-1].append(round((now - t_ref[0]) * 1e-6))
            t_ref[0] = now

        return real(*args, progress=mark, **kw)

    monkeypatch.setattr(bop, "sample_chains_resumable", timed)
    st, _ = bop.bench_operator(True, device="cpu", draws=24, burn=4, segment=12, coupled=True,
                               init_opt=5, lowrank_rank=2, lowrank_iters=6, keys=(2,))
    walls_ms = [round(w * 1e3) for w in st["seg_wall_s"]]
    assert len(walls_ms) == 2 and walls_ms[1] == marks[0][1] > 100
    assert walls_ms[0] - marks[0][0] == 3 and marks[0][0] > 100
    recs = profiling.records()
    by_id = {r["id"]: r for r in recs}
    for name, parent in (("vihmc.field.forward", "vihmc.field"),
                         ("vihmc.field.cotangents", "vihmc.field"),
                         ("vihmc.field.vjp", "vihmc.field"),
                         ("vihmc.mh.features", "vihmc.mh"),
                         ("vihmc.mh.paired_sums", "vihmc.mh"),
                         ("vihmc.warm_start.step", "vihmc.warm_start"),
                         ("vihmc.lanczos.hvp", "vihmc.lanczos")):
        got = _by_name(recs, name)
        assert got and all(by_id[r["parent"]]["name"] == parent for r in got), name
    # the detailed spans only inside the sampled draws (not the warm start's field calls)
    assert {r["draw"] for r in _by_name(recs, "vihmc.field.forward")} == {4, 16}
    c = profiling.counters()
    assert c["warm_start.steps"] == len(_by_name(recs, "vihmc.warm_start.step")) == 5
    assert c["lanczos.hvps"] == len(_by_name(recs, "vihmc.lanczos.hvp")) > 0
    for name in ("vihmc.warm_start", "vihmc.lanczos", "vihmc.init_state"):
        got = _by_name(recs, name)
        assert got and all(r["parent"] is None and r["draw"] is None for r in got), name
        assert all((r["dev_t0"], r["dev_t1"]) == (r["host_t0"], r["host_t1"]) for r in got)


class _StandInEvent:
    """A CUDA event on a stand-in device on the recorder's clock: the device
    reaches each event ``LAG_NS`` after the host's last reading; waiting on
    one drains the device, so an anchor is reached at the host's next
    reading."""

    LAG_NS = 3_000_000
    clock = None

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = self.clock.now + self.LAG_NS

    def synchronize(self):
        self.t = self.clock.now + self.clock.step_ns

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_the_event_path_maps_device_stamps_through_the_anchor(monkeypatch):
    """The card's path (events, pending until the segment's anchor) on the
    CPU with stand-in events on a fake clock: every device stamp is exactly
    its host stamp plus the device's lag (an end event is recorded one
    reading before the host's end), each draw runs to the next draw's
    start, and the events go back to the pool."""
    clock = _on_fake_clock(monkeypatch, 1_000, profiling)
    monkeypatch.setattr(_StandInEvent, "clock", clock)
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    monkeypatch.setattr(profiling.SpanRecorder, "_device_mode",
                        staticmethod(lambda device: ("event", "stream")))
    _sample(n=24, segment=12)
    recs = profiling.records()
    lag, end_lag = _StandInEvent.LAG_NS, _StandInEvent.LAG_NS - clock.step_ns
    draws = _by_name(recs, "vihmc.draw")
    assert len(draws) == 24
    for r in draws:
        assert r["dev_t0"] == r["host_t0"] + lag
    for a, b in zip(draws, draws[1:]):
        if a["segment"] == b["segment"]:
            assert a["dev_t1"] == b["dev_t0"]
    detail = _by_name(recs, "vihmc.field") + _by_name(recs, "vihmc.mh")
    assert {r["draw"] for r in detail} == {4, 16}
    for r in detail:
        assert r["dev_t0"] == r["host_t0"] + lag
        assert r["dev_t1"] == r["host_t1"] + end_lag
    for s in _by_name(recs, "vihmc.segment"):
        assert s["dev_t0"] is not None and s["dev_t1"] >= s["dev_t0"]
    rec = profiling.RECORDER
    assert rec._pending == [] and len(rec._pool) > 0
    # set-up spans outside a run: an event pair, resolved when read
    with profiling.span("vihmc.warm_start", "cuda"):
        pass
    (w,) = _by_name(profiling.records(), "vihmc.warm_start")
    assert (w["dev_t0"], w["dev_t1"]) == (w["host_t0"] + lag, w["host_t1"] + end_lag)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_cotangent_span_wraps_the_step_and_the_cpu_counts_no_merged_route(monkeypatch,
                                                                              dtype):
    """A Gram field call on the CPU (under a profiler, so the detailed spans
    record outside a draw): ``vihmc.field.cotangents`` opens after the
    forward, closes before the VJP and holds the whole cotangent step, which
    returns the compute dtype the VJP takes; the CPU has no bf16 -> f32
    product, so ``field.cotangents.merged`` stays 0 (bf16 stacks upcast)."""
    from torch.profiler import ProfilerActivity, profile

    from vihmc_torch.models.deeponet import DeepONetConfig
    from vihmc_torch.ops import gram_merge

    dt = getattr(torch, dtype)
    cfg = DeepONetConfig(in_branch=6, in_trunk=5, width_branch=9, width_trunk=9,
                         depth_branch=3, depth_trunk=3, output_neurons=7)
    rng = np.random.default_rng(19)
    bx, tx, y = (torch.as_tensor(a, dtype=torch.float32) for a in
                 (rng.normal(size=(37, 6)), rng.random((101, 2)), rng.normal(size=(37, 101))))
    real, out_dtypes = gram_merge._gram_cotangents, []

    def step(*args):
        with profiling.span("vihmc.test.cotangent_step"):
            out = real(*args)
        out_dtypes.append({t.dtype for t in out})
        return out

    monkeypatch.setattr(gram_merge, "_gram_cotangents", step)
    grad = gram_merge.make_gram_grad_full(cfg, bx, tx, y, 0.7, compute_dtype=dt,
                                          query_subset=np.arange(0, 101, 3))
    flats = torch.as_tensor(0.4 * rng.normal(size=(3, cfg.num_params)), dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]), profiling.detail_span("vihmc.field"):
        grad(flats)
    recs = profiling.records()
    (fwd,), (cot,), (vjp,), (inner,) = (_by_name(recs, n) for n in (
        "vihmc.field.forward", "vihmc.field.cotangents", "vihmc.field.vjp",
        "vihmc.test.cotangent_step"))
    assert inner["parent"] == cot["id"]
    assert fwd["host_t1"] <= cot["host_t0"] <= inner["host_t0"]
    assert inner["host_t1"] <= cot["host_t1"] <= vjp["host_t0"]
    assert out_dtypes == [{dt}]
    assert profiling.counters().get("field.cotangents.merged", 0) == 0


@pytest.mark.parametrize("n,segment", [(8, 2), (9, 3), (8, 4), (4, 1)])
def test_a_short_segment_details_its_last_draw_but_the_first(n, segment):
    _sample(n=n, segment=segment)
    recs = profiling.records()
    sampled = {i for i in range(n) if 0 < i % segment == segment - 1}
    assert {r["draw"] for r in _by_name(recs, "vihmc.field")} == sampled
    assert profiling.detailed(4, 30) and not profiling.detailed(3, 30)
    assert profiling.detailed(1, 2) and not profiling.detailed(0, 2)
    assert not profiling.detailed(0, 1) and profiling.detailed(4, None)


def _fno_problem(chains=2, per_chunk=None):
    """A small Bayesian FNO2d posterior: 6 functions on a 7 x 9 grid, the
    field's chunks of ``per_chunk`` functions (None: one chunk)."""
    from vihmc_torch import bench_fno
    from vihmc_torch.models.fno import FNO2dConfig, fno_field_bytes, init_fno

    cfg = FNO2dConfig(modes1=2, modes2=2, width=4, n_layers=2, fc_dim=8, padding=2)
    max_bytes = None if per_chunk is None else chains * per_chunk * fno_field_bytes(cfg, 7, 9)
    g = torch.Generator().manual_seed(21)
    u0 = torch.randn(6, 9, generator=g)
    y = 0.1 * torch.randn(6, 7 * 9, generator=g)
    mu = init_fno(cfg, g)
    sigma = torch.full_like(mu, 0.01)
    scores = bench_fno.fno_probe_scores(cfg, mu, sigma, u0, 7, 4, 3, seed=5)
    problem = bench_fno.build_fno_problem(cfg, u0, y, mu, sigma, torch.randn(
        mu.shape[0], generator=g), scores, 40, max_bytes)
    return cfg, problem


def test_fno_spans_open_and_close_in_order_inside_the_field_and_the_mh_test():
    """Subspace VI-HMC on a small Bayesian FNO2d through the sampler (segments
    of 2, so each segment's second draw is detailed): the spectral
    convolution's forward spans inside ``vihmc.field.forward``, its backward
    inside ``vihmc.field.vjp``, the pointwise layers in both, one
    ``vihmc.fno.density`` in each MH test, each span inside its parent and
    the same layer's spans in turn."""
    from vihmc_torch import bench_fno
    from vihmc_torch.dists.priors import DiagonalGaussianPrior
    from vihmc_torch.pipelines.common import fno_chunks

    cfg, p = _fno_problem(per_chunk=3)
    chunks = fno_chunks(cfg, 6, 2, 7, 9, p.max_bytes)
    assert len(chunks) == 2
    prior = DiagonalGaussianPrior(loc=p.spec.sub_mu(), scale=p.spec.sub_sigma())
    log_prob, aux0 = bench_fno.fno_log_prob(p, prior)
    inv_mass = bench_fno.fno_laplace_inv_mass(p)
    grad_fn = bench_fno.fno_trajectory_field(p, prior, inv_mass, "bfloat16")
    delta_fn = bench_fno.fno_mh_delta(p, prior)
    profiling.reset()
    cfg_h = HMCConfig(num_samples=4, num_leapfrog=3, step_size=0.05, burn=2)
    sample_chains_resumable(log_prob, p.spec.sub_mu().expand(2, -1).clone(), cfg_h, 2,
                            inv_mass, aux0, grad_fn=grad_fn, delta_fn=delta_fn, seed=9)
    recs = profiling.records()
    by_id = {r["id"]: r for r in recs}
    parents = {"vihmc.fno.spectral": {"vihmc.field.forward"},
               "vihmc.fno.spectral.bwd": {"vihmc.field.vjp"},
               "vihmc.fno.pointwise": {"vihmc.field.forward", "vihmc.field.vjp"},
               "vihmc.fno.density": {"vihmc.mh"}}
    for name, allowed in parents.items():
        got = _by_name(recs, name)
        assert {r["draw"] for r in got} == {1, 3}, name
        for r in got:
            par = by_id[r["parent"]]
            assert par["name"] in allowed, (name, par["name"])
            assert par["host_t0"] <= r["host_t0"] <= r["host_t1"] <= par["host_t1"]
            assert r["dev_t0"] is not None and r["dev_t0"] <= r["dev_t1"]
        spans = sorted((r["host_t0"], r["host_t1"]) for r in got)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), name
    per_draw = 3 * len(chunks)                      # field calls x chunks
    for name, n in (("vihmc.fno.spectral", cfg.n_layers * per_draw),
                    ("vihmc.fno.spectral.bwd", cfg.n_layers * per_draw),
                    ("vihmc.fno.pointwise", 2 * (cfg.n_layers + 2) * per_draw),
                    ("vihmc.fno.density", 1)):
        assert len(_by_name(recs, name)) == 2 * n, name
    # the backward spans close after their draw's forward spans of the chunk
    fwd = _by_name(recs, "vihmc.fno.spectral")
    bwd = _by_name(recs, "vihmc.fno.spectral.bwd")
    assert min(r["host_t0"] for r in bwd) > min(r["host_t1"] for r in fwd)


def test_fno_counters_count_chunks_transform_bytes_and_probes():
    from vihmc_torch.models.fno import fft_bytes, fno_field_bytes
    from vihmc_torch.pipelines.common import (fno_chunks, make_fno_grad_full,
                                              make_fno_paired_subspace_delta)
    from vihmc_torch.dists.priors import DiagonalGaussianPrior

    profiling.reset()
    cfg, p = _fno_problem()
    c = profiling.counters()
    # 4 functions x 3 probes, one VJP each
    assert c["sensitivity.probes"] == 12
    assert [r["name"] for r in profiling.records()].count("vihmc.sensitivity") == 1
    profiling.reset()
    mb = 3 * 3 * fno_field_bytes(cfg, 7, 9)
    chunks = fno_chunks(cfg, 6, 3, 7, 9, mb)
    assert len(chunks) == 2
    grad = make_fno_grad_full(cfg, p.u0, p.y, 1.0, max_bytes=mb)
    grad(p.frozen.expand(3, -1).contiguous())
    grad(p.frozen[None])
    c = profiling.counters()
    one = fno_chunks(cfg, 6, 1, 7, 9, mb)
    assert c["fno.chunks"] == len(chunks) + len(one)
    want = sum(2 * cfg.n_layers * fft_bytes(3, cfg.width, b - a, 9, 11) for a, b in chunks)
    want += sum(2 * cfg.n_layers * fft_bytes(1, cfg.width, b - a, 9, 11) for a, b in one)
    assert c["fno.fft_bytes"] == want
    profiling.reset()
    prior = DiagonalGaussianPrior(loc=p.spec.sub_mu(), scale=p.spec.sub_sigma())
    delta = make_fno_paired_subspace_delta(cfg, p.u0, p.y, 1.0, p.spec.idx, prior)
    q = p.spec.sub_mu().expand(2, -1)
    delta(q, q, p.frozen)
    c = profiling.counters()
    assert "fno.chunks" not in c
    assert c["fno.fft_bytes"] == cfg.n_layers * fft_bytes(4, cfg.width, 6, 9, 11)
    # the shapes' count: each transform reads its input and writes its output once
    assert fft_bytes(1, 1, 1, 9, 11) == 2 * (9 * 11 * 4 + 9 * 6 * 8)
