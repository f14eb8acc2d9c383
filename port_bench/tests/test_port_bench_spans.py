"""The seven readers of the program's spans (``harness/spans.py``,
``metrics/*``): hand-computed values on synthetic records, the profiled
stretch left out, None without records, and all seven as numbers in a traced
run on the CPU."""

import time
import types

import numpy as np
import pytest

from port_bench.harness.cells import merged, metric_reader
from port_bench.harness.runner import run_cell
from port_bench.tests.conftest import SMALL

MS = 1_000_000
READERS = ("draw_ms_p95", "boundary_idle_ms", "host_lead_ms", "field_forward_ms_per_draw",
           "field_cotangent_ms_per_draw", "field_vjp_ms_per_draw", "mh_features_ms_per_draw")

# per segment: (profiled, [(host start, device start, device end) per draw], ms;
# the detailed draw's spans: {name: [device ms per call]})
SEGMENTS = [
    (False, [(0, 0, 50), (10, 50, 90)], {"vihmc.field.forward": [1000.0]}),   # burn
    (False, [(95, 100, 110), (100, 110, 121), (104, 121, 133)],
     {"vihmc.field.forward": [1.0, 2.0], "vihmc.field.cotangents": [2.0, 2.0],
      "vihmc.field.vjp": [5.0, 6.0], "vihmc.mh.features": [7.0]}),
    (True, [(138, 440, 940), (141, 940, 1440), (142, 1440, 1940)],
     {"vihmc.field.forward": [100.0], "vihmc.field.cotangents": [100.0],
      "vihmc.field.vjp": [100.0], "vihmc.mh.features": [100.0]}),
    (False, [(1978, 1980, 1992), (1985, 1992, 2006), (1990, 2006, 2016)],
     {"vihmc.field.forward": [4.0, 1.0], "vihmc.field.cotangents": [3.0, 3.0],
      "vihmc.field.vjp": [7.0, 7.0], "vihmc.mh.features": [9.0]}),
    (False, [(2025, 2030, 2040), (2028, 2040, 2051), (2035, 2051, 2060)],
     {"vihmc.field.forward": [None]}),
    (False, [(2066, 2070, 2080), (2070, 2080, 2090), (2080, 2090, 2100)],
     {"vihmc.mh.features": [8.0]}),
]
# by hand: unprofiled window draws' device ms 10 11 12 | 12 14 10 | 10 11 9 | 10 10 10;
# boundaries 0->1 (opening the window): 100 - 90 = 10, 3->4: 2030 - 2016 = 14 and
# 4->5: 2070 - 2060 = 10 (those touching the profiled segment 2 drop); leads (not a
# segment's first) 10 17 | 7 16 | 12 16 | 10 10
WANT = {
    "draw_ms_p95": 12.0 + 0.45 * (14.0 - 12.0),
    "boundary_idle_ms": 10.0,
    "host_lead_ms": 11.0,
    "field_forward_ms_per_draw": 4.0,      # median of 3 and 5
    "field_cotangent_ms_per_draw": 5.0,    # of 4 and 6
    "field_vjp_ms_per_draw": 12.5,         # of 11 and 14
    "mh_features_ms_per_draw": 8.0,        # of 7, 9 and 8
}


def synthetic_records():
    ids = iter(range(10 ** 6))
    out, draw_id = [], 0

    def rec(name, parent, draw, seg, h0, h1, d0, d1, profiled):
        r = {"name": name, "id": next(ids), "parent": parent, "draw": draw, "segment": seg,
             "rank": None, "host_t0": h0, "host_t1": h1, "dev_t0": d0, "dev_t1": d1,
             "profiled": profiled}
        out.append(r)
        return r

    for seg, (profiled, draws, detail) in enumerate(SEGMENTS):
        s = rec("vihmc.segment", None, None, seg, draws[0][0] * MS, None, draws[0][1] * MS,
                draws[-1][2] * MS, profiled)
        for k, (h0, d0, d1) in enumerate(draws):
            d = rec("vihmc.draw", s["id"], draw_id, seg, h0 * MS, (h0 + 1) * MS, d0 * MS,
                    d1 * MS, profiled)
            if k == 1:
                for name, times in detail.items():
                    outer = rec("vihmc.mh" if name.startswith("vihmc.mh") else "vihmc.field",
                                d["id"], draw_id, seg, None, None, None, None, profiled)
                    t = d0 * MS
                    for ms in times:
                        end = None if ms is None else t + int(ms * MS)
                        rec(name, outer["id"], draw_id, seg, None, None,
                            None if ms is None else t, end, profiled)
                        t = end or t
            draw_id += 1
        s["host_t1"] = (draws[-1][0] + 3) * MS
        rec("vihmc.transfer", s["id"], None, seg, None, None, None, None, profiled)
    return out


def window_ctx():
    # the window: segments 1-5, one of them (2) traced
    return types.SimpleNamespace(untraced_draws=12, stretch_draws=3)


@pytest.fixture
def records(monkeypatch):
    from vihmc_torch.core import profiling

    recs = synthetic_records()
    monkeypatch.setattr(profiling, "records", lambda: recs)
    return recs


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_hand_computed_value(name, records):
    assert metric_reader(name)(window_ctx()) == pytest.approx(WANT[name], abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_drops_profiled_draws(name, records):
    base = metric_reader(name)(window_ctx())
    for r in records:
        if r["profiled"]:   # the traced segment, read as if it were not
            r["profiled"] = False
    assert metric_reader(name)(window_ctx()) != pytest.approx(base)
    for r in records:
        r["profiled"] = True
    assert metric_reader(name)(window_ctx()) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_returns_none_without_records(name, monkeypatch):
    from vihmc_torch.core import profiling

    monkeypatch.setattr(profiling, "records", lambda: [])
    assert metric_reader(name)(window_ctx()) is None
    # a program without the recorder (the parent of the change that adds it)
    monkeypatch.delattr(profiling, "records")
    assert metric_reader(name)(window_ctx()) is None


def test_a_traced_cpu_run_reports_all_seven():
    """SMALL's size with six-draw segments, so each segment has a detailed
    draw (index 4)."""
    co, wo = SMALL["deeponet-row-top2048"]
    wo = merged(wo, {"window": {"segment": 6}})
    line = run_cell("deeponet-row-top2048", 2 ** 31 + 29, 0.5, True, "cpu",
                    time.perf_counter(), co, wo)["line"]
    for name in READERS:
        v = line["metrics"][name]
        assert v["unit"] == "ms" and np.isfinite(v["value"]), name
    assert line["metrics"]["host_lead_ms"]["value"] == 0.0   # the CPU is synchronous
    assert line["metrics"]["draw_ms_p95"]["value"] > 0.0
