"""The benchmark's arithmetic against hand-worked values: the roofline, the
MFU, the low-precision rounding and the trace reduction."""

import pytest
import torch

from port_bench.harness import arith, lowp
from port_bench.harness.peaks import peaks_of
from port_bench.harness.trace import Trace

H100 = peaks_of("NVIDIA H100 80GB HBM3")


def test_paired_sums_work_by_hand():
    # C=1, B=2, P=3, K=4: 4*24 + 12*6 operations; 4*(2*8 + 2*12 + 6 + 5) bytes
    assert arith.paired_sums_work(1, 2, 3, 4) == (168.0, 204.0)


def test_roofline_takes_the_larger_bound():
    # the row's shape: 4 C B P K dominates, compute-bound at the bf16 peak
    flops, nbytes = arith.paired_sums_work(48, 1000, 10201, 100)
    t = arith.roofline_s(flops, nbytes, H100)
    assert t == pytest.approx(flops / 989e12)
    assert t * 1e3 == pytest.approx(0.2036, abs=1e-3)
    # memory-bound: 3.35e12 bytes take one second
    assert arith.roofline_s(1.0, 3.35e12, H100) == pytest.approx(1.0)
    # two launches of 1 s bound in 4 s of device time: 50 %
    assert arith.roofline_pct(1.0, 3.35e12, 2, 4.0, H100) == pytest.approx(50.0)


def test_mfu_by_hand():
    # 989e12 / 2 FLOPs per draw, 10 draws in 10 s: half the peak
    assert arith.mfu_pct(989e12 / 2, 10, 10.0, H100) == pytest.approx(50.0)
    assert peaks_of("cpu") is None


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, 1 + 3 * 2 ** -11])
    assert lowp.round_tf32(x).tolist() == [1.0, 1.0, 1 + 2 ** -9, 1 + 2 ** -9]


def test_fp8_rounding_has_three_mantissa_bits_at_its_scale():
    x = torch.tensor([[448.0, 1.0 + 1 / 16, -3.0]])
    assert lowp.round_fp8(x).tolist() == [[448.0, 1.0, -3.0]]


def test_rounded_matmul_differs_from_float32_and_differentiates():
    a = torch.randn(2, 8, 16, requires_grad=True)
    b = torch.randn(2, 16, 4)
    exact = lowp.matmul(a, b)
    low = lowp.matmul(a, b, "tf32")
    assert 0 < (exact - low).abs().max() < 1e-2
    (g,) = torch.autograd.grad(low.sum(), a)
    assert g.shape == a.shape


def _event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace():
    # a 100 us stretch: two field kernels (launched in the field span), one
    # paired_sums kernel (in mh_test), a copy, and one kernel outside it
    return Trace([
        _event("user_annotation", "stretch", 0, 100),
        _event("user_annotation", "segment", 0, 100),
        _event("user_annotation", "trajectory_field", 5, 20),
        _event("user_annotation", "mh_test", 40, 10),
        _event("cuda_runtime", "cudaLaunchKernel", 6, 1, 1),
        _event("cuda_runtime", "cudaLaunchKernel", 8, 1, 2),
        _event("cuda_runtime", "cudaLaunchKernel", 41, 1, 3),
        _event("cuda_runtime", "cudaMemcpyAsync", 60, 1, 4),
        _event("kernel", "gemm", 10, 10, 1),
        _event("kernel", "tanh", 15, 10, 2),          # overlaps the gemm
        _event("kernel", "void paired_tiles<true>(...)", 50, 20, 3),
        _event("gpu_memcpy", "Memcpy DtoH", 80, 5, 4),
        _event("kernel", "late", 150, 5, 5),          # after the stretch
        _event("gpu_user_annotation", "trajectory_field", 10, 15),
    ])


def test_trace_busy_launches_and_spans():
    t = synthetic_trace()
    assert len(t.device) == 4
    assert t.busy_s() == pytest.approx((15 + 20 + 5) * 1e-6)
    assert t.wall_s == pytest.approx(100e-6)
    assert [d[1] for d in t.launched_in("trajectory_field")] == ["gemm", "tanh"]
    assert [d[1] for d in t.launched_in("mh_test")] == ["void paired_tiles<true>(...)"]


def test_trace_breakdown_labels_idle_time_by_the_host_span():
    b = synthetic_trace().breakdown()
    assert b["device_ops"][0] == ["void paired_tiles<true>(...)", pytest.approx(20e-6)]
    gaps = dict(b["idle_gaps"])
    # idle: 0-10 in the field span, 25-50 (mid 37.5: segment), 70-80, 85-100
    assert gaps["trajectory_field"] == pytest.approx(10e-6)
    assert gaps["segment"] == pytest.approx((25 + 10 + 15) * 1e-6)


def test_metric_readers_on_the_synthetic_trace():
    import types

    from port_bench.harness.cells import metric_reader

    ctx = types.SimpleNamespace(trace=synthetic_trace(), stretch_draws=2, peak=H100,
                                shapes={"C": 1, "B": 2, "P": 3, "K": 4},
                                phases={"warm_start_s": 1.5}, flops_per_draw=989e12 * 25e-6,
                                untraced_draws=3, untraced_wall_s=150e-6)
    assert metric_reader("launches_per_draw")(ctx) == 2.0
    # busy 40 us in 2 traced draws against 50 us of untraced wall per draw
    assert metric_reader("device_idle_pct")(ctx) == pytest.approx(60.0)
    assert metric_reader("field_ms_per_draw")(ctx) == pytest.approx(0.01)
    assert metric_reader("warm_start_s")(ctx) == 1.5
    assert metric_reader("lanczos_s")(ctx) is None
    assert metric_reader("mfu_pct")(ctx) == pytest.approx(50.0)
    bound = arith.roofline_s(*arith.paired_sums_work(1, 2, 3, 4), H100)
    assert metric_reader("paired_sums_roofline")(ctx) == pytest.approx(100 * bound / 20e-6)
    ctx.trace = None
    assert metric_reader("launches_per_draw")(ctx) is None
