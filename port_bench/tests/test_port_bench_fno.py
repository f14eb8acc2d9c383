"""The ``fno2d-burgers`` configuration on the CPU: the benchmark's posterior
and layout against the program's, the arithmetic of ``harness/fno_arith.py``
against a hand count and against ``FlopCounterMode`` over the plain
reference, a sound run of the cell at a small size, the planted faults (the
field over half of the functions, a stuck transition, one stuck chain, a
wrong probe estimator) caught, a traced run's span metrics, and the roofline
reader on a synthetic trace."""

import dataclasses
import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.harness.cells import Cell, merged, metric_reader
from port_bench.harness.fno_arith import (fft_flops, fft_flops_per_draw, mixing_flops,
                                          spectral_bytes_per_draw, transform_bytes)
from port_bench.harness.fno_posterior import layout, posterior
from port_bench.harness.runner import run_cell, transition_flops

CELL = "fno2d-burgers-top2048"
TINY = {"modes1": 3, "modes2": 3, "width": 6, "n_layers": 4, "fc_dim": 16, "in_channels": 3,
        "padding": 2, "activation": "gelu"}


def tiny_model():
    from vihmc_torch.models.fno import FNO2dConfig
    return {**TINY, "num_params": FNO2dConfig(**{k: v for k, v in TINY.items()}).num_params}


def test_posterior_and_layout_are_the_program_s():
    from vihmc_torch.models.fno import FNO2dConfig, init_fno, param_slices

    cell = Cell(CELL)
    model = cell.config["model"]
    cfg = FNO2dConfig(**{k: model[k] for k in TINY})
    assert cfg.num_params == model["num_params"] == 2_368_001
    assert layout(model) == param_slices(cfg)
    m = tiny_model()
    post = cell.config["posterior"]
    got = posterior(m, post, "cpu")
    gen = torch.Generator()
    gen.manual_seed(post["init_seed"])
    assert torch.equal(got["mu"], init_fno(FNO2dConfig(**TINY), gen))
    sigma = got["sigma"]
    assert 0.004 < float(sigma.median()) < 0.01 and got["eps"].shape == sigma.shape


SHAPES = {"C": 3, "B": 5, "S1": 7, "S2": 6, "pad": 2, "width": 4, "n_layers": 2,
          "modes1": 2, "modes2": 2, "num_leapfrog": 3}


def test_transform_bytes_and_flops_by_hand():
    # a 9 x 8 padded grid: 72 float32 points, a 9 x 5 complex64 half spectrum
    per_plane = 72 * 4 + 45 * 8
    assert transform_bytes(1, 1, 1, 9, 8) == 2 * per_plane
    assert transform_bytes(3, 4, 5, 9, 8) == 60 * 2 * per_plane
    # the field's calls, forward and backward, in every layer
    assert spectral_bytes_per_draw(SHAPES) == 3 * 2 * 2 * 60 * 2 * per_plane
    assert fft_flops(9, 8) == 2.5 * 72 * math.log2(72)
    planes = 2 * 4 * 3 * 5
    assert fft_flops_per_draw(SHAPES) == planes * (4 * 3 + 4) * fft_flops(9, 8)
    assert mixing_flops(5, 4, 3, 8) == 8 * 5 * 4 * 3 * 8


def _reference(model, b=5, nt=7, nx=6, d=11):
    cell = Cell(CELL)
    g = torch.Generator().manual_seed(3)
    n = model["num_params"]
    inputs = {"u0": torch.randn(b, nx, generator=g), "y": torch.randn(b, nt * nx, generator=g),
              "mu": 0.1 * torch.randn(n, generator=g), "sigma": torch.full((n,), 0.01),
              "eps": torch.randn(n, generator=g), "idx": torch.arange(d),
              "scores": torch.rand(n, generator=g)}
    return cell.reference().Reference(inputs, model, {"tau_var": 1.0}, cell.workload), inputs


def test_flop_counter_counts_the_complex_mixing_as_the_hand_formula():
    ref, _ = _reference(tiny_model())
    a = torch.randn(5, 6, 3, 3, dtype=torch.complex64)
    w = torch.randn(6, 6, 3, 3, 2)
    with FlopCounterMode(display=False) as fc:
        ref._mix(a, w, None)
    assert fc.get_total_flops() == mixing_flops(5, 6, 6, 9)


def test_transition_flops_are_the_hand_count_of_every_matmul():
    m = tiny_model()
    ref, inputs = _reference(m)
    b, nt, nx = 5, 7, 6
    pts, grid = nt * nx, (nt + 2) * (nx + 2)
    w, f, lay, modes = m["width"], m["fc_dim"], m["n_layers"], 2 * m["modes1"] * m["modes2"]
    lift = 2 * 3 * w * pts
    body = lay * (2 * w * w * grid + mixing_flops(1, w, w, modes))
    head = 2 * w * f * pts + 2 * f * pts
    fwd = lift + body + head
    bwd = 2 * (body + head) + lift          # the input takes no gradient
    chains, num_leapfrog = 2, 3
    want = chains * b * (num_leapfrog * (fwd + bwd) + 2 * fwd)
    cell = Cell(CELL, config_over={"model": m},
                workload_over={"sampler": {"num_leapfrog": num_leapfrog}})
    assert transition_flops(cell, inputs, chains) == want


# A small size of the cell on the CPU: the program's widths cut (modes 3,
# width 6, fc 16, padding 2) on every 10th grid point of 24 functions, two
# chains, a short warm start; one window segment (``seconds`` 0).
SMALL = ({"model": tiny_model(), "data": {"n_functions": 24, "grid_stride": 10}},
         {"chains": 2, "warm_start_steps": 5, "subspace": {"top_k": 128},
          "sensitivity": {"functions": 4, "probes": 2}, "field": {"memory_gb": 0.001}})


def run_small(seed=20240611, workload_over=None):
    co, wo = SMALL
    return run_cell(CELL, seed, 0.0, False, "cpu", time.perf_counter(), co,
                    merged(wo, workload_over))["line"]


def failing(line):
    return [k for k, c in line["checks"].items()
            if not (c["value"] is not None and c["value"] <= c["limit"])]


def test_transition_flops_take_the_system_s_reference_inputs():
    """The MFU count builds the reference on meta tensors from what the
    system hands it (no scores: the reference draws its own)."""
    co, wo = SMALL
    cell = Cell(CELL, config_over=co, workload_over=wo)
    system = cell.system().build(cell.config, cell.workload, 5, torch.device("cpu"))
    assert "scores" not in system.reference_inputs
    assert transition_flops(cell, system.reference_inputs, 2) > 0


def test_sound_small_run_is_correct():
    line = run_small()
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] == 2 * 2
    assert set(line["checks"]) == {"lp_gap_nats", "dll_gap_nats", "field_gap",
                                   "field_scale_gap", "unmoved_chains_pct"}


@pytest.mark.parametrize("stuck,reads", [(slice(None), 100.0), (slice(0, 1), 50.0)],
                         ids=["every_chain", "one_chain"])
def test_a_stuck_transition_is_caught(monkeypatch, stuck, reads):
    """Every chain, or chain 0 alone, keeps its state at every transition:
    one stuck chain is 50 % of two here and 25 % of the card's four, both
    over the limit."""
    import vihmc_torch.chains.resume as resume

    real = resume.make_kernel

    def make_kernel(*args, **kwargs):
        kernel = real(*args, **kwargs)

        def step(state, noise):
            new, info = kernel(state, noise)
            fields = {}
            for name in ("position", "log_prob", "grad"):
                x = getattr(new, name).clone()
                x[stuck] = getattr(state, name)[stuck]
                fields[name] = x
            return dataclasses.replace(new, **fields), info
        return step

    monkeypatch.setattr(resume, "make_kernel", make_kernel)
    line = run_small()
    assert line["correct"] is False
    assert failing(line) == ["unmoved_chains_pct"]
    assert line["checks"]["unmoved_chains_pct"]["value"] == reads
    assert Cell(CELL).workload["limits"]["unmoved_chains_pct"] < 25.0


@pytest.mark.parametrize("fault,catches", [("seed", "lp_gap_nats"), ("probes", "lp_gap_nats"),
                                           ("scale", "field_scale_gap")])
def test_a_wrong_probe_estimator_is_caught(monkeypatch, fault, catches):
    """The program's sensitivity stage planted wrong: probes from the next
    seed, one probe fewer (both move the subspace, which the reference
    draws itself), or scores 100x too large (a wrong count in the mean: the
    same subspace, another mass, which the clipped field shows; the clip is
    lowered so that it binds here, as it does on the card)."""
    import vihmc_torch.bench_fno as bench_fno

    real = bench_fno.sensitivity_scores

    def sensitivity_scores(apply_one, mu, sigma, inputs, chunk_size=0, probes=0, seed=0,
                           apply_rows=None):
        seed += fault == "seed"
        probes -= fault == "probes"
        s = real(apply_one, mu, sigma, inputs, chunk_size, probes, seed, apply_rows)
        return s * 100.0 if fault == "scale" else s

    monkeypatch.setattr(bench_fno, "sensitivity_scores", sensitivity_scores)
    line = run_small(workload_over={"field": {"clip": 1.0}})
    assert line["correct"] is False
    assert catches in failing(line), line["checks"]


def test_a_field_over_half_of_the_functions_is_caught(monkeypatch):
    """The program's field summed over every other function (not scaled
    back): at this size the clip is not reached, so the field's scale shows
    (the reference's planted twin reads 0.17 here, 0.055-0.25 on the card)."""
    import vihmc_torch.bench_fno as bench_fno

    real = bench_fno.make_fno_grad_full

    def make_fno_grad_full(cfg, u0, y, tau_var, *args, **kwargs):
        return real(cfg, u0[::2].contiguous(), y[::2].contiguous(), tau_var, *args, **kwargs)

    monkeypatch.setattr(bench_fno, "make_fno_grad_full", make_fno_grad_full)
    line = run_small()
    assert line["correct"] is False
    assert "field_scale_gap" in failing(line), line["checks"]


def test_traced_small_run_reads_the_span_metrics():
    """A traced run on the CPU: the three span readers and ``sensitivity_s``
    read numbers (the roofline and MFU need a card's peaks)."""
    co, wo = SMALL
    out = run_cell(CELL, 7, 0.0, True, "cpu", time.perf_counter(), co,
                   merged(wo, {"window": {"trace_after": 1, "trace_segments": 1}}))
    metrics = out["line"]["metrics"]
    for name in ("fno_spectral_ms_per_draw", "fno_pointwise_ms_per_draw",
                 "fno_mh_ms_per_draw", "sensitivity_s"):
        assert metrics[name]["value"] > 0, name
    assert "fno_spectral_roofline" not in metrics and "fno_mfu_pct" not in metrics


def test_spectral_roofline_reads_the_operations_launched_in_the_spectral_spans(monkeypatch):
    """Synthetic trace and records: the program's host stamps (ns) are the
    trace's clock (us) less a 1 s offset; two field calls, each a little
    wider than the harness's span inside it, place the offset, and only the
    kernels launched inside a spectral span count (40 + 60 us of 1,600)."""
    import types

    from port_bench.harness.trace import Trace

    reader = metric_reader("fno_spectral_roofline")
    off_us = -1e6                     # trace us = host ns / 1e3 + off_us
    ev = [{"ph": "X", "cat": "user_annotation", "name": "stretch", "ts": 0, "dur": 5000}]
    recs, rid = [], iter(range(100))

    def rec(name, t0_us, t1_us):
        recs.append({"name": name, "id": next(rid), "parent": None, "draw": 0, "segment": 1,
                     "rank": None, "host_t0": (t0_us - off_us) * 1e3,
                     "host_t1": (t1_us - off_us) * 1e3, "dev_t0": None, "dev_t1": None,
                     "profiled": True})

    for a, b in ((100, 2000), (2100, 4000)):            # two field calls
        rec("vihmc.field", a - 2, b + 4)
        ev.append({"ph": "X", "cat": "user_annotation", "name": "trajectory_field", "ts": a,
                   "dur": b - a})
    rec("vihmc.fno.spectral", 200, 300)
    rec("vihmc.fno.spectral.bwd", 2500, 2600)
    rec("vihmc.fno.pointwise", 310, 400)
    for corr, (launch, dur) in enumerate([(250, 40.0), (2550, 60.0), (350, 1000.0),
                                          (3000, 500.0)]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": launch, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": launch + 5,
                   "dur": dur, "args": {"correlation": corr}})
    monkeypatch.setitem(reader.__globals__, "program_records", lambda: recs)
    peak = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    ctx = types.SimpleNamespace(trace=Trace(ev), peak=peak, stretch_draws=2, shapes=SHAPES)
    got = reader(ctx)
    want = 100.0 * spectral_bytes_per_draw(SHAPES) / 3.35e12 * 2 / (100.0 * 1e-6)
    assert got == pytest.approx(want, rel=1e-9)
