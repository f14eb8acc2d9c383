"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(set-up, the window, the comparison) on the CPU at a small size, with one
fault planted in the program: a transition that returns its state unchanged;
half of the batch left out and the mean taken over the rest (in the MH
test's sums); the trajectory field summed over half of the functions; a
field that is zero; a Lanczos metric cut to as many iterations as its rank;
an answer altered where it is produced. (The cells run on one card, so
there is no exchange between cards to leave out.) The window is one
segment (``seconds`` 0), so what a run compares does not hang on the
host's speed.
"""

import dataclasses
import time

import pytest
import torch

from port_bench.harness.cells import merged
from port_bench.harness.runner import run_cell
from port_bench.tests.conftest import FAULTS

CELLS = ("deeponet-row-top2048",)


def run_small(cell, seed=20240611, workload_over=None):
    co, wo = FAULTS[cell]
    return run_cell(cell, seed, 0.0, False, "cpu", time.perf_counter(), co,
                    merged(wo, workload_over))["line"]


def unchanged_step(monkeypatch, cell):
    import vihmc_torch.chains.resume as resume

    real = resume.make_kernel

    def make_kernel(*args, **kwargs):
        kernel = real(*args, **kwargs)

        def stuck(state, noise):
            new, info = kernel(state, noise)
            return dataclasses.replace(state, iteration=new.iteration, da=new.da), info
        return stuck

    monkeypatch.setattr(resume, "make_kernel", make_kernel)


def half_batch(monkeypatch, cell):
    """The MH test's sums over half of the functions, doubled."""
    import vihmc_torch.pipelines.common as common

    real = common.fused_paired_delta

    def fused_paired_delta(bout1, tout1, bias1, bout0, tout0, bias0, y, tau, y_sum_pair=None):
        h = y.shape[0] // 2
        dll, lp1 = real(bout1[:, :h].contiguous(), tout1, bias1, bout0[:, :h].contiguous(),
                        tout0, bias0, y[:h].contiguous(), tau)
        return 2.0 * dll, 2.0 * lp1

    monkeypatch.setattr(common, "fused_paired_delta", fused_paired_delta)


def half_sum_field(monkeypatch, cell):
    """The Gram field summed over half of the functions, not scaled."""
    import vihmc_torch.bench_operator as bo

    real = bo.make_gram_grad_full

    def make_gram_grad_full(cfg, branch_x, trunk_x, y, tau_var, **kw):
        return real(cfg, branch_x[::2].contiguous(), trunk_x, y[::2].contiguous(), tau_var,
                    **kw)

    monkeypatch.setattr(bo, "make_gram_grad_full", make_gram_grad_full)


def zero_field(monkeypatch, cell):
    """A trajectory field that returns zeros."""
    import vihmc_torch.bench_operator as bo

    real = bo.trajectory_field

    def trajectory_field(*args, **kwargs):
        fn = real(*args, **kwargs)
        return lambda q, aux: torch.zeros_like(fn(q, aux))

    monkeypatch.setattr(bo, "trajectory_field", trajectory_field)


def altered_answer(monkeypatch, cell):
    """One chain's Δ log p off by 5 nats where the MH sums are closed."""
    import vihmc_torch.pipelines.common as common

    real = common.fused_paired_delta

    def fused_paired_delta(*args, **kwargs):
        dll, lp1 = real(*args, **kwargs)
        bump = torch.zeros_like(dll)
        bump[0] = 5.0
        return dll + bump, lp1

    monkeypatch.setattr(common, "fused_paired_delta", fused_paired_delta)


# each fault, and the number that has to catch it
FAULT_FNS = [(unchanged_step, "unmoved_chains_pct"), (half_batch, "dll_gap_nats"),
             (half_sum_field, "field_scale_gap"),
             (zero_field, "field_scale_gap"), (altered_answer, "dll_gap_nats")]


def failing(line):
    return [k for k, c in line["checks"].items()
            if not (c["value"] is not None and c["value"] <= c["limit"])]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = run_small(cell)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault,number", FAULT_FNS, ids=[f.__name__ for f, _ in FAULT_FNS])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_not_correct(monkeypatch, cell, fault, number):
    fault(monkeypatch, cell)
    line = run_small(cell)
    assert line["correct"] is False
    assert number in failing(line), line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_few_lanczos_iterations_make_the_run_not_correct(cell):
    rank = FAULTS[cell][1]["lanczos"]["rank"]
    line = run_small(cell, workload_over={"lanczos": {"iters": rank}})
    assert line["correct"] is False
    assert "eig_residual" in failing(line)
