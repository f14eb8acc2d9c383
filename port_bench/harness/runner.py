"""One run of one cell: set-up, the window, the comparison, the metrics.

:func:`run_cell` takes the device it is given (the tests pass the CPU and
small sizes); ``run.py`` is the entry that insists on the card.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import random
import sys
import tempfile
import time
import types

import torch

from port_bench.harness import correct
from port_bench.harness.cells import Cell, metric_reader
from port_bench.harness.peaks import peaks_of
from port_bench.harness.trace import Trace
from port_bench.harness.window import Recorder, Tracer, Window, WindowClosed

# enough draws that the window, not the sampler, ends the call
MAX_SEGMENTS = 10 ** 6


def transition_flops(cell: Cell, inputs: dict, chains: int) -> float:
    """Matmul FLOPs of one draw of every chain: the reference's transition at
    the cell's shapes, on meta tensors (nothing is computed)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = {k: v.to("meta") for k, v in inputs.items()}
    ref = cell.reference().Reference(meta, cell.config["model"], cell.config["posterior"],
                                     cell.workload)
    q = torch.zeros((chains, inputs["idx"].shape[0]), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.transition(q, cell.workload["sampler"]["num_leapfrog"])
    return float(fc.get_total_flops())


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             config_over=None, workload_over=None, control: bool = False) -> dict:
    """Run cell ``name`` once and return ``{"line": ..., "readings": ...,
    "control": ...}``: ``line`` is the result line (``checks`` last)."""
    from vihmc_torch.chains.resume import sample_chains_resumable

    cell = Cell(name, config_over=config_over, workload_over=workload_over)
    work = cell.workload
    w = work["window"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    rng = random.Random(seed)
    t_build = time.perf_counter()
    system = cell.system().build(cell.config, work, seed, dev)
    t_built = time.perf_counter()
    rec = Recorder(rng, work["compare"]["calls"], spans=trace)
    tracer = Tracer(w["trace_after"], w["trace_segments"], sync) if trace else None
    win = Window(seconds, w["burn_segments"], w["segment"], rec, rng, sync, tracer,
                 work["compare"]["states"])
    hmc = dataclasses.replace(system.hmc_config, num_samples=w["segment"] * MAX_SEGMENTS)
    # the set-up's objects leave the collector's generations: its passes in
    # the window scan only what the window makes
    gc.collect()
    gc.freeze()
    try:
        sample_chains_resumable(
            rec.wrap_density(system.log_prob), system.inits, hmc, w["segment"],
            system.metric, system.aux0, grad_fn=rec.wrap_field(system.grad_fn),
            delta_fn=rec.wrap_delta(system.delta_fn), thin=w["thin"], seed=seed,
            progress=win)
        raise RuntimeError("the sampler ended before the window closed")
    except WindowClosed:
        pass
    setup_s = win.t0 - t_start
    # the set-up's parts (host clock): start-up and imports, the system's
    # build (its own parts in ``phases``), the first density and the burn
    system.phases.update(start_s=t_build - t_start, build_total_s=t_built - t_build,
                         burn_s=win.t0 - t_built)
    chains = system.shapes["C"]
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace_obj = None
    if tracer is not None:
        with tempfile.TemporaryDirectory(prefix="port_bench_") as tmp:
            path = os.path.join(tmp, "trace.json")
            tracer.export(path)
            trace_obj = Trace.load(path)
    # the program's state goes before the reference runs
    metric, shapes, inputs, phases = (system.metric, system.shapes, system.reference_inputs,
                                      system.phases)
    del system
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = cell.reference().Reference(inputs, cell.config["model"], cell.config["posterior"],
                                     work)
    center = shapes.get("q_center")
    values = correct.readings(rec, win, ref, metric, center)
    ctrl = faults = None
    if control:
        ctrl = correct.readings(rec, win, ref, metric, center, fmt=work["control"])
        faults = correct.field_fault_readings(rec, win, ref, work.get("field_faults", {}))
    ok, checks = correct.verdict(values, work["limits"])
    failed = win.failed_chain_draws()
    attempted = chains * win.draws
    ok = ok and failed == 0

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak = peaks_of(kind) if cuda else None
    metrics = {}
    if not trace:
        for m in cell.end_to_end():
            if m["name"] == "chain_draws_per_s":
                v = attempted / win.wall_s
            elif m["name"] == "setup_s":
                v = setup_s
            else:
                raise KeyError(f"no measurement of end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(
            phases=phases, shapes=shapes, trace=trace_obj, stretch_draws=tracer.draws,
            untraced_draws=win.untraced_draws, untraced_wall_s=win.untraced_wall_s, peak=peak,
            flops_per_draw=transition_flops(cell, inputs, chains) if peak else None)
        for m in cell.per_layer():
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    line = {"correct": bool(ok), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = trace_obj.busy_s()
        device_info["window_s"] = trace_obj.wall_s
        line["breakdown"] = trace_obj.breakdown()
    line["checks"] = checks
    return {"line": line, "readings": values, "control": ctrl, "faults": faults,
            "window": {"draws": win.draws, "wall_s": win.wall_s, "setup_s": setup_s,
                       "setup_cpu_s": win.setup_rusage.ru_utime + win.setup_rusage.ru_stime,
                       "setup_nivcsw": win.setup_rusage.ru_nivcsw,
                       "untraced_draws": win.untraced_draws,
                       "untraced_wall_s": win.untraced_wall_s, "phases": phases}}


def jax_modules() -> list:
    """Top-level names in ``sys.modules`` that belong to JAX or the JAX package."""
    tops = {k.split(".")[0] for k in list(sys.modules)}
    return sorted(tops & {"jax", "jaxlib", "flax", "vihmc_tpu"})
