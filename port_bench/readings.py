"""The two readings of every number that decides ``correct``, over seeds.

    python3 port_bench/readings.py --workload <cell> --seeds 1,2,3 --seconds 8 [--control]

For each seed, in one process: a run of the cell (set-up and a window of
``--seconds``) and the comparison's numbers of the program; with
``--control``, also the control's: the reference at the next lower
precision (the cell's ``control``) put in the program's place at the same
inputs, and the field's numbers with the workload's ``field_faults``
planted in the reference in the program's place; ``--workload-over``
plants a fault in the program itself. One JSON line per seed, then the largest program reading and the
smallest control reading of each number. The benchmark's own runs do not
run this; the limits in ``workloads/<cell>.json`` are set from its output.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--workload-over", default=None,
                    help="JSON merged into the cell's workload file: a fault planted in "
                         "the program, such as '{\"lanczos\": {\"iters\": 256}}'")
    args = ap.parse_args(argv)

    import torch

    from port_bench.harness.runner import run_cell

    lows, highs = {}, {}
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        over = json.loads(args.workload_over) if args.workload_over else None
        out = run_cell(args.workload, seed, args.seconds, False, "cuda:0", t,
                       workload_over=over, control=args.control)
        print(json.dumps({"seed": seed, "correct": out["line"]["correct"],
                          "readings": out["readings"], "control": out["control"],
                          "faults": out["faults"],
                          "metrics": out["line"]["metrics"], "window": out["window"]}),
              flush=True)
        for k, v in out["readings"].items():
            if v is not None:
                lows[k] = max(lows.get(k, v), v)
        for k, v in (out["control"] or {}).items():
            if v is not None:
                highs[k] = min(highs.get(k, v), v)
        del out
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        t = time.perf_counter()
    print(json.dumps({"program_max": lows, "control_min": highs}))


if __name__ == "__main__":
    main()
