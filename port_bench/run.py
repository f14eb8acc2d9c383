"""Run one cell of the port's benchmark on the card and print one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics read from a ``torch.profiler`` trace of a stretch of the
window. The line's ``checks`` (last) and the last lines of standard error
give each number that decides ``correct`` beside its limit. Without a card
(or with fewer than the cell asks for) the run exits with 2 and prints no
result; with JAX or the JAX package loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process with few threads: the host only dispatches, and idle CPU
# worker threads contend with it for the shared host's cores
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench.harness.cells import Cell
    from port_bench.harness.runner import jax_modules, run_cell

    chips = Cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   T_START)
    found = jax_modules()
    if found:
        print(f"port_bench: the process holds {found} in sys.modules", file=sys.stderr)
        return 3
    line = out["line"]
    w = out["window"]
    print("setup " + " ".join(f"{k}={v:.3f}" for k, v in w["phases"].items())
          + f" | window draws={w['draws']} wall_s={w['wall_s']:.4f} untraced_draws="
          f"{w['untraced_draws']} untraced_wall_s={w['untraced_wall_s']:.4f} | setup_cpu_s="
          f"{w['setup_cpu_s']:.3f} setup_nivcsw={w['setup_nivcsw']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
