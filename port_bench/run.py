"""Run one cell of the tpulsar_torch benchmark on the GPU it is
started on.

    python3 port_bench/run.py --workload mock_default.plan --seed N \
        --seconds S --trace 0|1

Prints the cell's metrics as the last line of standard output, one
JSON object, and each number the check compared beside its limit as
the last lines of standard error.  Needs a CUDA device (exit 3
without one); imports neither JAX nor the JAX package (exit 4 if
either is loaded once the window has closed).
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

#: one process with few threads: the host's other cores stay free
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "4"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from port_bench import harness

    bench = harness.load_benchmark()
    cell, _config, _traffic = harness.find_cell(bench, args.workload)
    harness.setup_caches()
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, rows = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START, bench=bench)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"port_bench: loaded {', '.join(bad)}; the benchmark "
              f"measures tpulsar_torch alone", file=sys.stderr)
        return 4
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
