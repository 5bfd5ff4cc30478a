"""Time the hi stage's two CPU consumers on the same spectra.

    python -m tpulsar_torch.cli.bench_accel_consumer [--nbins N]
        [--ndms D] [--zmax Z] [--numharm H] [--topk K] [--repeats R]

On the CPU, accel_search_batch hands each batch's correlation pieces to
the native consumer (native/accel_host.cpp) for the harmonic-stage
sums, z maxima and top-k; the torch consumer (_accel_block_topk)
computes the same function.  This script runs the batched CPU hi stage
both ways on seeded noise spectra with the default search's bank
(zmax 50, 8 harmonics, top 32), checks that the two results are the
same bits, and prints one JSON line: the median seconds of each over
the repeats, the CPU's name and the torch thread count.
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import time

import numpy as np
import torch


def _cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nbins", type=int, default=1 << 18)
    ap.add_argument("--ndms", type=int, default=4)
    ap.add_argument("--zmax", type=float, default=50.0)
    ap.add_argument("--numharm", type=int, default=8)
    ap.add_argument("--topk", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    from tpulsar_torch.kernels import accel

    rng = np.random.default_rng(0)
    specs = torch.from_numpy(
        (rng.standard_normal((args.ndms, args.nbins))
         + 1j * rng.standard_normal((args.ndms, args.nbins)))
        .astype(np.complex64))
    bank = accel.build_template_bank(args.zmax)
    usable = accel._native_cpu_path_usable
    times: dict[str, list[float]] = {"native": [], "torch": []}
    outs = {}
    try:
        for _ in range(args.repeats):
            for name in times:
                accel._native_cpu_path_usable = (
                    usable if name == "native" else (lambda dev: False))
                t0 = time.perf_counter()
                outs[name] = accel.accel_search_batch(
                    specs, bank, max_numharm=args.numharm, topk=args.topk)
                times[name].append(time.perf_counter() - t0)
    finally:
        accel._native_cpu_path_usable = usable
    same = all(np.array_equal(a, b)
               for h in outs["native"]
               for a, b in zip(outs["native"][h], outs["torch"][h]))
    rec = {"cpu": _cpu_name(), "torch_threads": torch.get_num_threads(),
           "nbins": args.nbins, "ndms": args.ndms, "nz": len(bank.zs),
           "numharm": args.numharm, "topk": args.topk,
           "native_s": statistics.median(times["native"]),
           "torch_s": statistics.median(times["torch"]),
           "bit_identical": same}
    rec["torch_over_native"] = rec["torch_s"] / rec["native_s"]
    print(json.dumps(rec), flush=True)
    if not same:
        raise SystemExit("the native and torch consumers disagree")
    return rec


if __name__ == "__main__":
    main()
