"""Readings that set the check's limits, for one cell, in one process.

    python3 port_bench/control.py --workload mock_default.plan \
        --seeds 11 12 13 --mode program|lowpath|control [--seconds S]

program: the benchmark's own run of the cell (harness.run) on each
seed, one after another; prints each seed's numbers.  Their largest
is a limit's lower reading.

lowpath: the same run with the program's own lower-precision path
switched on (the configuration's `control_environment` in place of
its `environment`): a control, whose smallest number is a limit's
upper reading.

control: the plain reference put in the program's place and computed
in bfloat16, the precision below the configuration's float32: on each
seed the passes a run would check (every pass counted as completed)
are computed by the reference twice, in float64 and in bfloat16, and
the bfloat16 outputs are compared with the float64 reference by the
run's own comparison.  Its smallest number is a limit's upper
reading.

Each line printed is one JSON object; the last line is the summary.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def control_numbers(config: dict, traffic: dict, seed: int, device,
                    npasses: int | None = None) -> dict:
    """The bfloat16 reference's numbers on one seed's beam."""
    import numpy as np

    from port_bench import beam as beam_mod
    from port_bench import harness
    from port_bench import plan as plan_mod
    from port_bench import reference as ref

    geom = beam_mod.Geometry.from_config(config)
    st = harness.stated(config)
    passes = plan_mod.interleaved(config["plan"])
    zaplist = harness.packaged_zaplist()
    freqs = geom.freqs()
    block, psr = beam_mod.make_beam(geom, traffic, seed, device)
    chk = config["check"]
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    nums: dict = {}
    picks = harness.choose_checks(passes, list(range(len(passes))), psr,
                                  seed, npasses or int(chk["passes"]))
    for idx in picks:
        want = harness.reference_pass(block, freqs, geom.tsamp_s,
                                      passes[idx], st, zaplist)
        low = harness.reference_pass(block, freqs, geom.tsamp_s,
                                     passes[idx], st, zaplist,
                                     ref.Prec("bf16"))
        rows = harness.pulsar_row(want.dms, psr)
        others = [r for r in range(len(want.dms)) if r not in rows]
        rng.shuffle(others)
        rows += others[:int(chk["hi_rows"])]
        out = harness.ref_outputs(low, st, rows, ref.Prec("bf16"))
        del low
        g = harness.compare_pass(want, [out], st, rows)
        g.pop("compared")
        for k, v in g.items():
            nums[k] = max(nums.get(k, 0.0), v)
        del want
    return nums


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=("program", "lowpath", "control"),
                    required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args()

    from port_bench import harness

    bench = harness.load_benchmark()
    _cell, config, traffic = harness.find_cell(bench, args.workload)
    if args.mode == "lowpath":
        if "control_environment" not in config:
            print("port_bench control: the configuration names no "
                  "lower-precision path", file=sys.stderr)
            return 2
        config = {**config, "environment": config["control_environment"]}
    harness.setup_caches()
    import torch

    if not torch.cuda.is_available():
        print("port_bench control: needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    seconds = args.seconds or bench["run_seconds"]
    worst: dict = {}
    best: dict = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.mode in ("program", "lowpath"):
            res, rows = harness.run(
                harness.cell_metrics(bench, args.workload, False), config,
                traffic, seed, seconds, False, dev, t0)
            nums = {k: v for k, v, _lim in rows}
            line = {"seed": seed, "correct": res["correct"],
                    "failed": res["failed"], "numbers": nums,
                    "metrics": {k: m["value"]
                                for k, m in res["metrics"].items()}}
        else:
            nums = control_numbers(config, traffic, seed, dev)
            line = {"seed": seed, "numbers": nums}
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
            best[k] = min(best.get(k, v), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "environment": config.get("environment", {}),
                      "seeds": args.seeds, "largest": worst,
                      "smallest": best,
                      "card": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
