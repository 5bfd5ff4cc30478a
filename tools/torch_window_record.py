"""One window of a benchmark cell, read from the program's own record:
the wall-clock stage seconds (StageTimers.times) beside the device
seconds the CUDA events give (StageTimers.record), the host's waits
and the checkpoint saves, summed over the window's calls.

    python3 tools/torch_window_record.py --workload mock_zeroaccel.plan \
        --seed N [--seconds 51] [--trace-file out.json]

Runs the cell as port_bench/run.py does (harness.run_cell: the same
set-up, beam, warm call and window) with each window call's
StageTimers bound, stops once the window has closed (no traced slice,
no check) and prints one JSON line.  --trace-file turns the program's
tracer on for the window (TPULSAR_TRACE's spans, the device track) and
writes its Chrome trace there, for the tracer's cost and the file's
size.  Needs a CUDA device.  A stand-in until the harness sums the
record itself.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: (name, stages) of the per-trial stage groups the benchmark reads
GROUPS = (("sp", ("single-pulse",)),
          ("fft_lo", ("FFT", "lo-accelsearch")),
          ("hi", ("hi-accelsearch",)))


class WindowRead(Exception):
    """The window has closed: args (window, set-up seconds)."""


@contextlib.contextmanager
def recording_window(device, trace_file: str = ""):
    """Within, harness.run_window binds the timers of each call it
    makes (traced too, with trace_file) and raises WindowRead once it
    returns, so the run ends before its check."""
    from port_bench import harness

    real_window = harness.run_window

    def window(*args, **kwargs):
        from tpulsar_torch.obs import trace
        from tpulsar_torch.search import executor

        real_block = executor.search_block

        def bound_block(*a, timers=None, **kw):
            timers.bind(device)
            return real_block(*a, timers=timers, **kw)

        setup_s = time.perf_counter() - T_START
        executor.search_block = bound_block
        if trace_file:
            trace.start(clear=True)
        try:
            win = real_window(*args, **kwargs)
        finally:
            executor.search_block = real_block
        if trace_file:
            trace.stop()
            trace.save(trace_file)
        raise WindowRead(win, setup_s)

    harness.run_window = window
    try:
        yield
    finally:
        harness.run_window = real_window


def sum_records(calls) -> dict:
    """The calls' StageTimers.record summed: numbers added, dicts added
    key by key."""
    from tpulsar_torch.search.report import new_record

    out = new_record()
    for c in calls:
        for k, v in c.timers.record.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    out[k][kk] = out[k].get(kk, 0) + vv
            else:
                out[k] += v
    return out


def summary(win: dict, passes) -> dict:
    """The window's numbers: rate, wall and device seconds per 1000
    trials of each stage group, device over wall, and the counters as
    shares of the window."""
    calls = win["calls"]
    trials = sum(passes[i].ndms for c in calls for i, _t in c.passes)
    window_s = win["t1"] - win["t0"]
    rec = sum_records(calls)
    wall = win["stage_s"]
    out = {"dm_trials_per_s": trials / window_s, "window_s": window_s,
           "trials": trials, "calls": len(calls)}
    for name, stages in GROUPS:
        w = sum(wall.get(s, 0.0) for s in stages)
        d = sum(rec["device_s"].get(s, 0.0) for s in stages)
        if w > 0:
            out[f"{name}_s_per_ktrial"] = w / (trials / 1000.0)
            out[f"{name}_device_s_per_ktrial"] = d / (trials / 1000.0)
            out[f"{name}_device_over_wall"] = d / w
    out["host_wait_share"] = 100.0 * rec["host_wait_s"] / window_s
    out["checkpoint_share"] = 100.0 * rec["checkpoint_s"] / window_s
    out["stage_s"] = wall
    out["record"] = rec
    return out


def run(workload: str, seed: int, seconds: float,
        trace_file: str = "") -> dict:
    import torch

    from port_bench import harness
    from port_bench import plan as plan_mod

    bench = harness.load_benchmark()
    _cell, config, _traffic = harness.find_cell(bench, workload)
    harness.setup_caches()
    device = torch.device("cuda", 0)
    try:
        with recording_window(device, trace_file):
            harness.run_cell(workload, seed, seconds, False, device,
                             T_START, bench=bench)
        raise RuntimeError("the window never closed")
    except WindowRead as read:
        win, setup_s = read.args
    out = {"workload": workload, "seed": seed, "setup_s": setup_s,
           "device": torch.cuda.get_device_name(device),
           "traced": bool(trace_file)}
    out.update(summary(win, plan_mod.interleaved(config["plan"])))
    if trace_file:
        out["trace_bytes"] = os.path.getsize(trace_file)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace-file", default="")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.workload, args.seed, args.seconds,
                         args.trace_file)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
