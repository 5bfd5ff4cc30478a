#!/usr/bin/env python3
"""What TPULSAR_PROFILE costs a beam on the GPU (tpulsar_torch).

    python3 tools/torch_profile_cost.py [--nsamp 983040]

Synthesizes chip_smoke.py's Mock beam (960 channels, 65.476 us, 4-bit,
one pulsar; a quarter of the full beam's 3,932,160 samples by default)
on the device, searches it once unprofiled with search_beam at
SearchParams(make_plots=False), then once more inside
torch.profiler.profile (CPU and CUDA activities, a search_block
record_function range: what TPULSAR_PROFILE wraps), and times each
part of the profile's cost apart: the profiled search, the profiler's
stop, kineto's JSON export, gzip of that JSON at levels 1, 6 and 9
(tensorboard_trace_handler's use_gzip=True is level 9), and a parse
of the level-1 file (gzip + json).  Prints the card's name and power
limit, then one JSON line with every time (s), the raw and gzipped
sizes (bytes) and the events by category.  Needs a CUDA device;
imports nothing of the JAX package.  The beam and the trace go to a
temporary directory that is removed.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpulsar_torch.io import synth  # noqa: E402
from tpulsar_torch.kernels import cuda_dd  # noqa: E402
from tpulsar_torch.search import executor  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nsamp", type=int, default=983_040,
                    help="samples of the beam (default: a quarter beam)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_cost: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    cuda_dd.build()
    tmp = tempfile.mkdtemp(prefix="torch_profile_cost_")
    out: dict = {"nsamp": args.nsamp}
    try:
        spec = synth.BeamSpec(nchan=960, nsamp=args.nsamp,
                              tsamp_s=65.476e-6, fctr_mhz=1375.5,
                              bw_mhz=322.617, nbits=4, nsblk=64,
                              backend="pdev", seed=20261016)
        fns = synth.synth_beam_slabs(
            os.path.join(tmp, "beam"), spec,
            pulsars=[synth.PulsarSpec(period_s=0.25, dm=50.0,
                                      width_frac=0.1,
                                      snr_per_sample=0.1)],
            device=dev)
        params = executor.SearchParams(make_plots=False)
        t0 = time.time()
        executor.search_beam(fns, os.path.join(tmp, "w0"),
                             os.path.join(tmp, "r0"), params, device=dev)
        out["plain_search_s"] = time.time() - t0
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        t0 = time.time()
        prof.start()
        with torch.profiler.record_function("search_block"):
            executor.search_beam(fns, os.path.join(tmp, "w1"),
                                 os.path.join(tmp, "r1"), params,
                                 device=dev)
        t1 = time.time()
        prof.stop()
        t2 = time.time()
        raw = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(raw)
        t3 = time.time()
        out.update(profiled_search_s=t1 - t0, stop_s=t2 - t1,
                   export_s=t3 - t2, raw_bytes=os.path.getsize(raw))
        for level in (1, 6, 9):
            t0 = time.time()
            with open(raw, "rb") as fin, \
                    gzip.open(f"{raw}.{level}.gz", "wb",
                              compresslevel=level) as fout:
                shutil.copyfileobj(fin, fout, 1 << 20)
            out[f"gzip{level}_s"] = time.time() - t0
            out[f"gzip{level}_bytes"] = os.path.getsize(f"{raw}.{level}.gz")
        t0 = time.time()
        with gzip.open(f"{raw}.1.gz", "rt") as fh:
            events = json.load(fh)["traceEvents"]
        out["parse_s"] = time.time() - t0
        cats: dict = {}
        for e in events:
            cat = str(e.get("cat"))
            cats[cat] = cats.get(cat, 0) + 1
        out.update(events=len(events), categories=cats)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
