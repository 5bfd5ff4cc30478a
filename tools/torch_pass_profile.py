#!/usr/bin/env python3
"""Where one Mock-survey pass spends its time on the GPU (tpulsar_torch).

    python3 tools/torch_pass_profile.py [--step 0] [--zero-accel]
                                        [--out DIR]

Builds a full-width PALFA Mock block (960 channels x 3,932,160 uint8
samples, random, made on the device from a seed: no file), then runs
tpulsar_torch.search.executor.search_block over one pass of the chosen
survey-plan step (76 trials at downsample 1 for step 0), once to warm
up and once under torch.profiler.  The configuration is the default
search, SearchParams(make_plots=False), so the hi-accel stage's
operations show by name (a noise block leaves no candidate to refine
or fold); --zero-accel runs SearchParams.slice_defaults() instead.
Prints, as one JSON line: the pass's wall time, the device-busy time
(the sum of the kernels' device times: one stream, so they do not
overlap), the device idle share, each StageTimers stage, and the 15
kernels with the most device time.  With --out the Chrome trace
is written there too.  Needs a CUDA device; imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpulsar_torch.io import synth  # noqa: E402
from tpulsar_torch.plan import ddplan  # noqa: E402
from tpulsar_torch.search import executor  # noqa: E402
from tpulsar_torch.search.report import StageTimers  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", type=int, default=0,
                    help="survey-plan step whose first pass is run")
    ap.add_argument("--zero-accel", action="store_true",
                    help="the zero-accel configuration (hi stage off)")
    ap.add_argument("--out", default="",
                    help="directory for the Chrome trace (optional)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_pass_profile: needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    spec = synth.BeamSpec(nchan=960, nsamp=3_932_160, tsamp_s=65.476e-6,
                          fctr_mhz=1375.5, bw_mhz=322.617)
    freqs = synth.channel_freqs(spec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    data = torch.randint(0, 256, (spec.nchan, spec.nsamp), generator=gen,
                         device=dev, dtype=torch.uint8)
    step = ddplan.survey_plan("pdev")[args.step]
    one_pass = [ddplan.DedispStep(step.lodm, step.dmstep,
                                  step.dms_per_pass, 1, step.numsub,
                                  step.downsamp)]
    params = (executor.SearchParams.slice_defaults() if args.zero_accel
              else executor.SearchParams(make_plots=False))

    def run(timers):
        executor.search_block(data, freqs, spec.tsamp_s, one_pass, params,
                              timers=timers, device=dev)
        torch.cuda.synchronize()

    run(StageTimers())                                   # warm-up
    timers = StageTimers()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(timers)
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.out, f"pass_step{args.step}_"
            f"{'zero_accel' if args.zero_accel else 'default'}_trace.json"))
    print(json.dumps({
        "card": card, "step": args.step, "downsamp": step.downsamp,
        "config": "zero-accel" if args.zero_accel else "default",
        "trials": step.dms_per_pass, "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6 if kernels else None,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_s)
        if kernels else None,
        "stage_s": {k: v for k, v in timers.times.items() if v},
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in top],
    }))


if __name__ == "__main__":
    main()
