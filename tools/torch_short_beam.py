#!/usr/bin/env python3
"""The smoke's Mock beam cut to NSAMP / k, searched by tpulsar_torch.

    python3 tools/torch_short_beam.py [--cut 8] [--synth-device cpu]
                                      [--device cuda] [--out DIR]

Writes the beam chip_smoke.py's mock_spec(NSAMP // k) describes (960
channels, 65.476 us, 4-bit, seed 20261016; one pulsar, P = 0.25 s,
DM 50, 10% width, 0.1 sigma per sample per channel) with
synth.synth_beam_slabs on --synth-device (the noise is torch's
generator on that device: a beam made on the CPU is the same file on
any host, one made on the card differs), prints its sha256, and
searches it with search_beam at SearchParams(make_plots=False), the
Mock survey plan and the packaged default zaplist on --device.
Prints, as one JSON line: the wall time, the number of candidates and
the five .accelcands rows nearest the pulsar's period (period,
relative period error, DM, z, sigma, harmonics).  A beam of 32 s
(k = 8) has Fourier bins 1/32 s apart, about 0.8% of the pulsar's
4 Hz.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpulsar_torch import checkpoint  # noqa: E402
from tpulsar_torch.cli import search_job  # noqa: E402
from tpulsar_torch.io import accelcands, synth  # noqa: E402
from tpulsar_torch.plan import ddplan  # noqa: E402
from tpulsar_torch.search import executor  # noqa: E402

NCHAN, TSAMP, NSAMP = 960, 65.476e-6, 3_932_160
PSR_PERIOD, PSR_DM = 0.25, 50.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cut", type=int, default=8,
                    help="the beam is NSAMP // CUT samples long")
    ap.add_argument("--synth-device", default="cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="",
                    help="work directory (default: a temporary one)")
    args = ap.parse_args(argv)
    root = args.out or tempfile.mkdtemp(prefix="tpulsar_short_beam_")
    spec = synth.BeamSpec(nchan=NCHAN, nsamp=NSAMP // args.cut,
                          tsamp_s=TSAMP, fctr_mhz=1375.5,
                          bw_mhz=322.617, nbits=4, nsblk=64,
                          backend="pdev", seed=20261016)
    fns = synth.synth_beam_slabs(
        os.path.join(root, "beam"), spec,
        pulsars=[synth.PulsarSpec(period_s=PSR_PERIOD, dm=PSR_DM,
                                  width_frac=0.1, snr_per_sample=0.1)],
        device=args.synth_device)
    sha = checkpoint.sha256_file(fns[0])
    t0 = time.time()
    out = executor.search_beam(
        fns, os.path.join(root, "work"), os.path.join(root, "results"),
        executor.SearchParams(make_plots=False),
        zaplist=search_job.choose_zaplist(["beam.fits"], None, None),
        plan=ddplan.survey_plan("pdev"), device=args.device)
    wall = time.time() - t0
    cands = accelcands.parse_candlist(os.path.join(
        out.resultsdir, f"{out.basenm}.accelcands"))
    near = sorted(cands, key=lambda c: abs(c.period_s - PSR_PERIOD))[:5]
    print(json.dumps({
        "nsamp": spec.nsamp, "synth_device": args.synth_device,
        "device": args.device, "sha256": sha, "wall_s": wall,
        "candidates": len(cands),
        "nearest": [{"period_s": c.period_s,
                     "rel_err": (c.period_s - PSR_PERIOD) / PSR_PERIOD,
                     "dm": c.dm, "z": c.z, "sigma": c.sigma,
                     "numharm": c.numharm} for c in near]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
