"""Sifted candidate-list file format (.accelcands).

Text format with capability parity to the reference's
lib/python/formats/accelcands.py (AccelCand/AccelCandlist/DMHit,
parse_candlist at :125): one line per candidate with its DM-hit
detail lines, parseable back into the same structures the uploader
consumes.
"""

from __future__ import annotations

import re

import numpy as np

from tpulsar_torch.search.sifting import Candidate

_CAND_RE = re.compile(
    r"^\s*(?P<num>\d+)\s+(?P<sigma>[\deE+.-]+)\s+(?P<numharm>\d+)\s+"
    r"(?P<power>[\deE+.-]+)\s+(?P<dm>[\d.]+)\s+(?P<r>[\deE+.-]+)\s+"
    r"(?P<z>[\deE+.-]+)\s+(?P<period_ms>[\deE+.-]+)\s+(?P<freq>[\deE+.-]+)")
_HIT_RE = re.compile(r"^\s+DM=\s*(?P<dm>[\d.]+)\s+sigma=\s*(?P<sigma>[\d.]+)")


def write_candlist(cands: list[Candidate], path: str,
                   baryv: float = 0.0) -> None:
    """Write the sifted candidate list.

    baryv (v/c, positive receding) converts the internally topocentric
    candidate frequencies to the barycentric frame for reporting,
    f_bary = f_topo * (1 + baryv) — the frame PRESTO's .accelcands
    carry because its time series are barycentred before the FFT
    (the reference passes the same velocity to zapbirds,
    PALFA2_presto_search.py:551-553).  r and z stay topocentric: they
    record where in our spectra the detection actually is.
    """
    scale = 1.0 + baryv
    with open(path, "w") as fh:
        fh.write("#cand   sigma  numharm     power        DM"
                 "            r         z   period(ms)     freq(Hz)\n")
        for i, c in enumerate(cands, start=1):
            fh.write(f"{i:5d} {c.sigma:8.2f} {c.numharm:8d} "
                     f"{c.power:12.4f} {c.dm:9.2f} {c.r:12.2f} "
                     f"{c.z:9.2f} {c.period_s / scale * 1e3:12.6f} "
                     f"{c.freq_hz * scale:12.6f}\n")
            for dm, sigma in sorted(c.dm_hits):
                fh.write(f"    DM= {dm:7.2f} sigma= {sigma:6.2f}\n")


def parse_candlist(path: str) -> list[Candidate]:
    cands: list[Candidate] = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            m = _CAND_RE.match(line)
            if m:
                cands.append(Candidate(
                    r=float(m.group("r")), z=float(m.group("z")),
                    sigma=float(m.group("sigma")),
                    power=float(m.group("power")),
                    numharm=int(m.group("numharm")),
                    dm=float(m.group("dm")),
                    period_s=float(m.group("period_ms")) / 1e3,
                    freq_hz=float(m.group("freq")), dm_hits=[]))
                continue
            h = _HIT_RE.match(line)
            if h and cands:
                cands[-1].dm_hits.append(
                    (float(h.group("dm")), float(h.group("sigma"))))
    return cands
