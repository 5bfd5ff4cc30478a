"""Uploadable result objects with verify-after-write — counterpart of
tpulsar/orchestrate/uploadables.py (a copy).

Mirrors the reference's upload framework (lib/python/upload.py:33-65 +
header.py / candidates.py / sp_candidates.py / diagnostics.py): each
Uploadable writes itself into the results DB, re-queries what was
written, and field-wise compares against its own comparison map — the
online consistency test of the production write path (SURVEY.md 4).
Headers propagate their id into dependent candidates/SP/diagnostics
before those upload (header.py:99-101).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Any

import numpy as np

from tpulsar_torch.checkpoint import hashing
from tpulsar_torch.orchestrate.results_db import ResultsDB


class UploadError(Exception):
    """Verification or parse failure: fail the job (re-process)."""


def _nowstr() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def _compare(expected: dict[str, Any], row, context: str) -> None:
    """Field-wise verify-after-write (reference header.py:150-230)."""
    problems = []
    for key, want in expected.items():
        got = row[key]
        if isinstance(want, float):
            import math
            if not math.isfinite(want):
                problems.append(
                    f"{key}: non-finite value {want!r} (NaN/inf cannot "
                    f"round-trip SQLite; fix the producing stage)")
                continue
            ok = (got is not None
                  and abs(got - want) <= 1e-6 * max(1.0, abs(want)))
        else:
            ok = got == want
        if not ok:
            problems.append(f"{key}: wrote {want!r} read back {got!r}")
    if problems:
        raise UploadError(f"verify-after-write failed for {context}: "
                          + "; ".join(problems))


class Uploadable:
    def upload(self, db: ResultsDB) -> int:
        raise NotImplementedError


@dataclasses.dataclass
class HeaderUpload(Uploadable):
    """Beam header (reference header.py:32-63 field set)."""
    obs_name: str
    beam_id: int
    original_file: str
    source_name: str
    ra_deg: float
    dec_deg: float
    gal_l: float
    gal_b: float
    obstime_s: float
    timestamp_mjd: float
    center_freq_mhz: float
    bw_mhz: float
    num_channels: int
    sample_time_us: float
    project_id: str
    observers: str
    file_size: int
    data_size: int
    num_samples: int
    telescope: str
    backend: str
    version_number: str
    dependents: list[Uploadable] = dataclasses.field(default_factory=list)
    header_id: int | None = None

    def add_dependent(self, dep: "Uploadable") -> None:
        self.dependents.append(dep)

    def upload(self, db: ResultsDB) -> int:
        cols = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in ("dependents", "header_id")}
        cols["uploaded_at"] = _nowstr()
        self.header_id = db.insert("headers", **cols)
        row = db.fetchone("SELECT * FROM headers WHERE id=?",
                          (self.header_id,))
        _compare({k: v for k, v in cols.items() if k != "uploaded_at"},
                 row, f"header {self.obs_name}")
        for dep in self.dependents:
            dep.header_id = self.header_id      # type: ignore[attr-defined]
            dep.upload(db)
        return self.header_id


@dataclasses.dataclass
class PeriodicityCandidateUpload(Uploadable):
    cand_num: int
    period_s: float
    freq_hz: float
    pdot: float
    dm: float
    snr: float
    sigma: float
    numharm: int
    fourier_bin: float
    z: float
    num_dm_hits: int
    reduced_chi2: float
    plots: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    # (plot_type, file path) pairs stored as blobs
    header_id: int | None = None

    def upload(self, db: ResultsDB) -> int:
        cols = dict(header_id=self.header_id, cand_num=self.cand_num,
                    period_s=self.period_s, freq_hz=self.freq_hz,
                    pdot=self.pdot, dm=self.dm, snr=self.snr,
                    sigma=self.sigma, numharm=self.numharm,
                    fourier_bin=self.fourier_bin, z=self.z,
                    num_dm_hits=self.num_dm_hits,
                    reduced_chi2=self.reduced_chi2,
                    uploaded_at=_nowstr())
        cand_id = db.insert("pdm_candidates", **cols)
        row = db.fetchone("SELECT * FROM pdm_candidates WHERE id=?",
                          (cand_id,))
        _compare({k: v for k, v in cols.items() if k != "uploaded_at"},
                 row, f"candidate {self.cand_num}")
        for plot_type, path in self.plots:
            with open(path, "rb") as fh:
                blob = fh.read()
            pid = db.insert("pdm_plots", cand_id=cand_id,
                            plot_type=plot_type,
                            filename=os.path.basename(path), blob=blob)
            back = db.fetchone("SELECT blob FROM pdm_plots WHERE id=?",
                               (pid,))
            # digest verify-after-write through the ONE shared sha256
            # helper (checkpoint/hashing.py — the checkpoint
            # manifests use the same one), and the error names what
            # diverged instead of a bare boolean
            want = hashing.sha256_bytes(blob)
            got = hashing.sha256_bytes(back["blob"] or b"")
            if got != want:
                raise UploadError(
                    f"plot blob verify failed for cand "
                    f"{self.cand_num}: wrote sha256 "
                    f"{hashing.short(want)} read back "
                    f"{hashing.short(got)}")
        return cand_id


@dataclasses.dataclass
class SinglePulseUpload(Uploadable):
    """SP events + the .singlepulse/.inf tarballs as blobs (reference
    sp_candidates.py stores tarballs via FTP; here they are DB blobs)."""
    events: np.ndarray
    tarballs: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    max_events: int = 10000
    header_id: int | None = None

    def upload(self, db: ResultsDB) -> int:
        n = 0
        for ev in self.events[: self.max_events]:
            db.insert("sp_candidates", header_id=self.header_id,
                      dm=float(ev["dm"]), sigma=float(ev["sigma"]),
                      time_s=float(ev["time_s"]), sample=int(ev["sample"]),
                      downfact=int(ev["downfact"]), uploaded_at=_nowstr())
            n += 1
        back = db.fetchone(
            "SELECT COUNT(*) c FROM sp_candidates WHERE header_id=?",
            (self.header_id,))
        if back["c"] != n:
            raise UploadError(
                f"sp event count verify failed: wrote {n} read {back['c']}")
        for file_type, path in self.tarballs:
            with open(path, "rb") as fh:
                db.insert("sp_files", header_id=self.header_id,
                          file_type=file_type,
                          filename=os.path.basename(path), blob=fh.read())
        return n


@dataclasses.dataclass
class FloatDiagnosticUpload(Uploadable):
    name: str
    value: float
    header_id: int | None = None

    def upload(self, db: ResultsDB) -> int:
        did = db.insert("diagnostics", header_id=self.header_id,
                        name=self.name, type="float", value=self.value,
                        uploaded_at=_nowstr())
        row = db.fetchone("SELECT * FROM diagnostics WHERE id=?", (did,))
        _compare({"name": self.name, "value": float(self.value)}, row,
                 f"diagnostic {self.name}")
        return did


@dataclasses.dataclass
class PlotDiagnosticUpload(Uploadable):
    name: str
    path: str
    header_id: int | None = None

    def upload(self, db: ResultsDB) -> int:
        with open(self.path, "rb") as fh:
            blob = fh.read()
        did = db.insert("diagnostics", header_id=self.header_id,
                        name=self.name, type="plot",
                        filename=os.path.basename(self.path), blob=blob,
                        uploaded_at=_nowstr())
        row = db.fetchone("SELECT blob FROM diagnostics WHERE id=?", (did,))
        want = hashing.sha256_bytes(blob)
        got = hashing.sha256_bytes(row["blob"] or b"")
        if got != want:
            raise UploadError(
                f"plot diagnostic verify failed: {self.name}: wrote "
                f"sha256 {hashing.short(want)} read back "
                f"{hashing.short(got)}")
        return did
