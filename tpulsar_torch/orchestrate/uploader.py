"""Upload orchestrator: find processed submissions, parse their result
directories, and upload everything in one verified transaction —
counterpart of tpulsar/orchestrate/uploader.py (a copy).

Capability parity with the reference's JobUploader (lib/python/
JobUploader.py): processed submits are discovered from the tracker
(:34-37), the whole beam (header + candidates + SP + diagnostics) is
one transaction so partial uploads are impossible (:93-134,183-185),
the error taxonomy maps parse/verify failures to job failure
(re-process), connection/deadlock errors to retry-later (:137-182),
and the code version is pinned per results dir via version_number.txt
so retried uploads use the original version (:48-70).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import subprocess
import time
import traceback

import numpy as np

from tpulsar_torch.io import accelcands
from tpulsar_torch.obs import telemetry
from tpulsar_torch.obs.log import get_logger
from tpulsar_torch.orchestrate import diagnostics as diag_mod
from tpulsar_torch.orchestrate.jobtracker import JobTracker
from tpulsar_torch.orchestrate.results_db import (
    DatabaseConnectionError,
    DatabaseDeadlockError,
    ResultsDB,
)
from tpulsar_torch.orchestrate.uploadables import (
    HeaderUpload,
    PeriodicityCandidateUpload,
    SinglePulseUpload,
    UploadError,
)
from tpulsar_torch.resilience import faults
from tpulsar_torch.resilience import policy as rpolicy

#: in-process deadlock retries before deferring the submit to the next
#: daemon iteration: writer contention usually clears in seconds, so a
#: couple of immediate replays beat a full-cycle wait — connection
#: errors are NOT retried here (the server may be down for a while;
#: the retry-later DB state handles those)
DEADLOCK_RETRY = rpolicy.RetryPolicy(
    max_attempts=3, backoff_base_s=1.0, backoff_mult=2.0,
    backoff_max_s=10.0, jitter=True,
    retry_on=(DatabaseDeadlockError,))


def pipeline_version() -> str:
    """Code version: git hash of the checkout (reference
    config/upload.py:7-21 hashes PRESTO+pipeline+psrfits_utils), else
    the package version when the tree has no .git (an exported
    copy)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "-C", repo, "rev-parse",
                              "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:
        pass
    from tpulsar_torch import __version__
    return f"v{__version__}"


def get_version_number(resultsdir: str) -> str:
    """Pin the version per results dir (reference JobUploader.py:48-70)."""
    path = os.path.join(resultsdir, "version_number.txt")
    if os.path.exists(path):
        with open(path) as fh:
            return fh.read().strip()
    ver = pipeline_version()
    with open(path, "w") as fh:
        fh.write(ver + "\n")
    return ver


#: per-category accumulated upload times, printed after each upload
#: under the 'upload' debug flag (reference upload_timing_summary,
#: JobUploader.py:88-90,105-129,208-215).  The same timings ALWAYS
#: feed the tpulsar_upload_seconds metrics histogram — the debug flag
#: only gates the print, so the per-category distribution is
#: observable (stats/exports) without rerunning under the flag.
upload_timing_summary: dict[str, float] = {}


@contextlib.contextmanager
def _timed(category: str):
    t0 = time.time()
    try:
        yield
    finally:
        elapsed = time.time() - t0
        upload_timing_summary[category] = (
            upload_timing_summary.get(category, 0.0) + elapsed)
        telemetry.upload_seconds().observe(elapsed, category=category)


class JobUploader:
    def __init__(self, tracker: JobTracker, db_url: str | None = None,
                 notify=None, delete_raw_on_upload: bool = False,
                 logger=None):
        self.t = tracker
        self.db_url = db_url
        self.notify = notify or (lambda subject, body: None)
        self.delete_raw_on_upload = delete_raw_on_upload
        self.log = logger or get_logger("uploader")

    def run(self) -> None:
        """One daemon iteration: upload every processed submit."""
        rows = self.t.query(
            "SELECT s.id sid, s.job_id, s.output_dir FROM job_submits s "
            "WHERE s.status='processed'")
        for row in rows:
            self.upload_results(row["sid"], row["job_id"],
                                row["output_dir"])
        from tpulsar_torch.obs import debugflags
        if rows and debugflags.is_on("upload"):
            print("Upload timing summary:")
            for cat, secs in sorted(upload_timing_summary.items()):
                print(f"    {cat}: {secs:.2f} s")

    # -------------------------------------------------------------- parse

    def parse_results(self, resultsdir: str):
        """Build the uploadable tree from a results directory."""
        hdr_path = os.path.join(resultsdir, "header.json")
        if not os.path.exists(hdr_path):
            raise UploadError(f"no header.json in {resultsdir}")
        with open(hdr_path) as fh:
            hdr_fields = json.load(fh)
        version = get_version_number(resultsdir)
        header = HeaderUpload(version_number=version, **hdr_fields)
        basenm = _basenm_from_dir(resultsdir)

        candfile = os.path.join(resultsdir, f"{basenm}.accelcands")
        cands = accelcands.parse_candlist(candfile) \
            if os.path.exists(candfile) else []
        for i, c in enumerate(cands, start=1):
            plots = []
            pfd = os.path.join(resultsdir, f"{basenm}_cand{i}.pfd.npz")
            bp = os.path.join(resultsdir, f"{basenm}_cand{i}.bestprof")
            chi2 = 0.0
            if os.path.exists(pfd):
                plots.append(("pfd", pfd))
                with np.load(pfd) as z:
                    chi2 = float(z["reduced_chi2"])
            if os.path.exists(bp):
                plots.append(("bestprof", bp))
            header.add_dependent(PeriodicityCandidateUpload(
                cand_num=i, period_s=c.period_s, freq_hz=c.freq_hz,
                pdot=0.0, dm=c.dm, snr=float(np.sqrt(max(c.power, 0.0))),
                sigma=c.sigma, numharm=c.numharm, fourier_bin=c.r,
                z=c.z, num_dm_hits=c.num_dm_hits, reduced_chi2=chi2,
                plots=plots))

        sp_npz = os.path.join(resultsdir, f"{basenm}_sp.npz")
        events = (np.load(sp_npz)["events"] if os.path.exists(sp_npz)
                  else np.empty(0))
        tarballs = [(suffix.strip("_").replace(".tgz", ""), p)
                    for suffix in ("_singlepulse.tgz", "_inf.tgz")
                    for p in glob.glob(os.path.join(resultsdir,
                                                    f"{basenm}{suffix}"))]
        sp = SinglePulseUpload(events=events, tarballs=tarballs)
        header.add_dependent(sp)

        diags = diag_mod.get_diagnostics(resultsdir, basenm)
        return header, diags

    # ------------------------------------------------------------- upload

    def upload_results(self, submit_id: int, job_id: int,
                       resultsdir: str) -> None:
        """One-beam upload with the reference's rollback taxonomy
        (JobUploader.py:73-206)."""
        t_start = time.time()
        # A clean worker-side skip (e.g. observation below the
        # low_T_to_search threshold) writes skipped.txt and no
        # header.json.  Move the job to a TERMINAL skipped state
        # instead of the failed->retry->terminal loop the missing
        # header would otherwise cause (the skip would be re-searched
        # max_attempts times just to be skipped again).
        skip_path = os.path.join(resultsdir, "skipped.txt")
        if os.path.exists(skip_path):
            with open(skip_path) as fh:
                reason = fh.read().strip()
            self.t.update("job_submits", submit_id, status="skipped",
                          details=reason[:4000])
            self.t.update("jobs", job_id, status="skipped",
                          details=reason[:4000])
            self.log.info("submit %d skipped: %s", submit_id, reason)
            # terminal state: reclaim raw data like the other
            # terminal outcomes (uploaded / terminal_failure) do
            if self.delete_raw_on_upload:
                self._delete_raw(job_id)
            return
        try:
            with _timed("Parsing"):
                header, diags = self.parse_results(resultsdir)
        except UploadError as e:
            self.t.update("job_submits", submit_id, status="upload_failed",
                          details=str(e)[:4000])
            self.t.update("jobs", job_id, status="failed",
                          details="result parsing failed")
            telemetry.uploads_total().inc(outcome="failed")
            self.log.warning("submit %d parse failed: %s", submit_id, e)
            return

        db = None
        try:
            db = ResultsDB(self.db_url)

            def _transaction():
                # the injected failure is connection-shaped so it
                # exercises the retry-later taxonomy (leave the submit
                # 'processed'; a later daemon iteration re-uploads)
                faults.fire("upload.write",
                            make_exc=DatabaseConnectionError,
                            detail=f"submit {submit_id}")
                with _timed("Header (incl. candidates + SP)"):
                    header.upload(db)
                with _timed("Diagnostics"):
                    for d in diags:
                        d.header_id = header.header_id
                        d.upload(db)
                db.commit()

            rpolicy.call(
                _transaction, DEADLOCK_RETRY,
                on_retry=lambda k, e: (
                    db.rollback(),
                    self.log.warning(
                        "submit %d deadlocked (attempt %d): %s; "
                        "replaying transaction", submit_id, k + 1, e)))
            upload_timing_summary["End-to-end"] = (
                upload_timing_summary.get("End-to-end", 0.0)
                + time.time() - t_start)
        except (DatabaseConnectionError, DatabaseDeadlockError) as e:
            if db:
                db.rollback()
            telemetry.uploads_total().inc(outcome="deferred")
            self.log.warning("submit %d upload deferred: %s", submit_id, e)
            return                      # leave processed: retry later
        except UploadError as e:
            if db:
                db.rollback()
            self.t.update("job_submits", submit_id, status="upload_failed",
                          details=str(e)[:4000])
            self.t.update("jobs", job_id, status="failed",
                          details="upload verification failed")
            telemetry.uploads_total().inc(outcome="failed")
            self.log.warning("submit %d upload failed: %s", submit_id, e)
            return
        except Exception:
            if db:
                db.rollback()
            # the counter must see EVERY attempt outcome: a daemon
            # hot-looping on an unexpected error would otherwise show
            # no upload activity at all in the metrics export
            telemetry.uploads_total().inc(outcome="error")
            self.log.error("submit %d unexpected upload error:\n%s",
                           submit_id, traceback.format_exc())
            raise
        finally:
            if db:
                db.close()

        self.t.update("job_submits", submit_id, status="uploaded",
                      details="uploaded and verified")
        self.t.update("jobs", job_id, status="uploaded",
                      details="complete")
        telemetry.uploads_total().inc(outcome="uploaded")
        self.log.info("submit %d uploaded (header %s)", submit_id,
                      header.header_id)
        if self.delete_raw_on_upload:
            self._delete_raw(job_id)

    def _delete_raw(self, job_id: int) -> None:
        for row in self.t.query(
                "SELECT f.id, f.filename FROM files f JOIN job_files jf "
                "ON jf.file_id=f.id WHERE jf.job_id=?", [job_id]):
            if os.path.exists(row["filename"]):
                os.remove(row["filename"])
            self.t.update("files", row["id"], status="deleted",
                          details="deleted after successful upload")


def _basenm_from_dir(resultsdir: str) -> str:
    """Recover the beam base name from the artifacts present."""
    reports = glob.glob(os.path.join(resultsdir, "*.report"))
    if reports:
        return os.path.splitext(os.path.basename(reports[0]))[0]
    cands = glob.glob(os.path.join(resultsdir, "*.accelcands"))
    if cands:
        return os.path.splitext(os.path.basename(cands[0]))[0]
    raise UploadError(f"cannot determine base name in {resultsdir}")
