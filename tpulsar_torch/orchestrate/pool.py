"""The job pool: create jobs from downloaded file groups, submit them
through the queue backend, track state, and recover from failures —
counterpart of tpulsar/orchestrate/pool.py (a copy).

Capability parity with the reference's scheduler loop (lib/python/
job.py): create_jobs_for_new_files (:62), rotate (:107),
update_jobs_status_from_queue (:125), recover_failed_jobs (:184) with
max_attempts and terminal-failure notification, submit_jobs (:257)
retrying-before-new, the 3-tier submit error handling (:293-330), and
the output-dir scheme {base_results}/{mjd}/{obs_name}/{beam}/{date}
(:361-393).  All state lives in the job-tracker DB (SURVEY.md 2.2).
"""

from __future__ import annotations

import os
import time
import traceback

from tpulsar_torch.io import datafile
from tpulsar_torch.obs import telemetry
from tpulsar_torch.obs.log import get_logger
from tpulsar_torch.orchestrate.jobtracker import JobTracker, nowstr
from tpulsar_torch.orchestrate.queue_managers import (
    PipelineQueueManager,
    QueueManagerFatalError,
    QueueManagerJobFatalError,
    QueueManagerNonFatalError,
)
from tpulsar_torch.resilience import faults


class JobPool:
    def __init__(self, tracker: JobTracker,
                 queue_manager: PipelineQueueManager,
                 base_results_dir: str, max_attempts: int = 2,
                 notify=None, delete_raw_on_terminal: bool = False,
                 logger=None):
        self.t = tracker
        self.qm = queue_manager
        self.base_results_dir = base_results_dir
        self.max_attempts = max_attempts
        self.notify = notify or (lambda subject, body: None)
        self.delete_raw_on_terminal = delete_raw_on_terminal
        self.log = logger or get_logger("jobpool")

    # ------------------------------------------------------------- status

    def shutdown(self) -> int:
        """Release backend resources on daemon exit or test teardown:
        backends that own subprocesses (local; warm's fallback)
        expose shutdown() and reap them here so search children never
        outlive the daemon that submitted them.  Returns the number
        of jobs the backend killed (0 for cluster backends, whose
        jobs rightly outlive the submitting daemon)."""
        qm_shutdown = getattr(self.qm, "shutdown", None)
        if callable(qm_shutdown):
            return qm_shutdown()
        return 0

    def status(self) -> dict[str, int]:
        counts = {}
        for row in self.t.query(
                "SELECT status, COUNT(*) c FROM jobs GROUP BY status"):
            counts[row["status"]] = row["c"]
        return counts

    # ------------------------------------------------------------- rotate

    def rotate(self) -> None:
        """One scheduler iteration (reference job.py:107-123).
        Iteration latency feeds the tpulsar_pool_rotate_seconds
        histogram — a rotate that grows from ms to minutes (stuck
        queue backend, contended tracker DB) is visible in the daemon
        metrics export before it stalls job flow entirely."""
        t0 = time.time()
        try:
            self.create_jobs_for_new_files()
            self.update_jobs_status_from_queue()
            self.recover_failed_jobs()
            self.submit_jobs()
        finally:
            telemetry.pool_rotate_seconds().observe(time.time() - t0)

    # ------------------------------------------------- job creation

    def create_jobs_for_new_files(self) -> None:
        """Group downloaded files with no job into complete observation
        groups and make a job for each (reference job.py:62-105)."""
        rows = self.t.query(
            "SELECT f.id, f.filename FROM files f "
            "LEFT JOIN job_files jf ON jf.file_id = f.id "
            "WHERE f.status IN ('downloaded', 'added') AND jf.id IS NULL")
        if not rows:
            return
        by_name = {r["filename"]: r["id"] for r in rows}
        groups = datafile.group_files(list(by_name))
        for group in groups:
            if not datafile.is_complete(group):
                continue
            job_id = self.t.insert("jobs", status="new",
                                   details="waiting to be submitted")
            for fn in group:
                self.t.insert("job_files", job_id=job_id,
                              file_id=by_name[fn])
            self.log.info("created job %d for %s", job_id,
                          [os.path.basename(f) for f in group])

    # ------------------------------------------------- queue sync

    def update_jobs_status_from_queue(self) -> None:
        """Poll running submissions (reference job.py:125-182)."""
        rows = self.t.query(
            "SELECT s.id sid, s.job_id, s.queue_id FROM job_submits s "
            "JOIN jobs j ON j.id = s.job_id "
            "WHERE s.status='running'")
        for row in rows:
            qid = row["queue_id"]
            if self.qm.is_running(qid):
                continue
            if self.qm.had_errors(qid):
                errors = self.qm.get_errors(qid)
                self.t.update("job_submits", row["sid"],
                              status="processing_failed", details=errors[:4000])
                self.t.update("jobs", row["job_id"], status="failed",
                              details="processing failed")
                self.log.warning("job %d failed on queue %s",
                                 row["job_id"], qid)
            else:
                self.t.update("job_submits", row["sid"], status="processed",
                              details="finished cleanly")
                self.t.update("jobs", row["job_id"], status="processed",
                              details="waiting for upload")
                self.log.info("job %d processed", row["job_id"])

    # ------------------------------------------------- failure recovery

    def recover_failed_jobs(self) -> None:
        """Retry failed jobs up to max_attempts, then terminal failure
        (reference job.py:184-254)."""
        for row in self.t.query("SELECT id FROM jobs WHERE status='failed'"):
            job_id = row["id"]
            attempts = self.t.query(
                "SELECT COUNT(*) c FROM job_submits WHERE job_id=?",
                [job_id], fetchone=True)["c"]
            if attempts < self.max_attempts:
                self.t.update("jobs", job_id, status="retrying",
                              details=f"attempt {attempts} failed; retrying")
            else:
                self.t.update("jobs", job_id, status="terminal_failure",
                              details=f"failed {attempts} times")
                last = self.t.query(
                    "SELECT details FROM job_submits WHERE job_id=? "
                    "ORDER BY id DESC", [job_id], fetchone=True)
                self.notify(
                    f"job {job_id} terminally failed",
                    f"Job {job_id} exhausted {attempts} attempts.\n\n"
                    f"Last error:\n{last['details'] if last else '(none)'}")
                if self.delete_raw_on_terminal:
                    self._delete_raw_files(job_id)

    def _delete_raw_files(self, job_id: int) -> None:
        for row in self.t.query(
                "SELECT f.id, f.filename FROM files f "
                "JOIN job_files jf ON jf.file_id = f.id "
                "WHERE jf.job_id=?", [job_id]):
            if os.path.exists(row["filename"]):
                os.remove(row["filename"])
            self.t.update("files", row["id"], status="deleted",
                          details="deleted after terminal job failure")

    # ------------------------------------------------- submission

    def submit_jobs(self) -> None:
        """Submit retrying jobs before new ones (reference
        job.py:257-274)."""
        for status in ("retrying", "new"):
            for row in self.t.query(
                    "SELECT id FROM jobs WHERE status=? ORDER BY id",
                    [status]):
                if not self.qm.can_submit():
                    return
                self.submit(row["id"])

    def get_output_dir(self, fns: list[str]) -> str:
        """{base_results}/{mjd}/{obs_name}/{beam}/{proc_date}
        (reference job.py:361-393)."""
        obj = datafile.autogen_dataobj(fns)
        mjd = int(obj.timestamp_mjd)
        beam = obj.beam_id
        proc_date = time.strftime("%y%m%d")
        try:
            obs_name = obj.obs_name
        except Exception:
            obs_name = f"{obj.project_id}.{obj.source_name}.{mjd}"
        return os.path.join(self.base_results_dir, str(mjd), obs_name,
                            str(beam), proc_date)

    def submit(self, job_id: int) -> None:
        """Submit one job with the 3-tier error taxonomy (reference
        job.py:276-357)."""
        fns = [r["filename"] for r in self.t.query(
            "SELECT f.filename FROM files f JOIN job_files jf "
            "ON jf.file_id = f.id WHERE jf.job_id=?", [job_id])]
        try:
            # backend-agnostic injection point: shaped non-fatal so it
            # exercises the defer-and-retry tier of the taxonomy below
            # (the job stays queued; the next rotate resubmits)
            faults.fire("queue.submit",
                        make_exc=QueueManagerNonFatalError,
                        detail=f"job {job_id}")
            outdir = self.get_output_dir(fns)
            queue_id = self.qm.submit(fns, outdir, job_id)
        except QueueManagerJobFatalError as e:
            self.t.update("jobs", job_id, status="failed",
                          details=f"submission fatal: {e}")
            self.t.insert("job_submits", job_id=job_id,
                          status="submission_failed", details=str(e))
            self.log.error("job %d submission fatal: %s", job_id, e)
            return
        except QueueManagerNonFatalError as e:
            self.log.warning("job %d submission deferred: %s", job_id, e)
            return
        except QueueManagerFatalError:
            raise
        except Exception as e:
            self.t.update("jobs", job_id, status="failed",
                          details=f"unexpected submit error: {e}")
            self.t.insert("job_submits", job_id=job_id,
                          status="submission_failed",
                          details=traceback.format_exc()[:4000])
            self.log.error("job %d unexpected submit error: %s", job_id, e)
            return
        self.t.insert("job_submits", job_id=job_id, queue_id=queue_id,
                      output_dir=outdir,
                      base_output_dir=self.base_results_dir,
                      status="running", details="submitted")
        self.t.update("jobs", job_id, status="submitted",
                      details=f"queue id {queue_id}")
        self.log.info("job %d submitted as %s", job_id, queue_id)
