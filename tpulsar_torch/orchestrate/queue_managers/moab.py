"""Moab queue backend (msub/showq/canceljob via subprocess) — counterpart of
tpulsar/orchestrate/queue_managers/moab.py (a copy).

Covers the reference's Moab backend capabilities
(lib/python/queue_managers/moab.py), whose distinguishing trait is
tolerance of a flaky scheduler front end:

- walltime provisioned from input size with the hours-per-GB
  heuristic (moab.py:14,72-79);
- a TTL-cached ``showq --xml`` snapshot shared by every poll
  (moab.py:365-393) so a rotate loop over hundreds of jobs costs one
  scheduler round trip;
- "communication error" replies are absorbed, not raised: a lost
  msub reply is recovered by looking the submission up BY JOB NAME in
  showq (the submit may well have landed even though the reply was
  lost, moab.py:94-139), ``is_running`` assumes alive (moab.py:160-174),
  and ``status`` reports (9999, 9999) so ``can_submit`` blocks new
  submissions until the scheduler answers again (moab.py:282-283).

Error detection is stderr-file based through the shared
SubmitRegistry (restart-safe), like the other CLI backends.
"""

from __future__ import annotations

import os
import subprocess
import time
from xml.etree import ElementTree

from tpulsar_torch.orchestrate.queue_managers import (
    CLIQueueBackend,
    QueueManagerFatalError,
    QueueManagerJobFatalError,
    QueueManagerNonFatalError,
    SubmitRegistry,
)
from tpulsar_torch.resilience import policy as rpolicy


class _SchedulerUnanswered(QueueManagerNonFatalError):
    """showq replied with a communication error (or nothing usable)
    during lost-msub recovery: not a definitive answer, retry."""

#: scheduler states that mean "no longer occupying the queue"
_GONE_STATES = ("Completed", "Canceling", "DNE")


def _gone(state: str) -> bool:
    return any(g in state for g in _GONE_STATES)


class MoabManager(CLIQueueBackend):
    def __init__(self, script: str, queue_name: str = "",
                 max_jobs_running: int = 50, max_jobs_queued: int = 1,
                 walltime_per_gb: float = 50.0,
                 job_basename: str = "tpulsar",
                 showq_ttl_s: float = 300.0,
                 comm_retry_limit: int = 10,
                 retry_wait_s: float = 30.0,
                 state_file: str | None = None,
                 runner=subprocess.run,
                 sleeper=time.sleep,
                 clock=time.monotonic):
        self.script = script
        self.queue_name = queue_name
        self.max_jobs_running = max_jobs_running
        self.max_jobs_queued = max_jobs_queued
        self.walltime_per_gb = walltime_per_gb
        self.job_basename = job_basename
        self.showq_ttl_s = showq_ttl_s
        self.comm_retry_limit = comm_retry_limit
        self.retry_wait_s = retry_wait_s
        self._run = runner           # injectable for hermetic tests
        self._sleep = sleeper
        self._clock = clock
        self._stderr = SubmitRegistry(state_file)
        # showq cache: {option: [(queue_id, job_name, state)]}
        self._queue: dict[str, list[tuple[str, str, str]]] = {
            "active": [], "eligible": [], "blocked": []}
        self._queue_at = float("-inf")

    # -- scheduler plumbing -------------------------------------------

    def _exec(self, cmd: list[str]) -> tuple[str, str, bool]:
        """(stdout, stderr, comm_err) — Moab surfaces front-end
        flakiness as 'communication error' text on stderr, which is a
        retry-later condition everywhere, never a job failure."""
        r = self._run(cmd, capture_output=True, text=True)
        err = r.stderr or ""
        return r.stdout or "", err, "communication error" in err.lower()

    def _showq(self, force: bool = False) -> tuple[dict, bool]:
        """TTL-cached queue snapshot.  On a communication error the
        stale snapshot is returned with comm_err=True — callers decide
        (is_running: assume alive; status: block submission)."""
        if not force and self._clock() < self._queue_at + self.showq_ttl_s:
            return self._queue, False
        cmd = ["showq", "--xml"]
        if self.queue_name:
            cmd[1:1] = ["-w", f"class={self.queue_name}"]
        out, err, comm_err = self._exec(cmd)
        if comm_err:
            return self._queue, True
        if not out.strip():
            raise QueueManagerNonFatalError(
                f"showq returned nothing: {err.strip()}")
        try:
            tree = ElementTree.fromstring(out)
        except ElementTree.ParseError as e:
            raise QueueManagerNonFatalError(f"showq XML unparsable: {e}")
        queue: dict[str, list[tuple[str, str, str]]] = {
            "active": [], "eligible": [], "blocked": []}
        for branch in tree:
            if branch.tag != "queue":
                continue
            bucket = queue.setdefault(branch.attrib.get("option", ""), [])
            for job in branch:
                if job.tag != "job":
                    continue
                name = job.attrib.get("JobName", "")
                if name.startswith(self.job_basename):
                    bucket.append((job.attrib.get("JobID", ""), name,
                                   job.attrib.get("State", "")))
        self._queue = queue
        self._queue_at = self._clock()
        return queue, False

    @staticmethod
    def _find_live(queue: dict, job_name: str) -> str:
        """The queue id of a LIVE job with this -N name.  Departing
        states are skipped: job names are deterministic per job_id, so
        a dying previous attempt must not be mistaken for the
        submission being recovered."""
        for bucket in queue.values():
            for qid, name, state in bucket:
                if name == job_name and not _gone(state):
                    return qid
        return ""

    def _job_state(self, queue_id: str, force: bool = False) -> str:
        queue, comm_err = self._showq(force=force)
        for bucket in queue.values():
            for qid, _name, state in bucket:
                if qid == str(queue_id):
                    return state
        return "COMMERR" if comm_err else "DNE"

    # -- PipelineQueueManager interface -------------------------------

    def submit(self, datafiles: list[str], outdir: str, job_id: int) -> str:
        os.makedirs(outdir, exist_ok=True)
        errpath = os.path.join(outdir, f"job{job_id}.stderr")
        job_name = f"{self.job_basename}{job_id}"
        cmd = ["msub", "-V",
               "-v", f"DATAFILES={';'.join(datafiles)},OUTDIR={outdir}",
               "-l", f"nodes=1:ppn=1,walltime={self._walltime(datafiles)}",
               "-N", job_name,
               "-o", os.path.join(outdir, f"job{job_id}.stdout"),
               "-e", errpath]
        if self.queue_name:
            cmd += ["-q", self.queue_name]
        cmd.append(self.script)
        out, err, comm_err = self._exec(cmd)
        qid = out.strip().splitlines()[-1].strip() if out.strip() else ""
        if comm_err:
            # the submission may have landed even though the reply was
            # lost — recover the id by job name rather than resubmit
            # (a resubmit would double-run the beam).  The constant-
            # wait recovery loop is the shared retry primitive with a
            # flat backoff curve and delay_first (wait BEFORE the
            # first showq too, like the hand-rolled loop did).
            def _lookup():
                try:
                    queue, lookup_comm_err = self._showq(force=True)
                except QueueManagerNonFatalError as e:
                    raise _SchedulerUnanswered(str(e))
                if lookup_comm_err:
                    raise _SchedulerUnanswered(
                        "showq communication error")
                # a definitive showq answer ends recovery ('' = the
                # name is absent: the lost msub never landed)
                return self._find_live(queue, job_name)

            try:
                qid = rpolicy.call(
                    _lookup,
                    rpolicy.RetryPolicy(
                        # call() rejects a zero bound; a configured
                        # limit of 0 still gets one lookup before the
                        # fatal verdict (the old loop's 0 meant 'give
                        # up immediately', which only ever punished a
                        # submit that might have landed)
                        max_attempts=max(1, self.comm_retry_limit),
                        backoff_base_s=self.retry_wait_s,
                        backoff_mult=1.0,
                        backoff_max_s=self.retry_wait_s,
                        delay_first=True,
                        retry_on=(_SchedulerUnanswered,)),
                    sleeper=self._sleep)
            except _SchedulerUnanswered:
                raise QueueManagerFatalError(
                    f"{self.comm_retry_limit} consecutive Moab "
                    f"communication errors while submitting job {job_id}")
            if not qid:
                # the scheduler answered and the name is absent: the
                # lost msub never landed, so retrying the submission
                # later cannot double-run the beam
                raise QueueManagerNonFatalError(
                    f"msub reply lost and job {job_name} absent from "
                    f"showq; submission did not land")
        elif not qid:
            stderr = err.strip()
            if "invalid" in stderr.lower() or "illegal" in stderr.lower():
                raise QueueManagerJobFatalError(f"msub rejected: {stderr}")
            raise QueueManagerNonFatalError(
                f"msub returned no job id: {stderr}")
        self._stderr.put(qid, errpath=errpath)
        try:
            # best effort: make the new job visible to status() and
            # can_submit() immediately — the job is already registered,
            # so a flaky snapshot here must not fail the submission
            self._showq(force=True)
        except QueueManagerNonFatalError:
            pass
        return qid

    def can_submit(self) -> bool:
        queued, running = self.status()
        return ((running + queued) < self.max_jobs_running
                and queued < self.max_jobs_queued)

    def is_running(self, queue_id: str) -> bool:
        try:
            state = self._job_state(queue_id)
        except QueueManagerNonFatalError:
            return True     # scheduler flaky: assume alive, poll later
        if state == "COMMERR":
            return True
        return not _gone(state)

    def delete(self, queue_id: str) -> bool:
        self._exec(["canceljob", str(queue_id)])
        try:
            # bypass the TTL cache: the verdict must reflect the cancel
            state = self._job_state(queue_id, force=True)
        except QueueManagerNonFatalError:
            return False
        if state == "COMMERR":
            return False
        return _gone(state)

    def status(self) -> tuple[int, int]:
        try:
            queue, comm_err = self._showq()
        except QueueManagerNonFatalError:
            comm_err, queue = True, self._queue
        if comm_err:
            # unanswerable: report sentinel counts that fail every
            # can_submit() comparison, so nothing new is submitted
            # until the scheduler answers again
            return 9999, 9999
        running = len(queue["active"])
        queued = len(queue["eligible"]) + len(queue["blocked"])
        return queued, running

    # had_errors / get_errors / _walltime come from CLIQueueBackend
