"""Slurm queue backend (sbatch/squeue/scancel via subprocess)
— counterpart of tpulsar/orchestrate/queue_managers/slurm.py (a copy).

The modern-cluster equivalent of the reference's PBS/Moab backends
(lib/python/queue_managers/pbs.py, moab.py): submission passes the
data files and output directory through environment variables, job
state is polled with squeue, errors are detected from the stderr file,
and walltime is provisioned from input size with the same hours-per-GB
heuristic (moab.py:14,72-79).
"""

from __future__ import annotations

import os
import subprocess

from tpulsar_torch.orchestrate.queue_managers import (
    CLIQueueBackend,
    QueueManagerJobFatalError,
    QueueManagerNonFatalError,
    SubmitRegistry,
)


class SlurmManager(CLIQueueBackend):
    def __init__(self, script: str, queue_name: str = "",
                 max_jobs_running: int = 50, max_jobs_queued: int = 1,
                 walltime_per_gb: float = 50.0,
                 job_basename: str = "tpulsar",
                 state_file: str | None = None,
                 runner=subprocess.run):
        self.script = script
        self.queue_name = queue_name
        self.max_jobs_running = max_jobs_running
        self.max_jobs_queued = max_jobs_queued
        self.walltime_per_gb = walltime_per_gb
        self.job_basename = job_basename
        self._run = runner           # injectable for hermetic tests
        self._stderr = SubmitRegistry(state_file)

    def submit(self, datafiles: list[str], outdir: str, job_id: int) -> str:
        os.makedirs(outdir, exist_ok=True)
        errpath = os.path.join(outdir, f"job{job_id}.stderr")
        cmd = ["sbatch", "--parsable",
               f"--job-name={self.job_basename}{job_id}",
               f"--time={self._walltime(datafiles)}",
               f"--output={os.path.join(outdir, f'job{job_id}.stdout')}",
               f"--error={errpath}",
               "--export=ALL,"
               f"DATAFILES={';'.join(datafiles)},OUTDIR={outdir}"]
        if self.queue_name:
            cmd.append(f"--partition={self.queue_name}")
        cmd.append(self.script)
        r = self._run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            if "Invalid" in (r.stderr or ""):
                raise QueueManagerJobFatalError(
                    f"sbatch rejected job: {r.stderr.strip()}")
            raise QueueManagerNonFatalError(
                f"sbatch failed (rc={r.returncode}): {r.stderr.strip()}")
        qid = r.stdout.strip().split(";")[0]
        if not qid:
            raise QueueManagerNonFatalError("sbatch returned no job id")
        self._stderr.put(qid, errpath=errpath)
        return qid

    def _squeue(self, extra: list[str]) -> list[str]:
        r = self._run(["squeue", "--noheader", "-o", "%i %t",
                       f"--name={self.job_basename}"] + extra,
                      capture_output=True, text=True)
        if r.returncode != 0:
            raise QueueManagerNonFatalError(
                f"squeue failed: {r.stderr.strip()}")
        return [ln for ln in r.stdout.splitlines() if ln.strip()]

    def can_submit(self) -> bool:
        queued, running = self.status()
        return (running < self.max_jobs_running
                and queued < self.max_jobs_queued)

    def is_running(self, queue_id: str) -> bool:
        try:
            lines = self._squeue(["-j", str(queue_id)])
        except QueueManagerNonFatalError:
            return True     # scheduler flaky: assume alive, retry later
        return any(ln.split()[0] == str(queue_id) for ln in lines)

    def delete(self, queue_id: str) -> bool:
        r = self._run(["scancel", str(queue_id)],
                      capture_output=True, text=True)
        return r.returncode == 0

    def status(self) -> tuple[int, int]:
        queued = running = 0
        for ln in self._squeue([]):
            state = ln.split()[1]
            if state in ("R", "CG"):
                running += 1
            else:
                queued += 1
        return queued, running

    # had_errors / get_errors / _walltime come from CLIQueueBackend
