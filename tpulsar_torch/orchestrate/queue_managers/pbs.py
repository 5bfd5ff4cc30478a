"""PBS/Torque queue backend (qsub/qstat/qdel via subprocess) — counterpart of
tpulsar/orchestrate/queue_managers/pbs.py (a copy).

Covers the reference's PBS backend capabilities
(lib/python/queue_managers/pbs.py): env-var argument passing
(DATAFILES/OUTDIR because PBS passes no argv, pbs.py:67-69), running
state from qstat, stderr-file error detection (pbs.py:209-230), and
submission caps.  Polling uses `qstat -f <id>` parsing instead of the
PBSQuery library.
"""

from __future__ import annotations

import os
import re
import subprocess

from tpulsar_torch.orchestrate.queue_managers import (
    CLIQueueBackend,
    QueueManagerJobFatalError,
    QueueManagerNonFatalError,
    SubmitRegistry,
)


class PBSManager(CLIQueueBackend):
    def __init__(self, script: str, queue_name: str = "",
                 max_jobs_running: int = 50, max_jobs_queued: int = 1,
                 job_basename: str = "tpulsar", ppn: int = 1,
                 node_property: str = "",
                 max_jobs_per_node: int | None = None,
                 state_file: str | None = None,
                 runner=subprocess.run):
        self.script = script
        self.queue_name = queue_name
        self.max_jobs_running = max_jobs_running
        self.max_jobs_queued = max_jobs_queued
        self.job_basename = job_basename
        self.ppn = ppn
        self.node_property = node_property
        self.max_jobs_per_node = max_jobs_per_node
        self._run = runner
        self._stderr = SubmitRegistry(state_file)

    _NODE_CACHE_TTL = 10.0

    def _get_submit_node(self) -> str | None:
        """Free-CPU-based node choice (the reference selects the free
        node with the most unused CPUs, honouring a per-node job cap
        and a node property filter — pbs.py:86-107,110-126 via the
        PBSQuery library; here parsed from `pbsnodes` ASCII output so
        the backend stays subprocess-only).  None when no node
        qualifies.  The verdict is cached for a few seconds: the pool
        polls can_submit() and then submit() immediately re-selects,
        and two pbsnodes round-trips per cycle would double the load
        on the queue server."""
        import time as _time

        cached = getattr(self, "_node_cache", None)
        if cached is not None and _time.monotonic() - cached[0] \
                < self._NODE_CACHE_TTL:
            return cached[1]
        r = self._run(["pbsnodes"], capture_output=True, text=True)
        if r.returncode != 0:
            raise QueueManagerNonFatalError(
                f"pbsnodes failed: {(r.stderr or '').strip()}")
        best, best_free = None, -1
        for block in re.split(r"\n\s*\n", r.stdout):
            lines = [ln for ln in block.splitlines() if ln.strip()]
            if not lines:
                continue
            name = lines[0].strip()
            attrs = {}
            for ln in lines[1:]:
                if "=" in ln:
                    k, _, v = ln.partition("=")
                    attrs[k.strip()] = v.strip()
            if attrs.get("state") != "free":
                continue
            props = [p.strip()
                     for p in attrs.get("properties", "").split(",")]
            if self.node_property and self.node_property not in props:
                continue
            jobs_val = attrs.get("jobs", "")
            slot_entries = [j for j in jobs_val.split(",") if j.strip()]
            # unique job ids for the PER-NODE JOB CAP: pbsnodes lists
            # one slot entry per CPU ('0/11.srv, 1/11.srv' is ONE
            # 2-ppn job, not two)
            njobs = len({j.strip().split("/")[-1]
                         for j in slot_entries})
            cap = self.max_jobs_per_node
            if cap is not None and njobs >= cap:
                continue
            try:
                np_cpus = int(attrs.get("np", "0"))
            except ValueError:
                continue
            # free-CPU RANKING counts occupied SLOTS, not unique jobs
            # (the reference's PBSQuery 'jobs' list is per-CPU-slot,
            # pbs.py:100-104): with ppn>1 jobs, np - unique_jobs would
            # overestimate free CPUs and steer submissions onto nearly
            # saturated nodes (round-4 advisor, medium)
            free = np_cpus - len(slot_entries)
            if free > best_free:
                best, best_free = name, free
        self._node_cache = (_time.monotonic(), best)
        return best

    def submit(self, datafiles: list[str], outdir: str, job_id: int) -> str:
        os.makedirs(outdir, exist_ok=True)
        errpath = os.path.join(outdir, f"job{job_id}.stderr")
        node_spec = "1"
        if self.max_jobs_per_node is not None or self.node_property:
            node = self._get_submit_node()
            if node is None:
                raise QueueManagerNonFatalError(
                    "no PBS node qualifies (state, property, or "
                    "per-node job cap)")
            node_spec = node
        cmd = ["qsub", "-V",
               "-v", f"DATAFILES={';'.join(datafiles)},OUTDIR={outdir}",
               "-N", f"{self.job_basename}{job_id}",
               "-l", f"nodes={node_spec}:ppn={self.ppn}",
               "-o", os.path.join(outdir, f"job{job_id}.stdout"),
               "-e", errpath]
        if self.queue_name:
            cmd += ["-q", self.queue_name]
        cmd.append(self.script)
        r = self._run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            stderr = (r.stderr or "").strip()
            if "Unauthorized" in stderr or "qsub: illegal" in stderr:
                raise QueueManagerJobFatalError(f"qsub rejected: {stderr}")
            raise QueueManagerNonFatalError(
                f"qsub failed (rc={r.returncode}): {stderr}")
        qid = r.stdout.strip().splitlines()[-1].strip()
        if not qid:
            raise QueueManagerNonFatalError("qsub returned no job id")
        # a successful submit invalidates the node cache: a burst of
        # submits inside the TTL would otherwise all target the same
        # cached node with stale job counts and overshoot
        # max_jobs_per_node (the reference re-queries every submit,
        # pbs.py:86-107; round-4 advisor, low)
        self._node_cache = None
        self._stderr.put(qid, errpath=errpath)
        return qid

    def _qstat_states(self) -> dict[str, str]:
        r = self._run(["qstat"], capture_output=True, text=True)
        if r.returncode != 0:
            raise QueueManagerNonFatalError(
                f"qstat failed: {(r.stderr or '').strip()}")
        states = {}
        for ln in r.stdout.splitlines():
            m = re.match(r"^(\S+)\s+(\S+)\s+\S+\s+\S+\s+([A-Z])\s", ln)
            if m and m.group(2).startswith(self.job_basename):
                states[m.group(1)] = m.group(3)
        return states

    def can_submit(self) -> bool:
        queued, running = self.status()
        if not (running < self.max_jobs_running
                and queued < self.max_jobs_queued):
            return False
        if self.max_jobs_per_node is not None or self.node_property:
            # reference can_submit also requires a qualifying node
            # (pbs.py:110-126)
            try:
                return self._get_submit_node() is not None
            except QueueManagerNonFatalError:
                return False
        return True

    def is_running(self, queue_id: str) -> bool:
        try:
            states = self._qstat_states()
        except QueueManagerNonFatalError:
            return True
        return any(qid.startswith(str(queue_id).split(".")[0])
                   for qid in states)

    def delete(self, queue_id: str) -> bool:
        r = self._run(["qdel", str(queue_id)], capture_output=True,
                      text=True)
        return r.returncode == 0

    def status(self) -> tuple[int, int]:
        queued = running = 0
        for state in self._qstat_states().values():
            if state == "R":
                running += 1
            elif state in ("Q", "H", "W"):
                queued += 1
        return queued, running

    # had_errors / get_errors come from CLIQueueBackend
