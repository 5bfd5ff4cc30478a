"""Pluggable cluster/queue backends — counterpart of
tpulsar/orchestrate/queue_managers/__init__.py (a copy).

The reference defines a 7-method abstract interface every backend must
implement (lib/python/queue_managers/generic_interface.py:7-99) and a
3-level error taxonomy that drives the job pool's recovery decisions
(lib/python/queue_managers/__init__.py:4-27).  Both are preserved
here; backends are: an in-process LocalProcessManager (testing +
single-node), Slurm, PBS and Moab CLI backends, a TPUSliceManager
that fans beam jobs out to accelerator hosts (registered as
``tpu_slice``, the JAX package's name), and the ``warm`` client of
the resident server's spool.  Every backend's worker is the port's
job, ``python -m tpulsar_torch.cli.search_job`` (or the configured
submit script).
"""

from __future__ import annotations

import json
import os
import threading


class SubmitRegistry:
    """Durable queue_id -> per-job paths map.

    The reference detects job errors from stderr files named after the
    submission (pbs.py:209-230) but keeps the mapping only in memory; a
    daemon restart then loses the error taxonomy for every in-flight
    job.  Backends persist the mapping here (a small JSON file, written
    atomically) so had_errors()/get_errors() survive restarts."""

    #: registry entries older than this are pruned at load time — far
    #: beyond any plausible walltime, purely a growth bound
    MAX_AGE_S = 14 * 86400.0

    def __init__(self, path: str | None):
        import time
        self.path = path
        self._lock = threading.Lock()
        self._map: dict[str, dict] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as fh:
                    self._map = json.load(fh)
            except (OSError, ValueError):
                self._map = {}
            cutoff = time.time() - self.MAX_AGE_S
            stale = [q for q, info in self._map.items()
                     if info.get("ts", cutoff + 1) < cutoff]
            for q in stale:
                del self._map[q]
            if stale:
                self._save()

    def put(self, queue_id: str, **info) -> None:
        import time
        info.setdefault("ts", time.time())
        with self._lock:
            self._map[str(queue_id)] = info
            self._save()

    def get(self, queue_id: str, key: str, default=None):
        with self._lock:
            return self._map.get(str(queue_id), {}).get(key, default)

    def known(self, queue_id: str) -> bool:
        with self._lock:
            return str(queue_id) in self._map

    def all_ids(self) -> list[str]:
        with self._lock:
            return list(self._map)

    def _save(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._map, fh)
        os.replace(tmp, self.path)


class CLIQueueBackend:
    """Shared behavior of the CLI-driven backends (slurm/pbs/moab):
    walltime provisioned from input size with the hours-per-GB
    heuristic (reference moab.py:14,72-79) and stderr-file error
    detection through the restart-safe SubmitRegistry (reference
    pbs.py:209-230).  Subclasses set ``walltime_per_gb`` (if they
    provision walltime) and ``self._stderr``."""

    walltime_per_gb: float = 50.0

    def _walltime(self, datafiles: list[str]) -> str:
        gb = sum(os.path.getsize(f) for f in datafiles
                 if os.path.exists(f)) / 2 ** 30
        hours = max(1, int(self.walltime_per_gb * gb + 0.5))
        return f"{hours}:00:00"

    def had_errors(self, queue_id: str) -> bool:
        errpath = self._stderr.get(queue_id, "errpath")
        return bool(errpath and os.path.exists(errpath)
                    and os.path.getsize(errpath) > 0)

    def get_errors(self, queue_id: str) -> str:
        errpath = self._stderr.get(queue_id, "errpath")
        if errpath and os.path.exists(errpath):
            with open(errpath, errors="replace") as fh:
                return fh.read()
        return ""


class QueueManagerFatalError(Exception):
    """The queue system itself is broken: stop the daemon."""


class QueueManagerJobFatalError(Exception):
    """This job cannot be submitted: mark the job failed."""


class QueueManagerNonFatalError(Exception):
    """Transient problem: leave the job queued and retry later."""


class PipelineQueueManager:
    """Abstract queue backend (reference generic_interface.py:7-99)."""

    def submit(self, datafiles: list[str], outdir: str,
               job_id: int) -> str:
        """Submit a search job; return the queue id."""
        raise NotImplementedError

    def can_submit(self) -> bool:
        """True if another job may be submitted now."""
        raise NotImplementedError

    def is_running(self, queue_id: str) -> bool:
        """True if the job is queued or running."""
        raise NotImplementedError

    def delete(self, queue_id: str) -> bool:
        """Remove/terminate the job; True on success."""
        raise NotImplementedError

    def status(self) -> tuple[int, int]:
        """(num_queued, num_running)."""
        raise NotImplementedError

    def had_errors(self, queue_id: str) -> bool:
        """True if the (finished) job produced errors."""
        raise NotImplementedError

    def get_errors(self, queue_id: str) -> str:
        """The error text of a finished job ('' if none)."""
        raise NotImplementedError


def get_queue_manager(name: str, **kw) -> PipelineQueueManager:
    if name == "local":
        from tpulsar_torch.orchestrate.queue_managers.local import (
            LocalProcessManager)
        return LocalProcessManager(**kw)
    if name == "slurm":
        from tpulsar_torch.orchestrate.queue_managers.slurm import SlurmManager
        return SlurmManager(**kw)
    if name == "pbs":
        from tpulsar_torch.orchestrate.queue_managers.pbs import PBSManager
        return PBSManager(**kw)
    if name == "moab":
        from tpulsar_torch.orchestrate.queue_managers.moab import MoabManager
        return MoabManager(**kw)
    if name == "tpu_slice":
        from tpulsar_torch.orchestrate.queue_managers.tpu_slice import (
            TPUSliceManager)
        return TPUSliceManager(**kw)
    if name == "warm":
        from tpulsar_torch.orchestrate.queue_managers.warm import (
            WarmServerManager)
        return WarmServerManager(**kw)
    raise ValueError(f"unknown queue manager {name!r}")
