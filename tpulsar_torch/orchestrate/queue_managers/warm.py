"""``warm`` queue backend: submit beams to resident search workers
— counterpart of tpulsar/orchestrate/queue_managers/warm.py (a copy).

Implements the 7-method PipelineQueueManager contract by writing job
tickets to a serve spool (serve/protocol.py) instead of
forking a process per beam — the JobPool daemon drives one warm worker
or a whole fleet of them with zero scheduling-code changes.

Liveness is the heartbeats: a submission only becomes a ticket while
at least ONE worker's heartbeat on the spool is fresh; with zero
fresh workers every operation load-sheds to an embedded
LocalProcessManager, so a deployment configured for ``warm`` keeps
processing beams (at cold per-process cost) when the fleet is down,
draining, or not yet started.  Queue ids are self-routing — ``warm-*``
ids live in the spool, anything else belongs to the fallback — and
both stores are on-disk, so a restarted daemon keeps polling jobs an
earlier process submitted.

Backpressure vs load-shedding: ``can_submit()`` consults the
AGGREGATE fleet capacity (the sum of fresh workers' advertised queue
depths minus tickets already waiting — protocol.fleet_capacity), so
admission scales with the number of live workers; a full queue with
live workers is backpressure (wait), while zero fresh workers is the
only condition that sheds load to process-per-beam submission.
"""

from __future__ import annotations

import os
import threading
import time

from tpulsar_torch.obs.log import get_logger
from tpulsar_torch.serve import protocol


class WarmServerManager:
    def __init__(self, spool: str | None = None,
                 max_queue_depth: int = 8,
                 heartbeat_max_age_s: float | None = None,
                 fallback_kwargs: dict | None = None,
                 logger=None):
        if spool is None:
            spool = protocol.default_spool_dir()
        self.spool = protocol.ensure_spool(spool)
        self.max_queue_depth = max_queue_depth
        # None = resolve config/env/default at CALL time via
        # protocol.heartbeat_max_age() — the one staleness knob
        self.heartbeat_max_age_s = heartbeat_max_age_s
        self.fallback_kwargs = fallback_kwargs or {}
        self.log = logger or get_logger("warmq")
        self._fallback = None
        self._lock = threading.Lock()
        self._next = 1

    # ------------------------------------------------------------ routing

    def server_available(self) -> bool:
        return protocol.heartbeat_fresh(self.spool,
                                        self.heartbeat_max_age_s)

    @property
    def fallback(self):
        """The embedded process-per-beam manager, built on first use
        (a deployment whose server never goes down never forks)."""
        if self._fallback is None:
            from tpulsar_torch.orchestrate.queue_managers.local import (
                LocalProcessManager)
            self._fallback = LocalProcessManager(**self.fallback_kwargs)
        return self._fallback

    @staticmethod
    def _is_warm_qid(queue_id: str) -> bool:
        return str(queue_id).startswith("warm-")

    def _abandon(self, queue_id: str, state: str) -> None:
        """Declare a ticket dead: the server's heartbeat is stale and
        nothing will ever process it.  The ticket is REMOVED from the
        spool before the failed result is written, so a later server
        boot cannot resurrect it into a double-processed beam (the
        pool is about to retry this job through submit())."""
        protocol.cancel_ticket(self.spool, queue_id)
        try:
            os.unlink(protocol.ticket_path(self.spool, queue_id,
                                           "claimed"))
        except OSError:
            pass
        protocol.write_result(
            self.spool, queue_id, "failed", rc=1,
            error=f"serve ticket abandoned: no fresh server "
                  f"heartbeat and the ticket was still {state!r}")
        self.log.warning("abandoned ticket %s (%s, stale server)",
                         queue_id, state)

    # ------------------------------------------------------------ contract

    def submit(self, datafiles: list[str], outdir: str,
               job_id: int) -> str:
        if not self.server_available():
            self.log.info("no fresh server heartbeat: job %d falls "
                          "back to process-per-beam", job_id)
            return self.fallback.submit(datafiles, outdir, job_id)
        os.makedirs(outdir, exist_ok=True)
        with self._lock:
            qid = (f"warm-{os.getpid()}-{self._next}-"
                   f"{int(time.time() * 1000) % 100000}")
            self._next += 1
        protocol.write_ticket(self.spool, qid, datafiles, outdir,
                              job_id=job_id)
        return qid

    def can_submit(self) -> bool:
        # the short-TTL cached probe: can_submit sits on the pool's
        # submission loop and the raw capacity read re-stats every
        # heartbeat file and the pending listing per call — our own
        # submits/heartbeats invalidate the cache, so a just-written
        # ticket is always counted
        cap = protocol.fleet_capacity_cached(
            self.spool, self.heartbeat_max_age_s,
            default_depth=self.max_queue_depth)
        if cap is None:
            # zero fresh workers: load-shed to process-per-beam
            return self.fallback.can_submit()
        return cap > 0

    def is_running(self, queue_id: str) -> bool:
        if not self._is_warm_qid(queue_id):
            return self.fallback.is_running(queue_id)
        state = protocol.ticket_state(self.spool, queue_id)
        if state in ("done", "unknown"):
            return False
        if not self.server_available():
            # waiting or claimed with no live server: nothing will
            # ever finish it — fail it now so the pool's retry
            # machinery takes over instead of polling forever
            self._abandon(queue_id, state)
            return False
        return True

    def delete(self, queue_id: str) -> bool:
        if not self._is_warm_qid(queue_id):
            return self.fallback.delete(queue_id)
        state = protocol.ticket_state(self.spool, queue_id)
        if state == "incoming":
            return protocol.cancel_ticket(self.spool, queue_id)
        if state == "claimed":
            # in-flight on the server: there is no cross-process way
            # to abort the device work — report the failure honestly
            return False
        return state == "done"

    def status(self) -> tuple[int, int]:
        queued = protocol.pending_count(self.spool)
        running = protocol.claimed_count(self.spool)
        if self._fallback is not None:
            fq, fr = self._fallback.status()
            queued, running = queued + fq, running + fr
        return queued, running

    def had_errors(self, queue_id: str) -> bool:
        if not self._is_warm_qid(queue_id):
            return self.fallback.had_errors(queue_id)
        rec = protocol.read_result(self.spool, queue_id)
        if rec is None:
            return True         # vanished without a result record
        return rec.get("status") not in ("done", "skipped") \
            or rec.get("rc", 1) != 0

    def get_errors(self, queue_id: str) -> str:
        if not self._is_warm_qid(queue_id):
            return self.fallback.get_errors(queue_id)
        rec = protocol.read_result(self.spool, queue_id)
        if rec is None:
            return f"no serve result record for {queue_id}"
        return rec.get("error", "") or f"status {rec.get('status')!r}"

    def shutdown(self) -> int:
        """Reap fallback subprocesses (daemon/test teardown).  The
        resident server is NOT ours to kill — it outlives its
        clients by design; operators stop it with SIGTERM."""
        if self._fallback is None:
            return 0
        return self._fallback.shutdown()
