"""The pluggable TicketQueue interface: the ticket lifecycle as a
contract, not a directory layout — counterpart of
tpulsar/frontdoor/queue.py (a copy of the interface, the spool and
the in-memory backends; the sqlite backend is sqlite_queue.py).

The serve spool is an exactly-once ticket protocol on a shared
filesystem; this module extracts that lifecycle behind an interface
so the front door (gateway, federation router, tests, embedded
pipelines) can speak *tickets* without speaking *spools*:

  * ``FilesystemSpoolQueue`` — the reference backend, a thin
    delegation to serve/protocol.py.  All serving processes (workers,
    fleet controller, janitors) keep using the protocol module
    directly; this adapter is the same state, same files, same
    semantics.
  * ``MemoryTicketQueue`` — a process-local backend with the same
    contract (thread-safe claims, attempts counting, quarantine, an
    in-memory journal), for tests and single-process embedding.

THE CONTRACT every backend must honour (the spool protocol's
invariants, verified by the backend-parameterized contract tests,
tests/test_frontdoor.py and tests/test_torch_serve.py):

  1. exactly-once claims: of N concurrent ``claim_next`` callers, at
     most one receives any given ticket, and a claimed ticket is
     never observable as pending;
  2. a claim always records its owner (pid + worker id) — there is no
     ownerless in-flight work;
  3. results are durable before the claim is released: a crash
     between the two leaves a *finished* ticket to reconcile, never a
     lost one;
  4. ``requeue_stale_claims`` steals only from DEAD owners, counts
     each crash-shaped requeue against the ticket's ``attempts``, and
     quarantines (with a terminal failed result, reason
     ``max_attempts``) at the cap; ``requeue_own_claims`` is
     attempt-neutral;
  5. every transition lands in the journal (``read_events``), and a
     finished ticket's chain satisfies ``journal.validate_chain``;
  6. claim ordering is FIFO by submission time unless a
     ``tenancy.TenantPolicy`` reorders it — the policy changes WHICH
     ticket a claimer gets, never the exclusivity of getting it.

``get_ticket_queue`` resolves backend URLs: a bare path or
``spool:<dir>`` is the filesystem backend; ``memory:`` or
``memory:<name>`` a (named, process-global) in-memory queue;
``sqlite:<path>`` the durable WAL-mode SQLite backend
(frontdoor/sqlite_queue.py) — same contract, no shared-filesystem
assumption.
"""

from __future__ import annotations

import os
import threading
import time
import uuid

from tpulsar_torch.obs import journal, telemetry
from tpulsar_torch.serve import protocol

_STATES = ("incoming", "claimed", "done", "quarantine")


class TicketQueue:
    """Abstract ticket queue (see the module contract above)."""

    backend = "?"

    @property
    def url(self) -> str:
        """The backend URL that resolves (via ``get_ticket_queue``)
        back to this queue's state — what a supervisor hands its
        worker subprocesses on the command line."""
        raise NotImplementedError

    # ----------------------------------------------------- submission
    def submit(self, ticket_id: str, datafiles: list[str],
               outdir: str, job_id: int | None = None,
               **extra) -> str:
        raise NotImplementedError

    def cancel(self, ticket_id: str) -> bool:
        """Remove a still-pending ticket; False once claimed."""
        raise NotImplementedError

    # --------------------------------------------------------- claims
    def claim_next(self, worker_id: str = "", policy=None,
                   worker_class: str = "") -> dict | None:
        raise NotImplementedError

    def claim_batch(self, n: int, worker_id: str = "", policy=None,
                    compat: str | None = None,
                    worker_class: str = "") -> list[dict]:
        """Claim up to ``n`` compatible tickets in ONE policy
        ordering pass (contract extension for batched admission):
        the first claim fixes the batch's declared ``compat`` key
        unless ``compat`` pins one, mismatching tickets stay pending
        IN PLACE, each member is an individually exclusive,
        owner-stamped, journaled claim, and the policy's quota
        budgeting spans the whole batch — a low-priority tenant's
        batchmates never displace a high-priority single."""
        raise NotImplementedError

    def requeue_stale_claims(
            self, max_attempts: int = protocol.DEFAULT_MAX_ATTEMPTS
    ) -> list[str]:
        raise NotImplementedError

    def requeue_own_claims(self) -> list[str]:
        raise NotImplementedError

    # -------------------------------------------------------- results
    def write_result(self, ticket_id: str, status: str, rc: int = 0,
                     error: str = "", **extra) -> None:
        raise NotImplementedError

    def read_result(self, ticket_id: str) -> dict | None:
        raise NotImplementedError

    # -------------------------------------------------- introspection
    def ticket_state(self, ticket_id: str) -> str:
        raise NotImplementedError

    def list_tickets(self, state: str) -> list[str]:
        raise NotImplementedError

    def read_ticket(self, ticket_id: str) -> dict | None:
        """The ticket record from whichever non-terminal state holds
        it (None when only a result exists, or nothing does)."""
        raise NotImplementedError

    def pending_count(self) -> int:
        return self.state_count("incoming")

    def claimed_count(self) -> int:
        return self.state_count("claimed")

    def state_count(self, state: str) -> int:
        raise NotImplementedError

    def pending_by_tenant(self) -> dict[str, int]:
        raise NotImplementedError

    def inflight_by_tenant(self) -> dict[str, int]:
        raise NotImplementedError

    # ---------------------------------------------- liveness/capacity
    def heartbeat(self, worker_id: str = "", **fields) -> None:
        raise NotImplementedError

    def fresh_workers(
            self, max_age_s: float | None = None
    ) -> dict[str, dict]:
        raise NotImplementedError

    def capacity(self,
                 max_age_s: float | None = None,
                 default_depth: int = 8) -> int | None:
        """Remaining admission capacity; None = zero fresh workers
        (load-shed), 0 = fresh workers but a full queue
        (backpressure) — the distinction federation rides on."""
        raise NotImplementedError

    def oldest_pending_age_s(self, now: float | None = None) -> float:
        """Age in seconds of the oldest pending ticket (0.0 when the
        queue is empty) — the autoscaler's starvation signal.  The
        generic walk reads every pending record; backends override
        with something cheaper (mtime scan, SQL MIN)."""
        now = time.time() if now is None else now
        oldest = None
        for tid in self.list_tickets("incoming"):
            rec = self.read_ticket(tid)
            if rec is None:
                continue
            t = rec.get("submitted_at")
            if t is not None and (oldest is None or t < oldest):
                oldest = float(t)
        return max(0.0, now - oldest) if oldest is not None else 0.0

    # -------------------------------------------------------- journal
    def record_event(self, event: str, **fields) -> None:
        """Append a lifecycle event outside the built-in transitions
        (the gateway's ``received``); observational, never raises."""
        raise NotImplementedError

    def read_events(self, ticket: str | None = None) -> list[dict]:
        raise NotImplementedError

    def read_events_after(self, after_offset: int = 0,
                          ticket: str | None = None
                          ) -> tuple[list[dict], int]:
        """Offset-tailed event read: ``(events past after_offset,
        next_offset)``.  Offset 0 attaches (full history once); a
        poller then passes each returned offset back, so following a
        ticket costs O(new events) per poll instead of re-reading the
        whole journal (the gateway's ``?follow=1`` stream and
        ``chaos verify --tail`` both ride this)."""
        raise NotImplementedError

    # --------------------------------------- liveness detail / ledger
    def read_heartbeat(self, worker_id: str = "") -> dict | None:
        raise NotImplementedError

    def list_heartbeats(self) -> dict[str, dict]:
        """Every heartbeat the backend holds, fresh or not, keyed by
        worker id (fleetview and the janitor read staleness, not just
        freshness)."""
        raise NotImplementedError

    def write_heartbeat_record(self, worker_id: str,
                               rec: dict) -> None:
        """Overwrite a worker's heartbeat record VERBATIM — no pid or
        timestamp restamp.  The controller's down-marking rides this:
        a dead incarnation's heartbeat is re-written with
        ``status="stopped"`` under the DEAD worker's pid, so capacity
        stops counting it immediately."""
        raise NotImplementedError

    def remove_heartbeat(self, worker_id: str) -> None:
        """Forget a retired worker's heartbeat entirely (elastic slot
        ids are never reused — without this a long-lived fleet leaks
        one liveness record per scale cycle)."""
        raise NotImplementedError

    def record_elective_kill(self, worker_id: str, pid: int,
                             reason: str = "scale_down") -> None:
        """The autoscaler's declaration of intent BEFORE a SIGKILL:
        the janitor's next sweep finds this (worker, pid) pair in the
        ledger and requeues its claims without a crash strike."""
        raise NotImplementedError

    def elective_kills(self) -> set[tuple[str, int]]:
        raise NotImplementedError

    # ------------------------------------------------ verifier surface
    @property
    def journal_root(self) -> str:
        """The directory whose ``events/journal.jsonl`` this backend
        appends to ('' for backends with no on-disk journal).  Run
        artifacts (fleet.json, chaos manifests, worker logs) live
        here too — the journal root IS the run root."""
        return ""

    def ticket_presence(self, ticket_id: str) -> dict[str, bool]:
        """Raw per-state presence for the chaos verifier's
        at-most-one-state invariant: which of the four states hold
        this ticket RIGHT NOW, no precedence applied (``ticket_state``
        resolves precedence; this deliberately does not)."""
        raise NotImplementedError

    def orphan_sweep(self) -> list[dict]:
        """Transient artifacts that outlived their transaction —
        ``{"ticket", "state", "name"}`` rows.  The spool backend
        reports surviving ``*.tmp`` / claim / takeover side-files;
        transactional backends have none by construction."""
        raise NotImplementedError

    def fsck(self) -> dict:
        """Offline health check: ``{"backend", "target", "counts",
        "findings"}`` where any finding means rc 1 for ``tpulsar
        queue fsck`` — integrity check + WAL checkpoint for sqlite,
        orphan side-file sweep for the spool."""
        raise NotImplementedError


# --------------------------------------------------------------------
# filesystem backend (the reference implementation)
# --------------------------------------------------------------------

class FilesystemSpoolQueue(TicketQueue):
    """serve/protocol.py as a TicketQueue.  ``spool`` is shared state:
    any number of these adapters, raw-protocol workers, and janitors
    may point at one directory concurrently — that concurrency is the
    protocol's whole design."""

    backend = "spool"

    def __init__(self, spool: str):
        self.spool = protocol.ensure_spool(spool)

    @property
    def url(self):
        return f"spool:{self.spool}"

    def __repr__(self):
        return f"FilesystemSpoolQueue({self.spool!r})"

    def submit(self, ticket_id, datafiles, outdir, job_id=None,
               **extra):
        return protocol.write_ticket(self.spool, ticket_id, datafiles,
                                     outdir, job_id=job_id, **extra)

    def cancel(self, ticket_id):
        return protocol.cancel_ticket(self.spool, ticket_id)

    def claim_next(self, worker_id="", policy=None, worker_class=""):
        return protocol.claim_next_ticket(self.spool, worker_id,
                                          policy=policy,
                                          worker_class=worker_class)

    def claim_batch(self, n, worker_id="", policy=None, compat=None,
                    worker_class=""):
        return protocol.claim_batch(self.spool, n, worker_id,
                                    policy=policy, compat=compat,
                                    worker_class=worker_class)

    def requeue_stale_claims(
            self, max_attempts=protocol.DEFAULT_MAX_ATTEMPTS):
        return protocol.requeue_stale_claims(self.spool, max_attempts)

    def requeue_own_claims(self):
        return protocol.requeue_own_claims(self.spool)

    def write_result(self, ticket_id, status, rc=0, error="",
                     **extra):
        protocol.write_result(self.spool, ticket_id, status, rc=rc,
                              error=error, **extra)

    def read_result(self, ticket_id):
        return protocol.read_result(self.spool, ticket_id)

    def ticket_state(self, ticket_id):
        return protocol.ticket_state(self.spool, ticket_id)

    def list_tickets(self, state):
        return protocol.list_tickets(self.spool, state)

    def read_ticket(self, ticket_id):
        for state in ("claimed", "incoming", "quarantine"):
            rec = protocol._read_json(
                protocol.ticket_path(self.spool, ticket_id, state))
            if rec is not None:
                return rec
        return None

    def state_count(self, state):
        return protocol.state_count(self.spool, state)

    def claimed_count(self):
        return protocol.claimed_count(self.spool)

    def pending_by_tenant(self):
        counts: dict[str, int] = {}
        for rec in protocol.pending_records(self.spool):
            tenant = rec.get("tenant") or "default"
            counts[tenant] = counts.get(tenant, 0) + 1
        return counts

    def inflight_by_tenant(self):
        return protocol.inflight_by_tenant(self.spool)

    def heartbeat(self, worker_id="", **fields):
        protocol.write_heartbeat(self.spool, worker_id=worker_id,
                                 **fields)

    def fresh_workers(self, max_age_s=None):
        return protocol.fresh_workers(self.spool, max_age_s)

    def capacity(self, max_age_s=None, default_depth=8):
        # the short-TTL cached probe: this sits on every gateway
        # admission decision
        return protocol.fleet_capacity_cached(self.spool, max_age_s,
                                              default_depth)

    def oldest_pending_age_s(self, now=None):
        # mtime scan, not record parse: this runs inside the
        # autoscaler's per-tick signal read
        now = time.time() if now is None else now
        oldest = now
        try:
            with os.scandir(os.path.join(self.spool,
                                         "incoming")) as it:
                for entry in it:
                    if not entry.name.endswith(".json"):
                        continue
                    try:
                        m = entry.stat().st_mtime
                    except OSError:
                        continue
                    if m < oldest:
                        oldest = m
        except OSError:
            return 0.0
        return max(0.0, now - oldest)

    def record_event(self, event, **fields):
        journal.record(self.spool, event, **fields)

    def read_events(self, ticket=None):
        # tolerant read: the gateway is a SERVING surface — status
        # queries and follow streams must outlive a corrupt journal
        # line (the chaos verifier is the strict reader that reports
        # it)
        return journal.read_events(self.spool, ticket=ticket,
                                   bad_lines=[])

    def read_events_after(self, after_offset=0, ticket=None):
        return journal.read_events(self.spool, ticket=ticket,
                                   after_offset=after_offset,
                                   bad_lines=[])

    # --------------------------------------- liveness detail / ledger

    def read_heartbeat(self, worker_id=""):
        return protocol.read_heartbeat(self.spool, worker_id)

    def list_heartbeats(self):
        return protocol.list_heartbeats(self.spool)

    def write_heartbeat_record(self, worker_id, rec):
        protocol._atomic_write_json(
            protocol.heartbeat_path(self.spool, worker_id), rec)

    def remove_heartbeat(self, worker_id):
        try:
            os.unlink(protocol.heartbeat_path(self.spool, worker_id))
        except OSError:
            pass

    def record_elective_kill(self, worker_id, pid,
                             reason="scale_down"):
        protocol.record_elective_kill(self.spool, worker_id, pid,
                                      reason=reason)

    def elective_kills(self):
        return protocol.elective_kills(self.spool)

    # ------------------------------------------------ verifier surface

    @property
    def journal_root(self):
        return self.spool

    def ticket_presence(self, ticket_id):
        return {state: os.path.exists(
                    protocol.ticket_path(self.spool, ticket_id,
                                         state))
                for state in _STATES}

    def orphan_sweep(self):
        out: list[dict] = []
        for state in _STATES:
            try:
                names = sorted(os.listdir(
                    os.path.join(self.spool, state)))
            except OSError:
                continue
            for name in names:
                if (name.endswith(".tmp") or ".json.claiming." in name
                        or ".json.takeover." in name):
                    out.append({"ticket": name.split(".json")[0],
                                "state": state, "name": name})
        return out

    def fsck(self):
        findings = [{"what": "orphan_sidefile",
                     "detail": f"{o['state']}/{o['name']}"}
                    for o in self.orphan_sweep()]
        counts = {s: self.state_count(s) for s in _STATES}
        return {"backend": self.backend, "target": self.spool,
                "counts": counts, "findings": findings}


# --------------------------------------------------------------------
# in-memory backend
# --------------------------------------------------------------------

class MemoryTicketQueue(TicketQueue):
    """The contract without a filesystem: dicts under one lock, an
    in-memory journal, thread-granularity concurrency.  Claims record
    the owning pid exactly like the spool backend, so the stale-claim
    machinery (dead-owner detection, attempts, quarantine) behaves
    identically — which is what lets the contention tests run
    against both backends unchanged."""

    backend = "memory"

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.RLock()
        self._states: dict[str, dict[str, dict]] = {
            s: {} for s in _STATES}
        self._heartbeats: dict[str, dict] = {}
        self._events: list[dict] = []
        self._elective: set[tuple[str, int]] = set()

    @property
    def url(self):
        return f"memory:{self.name}"

    def __repr__(self):
        return f"MemoryTicketQueue({self.name!r})"

    # ----------------------------------------------------- submission

    def submit(self, ticket_id, datafiles, outdir, job_id=None,
               **extra):
        rec = {"ticket": ticket_id, "datafiles": list(datafiles),
               "outdir": outdir, "job_id": job_id,
               "submitted_at": time.time(), "attempts": 0, **extra}
        rec.setdefault("trace_id", uuid.uuid4().hex[:16])
        self.record_event("submitted", ticket=ticket_id, attempt=0,
                          trace_id=rec["trace_id"], outdir=outdir,
                          tenant=rec.get("tenant", ""))
        with self._lock:
            self._states["incoming"][ticket_id] = rec
        return ticket_id

    def cancel(self, ticket_id):
        with self._lock:
            return self._states["incoming"].pop(ticket_id,
                                                None) is not None

    # --------------------------------------------------------- claims

    def _order_locked(self, policy) -> list[str]:
        pending = list(self._states["incoming"].values())
        if policy is None or getattr(policy, "is_trivial", False):
            return [r["ticket"] for r in sorted(
                pending, key=lambda r: (r.get("submitted_at", 0.0),
                                        r["ticket"]))]
        return policy.claim_order(pending, self.inflight_by_tenant())

    def _claim_locked(self, tid: str, worker_id: str,
                      worker_class: str = "") -> dict | None:
        rec = self._states["incoming"].pop(tid, None)
        if rec is None:
            return None
        rec = dict(rec)
        rec["claimed_at"] = time.time()
        rec["claimed_by"] = os.getpid()
        # this backend's claimers are threads of one process,
        # so pid-liveness alone would make every claim read
        # live forever — the thread ident is the in-memory
        # analogue of the spool backend's owner pid
        rec["claimed_by_thread"] = threading.get_ident()
        if worker_id:
            rec["claimed_by_worker"] = worker_id
        if worker_class:
            rec["claimed_by_class"] = worker_class
        self._states["claimed"][tid] = rec
        self.record_event(
            "claimed", ticket=tid, worker=worker_id,
            pid=os.getpid(),
            attempt=int(rec.get("attempts", 0)),
            trace_id=rec.get("trace_id", ""),
            queue_wait_s=round(
                rec["claimed_at"]
                - rec.get("submitted_at", rec["claimed_at"]),
                3),
            tenant=rec.get("tenant", ""),
            worker_class=worker_class)
        return rec

    def claim_next(self, worker_id="", policy=None, worker_class=""):
        with self._lock:
            for tid in self._order_locked(policy):
                rec = self._claim_locked(tid, worker_id, worker_class)
                if rec is not None:
                    return rec
            return None

    def claim_batch(self, n, worker_id="", policy=None, compat=None,
                    worker_class=""):
        # same contract as protocol.claim_batch: one ordering pass,
        # the first claim (or the pinned ``compat``) fixes the key,
        # mismatching tickets stay pending in place
        if n < 1:
            return []
        claimed: list[dict] = []
        with self._lock:
            for tid in self._order_locked(policy):
                if len(claimed) >= n:
                    break
                rec0 = self._states["incoming"].get(tid)
                if rec0 is None:
                    continue
                if compat is not None or claimed:
                    want = compat if compat is not None \
                        else str(claimed[0].get("compat", "") or "")
                    if str(rec0.get("compat", "") or "") \
                            != str(want or ""):
                        continue
                rec = self._claim_locked(tid, worker_id, worker_class)
                if rec is not None:
                    claimed.append(rec)
        return claimed

    def _requeue(self, verdict_fn, max_attempts: int,
                 neutral_reason: str) -> list[str]:
        requeued = []
        with self._lock:
            for tid in list(self._states["claimed"]):
                rec = self._states["claimed"][tid]
                if tid in self._states["done"]:
                    del self._states["claimed"][tid]
                    continue
                verdict = verdict_fn(rec)
                if verdict is None:
                    continue
                reason = neutral_reason
                if isinstance(verdict, tuple):
                    verdict, reason = verdict
                del self._states["claimed"][tid]
                owner_pid = rec.get("claimed_by")
                owner_worker = rec.get("claimed_by_worker", "")
                rec = protocol._strip_claim_stamps(dict(rec))
                rec.pop("claimed_by_thread", None)
                if verdict == "strike":
                    rec["attempts"] = int(rec.get("attempts", 0)) + 1
                    if rec["attempts"] >= max_attempts:
                        self._quarantine(rec, max_attempts)
                        continue
                self._states["incoming"][tid] = rec
                if verdict == "strike":
                    self.record_event(
                        "takeover", ticket=tid,
                        attempt=int(rec.get("attempts", 0)),
                        trace_id=rec.get("trace_id", ""),
                        from_worker=owner_worker, from_pid=owner_pid,
                        by_pid=os.getpid())
                else:
                    self.record_event(
                        "drain_requeue", ticket=tid,
                        worker=owner_worker,
                        attempt=int(rec.get("attempts", 0)),
                        trace_id=rec.get("trace_id", ""),
                        reason=reason)
                requeued.append(tid)
        return requeued

    def _quarantine(self, rec: dict, max_attempts: int) -> None:
        # called under the lock
        tid = rec.get("ticket", "?")
        rec["quarantined_at"] = time.time()
        self._states["quarantine"][tid] = rec
        self.record_event("quarantined", ticket=tid,
                          attempt=int(rec.get("attempts", 0)),
                          trace_id=rec.get("trace_id", ""),
                          max_attempts=max_attempts)
        self._write_result_locked(
            tid, "failed", rc=1,
            error=(f"quarantined after {rec.get('attempts', 0)} "
                   f"crash-shaped claim(s) (max_attempts "
                   f"{max_attempts}): this beam repeatedly killed "
                   f"its worker"),
            reason="max_attempts", attempts=rec.get("attempts", 0),
            outdir=rec.get("outdir", ""),
            trace_id=rec.get("trace_id", ""))

    def requeue_stale_claims(
            self, max_attempts=protocol.DEFAULT_MAX_ATTEMPTS):
        me = os.getpid()

        def verdict(rec):
            owner = rec.get("claimed_by")
            if owner == me:
                # in-process claims are same-pid by construction; a
                # boot-recovery sweep treats them like the spool
                # backend treats its own: requeue without a strike
                return None if self._owner_thread_live(rec) \
                    else "neutral"
            if owner is not None and protocol._pid_alive(owner):
                return None
            try:
                if (str(rec.get("claimed_by_worker", "")),
                        int(owner)) in self._elective:
                    # an autoscaler-declared kill: requeue without a
                    # crash strike, same ladder as the spool ledger
                    return ("neutral", "scale_down")
            except (TypeError, ValueError):
                pass
            return "strike"
        return self._requeue(verdict, max_attempts,
                             neutral_reason="boot_recovery")

    @staticmethod
    def _owner_thread_live(rec: dict) -> bool:
        """A same-pid claim is live while its claiming thread is —
        this backend's analogue of pid liveness.  Claims made by
        threads that have since exited are recoverable orphans."""
        ident = rec.get("claimed_by_thread")
        if ident is None:
            return True
        return any(t.ident == ident for t in threading.enumerate())

    def requeue_own_claims(self):
        me = os.getpid()
        return self._requeue(
            lambda rec: ("neutral" if rec.get("claimed_by") == me
                         else None),
            protocol.DEFAULT_MAX_ATTEMPTS, neutral_reason="drain")

    # -------------------------------------------------------- results

    def write_result(self, ticket_id, status, rc=0, error="",
                     **extra):
        with self._lock:
            self._write_result_locked(ticket_id, status, rc=rc,
                                      error=error, **extra)

    def _write_result_locked(self, ticket_id, status, rc=0, error="",
                             **extra):
        trace_id = extra.get("trace_id", "")
        if not trace_id:
            claim = self._states["claimed"].get(ticket_id)
            trace_id = (claim or {}).get("trace_id", "")
        rec = {"ticket": ticket_id, "status": status, "rc": rc,
               "error": error, "finished_at": time.time(), **extra}
        if trace_id:
            rec["trace_id"] = trace_id
        # result durable before the claim releases (contract #3);
        # "durable" here is dict-insertion order under the lock, but
        # the ordering property — a crash between the two leaves a
        # finished ticket — is the same observable contract
        self._states["done"][ticket_id] = rec
        self._states["claimed"].pop(ticket_id, None)
        self.record_event("result", ticket=ticket_id,
                          worker=str(extra.get("worker", "") or ""),
                          attempt=int(extra.get("attempts", 0) or 0),
                          trace_id=trace_id, status=status, rc=rc)

    def read_result(self, ticket_id):
        with self._lock:
            rec = self._states["done"].get(ticket_id)
            return dict(rec) if rec is not None else None

    # -------------------------------------------------- introspection

    def ticket_state(self, ticket_id):
        with self._lock:
            for state in ("done", "claimed", "incoming"):
                if ticket_id in self._states[state]:
                    return state
        return "unknown"

    def list_tickets(self, state):
        with self._lock:
            recs = list(self._states[state].values())
        return [r["ticket"] for r in sorted(
            recs, key=lambda r: (r.get("submitted_at", 0.0),
                                 r["ticket"]))]

    def read_ticket(self, ticket_id):
        with self._lock:
            for state in ("claimed", "incoming", "quarantine"):
                rec = self._states[state].get(ticket_id)
                if rec is not None:
                    return dict(rec)
        return None

    def state_count(self, state):
        with self._lock:
            return len(self._states[state])

    def pending_by_tenant(self):
        with self._lock:
            counts: dict[str, int] = {}
            for rec in self._states["incoming"].values():
                tenant = rec.get("tenant") or "default"
                counts[tenant] = counts.get(tenant, 0) + 1
            return counts

    def inflight_by_tenant(self):
        with self._lock:
            counts: dict[str, int] = {}
            for rec in self._states["claimed"].values():
                tenant = rec.get("tenant") or "default"
                counts[tenant] = counts.get(tenant, 0) + 1
            return counts

    # ---------------------------------------------- liveness/capacity

    def heartbeat(self, worker_id="", **fields):
        with self._lock:
            self._heartbeats[worker_id] = {
                "t": time.time(), "pid": os.getpid(),
                "worker": worker_id, **fields}

    def fresh_workers(self, max_age_s=None):
        with self._lock:
            return {wid: dict(rec)
                    for wid, rec in self._heartbeats.items()
                    if protocol._hb_fresh(rec, max_age_s)}

    def capacity(self, max_age_s=None, default_depth=8):
        fresh = self.fresh_workers(max_age_s)
        if not fresh:
            return None
        depth = sum(int(rec.get("max_queue_depth", default_depth))
                    for rec in fresh.values())
        return max(0, depth - self.pending_count())

    # -------------------------------------------------------- journal

    def record_event(self, event, **fields):
        rec = telemetry.event_record(event, **{
            k: v for k, v in fields.items() if v or v == 0})
        with self._lock:
            self._events.append(rec)

    def read_events(self, ticket=None):
        with self._lock:
            evs = [dict(e) for e in self._events
                   if ticket is None or e.get("ticket") == ticket]
        evs.sort(key=lambda r: r.get("t", 0.0))
        return evs

    def read_events_after(self, after_offset=0, ticket=None):
        # the "offset" here is simply an index into the in-memory
        # event list — same contract, no bytes involved
        with self._lock:
            start = max(0, min(int(after_offset), len(self._events)))
            evs = [dict(e) for e in self._events[start:]
                   if ticket is None or e.get("ticket") == ticket]
            next_offset = len(self._events)
        evs.sort(key=lambda r: r.get("t", 0.0))
        return evs, next_offset

    # --------------------------------------- liveness detail / ledger

    def read_heartbeat(self, worker_id=""):
        with self._lock:
            rec = self._heartbeats.get(worker_id)
            return dict(rec) if rec is not None else None

    def list_heartbeats(self):
        with self._lock:
            return {wid: dict(rec)
                    for wid, rec in self._heartbeats.items()}

    def write_heartbeat_record(self, worker_id, rec):
        with self._lock:
            self._heartbeats[worker_id] = dict(rec)

    def remove_heartbeat(self, worker_id):
        with self._lock:
            self._heartbeats.pop(worker_id, None)

    def record_elective_kill(self, worker_id, pid,
                             reason="scale_down"):
        with self._lock:
            self._elective.add((str(worker_id), int(pid)))

    def elective_kills(self):
        with self._lock:
            return set(self._elective)

    # ------------------------------------------------ verifier surface

    def ticket_presence(self, ticket_id):
        with self._lock:
            return {state: ticket_id in self._states[state]
                    for state in _STATES}

    def orphan_sweep(self):
        return []      # dict transitions leave no transient files

    def fsck(self):
        counts = {s: self.state_count(s) for s in _STATES}
        return {"backend": self.backend,
                "target": f"memory:{self.name}",
                "counts": counts, "findings": []}


# --------------------------------------------------------------------
# resolution
# --------------------------------------------------------------------

_memory_queues: dict[str, MemoryTicketQueue] = {}
_memory_lock = threading.Lock()


def memory_queue(name: str = "") -> MemoryTicketQueue:
    """The process-global named in-memory queue (so a gateway and an
    embedded worker constructed independently share one)."""
    with _memory_lock:
        q = _memory_queues.get(name)
        if q is None:
            q = _memory_queues[name] = MemoryTicketQueue(name)
        return q


def get_ticket_queue(url: str) -> TicketQueue:
    """Backend resolution: ``memory:`` / ``memory:<name>`` -> the
    named in-memory queue; ``sqlite:<path>`` -> the durable SQLite
    backend; ``spool:<dir>`` or a bare directory path -> the
    filesystem spool backend."""
    if url.startswith("memory:"):
        return memory_queue(url[len("memory:"):].lstrip("/"))
    if url == "memory":
        return memory_queue()
    if url.startswith("sqlite:"):
        # imported lazily: sqlite_queue imports this module for the
        # TicketQueue base class
        from tpulsar_torch.frontdoor import sqlite_queue
        path = url[len("sqlite:"):]
        if not path:
            raise ValueError("sqlite ticket-queue url needs a "
                             "database path (sqlite:<path>)")
        return sqlite_queue.SQLiteTicketQueue(path)
    if url.startswith("spool:"):
        url = url[len("spool:"):]
    if not url:
        raise ValueError("empty ticket-queue url")
    return FilesystemSpoolQueue(url)
