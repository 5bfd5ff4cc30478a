"""The durable SQLite TicketQueue backend: the ticket contract
without a shared filesystem — counterpart of
tpulsar/frontdoor/sqlite_queue.py (a copy: the same schema and table
names, so a database either package wrote is claimed, completed and
fsck'd by the other).

``sqlite:<path>`` in
:func:`tpulsar_torch.frontdoor.queue.get_ticket_queue` resolves here:
one WAL-mode SQLite database holds the whole ticket lifecycle —
tickets (state + owner + attempts), results, worker heartbeats, and
the autoscaler's elective-kill ledger — so N worker processes on one
host coordinate through transactions instead of rename games, and the
spool directory stops being a single point of failure for queue state.

How the spool protocol's contract maps onto transactions:

  exactly-once claims      every claim is a compare-and-swap UPDATE
                           (``WHERE state='incoming'``) inside a
                           ``BEGIN IMMEDIATE`` transaction: of N
                           concurrent claimers exactly one's rowcount
                           is 1, and a claimed ticket is never
                           observable as pending (same transaction).
  owner stamping           the CAS stamps ``claimed_by`` (pid) +
                           ``claimed_by_worker`` into both the row's
                           columns and its record JSON — an ownerless
                           claim cannot exist even for one statement.
  result-durable-before-   ``write_result`` INSERTs the result row
  claim-release            and DELETEs the claim row in ONE
                           transaction: the crash window between the
                           two, which the spool backend reconciles at
                           the next janitor pass, does not exist at
                           all here.
  dead-owner requeue       the same verdict ladder as
                           serve/protocol.py: own pid -> neutral
                           (boot recovery), live pid -> leave alone,
                           elective (worker, pid) pair -> neutral
                           ``scale_down``, else a crash strike with
                           the checkpoint-progress fairness watermark
                           and quarantine at the cap — each ticket's
                           judgment its own transaction, so a SIGKILL
                           mid-pass rolls back one ticket, never
                           loses one.
  journal                  events append through obs/journal.py to
                           ``<dirname(db)>/events/journal.jsonl`` —
                           the SAME artifact, vocabulary, and chain
                           discipline as the spool backend, so
                           ``chaos verify`` audits a sqlite run
                           unchanged.

Robustness machinery:

  * the ``queue.db`` fault point fires before EVERY statement
    (schedule-pollable, errno + delay modes), shaped as
    ``sqlite3.OperationalError`` so the busy/backoff machinery sees
    exactly what a contended database raises;
  * busy/locked errors retry through ``resilience.policy`` with
    jittered exponential backoff on top of SQLite's own busy timeout
    (knob ``TPULSAR_QUEUE_BUSY_TIMEOUT_S``);
  * corruption is CONTAINED, never silently absorbed: a failed
    ``PRAGMA integrity_check`` (or an unreadable/torn database) at
    open journals a ``queue_corrupt`` event and raises
    :class:`QueueCorrupt` loudly — and a mid-operation "database disk
    image is malformed" gets the same refusal;
  * every other terminal SQLite error surfaces as an EIO-shaped
    ``OSError``, the taxonomy every janitor loop, serve guard, and
    chaos worker already contains.

stdlib only (sqlite3, json, os) — importable by control-plane
processes that never touch the device.
"""

from __future__ import annotations

import errno as errno_mod
import json
import os
import sqlite3
import threading
import time
import uuid

from tpulsar_torch.frontdoor import queue as queue_mod
from tpulsar_torch.obs import journal, telemetry
from tpulsar_torch.resilience import faults
from tpulsar_torch.resilience import policy as respolicy
from tpulsar_torch.serve import protocol

_STATES = ("incoming", "claimed", "done", "quarantine")

#: the hot-path operations timed into tpulsar_queue_op_seconds —
#: a deliberate whitelist, so introspection reads (ticket_state,
#: list_heartbeats, ...) don't multiply the label cardinality
_TIMED_OPS = frozenset(
    ("submit", "claim", "claim_batch", "requeue", "result",
     "heartbeat"))

#: default SQLite busy timeout (seconds) — both the connection-level
#: timeout and PRAGMA busy_timeout; TPULSAR_QUEUE_BUSY_TIMEOUT_S
#: overrides it for deployments with many contending workers
DEFAULT_BUSY_TIMEOUT_S = 5.0


def busy_timeout_s() -> float:
    """Effective busy timeout: TPULSAR_QUEUE_BUSY_TIMEOUT_S env (>0)
    over the built-in default."""
    env = os.environ.get("TPULSAR_QUEUE_BUSY_TIMEOUT_S", "")
    if env:
        try:
            val = float(env)
            if val > 0:
                return val
        except ValueError:
            pass
    return DEFAULT_BUSY_TIMEOUT_S


class QueueCorrupt(RuntimeError):
    """The database failed its integrity check (or is unreadable):
    the backend REFUSES to serve from it.  Deliberately not
    OSError-shaped — the tolerant OSError guards in janitor/serve
    loops must not absorb a corrupt queue into a silent retry; the
    operator triages (docs/operations.md: corruption triage) and
    either restores or re-creates the database."""


def _op_error(msg: str) -> Exception:
    """The injected-fault shape for queue.db: what a contended or
    failing SQLite database actually raises, so retry classification
    and containment paths exercise their real taxonomy."""
    return sqlite3.OperationalError(msg)


def _is_busy(exc: BaseException) -> bool:
    msg = str(exc).lower()
    return "locked" in msg or "busy" in msg


def _is_corrupt(exc: BaseException) -> bool:
    msg = str(exc).lower()
    return ("malformed" in msg or "not a database" in msg
            or "corrupt" in msg)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS tickets (
    ticket            TEXT PRIMARY KEY,
    state             TEXT NOT NULL,
    submitted_at      REAL NOT NULL DEFAULT 0,
    attempts          INTEGER NOT NULL DEFAULT 0,
    tenant            TEXT NOT NULL DEFAULT '',
    compat            TEXT NOT NULL DEFAULT '',
    claimed_by        INTEGER,
    claimed_by_worker TEXT NOT NULL DEFAULT '',
    record            TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS tickets_state
    ON tickets (state, submitted_at, ticket);
CREATE TABLE IF NOT EXISTS results (
    ticket      TEXT PRIMARY KEY,
    finished_at REAL NOT NULL DEFAULT 0,
    record      TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS workers (
    worker TEXT PRIMARY KEY,
    t      REAL NOT NULL DEFAULT 0,
    record TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS elective_kills (
    worker TEXT NOT NULL,
    pid    INTEGER NOT NULL,
    t      REAL NOT NULL DEFAULT 0,
    reason TEXT NOT NULL DEFAULT 'scale_down'
);
"""


class SQLiteTicketQueue(queue_mod.TicketQueue):
    """One WAL-mode SQLite database as a TicketQueue (module
    docstring has the contract mapping).  Connections are per-thread;
    any number of processes may share the database file."""

    backend = "sqlite"

    def __init__(self, path: str, timeout_s: float | None = None):
        self.path = os.path.abspath(path)
        #: journal/fleet root: events live NEXT TO the database, so a
        #: queue.db inside a run directory keeps every journal
        #: consumer (chaos verify, obs console, fleetview) unchanged
        self.root = os.path.dirname(self.path) or "."
        self.timeout_s = (timeout_s if timeout_s and timeout_s > 0
                          else busy_timeout_s())
        self._local = threading.local()
        self._retry = respolicy.RetryPolicy(
            max_attempts=5, backoff_base_s=0.02, backoff_mult=2.0,
            backoff_max_s=0.5, jitter=True,
            retry_on=(sqlite3.OperationalError,), retryable=_is_busy)
        os.makedirs(self.root, exist_ok=True)
        self._open_checked()

    def __repr__(self):
        return f"SQLiteTicketQueue({self.path!r})"

    @property
    def url(self) -> str:
        return f"sqlite:{self.path}"

    @property
    def journal_root(self) -> str:
        return self.root

    # ---------------------------------------------------- connections

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=self.timeout_s,
                                   isolation_level=None)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=FULL")
            conn.execute(
                f"PRAGMA busy_timeout={int(self.timeout_s * 1000)}")
            self._local.conn = conn
        return conn

    def _open_checked(self) -> None:
        """First open: integrity-check BEFORE serving (a torn WAL or
        a corrupted page must refuse loudly at the door, not fail one
        beam an hour later), then create the schema."""
        try:
            conn = self._conn()
            row = conn.execute("PRAGMA integrity_check").fetchone()
            if row is None or str(row[0]).lower() != "ok":
                self._refuse(str(row[0]) if row else "no output from "
                             "PRAGMA integrity_check")
            conn.executescript(_SCHEMA)
        except sqlite3.DatabaseError as e:
            self._refuse(str(e))

    def _refuse(self, detail: str) -> None:
        """Corruption containment: journal the evidence, then refuse.
        The journaled event is what separates a contained refusal
        from silent data loss — the chaos verifier and the operator
        both see WHY the queue went away."""
        journal.record(self.root, "queue_corrupt", path=self.path,
                       error=detail[:200])
        raise QueueCorrupt(
            f"sqlite ticket queue {self.path} refused: {detail} "
            f"(see docs/operations.md corruption triage — restore "
            f"from the journal/results or re-create; never serve "
            f"from a database that fails its integrity check)")

    # ----------------------------------------------- statement plumbing

    def _fire(self, detail: str) -> None:
        faults.fire("queue.db", make_exc=_op_error, detail=detail)

    def _x(self, conn: sqlite3.Connection, sql: str, params=()):
        """Execute one statement with the queue.db fault point armed
        in front of it — EVERY statement, so a schedule window can
        fail a claim CAS, a result insert, or a requeue mid-ladder."""
        self._fire(" ".join(sql.split()[:2]).lower())
        return conn.execute(sql, params)

    def _guard(self, attempt, label: str):
        """Busy-retry + terminal-error classification around one
        read or one whole transaction.  Hot-path ops (the _TIMED_OPS
        whitelist) land their wall time — busy retries included, the
        latency a caller actually feels — in the
        tpulsar_queue_op_seconds histogram."""
        op = label.replace(" ", "_")
        t0 = time.perf_counter() if op in _TIMED_OPS else None
        try:
            out = respolicy.call(attempt, self._retry,
                                 label="queue.db")
            if t0 is not None:
                telemetry.queue_op_seconds().observe(
                    time.perf_counter() - t0,
                    backend="sqlite", op=op)
            return out
        except sqlite3.DatabaseError as e:
            if _is_corrupt(e):
                self._refuse(str(e))
            raise OSError(
                errno_mod.EIO,
                f"sqlite queue {label} failed: {e}") from e
        except sqlite3.Error as e:
            raise OSError(
                errno_mod.EIO,
                f"sqlite queue {label} failed: {e}") from e

    def _write(self, fn, label: str):
        """Run fn(conn) inside BEGIN IMMEDIATE .. COMMIT (one write
        transaction, retried as a unit on busy)."""
        def attempt():
            conn = self._conn()
            self._fire(f"begin {label}")
            conn.execute("BEGIN IMMEDIATE")
            try:
                out = fn(conn)
            except BaseException:
                try:
                    conn.execute("ROLLBACK")
                except sqlite3.Error:
                    pass
                raise
            conn.execute("COMMIT")
            return out
        return self._guard(attempt, label)

    def _read(self, fn, label: str):
        def attempt():
            return fn(self._conn())
        return self._guard(attempt, label)

    # ----------------------------------------------------- submission

    def submit(self, ticket_id, datafiles, outdir, job_id=None,
               **extra):
        rec = {"ticket": ticket_id, "datafiles": list(datafiles),
               "outdir": outdir, "job_id": job_id,
               "submitted_at": time.time(), "attempts": 0, **extra}
        rec.setdefault("trace_id", uuid.uuid4().hex[:16])
        # journaled BEFORE the insert, exactly like the spool backend:
        # the instant the row lands the ticket is claimable, and a
        # fast claimer's 'claimed' timestamp must never precede
        # 'submitted'
        journal.record(self.root, "submitted", ticket=ticket_id,
                       attempt=0, trace_id=rec["trace_id"],
                       outdir=outdir,
                       **({"tenant": rec["tenant"]}
                          if rec.get("tenant") else {}))

        def fn(conn):
            self._x(conn,
                    "INSERT OR REPLACE INTO tickets (ticket, state, "
                    "submitted_at, attempts, tenant, compat, "
                    "claimed_by, claimed_by_worker, record) "
                    "VALUES (?, 'incoming', ?, 0, ?, ?, NULL, '', ?)",
                    (ticket_id, rec["submitted_at"],
                     str(rec.get("tenant", "") or ""),
                     str(rec.get("compat", "") or ""),
                     json.dumps(rec, sort_keys=True)))
        try:
            self._write(fn, "submit")
        except (OSError, QueueCorrupt) as e:
            # the insert failed: the submission was cleanly REFUSED —
            # compensate the journaled head so the auditor tells a
            # refused beam from a lost one, then surface the error
            journal.record(self.root, "submit_failed",
                           ticket=ticket_id, attempt=0,
                           trace_id=rec["trace_id"],
                           error=str(e)[:200])
            raise
        return ticket_id

    def cancel(self, ticket_id):
        def fn(conn):
            return self._x(
                conn, "DELETE FROM tickets WHERE ticket = ? AND "
                "state = 'incoming'", (ticket_id,)).rowcount
        return self._write(fn, "cancel") > 0

    # --------------------------------------------------------- claims

    def _order_locked(self, conn, policy) -> list[str]:
        if policy is None or getattr(policy, "is_trivial", False):
            rows = self._x(
                conn, "SELECT ticket FROM tickets WHERE state = "
                "'incoming' ORDER BY submitted_at, ticket").fetchall()
            return [r[0] for r in rows]
        pending = [json.loads(r[0]) for r in self._x(
            conn, "SELECT record FROM tickets WHERE state = "
            "'incoming'").fetchall()]
        return policy.claim_order(pending,
                                  self._inflight_locked(conn))

    def _inflight_locked(self, conn) -> dict[str, int]:
        rows = self._x(
            conn, "SELECT CASE WHEN tenant = '' THEN 'default' ELSE "
            "tenant END, COUNT(*) FROM tickets WHERE state = "
            "'claimed' GROUP BY 1").fetchall()
        return {tenant: int(n) for tenant, n in rows}

    def _claim_locked(self, conn, tid: str, worker_id: str,
                      worker_class: str) -> dict | None:
        row = self._x(
            conn, "SELECT record FROM tickets WHERE ticket = ? AND "
            "state = 'incoming'", (tid,)).fetchone()
        if row is None:
            return None
        rec = json.loads(row[0])
        rec["claimed_at"] = time.time()
        rec["claimed_by"] = os.getpid()
        if worker_id:
            rec["claimed_by_worker"] = worker_id
        if worker_class:
            rec["claimed_by_class"] = worker_class
        # the CAS: WHERE state='incoming' makes this claim exclusive
        # even against a writer this transaction cannot see (it can't
        # — BEGIN IMMEDIATE — but the guard costs nothing and keeps
        # the exactly-once property independent of locking mode)
        cur = self._x(
            conn, "UPDATE tickets SET state = 'claimed', "
            "claimed_by = ?, claimed_by_worker = ?, record = ? "
            "WHERE ticket = ? AND state = 'incoming'",
            (os.getpid(), worker_id,
             json.dumps(rec, sort_keys=True), tid))
        if cur.rowcount != 1:
            return None
        return rec

    def _journal_claim(self, rec: dict, worker_id: str) -> None:
        journal.record(
            self.root, "claimed", ticket=rec.get("ticket", "?"),
            worker=worker_id, pid=os.getpid(),
            attempt=int(rec.get("attempts", 0)),
            trace_id=rec.get("trace_id", ""),
            queue_wait_s=round(
                rec["claimed_at"] - rec.get("submitted_at",
                                            rec["claimed_at"]), 3),
            **({"tenant": rec["tenant"]} if rec.get("tenant")
               else {}),
            **({"worker_class": rec["claimed_by_class"]}
               if rec.get("claimed_by_class") else {}))

    def claim_next(self, worker_id="", policy=None, worker_class=""):
        def fn(conn):
            for tid in self._order_locked(conn, policy):
                rec = self._claim_locked(conn, tid, worker_id,
                                         worker_class)
                if rec is not None:
                    return rec
            return None
        rec = self._write(fn, "claim")
        if rec is not None:
            self._journal_claim(rec, worker_id)
        return rec

    def claim_batch(self, n, worker_id="", policy=None, compat=None,
                    worker_class=""):
        # same contract as protocol.claim_batch: ONE ordering pass,
        # the first claim (or the pinned ``compat``) fixes the key,
        # mismatching tickets stay pending in place
        if n < 1:
            return []

        def fn(conn):
            claimed: list[dict] = []
            for tid in self._order_locked(conn, policy):
                if len(claimed) >= n:
                    break
                if compat is not None or claimed:
                    want = compat if compat is not None \
                        else str(claimed[0].get("compat", "") or "")
                    row = self._x(
                        conn, "SELECT compat FROM tickets WHERE "
                        "ticket = ? AND state = 'incoming'",
                        (tid,)).fetchone()
                    if row is None:
                        continue
                    if str(row[0] or "") != str(want or ""):
                        continue
                rec = self._claim_locked(conn, tid, worker_id,
                                         worker_class)
                if rec is not None:
                    claimed.append(rec)
            return claimed
        claimed = self._write(fn, "claim_batch")
        for rec in claimed:
            self._journal_claim(rec, worker_id)
        return claimed

    # -------------------------------------------------------- requeue

    def _quarantine_locked(self, conn, rec: dict, max_attempts: int,
                           events: list) -> None:
        tid = rec.get("ticket", "?")
        rec["quarantined_at"] = time.time()
        attempts = int(rec.get("attempts", 0))
        trace_id = rec.get("trace_id", "")
        result = {"ticket": tid, "status": "failed", "rc": 1,
                  "error": (f"quarantined after {attempts} "
                            f"crash-shaped claim(s) (max_attempts "
                            f"{max_attempts}): this beam repeatedly "
                            f"killed its worker"),
                  "finished_at": time.time(),
                  "reason": "max_attempts", "attempts": attempts,
                  "outdir": rec.get("outdir", "")}
        if trace_id:
            result["trace_id"] = trace_id
        # quarantine row + terminal failed result in the SAME
        # transaction: a quarantined ticket without its terminal
        # record is not an observable state here
        self._x(conn, "UPDATE tickets SET state = 'quarantine', "
                "claimed_by = NULL, claimed_by_worker = '', "
                "attempts = ?, record = ? WHERE ticket = ?",
                (attempts, json.dumps(rec, sort_keys=True), tid))
        self._x(conn, "INSERT OR REPLACE INTO results (ticket, "
                "finished_at, record) VALUES (?, ?, ?)",
                (tid, result["finished_at"],
                 json.dumps(result, sort_keys=True)))
        events.append(("quarantined",
                       dict(ticket=tid, attempt=attempts,
                            trace_id=trace_id,
                            max_attempts=max_attempts)))
        events.append(("result",
                       dict(ticket=tid, worker="", attempt=attempts,
                            trace_id=trace_id, status="failed",
                            rc=1)))

    def _requeue(self, verdict_fn, max_attempts: int,
                 neutral_reason: str) -> list[str]:
        def scan(conn):
            return [r[0] for r in self._x(
                conn, "SELECT ticket FROM tickets WHERE state = "
                "'claimed' ORDER BY submitted_at, ticket").fetchall()]
        try:
            tids = self._read(scan, "requeue scan")
        except OSError:
            return []
        requeued: list[str] = []
        clean_outdirs: list[str] = []
        for tid in tids:
            events: list = []

            def fn(conn, tid=tid, events=events):
                row = self._x(
                    conn, "SELECT record FROM tickets WHERE "
                    "ticket = ? AND state = 'claimed'",
                    (tid,)).fetchone()
                if row is None:
                    return None      # raced away: released/requeued
                rec = json.loads(row[0])
                done = self._x(
                    conn, "SELECT 1 FROM results WHERE ticket = ?",
                    (tid,)).fetchone()
                if done is not None:
                    # completed work whose claim never released (a
                    # crash between the spool backend's two steps has
                    # no analogue here, but a forged/legacy row still
                    # reconciles the same way)
                    self._x(conn, "DELETE FROM tickets WHERE "
                            "ticket = ? AND state = 'claimed'",
                            (tid,))
                    return None
                verdict = verdict_fn(rec)
                if verdict is None:
                    return None
                reason = neutral_reason
                if isinstance(verdict, tuple):
                    verdict, reason = verdict
                owner_pid = rec.get("claimed_by")
                owner_worker = rec.get("claimed_by_worker", "")
                rec = protocol._strip_claim_stamps(rec)
                progressed = False
                if verdict == "strike":
                    rec["attempts"] = int(rec.get("attempts", 0)) + 1
                    # checkpoint-progress fairness (see
                    # protocol._requeue_claims): progress resets the
                    # crash-loop BUDGET, attempts stay monotone
                    progress = protocol._checkpoint_progress(rec)
                    if progress > max(0,
                                      int(rec.get("ckpt_progress",
                                                  0))):
                        progressed = True
                        rec["ckpt_progress"] = progress
                        rec["attempts_at_progress"] = rec["attempts"]
                    stuck = rec["attempts"] - int(
                        rec.get("attempts_at_progress", 0))
                    if stuck >= max_attempts:
                        self._quarantine_locked(conn, rec,
                                                max_attempts, events)
                        return ("quarantined", rec)
                self._x(conn, "UPDATE tickets SET state = "
                        "'incoming', claimed_by = NULL, "
                        "claimed_by_worker = '', attempts = ?, "
                        "record = ? WHERE ticket = ?",
                        (int(rec.get("attempts", 0)),
                         json.dumps(rec, sort_keys=True), tid))
                if verdict == "strike":
                    events.append((
                        "takeover",
                        dict(ticket=tid,
                             attempt=int(rec.get("attempts", 0)),
                             trace_id=rec.get("trace_id", ""),
                             from_worker=owner_worker,
                             from_pid=owner_pid, by_pid=os.getpid(),
                             **({"ckpt_progress":
                                 rec.get("ckpt_progress", -1),
                                 "budget_reset": True}
                                if progressed else {}))))
                else:
                    events.append((
                        "drain_requeue",
                        dict(ticket=tid, worker=owner_worker,
                             attempt=int(rec.get("attempts", 0)),
                             trace_id=rec.get("trace_id", ""),
                             reason=reason)))
                return ("requeued", rec)
            try:
                out = self._write(fn, "requeue")
            except OSError:
                continue       # one sick ticket must not end the pass
            for name, fields in events:
                journal.record(self.root, name, **fields)
            if out is None:
                continue
            what, rec = out
            if what == "quarantined" and rec.get("outdir"):
                clean_outdirs.append(rec["outdir"])
            if what == "requeued":
                requeued.append(tid)
        for outdir in clean_outdirs:
            # resume state for a beam nothing will resume is dead
            # weight, and a *.tmp a kill left inside it must not
            # outlive janitor cleanup (no_orphan_sidefiles)
            from tpulsar_torch import checkpoint as ckpt
            ckpt.clean(ckpt.default_root(outdir))
        return requeued

    def requeue_stale_claims(
            self, max_attempts=protocol.DEFAULT_MAX_ATTEMPTS):
        me = os.getpid()
        elective = self.elective_kills()

        def verdict(rec):
            owner = rec.get("claimed_by")
            if owner == me:
                return "neutral"     # our own claim (boot recovery)
            if owner is not None and protocol._pid_alive(owner):
                return None          # a live co-worker owns this beam
            try:
                pair = (str(rec.get("claimed_by_worker", "")),
                        int(owner))
                if pair in elective:
                    # the autoscaler killed this owner on purpose:
                    # no strike (matched on the PAIR so a recycled
                    # pid in another worker slot strikes normally)
                    return ("neutral", "scale_down")
            except (TypeError, ValueError):
                pass
            return "strike"
        return self._requeue(verdict, max_attempts,
                             neutral_reason="boot_recovery")

    def requeue_own_claims(self):
        me = os.getpid()
        return self._requeue(
            lambda rec: ("neutral" if rec.get("claimed_by") == me
                         else None),
            protocol.DEFAULT_MAX_ATTEMPTS, neutral_reason="drain")

    # -------------------------------------------------------- results

    def write_result(self, ticket_id, status, rc=0, error="",
                     **extra):
        def fn(conn):
            trace_id = extra.get("trace_id", "")
            if not trace_id:
                row = self._x(
                    conn, "SELECT record FROM tickets WHERE "
                    "ticket = ? AND state = 'claimed'",
                    (ticket_id,)).fetchone()
                if row is not None:
                    trace_id = (json.loads(row[0])
                                or {}).get("trace_id", "")
            rec = {"ticket": ticket_id, "status": status, "rc": rc,
                   "error": error, "finished_at": time.time(),
                   **extra}
            if trace_id:
                rec["trace_id"] = trace_id
            # result insert + claim release in ONE transaction:
            # contract #3 with no crash window at all
            self._x(conn, "INSERT OR REPLACE INTO results (ticket, "
                    "finished_at, record) VALUES (?, ?, ?)",
                    (ticket_id, rec["finished_at"],
                     json.dumps(rec, sort_keys=True)))
            self._x(conn, "DELETE FROM tickets WHERE ticket = ? AND "
                    "state = 'claimed'", (ticket_id,))
            return trace_id
        trace_id = self._write(fn, "result")
        journal.record(self.root, "result", ticket=ticket_id,
                       worker=str(extra.get("worker", "") or ""),
                       attempt=int(extra.get("attempts", 0) or 0),
                       trace_id=trace_id, status=status, rc=rc)

    def read_result(self, ticket_id):
        def fn(conn):
            row = self._x(conn, "SELECT record FROM results WHERE "
                          "ticket = ?", (ticket_id,)).fetchone()
            return json.loads(row[0]) if row is not None else None
        return self._read(fn, "read_result")

    # -------------------------------------------------- introspection

    def ticket_state(self, ticket_id):
        def fn(conn):
            if self._x(conn, "SELECT 1 FROM results WHERE "
                       "ticket = ?", (ticket_id,)).fetchone():
                return "done"
            row = self._x(conn, "SELECT state FROM tickets WHERE "
                          "ticket = ?", (ticket_id,)).fetchone()
            if row is not None and row[0] in ("claimed", "incoming"):
                return row[0]
            return "unknown"
        return self._read(fn, "ticket_state")

    def list_tickets(self, state):
        assert state in _STATES, state

        def fn(conn):
            if state == "done":
                rows = self._x(conn, "SELECT ticket FROM results "
                               "ORDER BY ticket").fetchall()
            else:
                rows = self._x(
                    conn, "SELECT ticket FROM tickets WHERE "
                    "state = ? ORDER BY submitted_at, ticket",
                    (state,)).fetchall()
            return [r[0] for r in rows]
        return self._read(fn, "list_tickets")

    def read_ticket(self, ticket_id):
        def fn(conn):
            row = self._x(conn, "SELECT record FROM tickets WHERE "
                          "ticket = ?", (ticket_id,)).fetchone()
            return json.loads(row[0]) if row is not None else None
        return self._read(fn, "read_ticket")

    def state_count(self, state):
        assert state in _STATES, state

        def fn(conn):
            if state == "done":
                row = self._x(conn, "SELECT COUNT(*) FROM "
                              "results").fetchone()
            else:
                row = self._x(conn, "SELECT COUNT(*) FROM tickets "
                              "WHERE state = ?", (state,)).fetchone()
            return int(row[0])
        return self._read(fn, "state_count")

    def pending_by_tenant(self):
        def fn(conn):
            rows = self._x(
                conn, "SELECT CASE WHEN tenant = '' THEN 'default' "
                "ELSE tenant END, COUNT(*) FROM tickets WHERE "
                "state = 'incoming' GROUP BY 1").fetchall()
            return {tenant: int(n) for tenant, n in rows}
        return self._read(fn, "pending_by_tenant")

    def inflight_by_tenant(self):
        return self._read(self._inflight_locked, "inflight_by_tenant")

    # ---------------------------------------------- liveness/capacity

    def heartbeat(self, worker_id="", **fields):
        rec = {"t": time.time(), "pid": os.getpid(),
               "worker": worker_id, **fields}

        def fn(conn):
            self._x(conn, "INSERT OR REPLACE INTO workers (worker, "
                    "t, record) VALUES (?, ?, ?)",
                    (worker_id, rec["t"],
                     json.dumps(rec, sort_keys=True)))
        self._write(fn, "heartbeat")

    def read_heartbeat(self, worker_id=""):
        def fn(conn):
            row = self._x(conn, "SELECT record FROM workers WHERE "
                          "worker = ?", (worker_id,)).fetchone()
            return json.loads(row[0]) if row is not None else None
        return self._read(fn, "read_heartbeat")

    def list_heartbeats(self):
        def fn(conn):
            rows = self._x(conn, "SELECT worker, record FROM workers "
                           "ORDER BY worker").fetchall()
            return {wid: json.loads(rec) for wid, rec in rows}
        return self._read(fn, "list_heartbeats")

    def write_heartbeat_record(self, worker_id, rec):
        # verbatim overwrite (no pid/t restamp): the controller's
        # down-marking depends on the DEAD worker's pid surviving
        def fn(conn):
            self._x(conn, "INSERT OR REPLACE INTO workers (worker, "
                    "t, record) VALUES (?, ?, ?)",
                    (worker_id, float(rec.get("t", time.time())),
                     json.dumps(rec, sort_keys=True)))
        self._write(fn, "write_heartbeat_record")

    def remove_heartbeat(self, worker_id):
        def fn(conn):
            self._x(conn, "DELETE FROM workers WHERE worker = ?",
                    (worker_id,))
        self._write(fn, "remove_heartbeat")

    def fresh_workers(self, max_age_s=None):
        return {wid: rec
                for wid, rec in self.list_heartbeats().items()
                if protocol._hb_fresh(rec, max_age_s)}

    def capacity(self, max_age_s=None, default_depth=8):
        fresh = self.fresh_workers(max_age_s)
        if not fresh:
            return None
        depth = sum(int(rec.get("max_queue_depth", default_depth))
                    for rec in fresh.values())
        return max(0, depth - self.pending_count())

    def oldest_pending_age_s(self, now=None):
        now = time.time() if now is None else now

        def fn(conn):
            row = self._x(conn, "SELECT MIN(submitted_at) FROM "
                          "tickets WHERE state = 'incoming'"
                          ).fetchone()
            return row[0] if row is not None else None
        t = self._read(fn, "oldest_pending_age_s")
        return max(0.0, now - float(t)) if t is not None else 0.0

    # --------------------------------------------- elective-kill ledger

    def record_elective_kill(self, worker_id: str, pid: int,
                             reason: str = "scale_down") -> None:
        now = time.time()

        def fn(conn):
            self._x(conn, "DELETE FROM elective_kills WHERE t < ?",
                    (now - protocol.SCALEDOWN_TTL_S,))
            self._x(conn, "INSERT INTO elective_kills (worker, pid, "
                    "t, reason) VALUES (?, ?, ?, ?)",
                    (worker_id, int(pid), now, reason))
        self._write(fn, "elective_kill")

    def elective_kills(self) -> set[tuple[str, int]]:
        def fn(conn):
            rows = self._x(conn, "SELECT worker, pid FROM "
                           "elective_kills").fetchall()
            return {(str(w), int(p)) for w, p in rows}
        try:
            return self._read(fn, "elective_kills")
        except OSError:
            return set()     # tolerant, like a missing spool ledger

    # -------------------------------------------------------- journal

    def record_event(self, event, **fields):
        journal.record(self.root, event, **fields)

    def read_events(self, ticket=None):
        return journal.read_events(self.root, ticket=ticket,
                                   bad_lines=[])

    def read_events_after(self, after_offset=0, ticket=None):
        return journal.read_events(self.root, ticket=ticket,
                                   after_offset=after_offset,
                                   bad_lines=[])

    # ------------------------------------------------ verifier surface

    def ticket_presence(self, ticket_id) -> dict[str, bool]:
        def fn(conn):
            out = {s: False for s in _STATES}
            out["done"] = self._x(
                conn, "SELECT 1 FROM results WHERE ticket = ?",
                (ticket_id,)).fetchone() is not None
            row = self._x(conn, "SELECT state FROM tickets WHERE "
                          "ticket = ?", (ticket_id,)).fetchone()
            if row is not None and row[0] in out:
                out[row[0]] = True
            return out
        return self._read(fn, "presence")

    def orphan_sweep(self) -> list[dict]:
        # transactions leave no transient side-files by construction;
        # WAL/SHM files are live machinery, not orphans
        return []

    def fsck(self) -> dict:
        """Integrity check + WAL checkpoint + per-state counts (the
        ``queue fsck`` body).  Findings non-empty => rc 1."""
        findings: list[dict] = []
        try:
            conn = self._conn()
            row = conn.execute("PRAGMA integrity_check").fetchone()
            if row is None or str(row[0]).lower() != "ok":
                findings.append({
                    "what": "integrity_check",
                    "detail": str(row[0]) if row else "no output"})
            busy, log_frames, ckpt_frames = conn.execute(
                "PRAGMA wal_checkpoint(TRUNCATE)").fetchone()
            if busy:
                findings.append({
                    "what": "wal_checkpoint",
                    "detail": f"checkpoint blocked (busy={busy}, "
                              f"{log_frames} log frames, "
                              f"{ckpt_frames} checkpointed)"})
        except sqlite3.DatabaseError as e:
            findings.append({"what": "integrity_check",
                             "detail": str(e)})
            counts = {s: -1 for s in _STATES}
            return {"backend": self.backend, "target": self.path,
                    "counts": counts, "findings": findings}
        counts = {s: self.state_count(s) for s in _STATES}
        return {"backend": self.backend, "target": self.path,
                "counts": counts, "findings": findings}
