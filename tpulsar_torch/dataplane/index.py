"""Persistent candidate index — the query half of the data plane;
counterpart of tpulsar/dataplane/index.py (a copy, with the outdir
parse of the JAX package's frontdoor/results.py ``_candidate_rows``
carried here as ``candidate_rows``, which frontdoor/results.py
reuses).

Before this module ``/v1/candidates`` re-parsed every done ticket's
``*.accelcands`` files on every query (frontdoor/results.py): O(beams
x candidates) filesystem work per HTTP request, and impossible the
moment results live on another host.  The index is a sqlite database
(``<spool>/candidates.db``) written by the WORKER in the same durable
step that writes the result record, so by the time a result is
observable its candidates are queryable — and the gateway answers
from an indexed ``ORDER BY sigma DESC`` instead of a parse.

Row shape is EXACTLY ``candidate_rows``'s output (plus the ticket
id): the index is a cache of the sifted truth, never a
recomputation.  The legacy parse
survives only as the ``rebuild()`` path.

Concurrency discipline follows frontdoor/sqlite_queue.py: per-thread
connections, WAL + synchronous=FULL, BEGIN IMMEDIATE write
transactions, busy retries.  Indexing is idempotent per ticket
(delete-then-insert in one transaction) so a crash-retried result
write re-indexes cleanly — exactly-once by construction, not by
counting.  Every statement fires the ``dataplane.io`` fault point.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import sqlite3
import threading
import time

from tpulsar_torch.resilience import faults

#: bump on schema change; a mismatched db is refused loudly
SCHEMA_VERSION = 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS meta (
    key   TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS results (
    ticket     TEXT PRIMARY KEY,
    outdir     TEXT NOT NULL DEFAULT '',
    indexed_at REAL NOT NULL,
    ncands     INTEGER NOT NULL,
    artifacts  TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS candidates (
    ticket      TEXT NOT NULL,
    file        TEXT NOT NULL,
    num         INTEGER NOT NULL,
    sigma       REAL NOT NULL,
    power       REAL NOT NULL,
    numharm     INTEGER NOT NULL,
    dm          REAL NOT NULL,
    r           REAL NOT NULL,
    z           REAL NOT NULL,
    period_s    REAL NOT NULL,
    freq_hz     REAL NOT NULL,
    num_dm_hits INTEGER NOT NULL,
    PRIMARY KEY (ticket, file, num)
);
CREATE INDEX IF NOT EXISTS idx_cand_sigma
    ON candidates (sigma DESC);
"""

_BUSY_TIMEOUT_S = 5.0
_WRITE_RETRIES = 5

#: the per-candidate columns, in candidate_rows's row-key order
_CAND_COLS = ("r", "z", "sigma", "power", "numharm", "dm",
              "period_s", "freq_hz", "num", "num_dm_hits", "file")


class IndexCorrupt(RuntimeError):
    """The index db failed an integrity check — rebuild it (the
    source of truth is the outdirs; nothing is lost)."""


def index_path(spool: str) -> str:
    """The conventional index location next to a spool/queue root."""
    return os.path.join(spool, "candidates.db")


def candidate_rows(outdir: str) -> list[dict]:
    """Every sifted candidate in a results dir, as JSON-able rows
    (empty when the beam produced no candidate list — a clean skip,
    or a failed beam)."""
    from tpulsar_torch.io import accelcands
    rows: list[dict] = []
    for path in sorted(glob.glob(os.path.join(outdir,
                                              "*.accelcands"))):
        try:
            cands = accelcands.parse_candlist(path)
        except OSError:
            continue
        for i, c in enumerate(cands, start=1):
            row = {k: (float(v) if isinstance(v, float) else v)
                   for k, v in dataclasses.asdict(c).items()
                   if k != "dm_hits"}
            row["num"] = i
            row["num_dm_hits"] = len(c.dm_hits)
            row["file"] = os.path.basename(path)
            rows.append(row)
    return rows


def _fire(op: str) -> None:
    faults.fire("dataplane.io", make_exc=faults.io_error, detail=op)


class CandidateIndex:
    """One candidates.db.  Thread-safe; cheap to construct."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()

    # ------------------------------------------------------ connections

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            return conn
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        conn = sqlite3.connect(self.path, timeout=_BUSY_TIMEOUT_S,
                               isolation_level=None)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=FULL")
        conn.execute(f"PRAGMA busy_timeout="
                     f"{int(_BUSY_TIMEOUT_S * 1000)}")
        conn.executescript(_SCHEMA)
        row = conn.execute(
            "SELECT value FROM meta WHERE key='schema'").fetchone()
        if row is None:
            conn.execute(
                "INSERT OR IGNORE INTO meta (key, value) "
                "VALUES ('schema', ?)", (str(SCHEMA_VERSION),))
        elif int(row["value"]) != SCHEMA_VERSION:
            conn.close()
            raise IndexCorrupt(
                f"{self.path}: schema v{row['value']} != "
                f"v{SCHEMA_VERSION} (rebuild the index)")
        self._local.conn = conn
        return conn

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _write(self, fn, op: str):
        """BEGIN IMMEDIATE ... COMMIT as a unit, retried on busy."""
        conn = self._conn()
        last: Exception | None = None
        for attempt in range(_WRITE_RETRIES):
            _fire(op)
            try:
                conn.execute("BEGIN IMMEDIATE")
            except sqlite3.OperationalError as e:
                last = e
                time.sleep(0.02 * (attempt + 1))
                continue
            try:
                out = fn(conn)
                conn.execute("COMMIT")
                return out
            except sqlite3.DatabaseError as e:
                try:
                    conn.execute("ROLLBACK")
                except sqlite3.Error:
                    pass
                if isinstance(e, sqlite3.OperationalError) and \
                        "locked" in str(e).lower():
                    last = e
                    time.sleep(0.02 * (attempt + 1))
                    continue
                raise _shape(e, self.path)
            except BaseException:
                try:
                    conn.execute("ROLLBACK")
                except sqlite3.Error:
                    pass
                raise
        raise _shape(last or sqlite3.OperationalError("busy"),
                     self.path)

    # ------------------------------------------------------------ write

    def index_result(self, ticket: str, rows: list[dict],
                     artifacts: dict | None = None,
                     outdir: str = "") -> int:
        """Index one finished ticket's sifted candidate rows (the
        ``_candidate_rows`` shape) plus its artifact digest map, as
        ONE transaction — idempotent per ticket, so the worker's
        retried result write re-indexes the same rows, not twice."""

        def txn(conn: sqlite3.Connection) -> int:
            _fire("index")
            conn.execute("DELETE FROM candidates WHERE ticket=?",
                         (ticket,))
            for row in rows:
                conn.execute(
                    "INSERT INTO candidates (ticket, "
                    + ", ".join(_CAND_COLS) + ") VALUES (?"
                    + ", ?" * len(_CAND_COLS) + ")",
                    (ticket, *(row[c] for c in _CAND_COLS)))
            conn.execute(
                "INSERT OR REPLACE INTO results "
                "(ticket, outdir, indexed_at, ncands, artifacts) "
                "VALUES (?, ?, ?, ?, ?)",
                (ticket, outdir, time.time(), len(rows),
                 json.dumps(artifacts or {}, sort_keys=True)))
            return len(rows)

        return self._write(txn, "index")

    def index_outdir(self, ticket: str, outdir: str,
                     artifacts: dict | None = None) -> int:
        """Parse an outdir's ``*.accelcands`` (the legacy path) and
        index what it holds — the worker-side call and the rebuild
        primitive share this so their rows cannot drift."""
        return self.index_result(ticket, candidate_rows(outdir),
                                 artifacts, outdir)

    def rebuild(self, queue) -> dict:
        """Re-derive the whole index from the outdir parse (the
        ``--rebuild`` path: the outdirs are the source of truth, the
        index only a cache of them)."""
        tickets = list(queue.list_tickets("done"))
        indexed = rows = 0
        for tid in tickets:
            rec = queue.read_result(tid)
            if rec is None or rec.get("status") != "done":
                continue
            outdir = rec.get("outdir", "")
            if not outdir or not os.path.isdir(outdir):
                continue
            rows += self.index_outdir(tid, outdir,
                                      rec.get("artifacts") or {})
            indexed += 1
        return {"tickets": indexed, "rows": rows}

    # ------------------------------------------------------------- read

    def query(self, ticket: str | None = None,
              min_sigma: float = 0.0, limit: int = 200) -> dict:
        """The indexed ``/v1/candidates`` answer, shaped exactly like
        ``results.query_candidates`` (total counts matches BEFORE the
        cut; ``truncated`` is explicit).  ValueError on limit <= 0 —
        the gateway turns that into a 400, never a silent clamp."""
        if limit <= 0:
            raise ValueError(f"limit must be positive (got {limit})")
        _fire("query")
        conn = self._conn()
        where = "WHERE sigma >= ?"
        params: list = [min_sigma]
        if ticket is not None:
            where += " AND ticket = ?"
            params.append(ticket)
        try:
            total = conn.execute(
                f"SELECT COUNT(*) AS n FROM candidates {where}",
                params).fetchone()["n"]
            cur = conn.execute(
                "SELECT ticket, " + ", ".join(_CAND_COLS)
                + f" FROM candidates {where} "
                "ORDER BY sigma DESC, ticket, file, num LIMIT ?",
                [*params, limit])
            rows = [dict(r) for r in cur.fetchall()]
            searched = conn.execute(
                "SELECT COUNT(*) AS n FROM results"
                + (" WHERE ticket = ?" if ticket is not None else ""),
                ([ticket] if ticket is not None else [])
            ).fetchone()["n"]
        except sqlite3.DatabaseError as e:
            raise _shape(e, self.path)
        return {"total": total, "returned": len(rows),
                "truncated": total > len(rows),
                "tickets_searched": searched,
                "min_sigma": min_sigma, "source": "index",
                "candidates": rows}

    def tickets(self) -> list[str]:
        """Every indexed ticket id (the invariants' sweep list)."""
        _fire("tickets")
        cur = self._conn().execute(
            "SELECT ticket FROM results ORDER BY ticket")
        return [r["ticket"] for r in cur.fetchall()]

    def result_row(self, ticket: str) -> dict | None:
        """One ticket's index entry: outdir, ncands, artifacts map."""
        _fire("result_row")
        r = self._conn().execute(
            "SELECT * FROM results WHERE ticket=?",
            (ticket,)).fetchone()
        if r is None:
            return None
        out = dict(r)
        out["artifacts"] = json.loads(out.get("artifacts") or "{}")
        return out

    def candidate_rows(self, ticket: str) -> list[dict]:
        """One ticket's rows in the legacy parse's shape/order (file
        then num) WITHOUT the ticket key — directly comparable to
        ``candidate_rows(outdir)``."""
        _fire("rows")
        cur = self._conn().execute(
            "SELECT " + ", ".join(_CAND_COLS)
            + " FROM candidates WHERE ticket=? ORDER BY file, num",
            (ticket,))
        return [dict(r) for r in cur.fetchall()]

    def fsck(self) -> dict:
        """Integrity check + WAL checkpoint; IndexCorrupt on damage."""
        conn = self._conn()
        try:
            row = conn.execute("PRAGMA integrity_check").fetchone()
            if row[0] != "ok":
                raise IndexCorrupt(f"{self.path}: {row[0]}")
            conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            nres = conn.execute(
                "SELECT COUNT(*) AS n FROM results").fetchone()["n"]
            ncand = conn.execute(
                "SELECT COUNT(*) AS n FROM candidates").fetchone()["n"]
        except sqlite3.DatabaseError as e:
            raise IndexCorrupt(f"{self.path}: {e}")
        return {"ok": True, "results": nres, "candidates": ncand}


def _shape(e: Exception, path: str) -> OSError:
    """Disk-shaped error for callers: the index is infrastructure —
    its failures look like failing I/O, and the result transition the
    write rides on decides whether to tolerate that."""
    import errno
    return OSError(errno.EIO, f"candidate index {path}: {e}")
