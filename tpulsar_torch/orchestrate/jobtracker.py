"""Durable job-tracker database — counterpart of
tpulsar/orchestrate/jobtracker.py (a copy).

The backbone of the whole system (reference: lib/python/jobtracker.py
+ bin/create_database.py:14-63): all daemons coordinate exclusively
through these six tables, so any daemon can be killed and restarted at
any point and resume from DB state (SURVEY.md section 5.4).

Improvements over the reference while keeping its guarantees:
  * WAL journal mode + busy_timeout instead of an unbounded
    reconnect-retry loop with 1 s sleeps (jobtracker.py:33-68);
  * bounded, jittered retries on residual lock contention;
  * parameterized queries throughout;
  * the same states and transitions (SURVEY.md section 2.2).
"""

from __future__ import annotations

import os
import sqlite3
import time
from typing import Any, Iterable

from tpulsar_torch.obs import debugflags
from tpulsar_torch.resilience import policy as rpolicy

SCHEMA = """
CREATE TABLE IF NOT EXISTS requests (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    guid TEXT,
    size INTEGER,
    numbits INTEGER,
    numrequested INTEGER,
    file_type TEXT,
    status TEXT NOT NULL,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    details TEXT
);
CREATE TABLE IF NOT EXISTS files (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    request_id INTEGER,
    remote_filename TEXT,
    filename TEXT,
    size INTEGER,
    status TEXT NOT NULL,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    details TEXT
);
CREATE TABLE IF NOT EXISTS download_attempts (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    file_id INTEGER NOT NULL,
    status TEXT NOT NULL,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    details TEXT
);
CREATE TABLE IF NOT EXISTS jobs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    status TEXT NOT NULL,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    details TEXT
);
CREATE TABLE IF NOT EXISTS job_files (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    job_id INTEGER NOT NULL,
    file_id INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS job_submits (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    job_id INTEGER NOT NULL,
    queue_id TEXT,
    output_dir TEXT,
    base_output_dir TEXT,
    status TEXT NOT NULL,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    details TEXT
);
CREATE INDEX IF NOT EXISTS idx_files_status ON files(status);
CREATE INDEX IF NOT EXISTS idx_jobs_status ON jobs(status);
CREATE INDEX IF NOT EXISTS idx_submits_status ON job_submits(status);
CREATE INDEX IF NOT EXISTS idx_job_files_job ON job_files(job_id);
"""


def nowstr() -> str:
    """Timestamp format shared by every row (reference jobtracker.py:9)."""
    return time.strftime("%Y-%m-%d %H:%M:%S")


class JobTracker:
    """Serialized access to the tracker DB; every call is one
    transaction."""

    MAX_RETRIES = 20

    #: residual lock contention past the 40 s busy_timeout: bounded,
    #: jittered exponential backoff (0.05 s doubling, capped at 1 s)
    #: through the shared resilience primitive — same curve the
    #: hand-rolled loop implemented, now stated declaratively
    RETRY_POLICY = rpolicy.RetryPolicy(
        max_attempts=MAX_RETRIES, backoff_base_s=0.05,
        backoff_mult=2.0, backoff_max_s=1.0, jitter=True,
        retry_on=(sqlite3.OperationalError,),
        retryable=lambda e: "locked" in str(e) or "busy" in str(e))

    def __init__(self, db_path: str | None = None):
        if db_path is None:
            from tpulsar_torch.config import settings
            db_path = settings().background.jobtracker_db
        self.db_path = db_path
        d = os.path.dirname(os.path.abspath(db_path))
        os.makedirs(d, exist_ok=True)
        with self._connect() as conn:
            conn.executescript(SCHEMA)

    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.db_path, timeout=40.0)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA busy_timeout=40000")
        return conn

    def _with_retries(self, fn):
        # label: lock-contention retries become
        # tpulsar_retry_attempts_total{point="jobtracker.lock"} (and
        # the backoff sleeps the matching backoff-seconds counter) —
        # previously only visible as elapsed time
        return rpolicy.call(fn, self.RETRY_POLICY,
                            label="jobtracker.lock")

    # ------------------------------------------------------------- queries

    def query(self, sql: str, params: Iterable[Any] = (),
              fetchone: bool = False):
        if debugflags.is_on("jobtracker"):
            print(f"jobtracker: {sql} {list(params)}")

        def run():
            with self._connect() as conn:
                cur = conn.execute(sql, tuple(params))
                rows = cur.fetchall()
            return (rows[0] if rows else None) if fetchone else rows

        return self._with_retries(run)

    def execute(self, sql: str | list[str],
                params: Iterable[Any] | list[Iterable[Any]] = ()) -> int:
        """Execute one statement (or a list, atomically in one
        transaction).  Returns lastrowid of the final statement."""
        sqls = sql if isinstance(sql, list) else [sql]
        plist = params if isinstance(sql, list) else [params]
        if debugflags.is_on("jobtracker"):
            for s, p in zip(sqls, plist):
                print(f"jobtracker: {s} {list(p)}")

        def run():
            with self._connect() as conn:
                cur = None
                for s, p in zip(sqls, plist):
                    cur = conn.execute(s, tuple(p))
                conn.commit()
                return cur.lastrowid if cur else 0

        return self._with_retries(run)

    # -------------------------------------------------------- conveniences

    _TIMESTAMPED = {"requests", "files", "download_attempts", "jobs",
                    "job_submits"}

    def insert(self, table: str, **cols) -> int:
        if table in self._TIMESTAMPED:
            cols.setdefault("created_at", nowstr())
            cols.setdefault("updated_at", nowstr())
        names = ",".join(cols)
        ph = ",".join("?" for _ in cols)
        return self.execute(
            f"INSERT INTO {table} ({names}) VALUES ({ph})",
            list(cols.values()))

    def update(self, table: str, row_id: int, **cols) -> None:
        cols.setdefault("updated_at", nowstr())
        sets = ",".join(f"{k}=?" for k in cols)
        self.execute(f"UPDATE {table} SET {sets} WHERE id=?",
                     list(cols.values()) + [row_id])

    def count(self, table: str, status: str | None = None) -> int:
        if status is None:
            row = self.query(f"SELECT COUNT(*) c FROM {table}", fetchone=True)
        else:
            row = self.query(
                f"SELECT COUNT(*) c FROM {table} WHERE status=?",
                [status], fetchone=True)
        return row["c"]
