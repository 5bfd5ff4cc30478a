"""Results database — counterpart of tpulsar/orchestrate/results_db.py
(a copy: the same schema, so either package's uploader writes, and
either package reads, one results DB).  It replaces the reference's
MSSQL "common DB" (lib/python/database.py).

The reference talks to site-hosted stored procedures (spHeaderLoader,
spPDMCandUploaderFindsVersion, spDiagnosticAdder, ...) over ODBC with
a deadlock-retry taxonomy.  This module ships its own schema (SQLite;
the Database class isolates SQL so a Postgres backend can slot in)
and exposes the same call shapes: insert procedures that return ids,
explicit transactions, and typed Deadlock/Connection errors the
uploader maps to retry-later (JobUploader.py:167-174).
"""

from __future__ import annotations

import os
import sqlite3
from typing import Any

from tpulsar_torch.obs import debugflags

SCHEMA = """
CREATE TABLE IF NOT EXISTS headers (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    obs_name TEXT, beam_id INTEGER, original_file TEXT,
    source_name TEXT, ra_deg REAL, dec_deg REAL,
    gal_l REAL, gal_b REAL,
    obstime_s REAL, timestamp_mjd REAL,
    center_freq_mhz REAL, bw_mhz REAL, num_channels INTEGER,
    sample_time_us REAL, project_id TEXT, observers TEXT,
    file_size INTEGER, data_size INTEGER, num_samples INTEGER,
    telescope TEXT, backend TEXT,
    version_number TEXT, uploaded_at TEXT
);
CREATE TABLE IF NOT EXISTS pdm_candidates (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    header_id INTEGER NOT NULL REFERENCES headers(id),
    cand_num INTEGER, period_s REAL, freq_hz REAL, pdot REAL,
    dm REAL, snr REAL, sigma REAL, numharm INTEGER,
    fourier_bin REAL, z REAL, num_dm_hits INTEGER,
    reduced_chi2 REAL, uploaded_at TEXT
);
CREATE TABLE IF NOT EXISTS pdm_plots (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    cand_id INTEGER NOT NULL REFERENCES pdm_candidates(id),
    plot_type TEXT, filename TEXT, blob BLOB
);
CREATE TABLE IF NOT EXISTS sp_candidates (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    header_id INTEGER NOT NULL REFERENCES headers(id),
    dm REAL, sigma REAL, time_s REAL, sample INTEGER,
    downfact INTEGER, uploaded_at TEXT
);
CREATE TABLE IF NOT EXISTS sp_files (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    header_id INTEGER NOT NULL REFERENCES headers(id),
    file_type TEXT, filename TEXT, blob BLOB
);
CREATE TABLE IF NOT EXISTS diagnostics (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    header_id INTEGER NOT NULL REFERENCES headers(id),
    name TEXT, type TEXT, value REAL, filename TEXT, blob BLOB,
    uploaded_at TEXT
);
"""


class ResultsDBError(Exception):
    pass


class DatabaseConnectionError(ResultsDBError):
    """Transient connection problem: retry later without failing the
    job (reference upload.UploadNonFatalError semantics)."""


class DatabaseDeadlockError(ResultsDBError):
    """Writer contention: roll back and retry later (reference
    database.py:92-93)."""


class ResultsDB:
    """Connection wrapper with explicit transactions (autocommit off,
    like the uploader's single-transaction contract,
    JobUploader.py:93)."""

    def __init__(self, url: str | None = None):
        if url is None:
            from tpulsar_torch.config import settings
            url = settings().resultsdb.url
        self.url = url
        os.makedirs(os.path.dirname(os.path.abspath(url)), exist_ok=True)
        try:
            self.conn = sqlite3.connect(url, timeout=10.0,
                                        isolation_level="DEFERRED")
        except sqlite3.OperationalError as e:
            raise DatabaseConnectionError(str(e))
        self.conn.row_factory = sqlite3.Row
        self.conn.executescript(SCHEMA)
        self.conn.commit()

    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        if debugflags.is_on("resultsdb"):
            print(f"resultsdb: {sql} {params}")
        try:
            return self.conn.execute(sql, params)
        except sqlite3.OperationalError as e:
            msg = str(e)
            if "locked" in msg or "busy" in msg:
                raise DatabaseDeadlockError(msg)
            raise ResultsDBError(msg)

    def insert(self, table: str, **cols: Any) -> int:
        names = ",".join(cols)
        ph = ",".join("?" for _ in cols)
        cur = self.execute(
            f"INSERT INTO {table} ({names}) VALUES ({ph})",
            tuple(cols.values()))
        return cur.lastrowid

    def fetchone(self, sql: str, params: tuple = ()):
        return self.execute(sql, params).fetchone()

    def commit(self) -> None:
        self.conn.commit()

    def rollback(self) -> None:
        self.conn.rollback()

    def close(self) -> None:
        self.conn.close()
