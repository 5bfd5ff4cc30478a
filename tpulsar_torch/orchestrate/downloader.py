"""Data acquisition: restore requests, tracked downloads, verification,
retry/terminal-failure, and disk budgeting — counterpart of
tpulsar/orchestrate/downloader.py (a copy; its two transports live in
orchestrate/transports.py, re-exported here).

Capability parity with the reference's Downloader (lib/python/
Downloader.py): restore-request lifecycle with timeout (:204-238),
file entry creation from the remote listing (:241-306), bounded
concurrent downloads with a liveness sweep (:30-56, :310-349),
size-verification (:477-539), retry up to numretries then terminal
failure (:542-570), adaptive request sizing from the measured download
rate with the same allowed sizes ladder (:354-408), and disk-space
budgeting (:411-430).

The Cornell web service + FTPS stack is replaced by two pluggable
interfaces:
  RestoreService — request_restore(num, bits, type) -> guid;
                   location(guid) -> ready dir or None
  Transport      — list_files(dir), size(path), fetch(path, dst)
with hermetic local-directory implementations (the fixture backend the
reference lacked) and an HTTP implementation.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid

from tpulsar_torch.obs import telemetry
from tpulsar_torch.obs.log import get_logger
from tpulsar_torch.orchestrate.jobtracker import JobTracker, nowstr
from tpulsar_torch.orchestrate.transports import (  # noqa: F401
    HTTPTransport,
    LocalTransport,
)
from tpulsar_torch.resilience import faults
from tpulsar_torch.resilience.policy import RetryPolicy

ALLOWABLE_REQUEST_SIZES = [5, 10, 20, 50, 100, 200]   # Downloader.py:365


class HTTPRestoreService:
    """Restore service over plain HTTP GET endpoints, the successor of
    the reference's dynamic web-service client (CornellWebservice.py:
    6-29, which synthesized Restore/Location GET calls):

      GET {base}/restore?num=N&bits=B&type=T   -> guid (text/plain)
      GET {base}/location?guid=G               -> ready subdir, or 204/
                                                  empty body while the
                                                  restore is pending
    """

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _get(self, path: str) -> str:
        import urllib.request
        with urllib.request.urlopen(f"{self.base_url}/{path}",
                                    timeout=self.timeout_s) as resp:
            return resp.read().decode().strip()

    def request_restore(self, num_beams: int, bits: int,
                        file_type: str) -> str:
        from urllib.parse import quote
        guid = self._get(f"restore?num={num_beams}&bits={bits}"
                         f"&type={quote(file_type)}")
        if not guid:
            raise IOError("restore service returned no guid")
        return guid

    def location(self, guid: str) -> str | None:
        loc = self._get(f"location?guid={guid}")
        return loc or None


class LocalRestoreService:
    """Fixture restore service: a pool of beam files that get 'restored'
    into per-request directories after an optional delay (plays the
    role of the Cornell Restore/Location web service,
    CornellWebservice.py:9-29).

    State lives on the filesystem (.requests/ marker files + a pool
    cursor), so the service survives daemon restarts the way the real
    server-side service does — each CLI invocation may be a fresh
    process."""

    def __init__(self, transport_root: str, pool_dir: str = "pool",
                 delay_s: float = 0.0):
        self.root = transport_root
        self.pool_dir = pool_dir
        self.delay_s = delay_s
        self._state_dir = os.path.join(transport_root, ".requests")
        os.makedirs(self._state_dir, exist_ok=True)

    def request_restore(self, num_beams: int, bits: int,
                        file_type: str) -> str:
        guid = uuid.uuid4().hex[:16]
        with open(os.path.join(self._state_dir, guid), "w") as fh:
            fh.write(f"{time.time()} {num_beams}\n")
        return guid

    def _cursor(self) -> int:
        path = os.path.join(self._state_dir, "cursor")
        if os.path.exists(path):
            with open(path) as fh:
                return int(fh.read().strip() or 0)
        return 0

    def _set_cursor(self, value: int) -> None:
        with open(os.path.join(self._state_dir, "cursor"), "w") as fh:
            fh.write(str(value))

    def location(self, guid: str) -> str | None:
        """Returns the ready directory once restored, else None."""
        marker = os.path.join(self._state_dir, guid)
        if not os.path.exists(marker):
            return None
        with open(marker) as fh:
            t0_s, num_s = fh.read().split()
        if time.time() - float(t0_s) < self.delay_s:
            return None
        outdir = os.path.join(self.root, guid)
        if not os.path.isdir(outdir):
            os.makedirs(outdir, exist_ok=True)
            pool = sorted(os.listdir(os.path.join(self.root, self.pool_dir)))
            cursor = self._cursor()
            take = pool[cursor % max(1, len(pool)):][:int(num_s)] if pool else []
            for f in take:
                os.link(os.path.join(self.root, self.pool_dir, f),
                        os.path.join(outdir, f))
            self._set_cursor(cursor + int(num_s))
        return guid


# ------------------------------------------------------------- downloader

class Downloader:
    def __init__(self, tracker: JobTracker, restore_service, transport,
                 datadir: str, space_to_use: int = 60 * 2 ** 30,
                 min_free_space: int = 10 * 2 ** 30, numdownloads: int = 2,
                 numrestores: int = 5, numretries: int = 3,
                 request_timeout_hours: float = 6.0,
                 request_numbits: int = 4, request_datatype: str = "mock",
                 logger=None):
        self.t = tracker
        self.service = restore_service
        self.transport = transport
        self.datadir = datadir
        os.makedirs(datadir, exist_ok=True)
        self.space_to_use = space_to_use
        self.min_free_space = min_free_space
        self.numdownloads = numdownloads
        self.numrestores = numrestores
        self.numretries = numretries
        # the per-file attempt counter lives in the download_attempts
        # table, not a Python loop, so only the policy's BOUND is
        # consulted (should_retry) — stated through the shared
        # primitive so it is one knob with the other retry loops
        self.retry_policy = RetryPolicy(max_attempts=numretries)
        self.request_timeout_hours = request_timeout_hours
        self.request_numbits = request_numbits
        self.request_datatype = request_datatype
        self.log = logger or get_logger("downloader")
        self._threads: dict[int, threading.Thread] = {}
        self._rates: list[float] = []      # bytes/sec of finished downloads

    # ------------------------------------------------------------ main loop

    def run(self) -> None:
        """One daemon iteration (reference Downloader.py:141-157)."""
        self.check_download_attempts()
        self.check_active_requests()
        self.start_downloads()
        self.verify_files()
        self.recover_failed_downloads()
        if self.can_request_more():
            self.make_request()

    # ------------------------------------------------------------ requests

    def make_request(self) -> None:
        num = self.get_num_to_request()
        if num <= 0:
            return
        guid = self.service.request_restore(num, self.request_numbits,
                                            self.request_datatype)
        self.t.insert("requests", guid=guid, numrequested=num,
                      numbits=self.request_numbits,
                      file_type=self.request_datatype,
                      status="waiting", details="restore requested")
        self.log.info("restore request %s for %d beams", guid, num)

    def check_active_requests(self) -> None:
        for row in self.t.query(
                "SELECT * FROM requests WHERE status='waiting'"):
            age_h = _age_hours(row["created_at"])
            if age_h > self.request_timeout_hours:
                self.t.update("requests", row["id"], status="failed",
                              details=f"timed out after {age_h:.1f} h")
                continue
            loc = self.service.location(row["guid"])
            if loc is None:
                continue
            n = self.create_file_entries(row)
            if n:
                self.t.update("requests", row["id"], status="finished",
                              details=f"{n} files listed")
            else:
                # dedicated terminal state: the cooloff logic keys on
                # it (a free-text details match would silently break
                # when the message is reworded)
                self.t.update("requests", row["id"], status="empty",
                              details="restore came back empty")

    def create_file_entries(self, request_row) -> int:
        remote_files = self.transport.list_files(request_row["guid"])
        n = 0
        for rf in remote_files:
            local = os.path.join(self.datadir, os.path.basename(rf))
            # ANY tracked row is a duplicate — including terminal
            # failures (the reference's can_add_file semantics,
            # pipeline_utils.py:119-125): the downloader must not
            # re-request a file it already gave up on; re-adding after
            # a terminal failure is the operator's call (add-files).
            dup = self.t.query(
                "SELECT id FROM files WHERE remote_filename=? OR "
                "filename=?",
                [rf, local], fetchone=True)
            if dup:
                continue
            size = self.transport.size(rf)
            self.t.insert("files", request_id=request_row["id"],
                          remote_filename=rf, filename=local, size=size,
                          status="new", details="listed from restore")
            n += 1
        return n

    # ----------------------------------------------------------- downloads

    def start_downloads(self) -> None:
        active = sum(1 for th in self._threads.values() if th.is_alive())
        rows = self.t.query(
            "SELECT * FROM files WHERE status IN ('new','retrying') "
            "ORDER BY created_at")
        for row in rows:
            if active >= self.numdownloads:
                break
            if not self.can_download(row["size"] or 0):
                self.log.warning("disk budget exhausted; pausing downloads")
                break
            attempt_id = self.t.insert("download_attempts",
                                       file_id=row["id"],
                                       status="downloading",
                                       details="thread started")
            self.t.update("files", row["id"], status="downloading")
            th = threading.Thread(target=self._download, daemon=True,
                                  args=(row["id"], attempt_id,
                                        row["remote_filename"],
                                        row["filename"]))
            th.start()
            self._threads[attempt_id] = th
            active += 1

    def _download(self, file_id: int, attempt_id: int, remote: str,
                  local: str) -> None:
        t0 = time.time()
        try:
            # the injected failure takes the identical route as a real
            # transport error: failed -> retrying (< numretries) ->
            # terminal_failure, all recorded in download_attempts
            faults.fire("download.transfer", make_exc=IOError,
                        detail=remote)
            self.transport.fetch(remote, local)
        except Exception as e:
            telemetry.download_failures_total().inc(kind="transfer")
            self.t.execute(
                ["UPDATE download_attempts SET status=?, details=?, "
                 "updated_at=? WHERE id=?",
                 "UPDATE files SET status=?, details=?, updated_at=? "
                 "WHERE id=?"],
                [["download_failed", str(e)[:500], nowstr(), attempt_id],
                 ["failed", str(e)[:500], nowstr(), file_id]])
            return
        elapsed = max(time.time() - t0, 1e-3)
        if os.path.exists(local):
            nbytes = os.path.getsize(local)
            self._rates.append(nbytes / elapsed)
            telemetry.download_bytes_total().inc(nbytes)
        self.t.execute(
            ["UPDATE download_attempts SET status=?, details=?, "
             "updated_at=? WHERE id=?",
             "UPDATE files SET status=?, details=?, updated_at=? "
             "WHERE id=?"],
            [["complete", f"downloaded in {elapsed:.1f}s", nowstr(),
              attempt_id],
             ["unverified", "awaiting size verification", nowstr(),
              file_id]])

    def check_download_attempts(self) -> None:
        """Reconcile thread liveness with DB state — crash-orphaned
        attempts become 'unknown' (reference Downloader.py:30-56)."""
        rows = self.t.query(
            "SELECT id, file_id FROM download_attempts "
            "WHERE status='downloading'")
        for row in rows:
            th = self._threads.get(row["id"])
            if th is None or not th.is_alive():
                # thread is gone but DB still says downloading
                self.t.update("download_attempts", row["id"],
                              status="unknown",
                              details="no live thread for this attempt")
                self.t.update("files", row["file_id"], status="retrying",
                              details="orphaned download attempt")

    # -------------------------------------------------------- verification

    def verify_files(self) -> None:
        """Size-match verification (reference Downloader.py:477-539)."""
        for row in self.t.query(
                "SELECT * FROM files WHERE status='unverified'"):
            local = row["filename"]
            expected = row["size"]
            actual = os.path.getsize(local) if os.path.exists(local) else -1
            if expected is not None and actual == expected:
                self.t.update("files", row["id"], status="downloaded",
                              details="size verified")
            else:
                if os.path.exists(local):
                    os.remove(local)
                telemetry.download_failures_total().inc(kind="verify")
                self.t.update("files", row["id"], status="failed",
                              details=f"size mismatch: {actual} != {expected}")
                att = self.t.query(
                    "SELECT id FROM download_attempts WHERE file_id=? "
                    "ORDER BY id DESC", [row["id"]], fetchone=True)
                if att:
                    self.t.update("download_attempts", att["id"],
                                  status="verification_failed")

    def recover_failed_downloads(self) -> None:
        """failed -> retrying (< numretries) | terminal_failure
        (reference Downloader.py:542-570)."""
        for row in self.t.query(
                "SELECT id FROM files WHERE status='failed'"):
            attempts = self.t.query(
                "SELECT COUNT(*) c FROM download_attempts WHERE file_id=?",
                [row["id"]], fetchone=True)["c"]
            if self.retry_policy.should_retry(attempts):
                self.t.update("files", row["id"], status="retrying",
                              details=f"{attempts} failed attempts")
            else:
                self.t.update("files", row["id"], status="terminal_failure",
                              details=f"gave up after {attempts} attempts")

    # ------------------------------------------------------------- budgets

    def used_space(self) -> int:
        rows = self.t.query(
            "SELECT size FROM files WHERE status IN "
            "('downloading','unverified','downloaded','added')")
        return sum(r["size"] or 0 for r in rows)

    def can_download(self, next_size: int) -> bool:
        free = shutil.disk_usage(self.datadir).free
        if free - next_size < self.min_free_space:
            return False
        return self.used_space() + next_size <= self.space_to_use

    #: back off this long after a restore came back with nothing new
    #: (otherwise an exhausted archive makes every cycle fire another
    #: request that immediately fails again)
    EMPTY_RESTORE_COOLOFF_S = 600.0

    def can_request_more(self) -> bool:
        waiting = self.t.count("requests", "waiting")
        if waiting >= self.numrestores:
            return False
        last_empty = self.t.query(
            "SELECT updated_at FROM requests WHERE status='empty' "
            "ORDER BY id DESC",
            fetchone=True)
        if last_empty and _age_hours(
                last_empty["updated_at"]) * 3600.0 \
                < self.EMPTY_RESTORE_COOLOFF_S:
            return False
        pending = self.t.query(
            "SELECT COUNT(*) c FROM files WHERE status IN "
            "('new','downloading','unverified','retrying')",
            fetchone=True)["c"]
        return pending < self.numdownloads * 2

    def get_num_to_request(self) -> int:
        """Adaptive request sizing from the measured download rate
        (reference Downloader.py:354-408): aim to keep the pipe busy
        for one request-timeout window, snapped to the allowed ladder."""
        if not self._rates:
            return ALLOWABLE_REQUEST_SIZES[0]
        rate = sum(self._rates[-10:]) / len(self._rates[-10:])
        mean_size_row = self.t.query(
            "SELECT AVG(size) a FROM files WHERE size IS NOT NULL",
            fetchone=True)
        mean_size = mean_size_row["a"] or 2 * 2 ** 30
        window_s = self.request_timeout_hours * 3600 / 2
        ideal = int(rate * window_s / mean_size)
        for sz in reversed(ALLOWABLE_REQUEST_SIZES):
            if sz <= ideal:
                return sz
        return ALLOWABLE_REQUEST_SIZES[0]

    def wait_downloads(self) -> None:
        """Join the transfer threads this process started.  A one-shot
        iteration (``downloader --once``) calls it before the process
        exits: the threads are daemons, so without the join the
        interpreter's exit kills a transfer in flight and the next
        iteration finds it orphaned and starts it again — a file that
        takes longer to fetch than the process takes to exit never
        arrives.  (An addition of the port; the JAX CLI's --once does
        not wait.)"""
        for th in list(self._threads.values()):
            th.join()

    # -------------------------------------------------------------- status

    def status(self) -> dict:
        return {
            "requests_waiting": self.t.count("requests", "waiting"),
            "files_downloading": self.t.count("files", "downloading"),
            "files_downloaded": self.t.count("files", "downloaded"),
            "files_failed": self.t.count("files", "failed"),
            "files_terminal": self.t.count("files", "terminal_failure"),
            "used_space_bytes": self.used_space(),
        }


def _age_hours(created_at: str) -> float:
    t0 = time.mktime(time.strptime(created_at, "%Y-%m-%d %H:%M:%S"))
    return (time.time() - t0) / 3600.0
