"""Host-side stage-in prefetch for the resident server — counterpart
of tpulsar/serve/stagein.py (PreparedBeam, prepare_beam,
StageInPipeline, and the batched admission of ``serve --batch N``:
PreparedBatch and BatchStageInPipeline).

The process-per-beam path pays stage-in (copy raw files to the
node-local workspace), Mock subband merge, and zaplist selection
serially before any device work.  In a resident worker those are pure
host/disk operations, so one background thread prepares beam N+1
while the device computes beam N — the handoff is a bounded queue
(depth 1 by default: prefetching further ahead only grows the scratch
footprint, the device can only consume one beam at a time).

The preparation itself is ``cli.search_job.prepare_inputs`` — the
same library function the batch path runs — so a beam staged by the
prefetch thread is byte-identical to one staged by a cold process.

A preparation failure (missing file, corrupt FITS, full disk) is
carried in ``PreparedBeam.error`` instead of raised: the server marks
that one job failed and keeps serving — a poisoned input must not
kill the worker.

Spool-less stage-in: a ticket may carry ``blobs`` (a
``{filename: sha256}`` map) instead of shared-disk paths — the worker
then pulls each file BY DIGEST from the data plane (the gateway CAS
at the ticket's ``data_url`` / the ``TPULSAR_DATA_URL`` knob, or a
local ``TPULSAR_BLOB_ROOT`` store), verified against its address on
arrival.  Every fetch passes the ``stagein.fetch`` fault point, and a
failed fetch is contained exactly like a missing shared-disk file:
one stagein_failed beam, a worker that keeps serving.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import threading
import time
import traceback
from typing import Callable

import numpy as np

from tpulsar_torch.obs import telemetry
from tpulsar_torch.obs.log import get_logger
from tpulsar_torch.resilience import faults


@dataclasses.dataclass
class PreparedBeam:
    """A ticket plus everything the device loop needs to search it."""
    ticket: dict
    workdir: str = ""
    ppfns: list[str] = dataclasses.field(default_factory=list)
    zaplist: np.ndarray | None = None
    error: str = ""              # non-empty: stage-in/preprocess failed
    stagein_seconds: float = 0.0

    @property
    def ticket_id(self) -> str:
        return self.ticket.get("ticket", "?")

    def cleanup(self) -> None:
        if self.workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)


def _stage_blobs(ticket: dict, workdir: str) -> list[str]:
    """Resolve a ticket's ``blobs`` refs ({filename: sha256}) into
    local files under ``workdir/stagein/`` and return their paths.

    Source resolution: the ticket's own ``data_url`` beats the
    ``TPULSAR_DATA_URL`` knob (HTTP fetch from the gateway CAS, digest
    re-verified on arrival); with neither set, a local blob store at
    ``TPULSAR_BLOB_ROOT`` serves the bytes directly.  No source at all
    is a configuration error — raised, so it lands on the contained
    stagein_failed path rather than half-staging a beam.

    Each fetch passes the ``stagein.fetch`` fault point: errno mode
    models a dead data plane (the fetch fails, the beam fails, the
    worker survives), delay mode a congested one."""
    from tpulsar_torch.dataplane import blobstore, transfer

    blobs = dict(ticket.get("blobs") or {})
    url = str(ticket.get("data_url", "")
              or os.environ.get("TPULSAR_DATA_URL", ""))
    root = "" if url else blobstore.default_blob_root("")
    if not url and not root:
        raise RuntimeError(
            "ticket carries blobs: refs but no data plane is "
            "configured (set TPULSAR_DATA_URL or TPULSAR_BLOB_ROOT)")
    dest_dir = os.path.join(workdir, "stagein")
    os.makedirs(dest_dir, exist_ok=True)
    store = blobstore.BlobStore(root) if root else None
    fetched: list[str] = []
    for fname, digest in sorted(blobs.items()):
        digest = blobstore.check_digest(str(digest))
        dest = os.path.join(dest_dir, os.path.basename(str(fname)))
        faults.fire("stagein.fetch", make_exc=faults.io_error,
                    detail=f"{os.path.basename(str(fname))} "
                           f"{digest[:12]}")
        t0 = time.time()
        if store is not None:
            store.fetch_to(digest, dest)
            nbytes = os.path.getsize(dest)
        else:
            nbytes = transfer.get_to_file(url, digest, dest)
        dt = time.time() - t0
        telemetry.dataplane_transfer_seconds().observe(dt, op="stagein")
        telemetry.dataplane_bytes_total().inc(float(nbytes),
                                              op="stagein")
        fetched.append(dest)
    return fetched


def prepare_beam(ticket: dict, workdir_base: str | None = None,
                 cfg=None) -> PreparedBeam:
    """Stage one ticket's beam into a fresh workspace (device-free:
    safe on a background thread while the device is busy)."""
    from tpulsar_torch.cli import search_job

    if cfg is None:
        from tpulsar_torch.config import settings
        cfg = settings()
    t0 = time.time()
    workdir = search_job.init_workspace(
        workdir_base or cfg.processing.base_working_directory)
    try:
        datafiles = ticket["datafiles"]
        if ticket.get("blobs"):
            # spool-less path: materialise by-digest refs first, then
            # stage the fetched local copies exactly like shared-disk
            # inputs — downstream never knows the difference
            datafiles = _stage_blobs(ticket, workdir)
        ppfns, zap = search_job.prepare_inputs(
            datafiles, workdir, cfg=cfg)
    except BaseException as e:
        shutil.rmtree(workdir, ignore_errors=True)
        return PreparedBeam(
            ticket=ticket,
            error=f"stage-in failed: {e}\n{traceback.format_exc()}"[:4000])
    dt = time.time() - t0
    telemetry.serve_stagein_seconds().observe(dt)
    return PreparedBeam(ticket=ticket, workdir=workdir, ppfns=ppfns,
                        zaplist=zap, stagein_seconds=dt)


@dataclasses.dataclass
class PreparedBatch:
    """A coalesced admission batch: up to N compatibility-claimed
    tickets staged concurrently, handed to the device loop as one
    unit.  Members keep full per-beam identity (ticket, workdir,
    error) — the batch is a dispatch grouping, never a merged job."""
    beams: list[PreparedBeam] = dataclasses.field(default_factory=list)

    @property
    def ticket_ids(self) -> list[str]:
        return [b.ticket_id for b in self.beams]


class BatchStageInPipeline:
    """Batched admission for ``serve --batch N``: one background
    thread claims up to N COMPATIBLE tickets in one tenant-policy
    ordering pass (protocol.claim_batch), lingers a bounded window to
    top up a partial batch (late-arriving compatible tickets join;
    a partial batch dispatches at the deadline instead of starving),
    stages every member CONCURRENTLY (stage-in is host/disk work —
    batchmates' copies overlap), and hands the whole batch through
    the same bounded queue contract as StageInPipeline.

    ``claim_batch`` is ``callable(n, compat) -> list[ticket]``: the
    server binds protocol.claim_batch with its spool/policy/worker
    identity; ``compat=None`` lets the first claim fix the batch key,
    a non-None value pins it for linger top-ups."""

    def __init__(self, claim_batch, workdir_base: str | None = None,
                 cfg=None, batch: int = 2, linger_s: float = 2.0,
                 depth: int = 1, poll_s: float = 0.5, logger=None,
                 journal: Callable | None = None):
        self.claim_batch = claim_batch
        self.workdir_base = workdir_base
        self.cfg = cfg
        self.batch = max(1, int(batch))
        self.linger_s = max(0.0, float(linger_s))
        self.poll_s = poll_s
        self.log = logger or get_logger("serve.stagein")
        self.journal = journal
        self._out: queue.Queue[PreparedBatch] = queue.Queue(
            maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._dropped: list[PreparedBeam] = []
        self._dropped_lock = threading.Lock()

    def start(self) -> "BatchStageInPipeline":
        self._thread = threading.Thread(
            target=self._run, name="serve-stagein-batch", daemon=True)
        self._thread.start()
        return self

    def _claim(self, n: int, compat) -> list[dict]:
        try:
            return self.claim_batch(n, compat)
        except Exception:
            self.log.exception("batch ticket claim failed")
            return []

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._claim(self.batch, None)
            if not batch:
                self._stop.wait(self.poll_s)
                continue
            # linger window: a partial batch waits a BOUNDED time for
            # compatible late arrivals, then dispatches partial — the
            # no-starvation half of the coalescing bargain
            deadline = time.time() + self.linger_s
            compat = str(batch[0].get("compat", "") or "")
            while len(batch) < self.batch and not self._stop.is_set():
                left = deadline - time.time()
                if left <= 0:
                    break
                more = self._claim(self.batch - len(batch), compat)
                if more:
                    batch.extend(more)
                    continue
                self._stop.wait(min(0.1, max(0.01, left)))
            prepared = self._stage_all(batch)
            while not self._stop.is_set():
                try:
                    self._out.put(prepared, timeout=0.25)
                    break
                except queue.Full:
                    continue
            else:
                for b in prepared.beams:
                    b.cleanup()
                with self._dropped_lock:
                    self._dropped.extend(prepared.beams)

    def _stage_one(self, ticket: dict) -> PreparedBeam:
        waited = time.time() - ticket.get("submitted_at", time.time())
        telemetry.serve_admission_wait_seconds().observe(
            max(0.0, waited))
        # each staging thread stamps its OWN beam's trace id on the
        # spans it records (thread-local context)
        telemetry.trace.set_trace_id(ticket.get("trace_id", ""))
        try:
            prepared = prepare_beam(ticket, self.workdir_base,
                                    self.cfg)
        finally:
            telemetry.trace.set_trace_id("")
        if self.journal is not None:
            if prepared.error:
                self.journal(
                    "stagein_failed", ticket,
                    error=prepared.error.splitlines()[0][:200])
            else:
                self.journal(
                    "stagein_done", ticket,
                    seconds=round(prepared.stagein_seconds, 3))
        return prepared

    def _stage_all(self, batch: list[dict]) -> PreparedBatch:
        if len(batch) == 1:
            return PreparedBatch(beams=[self._stage_one(batch[0])])
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(
                max_workers=len(batch),
                thread_name_prefix="serve-stagein-batch") as pool:
            beams = list(pool.map(self._stage_one, batch))
        return PreparedBatch(beams=beams)

    def next(self, timeout: float | None = None
             ) -> PreparedBatch | None:
        try:
            return self._out.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> list[PreparedBeam]:
        """Stop and join; returns every prepared-but-unconsumed beam
        (cleaned up; their claims stay in the spool for the caller's
        requeue_own_claims — same contract as StageInPipeline)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():
                self.log.warning("batch stage-in thread still "
                                 "running after stop(); abandoning "
                                 "it")
        leftovers: list[PreparedBeam] = []
        while True:
            try:
                b = self._out.get_nowait()
            except queue.Empty:
                break
            for beam in b.beams:
                beam.cleanup()
                leftovers.append(beam)
        with self._dropped_lock:
            leftovers.extend(self._dropped)
            self._dropped = []
        return leftovers


class StageInPipeline:
    """One background thread: claim tickets, prepare them, hand them
    over through a bounded queue.

    ``claim`` is any callable returning the next ticket record or
    None (the server passes protocol.claim_next_ticket on its spool).
    The bounded handoff queue is the backpressure: with depth 1 the
    thread stages at most one beam ahead of the device and then
    blocks, so scratch disk holds at most two staged beams."""

    def __init__(self, claim: Callable[[], dict | None],
                 workdir_base: str | None = None, cfg=None,
                 depth: int = 1, poll_s: float = 0.5, logger=None,
                 journal: Callable | None = None):
        self.claim = claim
        self.workdir_base = workdir_base
        self.cfg = cfg
        self.poll_s = poll_s
        self.log = logger or get_logger("serve.stagein")
        #: optional lifecycle hook ``journal(event, ticket_rec,
        #: **extra)`` — the server passes its journal writer so
        #: stage-in outcomes land in the spool's ticket journal
        self.journal = journal
        self._out: queue.Queue[PreparedBeam] = queue.Queue(
            maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # guarded by _dropped_lock: appended by the stage-in thread,
        # drained by stop() — which can overlap when the join times out
        self._dropped: list[PreparedBeam] = []
        self._dropped_lock = threading.Lock()

    # ----------------------------------------------------------- thread

    def start(self) -> "StageInPipeline":
        self._thread = threading.Thread(
            target=self._run, name="serve-stagein", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                ticket = self.claim()
            except Exception:
                self.log.exception("ticket claim failed")
                ticket = None
            if ticket is None:
                self._stop.wait(self.poll_s)
                continue
            waited = time.time() - ticket.get("submitted_at",
                                              time.time())
            telemetry.serve_admission_wait_seconds().observe(
                max(0.0, waited))
            # the prefetch thread stages beam N+1 while the main
            # thread searches beam N: each thread stamps its OWN
            # beam's trace id on the spans it records
            telemetry.trace.set_trace_id(ticket.get("trace_id", ""))
            try:
                prepared = prepare_beam(ticket, self.workdir_base,
                                        self.cfg)
            finally:
                telemetry.trace.set_trace_id("")
            if self.journal is not None:
                if prepared.error:
                    self.journal(
                        "stagein_failed", ticket,
                        error=prepared.error.splitlines()[0][:200])
                else:
                    self.journal(
                        "stagein_done", ticket,
                        seconds=round(prepared.stagein_seconds, 3))
            while not self._stop.is_set():
                try:
                    self._out.put(prepared, timeout=0.25)
                    break
                except queue.Full:
                    continue
            else:
                # stopping with an unconsumed beam: drop the scratch
                # dir; the still-claimed ticket is requeued by the
                # server's drain (requeue_own_claims)
                prepared.cleanup()
                with self._dropped_lock:
                    self._dropped.append(prepared)

    # ----------------------------------------------------------- caller

    def next(self, timeout: float | None = None) -> PreparedBeam | None:
        """The next prepared beam, or None on timeout."""
        try:
            return self._out.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> list[PreparedBeam]:
        """Stop and JOIN the thread, then return every prepared-but-
        unconsumed beam — both those waiting in the handoff queue and
        any the stopping thread had to drop (all already cleaned up;
        their tickets are still claimed in the spool for the caller
        to requeue).  When the join times out the list is best-effort
        — the abandoned thread may drop one more beam after we return
        — which is safe because the caller's requeue_own_claims
        rescans the spool rather than trusting this list."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if self._thread.is_alive():
                # a straggling stage-in (huge copy, slow disk): the
                # caller's requeue_own_claims still returns whatever
                # ticket it holds; log so the leak is attributable
                self.log.warning("stage-in thread still running "
                                 "after stop(); abandoning it")
        leftovers = []
        while True:
            try:
                b = self._out.get_nowait()
            except queue.Empty:
                break
            b.cleanup()
            leftovers.append(b)
        with self._dropped_lock:
            leftovers.extend(self._dropped)
            self._dropped = []
        return leftovers
