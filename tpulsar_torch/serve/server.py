"""The resident search server — counterpart of tpulsar/serve/server.py.

One long-lived, device-owning process replaces the fork-per-beam
model: it builds or loads its libraries through the AOT gate
(aot/warmstart.py::warm_boot: verify first, compile on a miss),
prepares the device and (optionally) searches one synthesized block
at boot, then
loops over the spool admission queue (serve/protocol.py).  Every beam
after boot reuses the process's kernel library, template banks, FFT
plans and device allocator: process start, kernel build and device
set-up are paid once per boot, not once per beam.

Properties the batch path cannot offer:

  * admission queue with bounded depth — the JAX package's ``warm``
    queue backend refuses tickets past ``max_queue_depth`` (spool
    backpressure, not an unbounded directory);
  * stage-in prefetch — serve/stagein.py overlaps host-side staging
    of beam N+1 with device compute of beam N;
  * per-beam deadlines — resilience.policy.run_with_deadline converts
    a hung dispatch into a failed ticket instead of a wedged server;
  * crash isolation — a poisoned beam (fault point ``serve.beam``, or
    a kernel that fails to build or launch) marks THAT ticket failed
    and the loop continues; no beam ever moves to the plain CPU path;
  * graceful drain — SIGTERM finishes the in-flight beam, joins the
    stage-in prefetch thread, requeues every claimed-but-unstarted
    ticket this worker holds via the attempt-neutral
    ``requeue_own_claims``, and stamps the heartbeat ``stopped``;
  * fleet membership — with a ``worker_id`` the heartbeat goes to
    ``server.<worker_id>.json`` and every claim/result is stamped
    with the worker, so N servers (of either package) share one spool
    safely.  Fault point ``fleet.worker`` simulates a worker CRASH
    (hard process exit mid-beam, no drain).

  * batched admission — with ``batch_size`` N > 1 (``serve --batch
    N``) the stage-in thread claims up to N compatible tickets, lingers
    ``batch_linger_s`` to fill a partial batch, and the batch is
    searched as coalesced groups (executor.search_beam_batch); a beam
    that cannot ride the batch falls out to the solo path, never
    failing its batchmates.

Per-beam results are produced by the same ``cli.search_job``
library functions the per-beam job runs, so the output directory
layout is identical.

Stream mode (``stream=True``, ``serve --stream``): the loop claims
``kind: "stream"`` session tickets instead of beams and runs each
through the streaming plane (stream/worker.py) on the server's
device, and boot warms one stream emission at STREAM_PROFILE instead
of the beam search.

The data plane: a ticket's ``blobs`` refs are staged by digest
(serve/stagein.py), and a finished beam's ``*.accelcands`` are pushed
into the CAS — the gateway's at ``TPULSAR_DATA_URL``, else a local
store at ``TPULSAR_BLOB_ROOT`` — and indexed with their digests
before its result record is written (``_publish_result``).
"""

from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np
import torch

# Module import (not name import): frontdoor.queue itself imports
# serve.protocol, so pulling a name out of it here would trip the
# circular-import guard when queue.py is the first module loaded.
from tpulsar_torch import resolve_device
from tpulsar_torch.aot import warmstart
from tpulsar_torch.cli import search_job
from tpulsar_torch.dataplane import blobstore, transfer
from tpulsar_torch.dataplane import index as dp_index
from tpulsar_torch.frontdoor import queue as frontdoor_queue
from tpulsar_torch.frontdoor.tenancy import TenantPolicy
from tpulsar_torch.kernels import accel as accel_k
from tpulsar_torch.kernels import cuda_dd
from tpulsar_torch.obs import fleetview, health, journal, telemetry
from tpulsar_torch.obs.log import get_logger
from tpulsar_torch.plan import ddplan
from tpulsar_torch.resilience import faults, policy
from tpulsar_torch.search import executor
from tpulsar_torch.serve import protocol
from tpulsar_torch.serve.stagein import (BatchStageInPipeline,
                                         PreparedBatch, PreparedBeam,
                                         StageInPipeline)

#: the PALFA Mock beam the warm boot synthesizes a block of (the
#: geometry of the JAX package's AOT gate, aot/registry.py)
MOCK_NCHAN = 960
MOCK_TSAMP = 65.476e-6
MOCK_NSAMP = 3_932_160
MOCK_FCTR, MOCK_BW = 1375.5, 322.617
#: the warm block's samples are a multiple of this, so every
#: downsample of the Mock plan divides them
NSAMP_QUANTUM = 30720


class SearchServer:
    def __init__(self, spool: str | None = None, cfg=None, *,
                 queue_url: str = "",
                 worker_id: str = "",
                 worker_class: str = "",
                 max_queue_depth: int = 8,
                 beam_deadline_s: float = 0.0,
                 ticket_max_attempts: int = protocol.DEFAULT_MAX_ATTEMPTS,
                 warm_boot: bool = True,
                 warm_boot_scale: float = 0.05,
                 prefetch_depth: int = 1,
                 poll_s: float = 0.5,
                 heartbeat_interval_s: float = 10.0,
                 claim_policy=None,
                 batch_size: int = 1,
                 batch_linger_s: float = 2.0,
                 stream: bool = False,
                 beam_fn=None, batch_fn=None, logger=None, device=None):
        #: where every beam runs: the GPU unless the caller asks for
        #: the CPU (refused here, before anything is claimed, when
        #: there is no GPU)
        self.device = resolve_device(device)
        if cfg is None:
            from tpulsar_torch.config import settings
            cfg = settings()
        if claim_policy is None:
            # tenant priority classes + in-flight quotas enforced at
            # the claim (frontdoor/tenancy.py): with no tenants
            # configured this degrades to FIFO, so it is always on
            claim_policy = TenantPolicy.from_config(cfg)
        self.claim_policy = claim_policy
        self.cfg = cfg
        self.spool = spool or protocol.default_spool_dir(cfg)
        #: the ticket backend (``serve --queue spool:<dir>``,
        #: ``memory:`` or ``sqlite:<db>``): claims, results,
        #: heartbeats, and requeues all route through it; the spool
        #: stays the worker's scratch/log/metrics-snapshot root
        self.queue = frontdoor_queue.get_ticket_queue(
            queue_url or f"spool:{self.spool}")
        #: journal root (== spool for the spool backend and a
        #: queue.db inside the spool directory)
        self.jroot = self.queue.journal_root or self.spool
        self.worker_id = worker_id
        #: "spot" workers advertise that an autoscaler SIGKILL is
        #: routine for them: the class rides the heartbeat, every
        #: claim, and every result — no behavioural difference inside
        #: the worker itself (checkpoint resume + the scale-down
        #: ledger's attempt-neutral requeue carry the semantics)
        self.worker_class = worker_class
        self.max_queue_depth = max_queue_depth
        self.ticket_max_attempts = ticket_max_attempts
        self.beam_deadline_s = beam_deadline_s
        self.warm_boot = warm_boot
        self.warm_boot_scale = warm_boot_scale
        self.poll_s = poll_s
        self.heartbeat_interval_s = heartbeat_interval_s
        #: injectable for tests: callable(PreparedBeam) ->
        #: SearchOutcome | None (None = clean skip)
        self.beam_fn = beam_fn or self._search_one
        #: seconds the last boot() took (kernel build and load, device
        #: set-up, warm search)
        self.boot_seconds = 0.0
        self.log = logger or get_logger(
            f"serve.{worker_id}" if worker_id else "serve")
        #: injectable for tests: the fleet.worker fault's hard process
        #: exit (a crash leaves claims in place — no drain, no result)
        self._crash = os._exit
        #: batched admission (``serve --batch N``): claim up to N
        #: compatible tickets per ordering pass and dispatch them as
        #: one batch through executor.search_beam_batch — a per-beam
        #: error, resume state, or a lying compat stamp degrades THAT
        #: beam to the solo path, never its batchmates.  batch_fn is
        #: injectable for tests: callable(list[PreparedBeam]) ->
        #: list[(status, payload, path)]
        self.batch_size = max(1, int(batch_size))
        self.batch_fn = batch_fn or self._search_batch
        if self.batch_size > 1:
            self.pipeline = BatchStageInPipeline(
                claim_batch=lambda n, compat: self.queue.claim_batch(
                    n, self.worker_id,
                    policy=self.claim_policy,
                    worker_class=self.worker_class, compat=compat),
                workdir_base=cfg.processing.base_working_directory,
                cfg=cfg, batch=self.batch_size,
                linger_s=batch_linger_s, depth=prefetch_depth,
                poll_s=poll_s, logger=self.log,
                journal=self._journal)
        else:
            self.pipeline = StageInPipeline(
                claim=lambda: self.queue.claim_next(
                    self.worker_id,
                    policy=self.claim_policy,
                    worker_class=self.worker_class),
                workdir_base=cfg.processing.base_working_directory,
                cfg=cfg, depth=prefetch_depth, poll_s=poll_s,
                logger=self.log, journal=self._journal)
        #: stream mode (``serve --stream``): the loop claims stream
        #: session tickets instead of beams and runs them through the
        #: streaming plane (stream/worker.py) on self.device; boot has
        #: already built the kernels and run one emission
        self.stream = bool(stream)
        self._drain = threading.Event()
        self._stopped = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self._hb_last = 0.0
        self.beams = {"done": 0, "failed": 0, "skipped": 0}
        #: the flight recorder (obs/health.py): a bounded ring of
        #: this worker's recent moves, dumped to <spool>/blackbox/ on
        #: crash or abnormal exit — armed once serving starts,
        #: disarmed by a clean drain
        self.blackbox = health.FlightRecorder(
            worker_id, spool=self.spool)
        self.started_at = time.time()

    # ------------------------------------------------------------ control

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT request a graceful drain: finish the
        in-flight beam, requeue the rest, heartbeat ``stopped``."""
        def _on_term(signum, frame):
            self.log.info("signal %d: draining", signum)
            self.request_drain()

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_term)

    def request_drain(self) -> None:
        self._drain.set()

    @property
    def draining(self) -> bool:
        return self._drain.is_set()

    def _journal(self, event: str, ticket: dict, **extra) -> None:
        """This worker's journal hook (the stage-in pipeline calls it
        too): stamps worker id, attempt, and the ticket's trace id
        onto every event."""
        self.blackbox.note("journal", event=event,
                           ticket=ticket.get("ticket", "?"))
        journal.record(
            self.jroot, event, ticket=ticket.get("ticket", "?"),
            worker=self.worker_id,
            attempt=int(ticket.get("attempts", 0)),
            trace_id=ticket.get("trace_id", ""), **extra)

    # ------------------------------------------------------------ boot

    def boot(self) -> None:
        t0 = time.time()
        protocol.ensure_spool(self.spool)
        requeued = self.queue.requeue_stale_claims(
            self.ticket_max_attempts)
        if requeued:
            self.log.warning(
                "requeued %d ticket(s) a dead worker left claimed: %s",
                len(requeued), ", ".join(requeued))
        # the whole point of residency: one library build or load and
        # one device set-up for EVERY beam this process will search.
        # Verify-first: a restart over a warm build directory loads
        # the manifest's libraries (all hits); a miss rebuilds them.
        # The native library serves the reads (a stream reads none),
        # the CUDA kernels the card.
        only = tuple(name for name, used in (
            ("native", not self.stream),
            ("cuda_dd", self.device.type == "cuda")) if used)
        rc = warmstart.warm_boot(
            only=only, echo=lambda s: self.log.info("gate: %s", s)) \
            if only else 0
        if rc != 0:
            # a failed gate is a degraded boot, not a fatal one: beams
            # still run, building what they need at first use (visible
            # as compile_misses in every result record) or failing
            # loudly through crash isolation
            self.log.warning("warm-start gate rc %d — serving without "
                             "it", rc)
        elif self.device.type == "cuda":
            cuda_dd._prepare(self.device)
        if self.warm_boot:
            self.log.info("warm boot (%s) ...", "stream profile"
                          if self.stream else
                          f"scale {self.warm_boot_scale:g}")
            try:
                if self.stream:
                    self._warm_stream()
                else:
                    self._warm_search()
            except Exception:
                # a failed warm search is a degraded boot, not a fatal
                # one: beams still run (and fail loudly through crash
                # isolation if the device itself is broken)
                self.log.exception("warm boot search failed — serving "
                                   "without it")
        self.boot_seconds = time.time() - t0
        self.log.info("boot took %.2f s", self.boot_seconds)
        self._heartbeat("running", force=True)

    def _warm_search(self) -> None:
        """Search one synthesized block of the Mock geometry (960
        channels, ``warm_boot_scale`` of its samples, uint8 noise from
        a fixed seed) through search_block on the device, with this
        deployment's search parameters and the Mock survey plan: the
        template banks, FFT plans, kernel launch paths and the
        device allocator are warm before the first ticket."""
        nsamp = int(MOCK_NSAMP * self.warm_boot_scale)
        nsamp = max(NSAMP_QUANTUM, nsamp - nsamp % NSAMP_QUANTUM)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        block = torch.randint(0, 256, (MOCK_NCHAN, nsamp),
                              generator=gen, device=self.device,
                              dtype=torch.uint8)
        freqs = (MOCK_FCTR - MOCK_BW / 2) \
            + (np.arange(MOCK_NCHAN) + 0.5) * (MOCK_BW / MOCK_NCHAN)
        executor.search_block(
            block, freqs, MOCK_TSAMP, ddplan.survey_plan("pdev"),
            executor.SearchParams.from_config(self.cfg.searching),
            device=self.device)

    def _warm_stream(self) -> None:
        """One stream emission at STREAM_PROFILE on the device (one
        launch of the stage-2 kernel) and the search of the block it
        emits, from seeded noise: the kernel's launch path, the span
        search's ops and the device allocator are warm before the
        first session."""
        from tpulsar_torch.stream import STREAM_PROFILE
        from tpulsar_torch.stream.dedisp_state import (StreamDedisp,
                                                       geometry_freqs_dms)
        from tpulsar_torch.stream.trigger import search_span

        sd = StreamDedisp(STREAM_PROFILE, backend="torch",
                          device=self.device)
        rng = np.random.default_rng(0)
        blocks = []
        while not blocks:
            blocks = sd.append(rng.standard_normal(
                (sd.nchan, sd.chunk_len)).astype(np.float32))
        search_span(blocks[0], geometry_freqs_dms(STREAM_PROFILE)[1],
                    STREAM_PROFILE["dt"], backend="torch",
                    device=self.device)

    def _heartbeat(self, status: str, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._hb_last < self.heartbeat_interval_s:
            return
        depth = self.queue.pending_count()
        self.blackbox.note("heartbeat", status=status, depth=depth)
        telemetry.serve_queue_depth().set(depth)
        self.queue.heartbeat(
            worker_id=self.worker_id, status=status,
            queue_depth=depth, max_queue_depth=self.max_queue_depth,
            beams=dict(self.beams), started_at=self.started_at,
            # the hi stage's batch breaker pins the per-DM path for the
            # life of the process (slower beams until a restart)
            accel_batch_pinned=accel_k.batch_path_pinned(),
            **({"worker_class": self.worker_class}
               if self.worker_class else {}))
        # every heartbeat also drops this worker's registry snapshot
        # into the spool, so a fleet aggregator can merge ALL
        # workers' metrics without attaching to any process
        fleetview.export_worker_snapshot(self.spool, self.worker_id)
        self._hb_last = now

    def _heartbeat_loop(self) -> None:
        """Background freshness writer: a beam can hold the main
        thread for many minutes, and a heartbeat that goes stale
        mid-compute would make the warm backend abandon tickets a
        perfectly healthy server still owns."""
        while not self._stopped.wait(self.heartbeat_interval_s):
            try:
                self._heartbeat(
                    "draining" if self.draining else "running",
                    force=True)
            except OSError:
                pass            # a full disk must not kill the writer

    # ------------------------------------------------------------ serving

    def serve(self, once: bool = False) -> int:
        """The server loop.  once=True drains the spool's current
        contents and exits 0 (CI / cron mode); otherwise loops until
        a drain is requested."""
        # liveness BEFORE boot work: a cold-cache warm-start gate can
        # run for minutes, and without a fresh heartbeat through that
        # window the warm backend would abandon (fail) every ticket
        # already queued for this perfectly healthy, booting server
        protocol.ensure_spool(self.spool)
        self._heartbeat("running", force=True)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="serve-heartbeat",
            daemon=True)
        self._hb_thread.start()
        try:
            self.boot()
        except BaseException:
            # the kernel library did not build or load, or the device
            # refused its set-up: nothing is claimed, the heartbeat
            # says so, and the process exits non-zero
            self._stopped.set()
            self._heartbeat("stopped", force=True)
            raise
        self.blackbox.arm()
        if self.stream:
            return self._serve_stream(once)
        self.pipeline.start()
        try:
            while not self.draining:
                try:
                    self._heartbeat("running")
                except OSError:
                    # a failed heartbeat write (spool I/O fault) costs
                    # freshness, not the worker: the background loop
                    # retries within heartbeat_interval_s
                    pass
                prepared = self.pipeline.next(timeout=self.poll_s)
                if prepared is not None:
                    if isinstance(prepared, PreparedBatch):
                        self._process_batch(prepared)
                    else:
                        self._process(prepared)
                    continue
                if once and self.queue.pending_count() == 0 \
                        and self.queue.claimed_count() == 0:
                    break
        finally:
            self._shutdown()
        return 0

    def _serve_stream(self, once: bool) -> int:
        """The stream-mode loop: claim session tickets, run each to
        its terminal result through the streaming plane's
        exactly-once machinery (stream/worker.py) on the server's
        device.  A drain mid-session checkpoints the carry and
        requeues the claim — the next worker (of either package)
        resumes without reprocessing an acknowledged chunk."""
        from tpulsar_torch.stream import worker as stream_worker

        def beat(status: str = "running") -> None:
            try:
                self._heartbeat(status)
            except OSError:
                pass

        try:
            while not self.draining:
                beat()
                try:
                    rec = self.queue.claim_next(
                        self.worker_id, policy=self.claim_policy,
                        worker_class=self.worker_class)
                except OSError:
                    time.sleep(self.poll_s)
                    continue
                if rec is None:
                    if once and self.queue.pending_count() == 0 \
                            and self.queue.claimed_count() == 0:
                        break
                    time.sleep(self.poll_s)
                    continue
                self.blackbox.note("claim",
                                   ticket=rec.get("ticket", "?"))
                if (rec.get("kind") or "") != "stream":
                    self.queue.write_result(
                        rec.get("ticket", "?"), "failed", rc=1,
                        error="a stream server claims only stream "
                              "tickets (serve without --stream for "
                              "beams)", worker=self.worker_id)
                    self.beams["skipped"] += 1
                    continue
                status = stream_worker.process_stream_ticket(
                    self.queue, rec, jroot=self.jroot,
                    worker_id=self.worker_id, backend="torch",
                    device=self.device, box=self.blackbox,
                    poll_s=min(self.poll_s, 0.05), beat=beat,
                    should_drain=lambda: self.draining)
                if status:
                    self.beams["done" if status == "done"
                               else "failed"] += 1
        finally:
            self._shutdown(pipeline=False)
        return 0

    def _shutdown(self, pipeline: bool = True) -> None:
        t0 = time.time()
        # a drain that reaches here is the clean exit path: the
        # atexit dump must not leave wreckage for a healthy shutdown
        self.blackbox.disarm()
        self._stopped.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        # join the prefetch thread FIRST: beams it already staged into
        # the handoff queue (and any it was mid-stage on) hold claims
        # this worker must give back — then requeue every claim this
        # pid still owns, attempt-neutral (a drain is not a crash; the
        # returned beams are not suspects).  Stream mode never started
        # the pipeline, but its session claims requeue the same way.
        leftovers = self.pipeline.stop() if pipeline else []
        try:
            requeued = self.queue.requeue_own_claims()
        except OSError as e:
            # a failing spool during drain: the claims stay put and
            # the janitor recovers them once this pid is gone — the
            # drain must still stamp its heartbeat and exit
            self.log.error("drain requeue failed (%s); leaving "
                           "claims for the janitor", e)
            requeued = []
        if requeued:
            self.log.info(
                "drain requeued %d unstarted ticket(s) (%d of them "
                "already staged): %s", len(requeued), len(leftovers),
                ", ".join(requeued))
        try:
            self._heartbeat("stopped", force=True)
        except OSError:
            pass
        dt = time.time() - t0
        telemetry.serve_drain_seconds().observe(dt)
        self.log.info(
            "server stopped after %.0f s: %d done, %d failed, "
            "%d skipped (drain took %.2f s)",
            time.time() - self.started_at, self.beams["done"],
            self.beams["failed"], self.beams["skipped"], dt)

    # ------------------------------------------------------------ one beam

    def _search_one(self, prepared: PreparedBeam):
        """The real beam runner: the same library calls the per-beam
        job makes, so results are layout-identical."""
        # deterministic poisoned-beam injection point: fires before
        # any device work, shaped like a runtime refusal
        faults.fire("serve.beam",
                    detail=f"ticket {prepared.ticket_id}")
        params = executor.SearchParams.from_config(self.cfg.searching)
        return search_job.run_search(
            prepared.ppfns, prepared.workdir,
            prepared.ticket["outdir"], params, prepared.zaplist,
            log=lambda msg: self.log.info("[%s] %s",
                                          prepared.ticket_id, msg),
            # checkpoint resume evidence rides the ticket journal,
            # stamped with this worker + attempt: a reclaimed beam's
            # 'resume'/'pass_complete' chain is auditable fleet-wide
            journal=lambda event, **extra: self._journal(
                event, prepared.ticket, **extra),
            device=self.device)

    def _process(self, prepared: PreparedBeam) -> None:
        tid = prepared.ticket_id
        outdir = prepared.ticket.get("outdir", "")
        t0 = time.time()
        # adopt the ticket's trace context: every span this thread
        # records while searching the beam carries the trace id
        # minted at submission, so a stolen beam's spans from two
        # workers stitch into one timeline
        telemetry.trace.set_trace_id(
            prepared.ticket.get("trace_id", ""))
        telemetry.trace.instant("serve_beam_start", ticket=tid)
        if faults.targets("fleet.worker"):
            try:
                faults.fire("fleet.worker",
                            detail=f"ticket {tid} worker "
                                   f"{self.worker_id or '-'}")
            except BaseException:
                # a worker CRASH, not a beam failure: hard exit with
                # the claim still in place and no result record —
                # exactly what a real mid-beam kill leaves behind for
                # requeue_stale_claims / the fleet janitor to recover
                self.log.error("fleet.worker fault: crashing on "
                               "ticket %s", tid)
                # os._exit skips atexit: dump the black box NOW —
                # this is the evidence trail the injected crash
                # exists to exercise
                self.blackbox.dump(
                    reason=f"fleet.worker fault on {tid}", rc=70)
                self._crash(70)
                return          # unreachable with the real os._exit
        att = int(prepared.ticket.get("attempts", 0))
        if prepared.error:
            self.log.error("ticket %s stage-in failed: %s", tid,
                           prepared.error.splitlines()[0]
                           if prepared.error else "?")
            self._finish(tid, "failed", t0, outdir,
                         error=prepared.error, attempts=att)
            return
        self._journal("search_start", prepared.ticket)
        misses0 = self._compile_misses_total()
        try:
            outcome = policy.run_with_deadline(
                lambda: self.beam_fn(prepared),
                self.beam_deadline_s, label=f"serve beam {tid}")
        except policy.DeadlineExceeded as e:
            # the abandoned runner thread still holds the device AND
            # the workdir — deliberately LEAK the scratch dir rather
            # than rmtree it under a live thread; the ticket is
            # answered now, the leak is bounded per deadline kill
            self.log.error(
                "ticket %s exceeded its %.0f s deadline; workdir %s "
                "left to the abandoned runner", tid,
                self.beam_deadline_s, prepared.workdir)
            self._finish(
                tid, "failed", t0, outdir, error=str(e), attempts=att,
                compile_misses=self._compile_misses_total() - misses0)
            return
        except Exception as e:
            # crash isolation: THIS ticket failed; the server (and
            # the device) live on
            import traceback
            self.log.exception("ticket %s failed", tid)
            prepared.cleanup()
            self._finish(
                tid, "failed", t0, outdir, attempts=att,
                error=f"{e}\n{traceback.format_exc()}"[:4000],
                compile_misses=self._compile_misses_total() - misses0)
            return
        prepared.cleanup()
        if outcome is None:                 # TooShort clean skip
            self._finish(tid, "skipped", t0, outdir, attempts=att)
        else:
            self._finish(tid, "done", t0, outdir, attempts=att,
                         compile_misses=outcome.compile_misses,
                         compile_hits=outcome.compile_hits,
                         candidates=len(outcome.candidates),
                         dm_trials=outcome.num_dm_trials)

    # ------------------------------------------------------------ one batch

    def _search_batch(self, beams: list[PreparedBeam]):
        """The real batch runner: search_job.run_search_batch over
        the staged members — same library layering as _search_one, so
        each beam's results directory is layout-identical whichever
        admission mode claimed it."""
        for prepared in beams:
            faults.fire("serve.beam",
                        detail=f"ticket {prepared.ticket_id}")
        params = executor.SearchParams.from_config(self.cfg.searching)
        jobs = []
        for prepared in beams:
            t = prepared.ticket
            jobs.append({
                "ppfns": prepared.ppfns, "workdir": prepared.workdir,
                "outdir": t["outdir"], "zap": prepared.zaplist,
                "label": prepared.ticket_id,
                "journal": (lambda event, _t=t, **extra:
                            self._journal(event, _t, **extra)),
            })
        return search_job.run_search_batch(
            jobs, params,
            log=lambda msg: self.log.info("[batch] %s", msg),
            device=self.device)

    def _process_batch(self, batch: PreparedBatch) -> None:
        t0 = time.time()
        if faults.targets("fleet.worker"):
            try:
                faults.fire(
                    "fleet.worker",
                    detail=f"batch {batch.ticket_ids} worker "
                           f"{self.worker_id or '-'}")
            except BaseException:
                # same crash footprint as the solo path: every
                # member's claim stays in place with no result — the
                # mid-batch kill the janitor must requeue per ticket
                self.log.error("fleet.worker fault: crashing on "
                               "batch %s", batch.ticket_ids)
                self.blackbox.dump(
                    reason=f"fleet.worker fault on batch "
                           f"{batch.ticket_ids}", rc=70)
                self._crash(70)
                return          # unreachable with the real os._exit
        ok: list[PreparedBeam] = []
        for prepared in batch.beams:
            att = int(prepared.ticket.get("attempts", 0))
            if prepared.error:
                # a poisoned input fails ITS ticket only — the rest
                # of the batch dispatches without it
                self.log.error(
                    "ticket %s stage-in failed: %s",
                    prepared.ticket_id,
                    prepared.error.splitlines()[0]
                    if prepared.error else "?")
                self._finish(prepared.ticket_id, "failed", t0,
                             prepared.ticket.get("outdir", ""),
                             error=prepared.error, attempts=att)
                continue
            ok.append(prepared)
        if not ok:
            return
        # the batch-dispatch evidence: ONE fleet-level journal event
        # naming the members (their own chains carry claim/result),
        # plus per-beam search_start so every chain stays well-formed
        journal.record(self.jroot, "batch_dispatch",
                       worker=self.worker_id, beams=len(ok),
                       tickets=[p.ticket_id for p in ok])
        telemetry.beam_batch_occupancy().set(len(ok))
        for prepared in ok:
            telemetry.trace.instant("serve_beam_start",
                                    ticket=prepared.ticket_id)
            self._journal("search_start", prepared.ticket)
        misses0 = self._compile_misses_total()
        try:
            # the per-beam deadline scales with the batch: B beams of
            # device work ride one dispatch stream
            results = policy.run_with_deadline(
                lambda: self.batch_fn(ok),
                self.beam_deadline_s * len(ok),
                label=f"serve batch x{len(ok)}")
        except policy.DeadlineExceeded as e:
            self.log.error(
                "batch of %d exceeded its %.0f s deadline; workdirs "
                "left to the abandoned runner", len(ok),
                self.beam_deadline_s * len(ok))
            d_miss = self._compile_misses_total() - misses0
            for prepared in ok:
                self._finish(
                    prepared.ticket_id, "failed", t0,
                    prepared.ticket.get("outdir", ""), error=str(e),
                    attempts=int(prepared.ticket.get("attempts", 0)),
                    compile_misses=d_miss)
            return
        except Exception as e:
            import traceback
            self.log.exception("batch of %d failed", len(ok))
            err = f"{e}\n{traceback.format_exc()}"[:4000]
            d_miss = self._compile_misses_total() - misses0
            for prepared in ok:
                prepared.cleanup()
                self._finish(
                    prepared.ticket_id, "failed", t0,
                    prepared.ticket.get("outdir", ""), error=err,
                    attempts=int(prepared.ticket.get("attempts", 0)),
                    compile_misses=d_miss)
            return
        for prepared, (status, payload, path) in zip(ok, results):
            prepared.cleanup()
            att = int(prepared.ticket.get("attempts", 0))
            outdir = prepared.ticket.get("outdir", "")
            if status == "failed":
                self._finish(prepared.ticket_id, "failed", t0, outdir,
                             error=str(payload)[:4000], attempts=att,
                             batch_path=path)
            elif status == "skipped":
                self._finish(prepared.ticket_id, "skipped", t0,
                             outdir, attempts=att, batch_path=path)
            else:
                self._finish(prepared.ticket_id, "done", t0, outdir,
                             attempts=att,
                             compile_misses=payload.compile_misses,
                             compile_hits=payload.compile_hits,
                             candidates=len(payload.candidates),
                             dm_trials=payload.num_dm_trials,
                             batch_path=path,
                             batch_beams=len(ok))

    @staticmethod
    def _compile_misses_total() -> int:
        """Process-cumulative library builds (the compile-cache miss
        tally, aot/warmstart.COMPILES): failure paths label their
        result records from the delta over the beam, since no
        SearchOutcome exists to carry it."""
        return warmstart.COMPILES["misses"]

    def _publish_result(self, tid: str, outdir: str) -> dict:
        """Data-plane publication for a finished beam: push the sifted
        ``*.accelcands`` artifacts into the CAS (HTTP to
        TPULSAR_DATA_URL, or a local TPULSAR_BLOB_ROOT store, pinned
        under the ticket id) and write the candidate index rows — so
        by the time the result record is observable, ``/v1/candidates``
        answers from the index and the bytes are fetchable by digest
        from any host.  Returns extras for the result record
        ({"artifacts": {name: sha256}} when anything was pushed).

        Publication failures degrade, never fail the beam: the search
        succeeded and the outdir holds the truth — the gateway falls
        back to the legacy parse, and the warning names what to
        re-push/reindex."""
        import glob as globmod

        extras: dict = {}
        paths = (sorted(globmod.glob(
            os.path.join(outdir, "*.accelcands")))
            if outdir and os.path.isdir(outdir) else [])
        url = os.environ.get("TPULSAR_DATA_URL", "")
        root = "" if url else os.environ.get("TPULSAR_BLOB_ROOT", "")
        artifacts: dict[str, str] = {}
        if paths and (url or root):
            try:
                for path in paths:
                    if url:
                        digest = transfer.put_file(url, path)
                    else:
                        store = blobstore.BlobStore(root)
                        digest = store.put_file(path)
                        store.add_ref(digest, tid)
                    artifacts[os.path.basename(path)] = digest
            except Exception as e:      # noqa: BLE001 — degrade loud
                self.log.warning(
                    "ticket %s: artifact push failed (%s) — results "
                    "stay on disk, re-push with `blob put`", tid, e)
                artifacts = {}
        if artifacts:
            extras["artifacts"] = artifacts
            self._journal("artifact_push", {"ticket": tid},
                          blobs=len(artifacts))
        try:
            dp_index.CandidateIndex(
                dp_index.index_path(self.jroot)).index_outdir(
                    tid, outdir, artifacts)
        except Exception as e:          # noqa: BLE001 — degrade loud
            self.log.warning(
                "ticket %s: candidate index write failed (%s) — the "
                "gateway will parse the outdir; `index rebuild` "
                "recovers", tid, e)
        return extras

    def _finish(self, tid: str, status: str, t0: float, outdir: str,
                error: str = "", **extra) -> None:
        dt = time.time() - t0
        if status == "done":
            # the data plane rides the SAME durable step as the
            # result: artifacts pushed + index rows written before the
            # record that makes them observable
            extra.update(self._publish_result(tid, outdir))
        # a beam is warm when it compiled nothing: the steady state
        # this subsystem exists to reach (failed beams are labelled
        # by their measured compile traffic too — a deadline kill
        # during a compile is a cold failure)
        warm = extra.get("compile_misses", 0) == 0
        # a TRANSIENT spool I/O failure (EIO burst, momentary ENOSPC)
        # must not cost a finished beam its result — retry briefly.
        # A PERSISTENT one must surface: the raise unwinds the serve
        # loop into _shutdown, the claim stays in place, and after
        # this worker dies the janitor reassigns the beam — degraded
        # but never lost, never double-recorded.
        for io_try in range(3):
            try:
                self.queue.write_result(
                    tid, status,
                    rc=0 if status in ("done", "skipped") else 1,
                    error=error, beam_seconds=dt, warm=warm,
                    outdir=outdir, worker=self.worker_id,
                    **({"worker_class": self.worker_class}
                       if self.worker_class else {}), **extra)
                break
            except OSError as e:
                if io_try == 2:
                    self.log.error(
                        "ticket %s: result write failed 3x (%s) — "
                        "leaving the claim for the janitor", tid, e)
                    # abnormal exit path: the unwind reaches
                    # _shutdown (which disarms), so the black box
                    # must dump here or not at all
                    self.blackbox.dump(
                        reason=f"result write failed for {tid}: {e}")
                    raise
                self.log.warning(
                    "ticket %s: result write failed (%s); retrying",
                    tid, e)
                time.sleep(0.05 * (io_try + 1))
        self.blackbox.note("result", ticket=tid, status=status,
                           seconds=round(dt, 3))
        self.beams[status] = self.beams.get(status, 0) + 1
        telemetry.serve_beams_total().inc(outcome=status)
        if status != "skipped":
            telemetry.serve_beam_seconds().observe(
                dt, mode="warm" if warm else "cold")
        telemetry.trace.set_trace_id("")     # the beam's context ends
        try:
            self._heartbeat("running", force=True)
        except OSError:
            pass      # the result IS durable; freshness catches up
        self.log.info("ticket %s -> %s in %.2f s (%s)", tid, status,
                      dt, "warm" if warm else "cold")
