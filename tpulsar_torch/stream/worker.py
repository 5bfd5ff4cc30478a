"""The stream worker: session tickets through exactly-once machinery —
counterpart of tpulsar/stream/worker.py.

A stream-kind ticket names one ingest session (``session`` +
``stream_root`` extras).  The worker claims it through the ordinary
TicketQueue claim (exclusive, owner-stamped, janitor-healable),
processes chunk frames in seq order as they land, and writes the one
terminal result when the session drains.  Per chunk, the commit
order is:

    dedisperse -> search completed spans -> publish triggers
    (triggers.jsonl, idempotent by span) -> journal chunk_received
    -> checkpoint the carry state (ack = seq)

so a SIGKILL in ANY window is recoverable: the journal is the
acknowledgment of record (an exactly-once audit reads it), the
checkpoint is the resume point (a chunk
acknowledged there is never reprocessed), and the at-most-one chunk
between them is REPLAYED deterministically with both publications
deduplicated — counted, never re-acknowledged.

Gap semantics: a seq that never lands (a later seq landed and the
gap wait expired, or the session closed without it) is journaled as
``chunk_gap`` and zero-filled.  Zeros flow through dedispersion and
span search like any other samples — never spliced out, so sample
indices and span boundaries stay exact.

The carry checkpoint is the reference's npz (carry, emitted,
ack_next, sp_pend, sp_next_span) under the key ``stream_carry``,
written uncompressed (np.load reads either) to one of two files in
turn (see _checkpoint), so a session either package's worker
checkpointed resumes in the other's.

The entry point, ``python -m tpulsar_torch.stream.worker``, defaults
to ``--backend torch --device cuda``: the emissions go through the
CUDA stage-2 kernel and the span search runs on the card.  Without a
GPU it fails unless ``--device cpu`` is given.  (The reference's
worker defaults to its numpy backend, for its chaos harness.)
"""

from __future__ import annotations

import argparse
import io
import os
import signal
import sys
import time

import numpy as np

from tpulsar_torch import checkpoint as ckpt
from tpulsar_torch import resolve_device
from tpulsar_torch.obs import health, journal, telemetry
from tpulsar_torch.resilience import faults
from tpulsar_torch.serve import protocol
from tpulsar_torch.stream import ingest
from tpulsar_torch.stream.dedisp_state import StreamDedisp
from tpulsar_torch.stream.trigger import SpanTrigger, trigger_digest

#: how long to wait for a missing seq while later seqs exist, before
#: declaring a gap (pre-close; after close a hole is a gap instantly)
GAP_WAIT_S = 2.0


def _knob(raw: str, default: float) -> float:
    try:
        return float(raw or default)
    except ValueError:
        return default


def chunk_deadline_s() -> float:
    return _knob(os.environ.get("TPULSAR_STREAM_CHUNK_DEADLINE_S",
                                ""), 30.0)


def idle_timeout_s() -> float:
    return _knob(os.environ.get("TPULSAR_STREAM_IDLE_TIMEOUT_S", ""),
                 60.0)


def ring_chunks() -> int:
    return int(_knob(os.environ.get("TPULSAR_STREAM_RING_CHUNKS",
                                    ""), 4))


class SessionAborted(RuntimeError):
    """Unrecoverable per-session failure (idle timeout, bad state)."""


class StreamSession:
    """One claimed session ticket's processing state machine.

    Drives ingest -> dedispersion carry -> span triggers with the
    exactly-once commit order above.  ``step()`` advances by at most
    one chunk (so callers interleave heartbeats and drain checks);
    ``done`` flips when the terminal result may be written.
    """

    def __init__(self, rec: dict, *, jroot: str, worker_id: str,
                 backend: str = "torch", device=None, box=None):
        self.rec = rec
        self.tid = rec.get("ticket", "?")
        self.attempt = int(rec.get("attempts", 0))
        self.jroot = jroot
        self.wid = worker_id
        self.backend = backend
        self.device = resolve_device(device)
        self.box = box
        self.session = rec.get("session") or self.tid
        self.root = rec.get("stream_root") or ""
        if not self.root:
            raise SessionAborted("stream ticket names no stream_root")
        self.slo_s = float(rec.get("slo_s") or chunk_deadline_s())
        self.started = time.time()
        self.last_progress = self.started
        self.next_seq = 0
        self.acked: set[int] = set()
        self.gapped: set[int] = set()
        self.replayed = 0
        self.n_triggers = 0
        self.done = False
        self.result_extras: dict = {}
        self._gap_noticed: float | None = None
        self._dd: StreamDedisp | None = None
        self._trig: SpanTrigger | None = None
        self._ck = None
        self._man: dict | None = None
        self._published_spans: set[int] = set()
        self._journaled_spans: set[int] = set()

    # ------------------------------------------------------- plumbing
    def _jr(self, event: str, **extra) -> None:
        if self.box is not None:
            self.box.note("journal", event=event, ticket=self.tid)
        journal.record(self.jroot, event, ticket=self.tid,
                       worker=self.wid, attempt=self.attempt,
                       trace_id=self.rec.get("trace_id", ""), **extra)

    def _open_checkpoint(self, fingerprint: str):
        outdir = self.rec.get("outdir") or ""
        if not outdir:
            return None
        return ckpt.CheckpointStore(
            ckpt.default_root(outdir), fingerprint,
            journal=lambda event, **extra: journal.record(
                self.jroot, event, ticket=self.tid, worker=self.wid,
                **extra))

    # ----------------------------------------------------------- boot
    def _ensure_open(self) -> bool:
        """Wait for the session manifest; build state + resume.
        Returns False while the manifest has not landed yet."""
        if self._dd is not None:
            return True
        self._man = ingest.read_manifest(self.root, self.session)
        if self._man is None:
            if time.time() - self.started > idle_timeout_s():
                raise SessionAborted(
                    f"no manifest for session {self.session} within "
                    f"the idle timeout")
            return False
        geom = dict(self._man["geometry"])
        geom.setdefault("span_chunks", ring_chunks())
        self._dd = StreamDedisp(geom, backend=self.backend,
                                device=self.device)
        self._trig = SpanTrigger(geom, session=self.session,
                                 threshold=float(
                                     self.rec.get("threshold") or 6.0),
                                 backend=self.backend,
                                 device=self.device)
        # ---- resume: journal = acknowledgment of record ----------
        for ev in journal.read_events(self.jroot, ticket=self.tid):
            name = ev.get("event")
            if name == "chunk_received":
                self.acked.add(int(ev.get("seq", -1)))
            elif name == "chunk_gap":
                self.gapped.add(int(ev.get("seq", -1)))
            elif name == "trigger":
                self._journaled_spans.add(int(ev.get("span", -1)))
        self._published_spans = {
            int(r.get("span", -1))
            for r in ingest.read_triggers(self.root, self.session)}
        self.n_triggers = len(
            ingest.read_triggers(self.root, self.session))
        # ---- resume: checkpoint = carry-state of record ----------
        self._ck = self._open_checkpoint(self._man["fingerprint"])
        resumed = False
        if self._ck is not None:
            blob = self._ck.load("stream_carry")
            if blob is not None:
                with np.load(io.BytesIO(blob)) as z:
                    self._dd.buf = np.ascontiguousarray(
                        z["carry"].astype(np.float32))
                    self._dd.emitted = int(z["emitted"])
                    self._trig.restore(
                        {"sp_pend": z["sp_pend"],
                         "sp_next_span": z["sp_next_span"]})
                    self.next_seq = int(z["ack_next"])
                resumed = True
        self._jr("stream_open", session=self.session,
                 fingerprint=self._man["fingerprint"][:12],
                 resumed=int(resumed), ack=self.next_seq,
                 backend=self.backend)
        self.last_progress = time.time()
        return True

    def _checkpoint(self) -> None:
        if self._ck is None or self._dd is None:
            return
        buf = io.BytesIO()
        sp = self._trig.state_arrays()
        np.savez(
            buf, carry=self._dd.buf,
            emitted=np.int64(self._dd.emitted),
            ack_next=np.int64(self.next_seq),
            sp_pend=sp["sp_pend"],
            sp_next_span=sp["sp_next_span"])
        # the artifact alternates between two files and the manifest's
        # entry names the current one: a kill between the artifact's
        # rename and the manifest's leaves the previous carry whole
        # and still named, so a resume replays at most one chunk (one
        # file rewritten in place lost the whole carry to a sha256
        # mismatch there).  Either package loads the carry through
        # the manifest's file name.
        self._ck.save("stream_carry", buf.getvalue(), kind="stream",
                      ext=f".{self.next_seq % 2}.npz",
                      ack_next=self.next_seq)

    # ----------------------------------------------------- processing
    def _publish_spans(self, spans) -> None:
        """Idempotent publication: triggers.jsonl by span, journal
        ``trigger`` by span — a replayed chunk re-derives the same
        spans and both guards skip the duplicate."""
        for span_idx, recs in spans:
            if recs and span_idx not in self._published_spans:
                ingest.append_triggers(self.root, self.session, recs)
                self._published_spans.add(span_idx)
                self.n_triggers += len(recs)
                telemetry.stream_triggers_total().inc(len(recs))
            if recs and span_idx not in self._journaled_spans:
                self._jr("trigger", span=span_idx, n=len(recs),
                         top_sigma=max(r["sigma"] for r in recs),
                         digest=trigger_digest(recs)[:12])
                self._journaled_spans.add(span_idx)

    def _process_chunk(self, seq: int, arr: np.ndarray,
                       t_ingest: float, gap: bool,
                       waited_s: float = 0.0) -> None:
        t0 = time.time()
        blocks = self._dd.append(arr)
        spans = []
        for blk in blocks:
            spans.extend(self._trig.feed(blk))
        self._publish_spans(spans)
        already = seq in self.acked or seq in self.gapped
        if already:
            self.replayed += 1
            telemetry.stream_chunks_total().inc(outcome="replayed")
        elif gap:
            self._jr("chunk_gap", seq=seq, waited_s=round(waited_s, 3))
            self.gapped.add(seq)
            telemetry.stream_chunks_total().inc(outcome="gap")
        else:
            latency = max(0.0, time.time() - t_ingest)
            telemetry.stream_latency_seconds().observe(latency)
            telemetry.stream_chunks_total().inc(outcome="received")
            self._jr("chunk_received", seq=seq,
                     latency_s=round(latency, 6),
                     slo_s=round(self.slo_s, 3),
                     proc_s=round(time.time() - t0, 6))
            self.acked.add(seq)
        self.next_seq = seq + 1
        self._checkpoint()
        self.last_progress = time.time()
        self._gap_noticed = None

    def _close(self, n_chunks: int) -> None:
        spans = []
        for blk in self._dd.flush():
            spans.extend(self._trig.feed(blk))
        spans.extend(self._trig.flush())
        self._publish_spans(spans)
        all_recs = ingest.read_triggers(self.root, self.session)
        digest = trigger_digest(all_recs)
        self._jr("stream_closed", n_chunks=n_chunks,
                 chunks=len(self.acked), gaps=len(self.gapped),
                 triggers=len(all_recs), digest=digest)
        self.result_extras = {
            "session": self.session, "n_chunks": n_chunks,
            "chunks": len(self.acked), "gaps": len(self.gapped),
            "replayed": self.replayed, "triggers": len(all_recs),
            "trigger_digest": digest,
            "emitted_samples": int(self._dd.emitted)}
        self.done = True

    def step(self) -> bool:
        """Advance by at most one chunk.  True = progressed (caller
        should step again soon), False = idle (caller may sleep)."""
        if self.done:
            return False
        if not self._ensure_open():
            return False
        man = ingest.read_manifest(self.root, self.session) or self._man
        self._man = man
        closed = bool(man.get("closed"))
        n_chunks = man.get("n_chunks")
        if closed and n_chunks is not None \
                and self.next_seq >= int(n_chunks):
            self._close(int(n_chunks))
            return True
        # verified read; an injected stream.ingest fault is retried
        # on the next step (frame stays on disk: latency, not data)
        try:
            got = ingest.read_chunk(self.root, self.session,
                                    self.next_seq)
        except (OSError, ingest.StreamError):
            return False
        if self.next_seq in self.gapped:
            # replaying a declared gap: stay deterministic even if the
            # frame straggled in after the declaration — zeros, always
            zeros = np.zeros((self._dd.nchan, self._dd.chunk_len),
                             np.float32)
            self._process_chunk(self.next_seq, zeros, 0.0, gap=True)
            return True
        if got is not None:
            header, arr = got
            self._process_chunk(self.next_seq, arr,
                                float(header.get("t_ingest", 0.0)),
                                gap=False)
            return True
        # missing seq: a hole behind a landed later seq (or behind a
        # closed manifest) becomes a zero-filled, journaled gap
        later = [s for s in ingest.landed_seqs(self.root, self.session)
                 if s > self.next_seq]
        hole = bool(later) or (closed and n_chunks is not None
                               and self.next_seq < int(n_chunks))
        if hole:
            if closed:
                waited = 0.0
            else:
                if self._gap_noticed is None:
                    self._gap_noticed = time.time()
                waited = time.time() - self._gap_noticed
                if waited < GAP_WAIT_S:
                    return False
            zeros = np.zeros((self._dd.nchan, self._dd.chunk_len),
                             np.float32)
            self._process_chunk(self.next_seq, zeros, 0.0, gap=True,
                                waited_s=waited)
            return True
        if time.time() - self.last_progress > idle_timeout_s():
            raise SessionAborted(
                f"session {self.session} idle past "
                f"{idle_timeout_s():g}s at seq {self.next_seq}")
        return False


def process_stream_ticket(q, rec: dict, *, jroot: str, worker_id: str,
                          backend: str = "torch", device=None, box=None,
                          poll_s: float = 0.02, beat=None,
                          should_drain=None) -> str:
    """Run one claimed stream ticket to its terminal result.  Returns
    the status written ('done' | 'failed' | '' when a drain was
    requested mid-session: the carry is checkpointed, no result is
    written, and the caller requeues the claim).  A ticket the session
    cannot even be built for (no stream_root) fails with a result, as
    any other per-ticket error does."""
    status, err, sess = "done", "", None
    try:
        sess = StreamSession(rec, jroot=jroot, worker_id=worker_id,
                             backend=backend, device=device, box=box)
        while not sess.done:
            if should_drain is not None and should_drain():
                sess._checkpoint()
                return ""
            progressed = sess.step()
            if beat is not None:
                beat("streaming")
            if not progressed:
                time.sleep(poll_s)
    except SessionAborted as e:
        status, err = "failed", str(e)[:500]
    except Exception as e:   # noqa: BLE001 — crash isolation per ticket
        status, err = "failed", str(e)[:500]
    for io_try in range(3):
        try:
            q.write_result(
                rec.get("ticket", "?"), status,
                rc=0 if status == "done" else 1, error=err,
                worker=worker_id, attempts=int(rec.get("attempts", 0)),
                outdir=rec.get("outdir", ""),
                trace_id=rec.get("trace_id", ""),
                **(sess.result_extras if sess is not None else {}))
            break
        except OSError as e:
            if io_try == 2:
                if box is not None:
                    box.dump(reason=f"stream result write failed: {e}",
                             rc=74)
                os._exit(74)
            time.sleep(0.05 * (io_try + 1))
    if status == "done" and sess._ck is not None:  # done => sess built
        ckpt.clean(sess._ck.root)
    return status


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spool", required=True)
    p.add_argument("--queue", default="",
                   help="ticket-queue backend URL; default = the "
                        "spool itself")
    p.add_argument("--worker-id", required=True)
    p.add_argument("--backend", default="torch",
                   choices=("torch", "numpy", "auto"),
                   help="dedispersion/search backend (torch = the "
                        "CUDA stage-2 kernel and the span search on "
                        "--device; numpy = the host fold; auto = "
                        "torch)")
    p.add_argument("--device", default="cuda",
                   help="where the torch backend runs: cuda (default) "
                        "or cpu; without a GPU the worker fails "
                        "unless --device cpu is given")
    p.add_argument("--poll-s", type=float, default=0.02)
    p.add_argument("--heartbeat-s", type=float, default=1.0)
    p.add_argument("--max-attempts", type=int,
                   default=protocol.DEFAULT_MAX_ATTEMPTS)
    p.add_argument("--once", action="store_true")
    args = p.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"stream worker: {e}", file=sys.stderr)
        return 2
    faults.configure()          # TPULSAR_FAULTS + chaos schedule env
    spool, wid = args.spool, args.worker_id
    from tpulsar_torch.frontdoor.queue import get_ticket_queue
    q = get_ticket_queue(args.queue or f"spool:{spool}")
    jroot = q.journal_root or spool
    box = health.FlightRecorder(wid, spool=spool)

    draining: list = []
    signal.signal(signal.SIGTERM, lambda *a: draining.append(1))
    signal.signal(signal.SIGINT, lambda *a: draining.append(1))

    last_beat = [0.0]

    def beat(status: str = "running", force: bool = False) -> None:
        now = time.time()
        if not force and now - last_beat[0] < args.heartbeat_s:
            return
        try:
            q.heartbeat(wid, status=status,
                        queue_depth=q.pending_count(),
                        max_queue_depth=1)
            last_beat[0] = now
            box.note("heartbeat", status=status)
        except OSError:
            pass

    try:
        q.requeue_stale_claims(args.max_attempts)
    except OSError:
        pass
    beat(force=True)
    box.arm()

    while not draining:
        try:
            rec = q.claim_next(wid)
        except OSError:
            beat()
            time.sleep(args.poll_s)
            continue
        if rec is None:
            if args.once and q.pending_count() == 0 \
                    and q.claimed_count() == 0:
                break
            beat()
            time.sleep(args.poll_s)
            continue
        box.note("claim", ticket=rec.get("ticket", "?"))
        if (rec.get("kind") or "") != "stream":
            q.write_result(rec.get("ticket", "?"), "failed", rc=1,
                           error="not a stream ticket", worker=wid)
            continue
        process_stream_ticket(
            q, rec, jroot=jroot, worker_id=wid, backend=args.backend,
            device=device, box=box, poll_s=args.poll_s, beat=beat,
            should_drain=lambda: bool(draining))
        beat()
    if draining:
        try:
            q.requeue_own_claims()
        except OSError:
            pass
    box.disarm()
    beat("stopped", force=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
