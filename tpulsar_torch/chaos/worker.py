"""A protocol-complete, torch-free chaos worker — counterpart of
tpulsar/chaos/worker.py (a copy: the same claims, journal events,
result records and checkpoint artifacts, so either package's verifier
audits its storms and either package's controller supervises it).

Chaos scenarios need dozens of beams flowing through the REAL spool
protocol in seconds, with every fault point armed — not real
dedispersion.  This worker speaks the full serve contract as a
first-class module the fleet controller spawns (``python -m
tpulsar_torch.chaos.worker``; the port's controller tests drive it
too, so the controller's tests and the chaos harness drive ONE
protocol implementation), with the pieces a storm needs:

  * exclusive two-rename claims through ``protocol.claim_next_ticket``
    under the scenario's TenantPolicy (quota enforcement at the claim
    — the invariant the verifier audits);
  * per-worker heartbeats, ``search_start`` journal events with the
    ticket's trace context, durable results stamped worker+attempts;
  * the faults layer fully armed: ``TPULSAR_FAULTS`` baseline plus
    the chaos schedule (TPULSAR_CHAOS_SCHEDULE/_WORKER env the
    conductor injects), so ``spool.io``/``journal.append``/
    ``serve.beam``/``fleet.worker`` windows fire in THIS process at
    the scheduled instants;
  * the same containment contract as the real server: transient
    result-write failures retried, persistent ones exit the worker
    with its claim in place for the janitor; ``fleet.worker`` is a
    hard ``os._exit(70)`` mid-beam — crash footprint, no drain;
  * SIGTERM graceful drain with attempt-neutral requeue;
  * deterministic crash knobs for supervisor tests (``--crash-after``
    = ``os._exit(70)`` right after claiming the N-th ticket — claim
    in place, no result; ``--exit-rc`` = die at boot), so the fleet
    controller's test suite drives THIS worker too — one stub, one
    protocol, no drift.

It never imports torch: a stub boots in milliseconds, and only the
``serve`` workers of a storm touch the device.

A beam is ``time.sleep(beam_s)`` (the ticket may carry its own
``beam_s``); everything else is byte-for-byte the serving stack.

Multi-pass beams (checkpoint resume under chaos): a ticket carrying
``passes``/``pass_s`` runs as ``passes`` sequential units through the
REAL checkpoint layer (tpulsar_torch/checkpoint/): each pass sleeps
``pass_s`` then dumps a deterministic artifact into the ticket
outdir's ``.checkpoint`` store (``pass_complete`` journaled once
durable), and a reclaimed beam verifies the manifest and recomputes
only the missing tail (``resume`` journaled with ``salvaged_s``).
The per-pass payload is a PURE FUNCTION of (ticket, pass index) —
:func:`pass_payload` — so the terminal result's
``candidates_digest`` is recomputable by the invariant verifier from
the journal alone, and "resumed candidates identical to an
uninterrupted run" (``resume_consistent``) is a byte-exact check,
not a heuristic.  ``--no-checkpoint`` is the from-zero control the
resume bench contrasts against; ``--crash-after-pass N`` =
``os._exit(70)`` right after computing (not resuming) a beam's N-th
pass — the deterministic kill-mid-beam footprint.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import signal
import sys
import time

from tpulsar_torch.obs import health, journal
from tpulsar_torch.resilience import faults
from tpulsar_torch.serve import protocol


def pass_payload(ticket: str, k: int) -> bytes:
    """Deterministic per-pass 'science': independent of worker,
    attempt, and wall clock, so any combination of crashes and
    resumes that computes every pass exactly once (or recomputes a
    discarded one identically) yields the same final digest."""
    return hashlib.sha256(f"{ticket}:pass{k}".encode()).digest()


def expected_digest(ticket: str, npasses: int) -> str:
    """The uninterrupted golden run's candidates_digest — what the
    verifier's ``resume_consistent`` invariant compares against."""
    h = hashlib.sha256()
    for k in range(npasses):
        h.update(pass_payload(ticket, k))
    return h.hexdigest()


def _run_pass_beam(spool: str, wid: str, rec: dict, args,
                   npasses: int,
                   box: health.FlightRecorder | None = None) -> dict:
    """One multi-pass beam through the checkpoint store.  Returns the
    result-record extras (passes, computed/resumed counts, digest)."""
    from tpulsar_torch import checkpoint as ckpt   # hoisted via main()

    tid = rec.get("ticket", "?")
    att = int(rec.get("attempts", 0))
    pass_s = float(rec.get("pass_s", 0.05))
    outdir = rec.get("outdir") or ""

    def jr(event: str, **extra) -> None:
        if box is not None:
            box.note("journal", event=event, ticket=tid)
        journal.record(spool, event, ticket=tid, worker=wid,
                       attempt=att,
                       trace_id=rec.get("trace_id", ""), **extra)

    store = None
    if outdir and not args.no_checkpoint:
        store = ckpt.CheckpointStore(
            ckpt.default_root(outdir),
            fingerprint=f"chaos:{tid}:{npasses}:{pass_s!r}",
            journal=jr)
    parts: dict[int, bytes] = {}
    if store is not None:
        # verify-then-skip: every prior artifact is loaded (and hash
        # checked) up front, so the resume event's salvage accounting
        # counts only artifacts that actually survived intact
        for k in range(npasses):
            data = store.load(f"pass_{k:04d}")
            if data is not None:
                parts[k] = data
        if parts:
            jr("resume", passes_done=len(parts), npasses=npasses,
               salvaged_s=round(len(parts) * pass_s, 3))
    computed = 0
    for k in range(npasses):
        if k in parts:
            continue
        time.sleep(pass_s)          # the 'compute'
        computed += 1
        data = pass_payload(tid, k)
        parts[k] = data
        if store is not None and store.save(
                f"pass_{k:04d}", data, kind="pass", pass_idx=k):
            jr("pass_complete", pass_idx=k, npasses=npasses)
        if args.crash_after_pass and computed >= args.crash_after_pass:
            if box is not None:
                box.dump(reason=f"--crash-after-pass on {tid} "
                                f"pass {k}", rc=70)
            os._exit(70)
    h = hashlib.sha256()
    for k in range(npasses):
        h.update(parts[k])
    return {"passes": npasses, "pass_s": pass_s,
            "computed_passes": computed,
            "resumed_passes": npasses - computed,
            "candidates_digest": h.hexdigest()}


def synth_candidates(ticket: str, n: int = 3):
    """Deterministic sifted candidates for a dataplane beam — a pure
    function of the ticket id, so a retried beam writes a byte-
    identical .accelcands and the index delete+reinsert is a no-op."""
    from tpulsar_torch.search.sifting import Candidate
    h = hashlib.sha256(ticket.encode()).digest()
    out = []
    for k in range(n):
        b = h[4 * k:4 * k + 4]
        freq = 1.0 + b[0] / 8.0
        out.append(Candidate(
            r=round(100.0 + b[1], 2), z=round(b[2] / 16.0, 2),
            sigma=round(6.0 + b[3] / 32.0, 2),
            power=round(20.0 + b[0] / 4.0, 4),
            numharm=1 + k, dm=round(10.0 * (k + 1), 2),
            period_s=1.0 / freq, freq_hz=freq,
            dm_hits=[(round(10.0 * (k + 1), 2),
                      round(6.0 + b[3] / 32.0, 2))]))
    return out


def _run_dataplane_beam(jroot: str, wid: str, rec: dict, args,
                        box: health.FlightRecorder | None = None
                        ) -> dict:
    """One SPOOL-LESS beam: stage in the ticket's ``blobs:`` refs by
    digest (HTTP when TPULSAR_DATA_URL is set, else a local
    TPULSAR_BLOB_ROOT store), 'search' (sleep beam_s), write a real
    .accelcands artifact into the outdir, push it back into the CAS,
    and index the candidates — the same publish discipline as
    serve/server.py, at stub-worker speed.  A stage-in failure is
    journaled ``stagein_failed`` and re-raised so the caller's
    containment marks THIS ticket failed and keeps serving."""
    from tpulsar_torch.dataplane import blobstore, index as dp_index, \
        transfer

    tid = rec.get("ticket", "?")
    att = int(rec.get("attempts", 0))
    outdir = rec.get("outdir") or ""

    def jr(event: str, **extra) -> None:
        if box is not None:
            box.note("journal", event=event, ticket=tid)
        journal.record(jroot, event, ticket=tid, worker=wid,
                       attempt=att,
                       trace_id=rec.get("trace_id", ""), **extra)

    url = os.environ.get("TPULSAR_DATA_URL", "")
    root = "" if url else blobstore.default_blob_root("")
    staging = os.path.join(outdir or jroot, "stagein")
    t0 = time.time()
    fetched = 0
    try:
        for fname, digest in sorted(
                (rec.get("blobs") or {}).items()):
            faults.fire("stagein.fetch", make_exc=faults.io_error,
                        detail=f"{fname} {str(digest)[:12]}")
            dest = os.path.join(staging,
                                os.path.basename(str(fname)))
            if url:
                fetched += transfer.get_to_file(url, str(digest),
                                                dest)
            elif root:
                blobstore.BlobStore(root).fetch_to(str(digest), dest)
                fetched += os.path.getsize(dest)
            else:
                raise RuntimeError(
                    "blobs: ticket with no data plane configured")
    except Exception as e:          # noqa: BLE001 — contained
        jr("stagein_failed", error=str(e)[:200])
        raise
    jr("stagein_done", seconds=round(time.time() - t0, 3))
    time.sleep(float(rec.get("beam_s", args.beam_s)))
    # lazy import: accelcands needs numpy, which only dataplane
    # storms require of the stub worker
    from tpulsar_torch.io import accelcands
    os.makedirs(outdir, exist_ok=True)
    apath = os.path.join(outdir, f"{tid}.accelcands")
    accelcands.write_candlist(synth_candidates(tid), apath)
    if url:
        digest = transfer.put_file(url, apath)
    else:
        store = blobstore.BlobStore(root)
        digest = store.put_file(apath)
        store.add_ref(digest, tid)
    artifacts = {os.path.basename(apath): digest}
    dp_index.CandidateIndex(
        dp_index.index_path(jroot)).index_outdir(tid, outdir,
                                                 artifacts)
    jr("artifact_push", blobs=len(artifacts))
    return {"artifacts": artifacts, "blob_bytes": fetched}


def _policy():
    import json as _json
    raw = os.environ.get("TPULSAR_CHAOS_TENANTS", "")
    from tpulsar_torch.frontdoor.tenancy import TenantPolicy
    if not raw:
        return TenantPolicy()
    return TenantPolicy(_json.loads(raw))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spool", required=True)
    p.add_argument("--queue", default="",
                   help="ticket-queue backend URL (sqlite:<path>, "
                        "spool:<dir>); default = the spool itself. "
                        "The spool stays the run root: journal, "
                        "heartbeat files for spool runs, checkpoint "
                        "outdirs")
    p.add_argument("--worker-id", required=True)
    p.add_argument("--worker-class", default="",
                   help="worker class stamped on heartbeats and "
                        "claims ('spot' = the autoscaler SIGKILLs "
                        "this worker on scale-down instead of "
                        "draining it)")
    p.add_argument("--beam-s", type=float, default=0.2)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--poll-s", type=float, default=0.05)
    p.add_argument("--heartbeat-s", type=float, default=1.0)
    p.add_argument("--max-attempts", type=int,
                   default=protocol.DEFAULT_MAX_ATTEMPTS)
    p.add_argument("--once", action="store_true")
    p.add_argument("--crash-after", type=int, default=0,
                   help="os._exit(70) right after claiming the N-th "
                        "ticket (0 = never): the fleet.worker crash "
                        "footprint without arming the faults layer")
    p.add_argument("--exit-rc", type=int, default=-1,
                   help="exit immediately with this rc (spawn-crash "
                        "simulation; -1 = serve normally)")
    p.add_argument("--no-checkpoint", action="store_true",
                   help="run multi-pass beams WITHOUT the checkpoint "
                        "store (the from-zero recovery control the "
                        "resume bench measures waste against)")
    p.add_argument("--crash-after-pass", type=int, default=0,
                   help="os._exit(70) right after computing a beam's "
                        "N-th pass (0 = never): a deterministic "
                        "kill-mid-beam with the claim in place and "
                        "the checkpoint store holding N artifacts")
    p.add_argument("--batch", type=int, default=1,
                   help="batched admission: claim up to N compatible "
                        "tickets per protocol.claim_batch ordering "
                        "pass, journal ONE batch_dispatch naming the "
                        "members, and finish each beam with its own "
                        "durable result (1 = single-ticket claims)")
    p.add_argument("--crash-mid-batch", action="store_true",
                   help="os._exit(70) after finishing the FIRST beam "
                        "of the first >=2-ticket batch: the "
                        "deterministic mid-batch SIGKILL footprint — "
                        "one durable result, the remaining "
                        "batchmates' claims held for the janitor to "
                        "requeue individually")
    args = p.parse_args(argv)

    if args.exit_rc >= 0:
        return args.exit_rc

    faults.configure()          # TPULSAR_FAULTS + chaos schedule env
    policy = _policy()
    # pay the checkpoint layer's import at BOOT, not inside the first
    # claimed beam: on a loaded host the lazy import would stretch
    # the first beam by whole seconds and skew every storm timing
    # (the worker heartbeats only after this line, so the conductor's
    # fleet-fresh gate already accounts for it)
    import tpulsar_torch.checkpoint  # noqa: F401
    spool, wid = args.spool, args.worker_id
    # all ticket traffic rides the backend interface; a corrupt
    # sqlite queue raises QueueCorrupt here and the worker dies
    # LOUDLY at boot (containment, not absorption)
    from tpulsar_torch.frontdoor.queue import get_ticket_queue
    q = get_ticket_queue(args.queue or f"spool:{spool}")
    # direct journal appends (search_start, pass events, dispatch
    # evidence) land at the backend's journal root — identical to the
    # spool for every committed scenario layout
    jroot = q.journal_root or spool
    # flight recorder: bounded ring of recent claims/journal appends/
    # heartbeats, dumped to <spool>/blackbox/ on any abnormal exit so
    # a crashed worker's last seconds are reconstructable post-mortem
    box = health.FlightRecorder(wid, spool=spool)

    draining = []
    signal.signal(signal.SIGTERM, lambda *a: draining.append(1))
    signal.signal(signal.SIGINT, lambda *a: draining.append(1))

    last_beat = [0.0]

    def beat(status: str = "running", force: bool = False) -> None:
        now = time.time()
        if not force and now - last_beat[0] < args.heartbeat_s:
            return
        try:
            q.heartbeat(
                wid, status=status,
                queue_depth=q.pending_count(),
                max_queue_depth=args.depth,
                **({"worker_class": args.worker_class}
                   if args.worker_class else {}))
            last_beat[0] = now
            box.note("heartbeat", status=status)
        except OSError:
            pass      # a spool.io window costs freshness, not the worker

    # boot recovery, like the real server — guarded: a fault window
    # open at boot must not kill the worker before its first claim
    try:
        q.requeue_stale_claims(args.max_attempts)
    except OSError:
        pass
    beat(force=True)
    box.arm()

    claims = [0]

    def process_ticket(rec: dict) -> None:
        claims[0] += 1
        tid = rec.get("ticket", "?")
        box.note("claim", ticket=tid, n=claims[0])
        if args.crash_after and claims[0] >= args.crash_after:
            box.dump(reason=f"--crash-after on claim {claims[0]}",
                     rc=70)
            os._exit(70)
        att = int(rec.get("attempts", 0))
        box.note("journal", event="search_start", ticket=tid)
        journal.record(jroot, "search_start", ticket=tid, worker=wid,
                       attempt=att, trace_id=rec.get("trace_id", ""))
        # worker-crash injection: hard exit mid-beam, claim in place,
        # no result, no drain — the footprint the janitor must heal
        if faults.targets("fleet.worker"):
            try:
                faults.fire("fleet.worker",
                            detail=f"ticket {tid} worker {wid}")
            except BaseException:
                box.dump(reason=f"fleet.worker fault on {tid}",
                         rc=70)
                os._exit(70)
        status, err = "done", ""
        extras: dict = {}
        npasses = int(rec.get("passes", 0) or 0)
        try:
            faults.fire("serve.beam", detail=f"ticket {tid}")
            if rec.get("blobs"):
                extras = _run_dataplane_beam(jroot, wid, rec, args,
                                             box=box)
            elif npasses > 0:
                extras = _run_pass_beam(jroot, wid, rec, args,
                                        npasses, box=box)
            else:
                time.sleep(float(rec.get("beam_s", args.beam_s)))
        except Exception as e:   # noqa: BLE001 — crash isolation:
            status, err = "failed", str(e)[:500]   # this ticket only
        for io_try in range(3):
            try:
                q.write_result(
                    tid, status, rc=0 if status == "done"
                    else 1, error=err,
                    beam_seconds=float(rec.get("beam_s",
                                               args.beam_s)),
                    warm=True, worker=wid, attempts=att,
                    outdir=rec.get("outdir", ""),
                    trace_id=rec.get("trace_id", ""), **extras)
                break
            except OSError as e:
                if io_try == 2:
                    # persistent spool failure: die with the claim in
                    # place — the janitor reassigns, never loses it
                    box.dump(reason=f"result write failed for {tid}:"
                                    f" {e}", rc=74)
                    os._exit(74)
                time.sleep(0.05 * (io_try + 1))
        if status == "done" and npasses > 0 and rec.get("outdir"):
            # resume state is disposable only once the result is
            # durable (run_search's ordering) — and removing it keeps
            # checkpoint litter out of the quiesced-spool audit
            from tpulsar_torch import checkpoint as ckpt
            ckpt.clean(ckpt.default_root(rec["outdir"]))

    while not draining:
        try:
            if args.batch > 1:
                recs = q.claim_batch(
                    args.batch, wid, policy=policy,
                    worker_class=args.worker_class)
            else:
                one = q.claim_next(
                    wid, policy=policy,
                    worker_class=args.worker_class)
                recs = [one] if one is not None else []
        except OSError:
            beat()
            time.sleep(args.poll_s)
            continue
        if not recs:
            if args.once and q.pending_count() == 0 \
                    and q.claimed_count() == 0:
                break
            beat()
            time.sleep(args.poll_s)
            continue
        if args.batch > 1:
            # the batch-dispatch evidence (fleet-level, no ticket
            # key): the members' own chains carry claim/result
            journal.record(jroot, "batch_dispatch", worker=wid,
                           beams=len(recs),
                           tickets=[r.get("ticket", "?")
                                    for r in recs])
        for bi, rec in enumerate(recs):
            process_ticket(rec)
            if args.crash_mid_batch and len(recs) >= 2 and bi == 0:
                # mid-batch SIGKILL footprint: first beam's result is
                # durable, every remaining batchmate's claim is held
                # — the janitor must requeue each individually
                box.dump(reason="--crash-mid-batch after first beam",
                         rc=70)
                os._exit(70)
        beat()
    if draining:
        try:
            q.requeue_own_claims()
        except OSError:
            pass
    box.disarm()        # clean exit: no dump, no atexit footprint
    beat("stopped", force=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
