"""The ticket lifecycle journal: an append-only event log in the spool
— counterpart of tpulsar/obs/journal.py (a copy).  The event
vocabulary and the file layout are the JAX package's, so one journal
holds both packages' chains.

Serving is a multi-process system — N serve workers, a
controller, janitors, work-stealing takeovers, quarantine — and no
single artifact could answer "what happened to beam X, end to end,
across the workers that touched it".  This module is that artifact:
every actor that moves a ticket through the spool state machine
appends ONE stamped event per transition to
``<spool>/events/journal.jsonl``:

    received         OPTIONAL chain head: the HTTP gateway accepted
                     the submission at the network edge (trace id
                     minted there; tenant recorded) — queue-wait SLOs
                     measure from here when present, so they include
                     the gateway hop, not just the spool write
    submitted        client wrote the ticket (trace id minted here
                     unless a gateway minted it at the edge)
    submit_failed    the incoming/ write behind 'submitted' failed
                     (full disk / injected spool.io): the submission
                     was cleanly REFUSED, the chain ends here — how
                     the auditor tells a refused beam from a lost one
    claimed          a worker won the claim rename (worker, pid,
                     attempt, queue_wait_s)
    stagein_done /   the prefetch thread staged the beam's inputs
    stagein_failed   (seconds / first error line)
    search_start     device work began (worker, attempt)
    resume           the claimed beam restarted from checkpointed
                     artifacts (tpulsar/checkpoint/): passes_done
                     (+ salvaged_s where the worker can cost it) —
                     recovery proportional to work LOST, not done
    pass_complete    one checkpoint artifact (a DDplan pass) is
                     durable + manifested (pass_idx/npasses); the
                     unit the no_pass_rerun invariant audits
    checkpoint_invalid   a corrupt/torn/mismatched checkpoint entry
                     was discarded and recomputed (scope entry |
                     manifest, key, reason) — excuses a re-run of
                     exactly that pass
    checkpoint_disabled  ENOSPC/EROFS on the checkpoint dir disabled
                     checkpointing for the rest of the beam (the
                     search finishes un-checkpointed, never fails)
    result           TERMINAL: the durable done/ record landed
                     (status done|failed|skipped, rc, worker, attempt)
    takeover         a janitor stole the claim from a DEAD owner
                     (from_worker/from_pid; attempt = after the
                     strike) — the crash evidence, written by the
                     survivor because the crashed worker cannot
    drain_requeue    attempt-neutral requeue (reason: drain |
                     boot_recovery | abandoned_claiming |
                     abandoned_takeover)
    quarantined      the beam hit the attempts cap (followed by its
                     terminal failed ``result``)
    worker_spawn /   controller lifecycle (no ticket key): spawns,
    worker_exit      restarts, crash exits

Records use the ``telemetry.event_record`` shape (``{"t": <unix>,
"event": ...}`` plus free-form keys), keyed by ``ticket`` + ``worker``
+ ``attempt`` and carrying the ticket's ``trace_id`` so journal events
and trace spans from different processes stitch into one timeline.

Crash safety: each event is one ``os.write`` to an ``O_APPEND`` fd —
atomic line appends even with N processes writing concurrently, no
locks, and a reader can at worst observe (and skip) the final torn
line of a writer that died mid-append.  The journal is OBSERVATIONAL:
events are appended AFTER the spool rename/write they describe
succeeds, and a journal write failure (full disk, read-only spool)
never fails the transition it records.

stdlib only — imported by serve/protocol.py, which runs in processes
that never import jax.
"""

from __future__ import annotations

import json
import os

from tpulsar_torch.obs import telemetry
from tpulsar_torch.resilience import faults

EVENTS_DIR = "events"
JOURNAL_FILE = "journal.jsonl"


class JournalCorrupt(OSError):
    """A MID-FILE journal line is unparseable (and not a recoverable
    torn-append prefix).  Exactly one TRAILING partial line per
    generation is expected wreckage — a writer crashed mid-append —
    and silently skipped; anything else is evidence of real
    corruption and must surface, not vanish.  OSError-shaped on
    purpose: every existing journal-tolerant guard (the controller's
    aggregation loop, record()'s callers) already contains OSError,
    while the chaos verifier catches this class by name."""

#: one rotation generation (journal.jsonl.1) is kept, like the
#: daemons' metrics JSONL: a fleet appending for months must not fill
#: the spool volume, and readers merge both generations
MAX_BYTES = 64 << 20

#: the journal event vocabulary — THE exported contract between the
#: writers (serve/protocol, serve/server, fleet, frontdoor, chaos)
#: and the readers (validate_chain below, chaos/invariants.py, the
#: ops console, docs/operations.md).  One entry per event name with a
#: one-line meaning; the static contract linter (``tpulsar lint
#: --checker journal-events``) fails any ``record()`` call or
#: verifier comparison whose literal is missing here, so a new event
#: type cannot ship without the verifier and the docs knowing it.
EVENTS = {
    "received": "gateway-edge chain head: HTTP submission accepted "
                "(trace id minted at the edge; tenant recorded)",
    "submitted": "client wrote the ticket into incoming/ (mints the "
                 "trace id unless a gateway already did)",
    "submit_failed": "the incoming/ write behind 'submitted' failed: "
                     "the submission was cleanly refused, chain ends",
    "claimed": "a worker won the claim rename (pid, queue_wait_s)",
    "stagein_done": "the prefetch thread staged the beam's inputs",
    "stagein_failed": "stage-in error (first error line)",
    "search_start": "device work began (worker, attempt)",
    "resume": "the claimed beam restarted from checkpointed "
              "artifacts (passes_done, salvaged_s where known)",
    "pass_complete": "one checkpoint artifact (a DDplan pass) is "
                     "durable + manifested (pass_idx/npasses)",
    "checkpoint_invalid": "a corrupt/torn/mismatched checkpoint "
                          "entry was discarded and recomputed "
                          "(scope entry | manifest, key, reason)",
    "checkpoint_disabled": "ENOSPC/EROFS disabled checkpointing for "
                           "the rest of the beam",
    "checkpoint_write_failed": "a transient (non-disabling) "
                               "checkpoint artifact write failed: "
                               "that one artifact is skipped and "
                               "recomputed on resume (key, errno)",
    "batch_dispatch": "a worker coalesced N claimed tickets into one "
                      "batched dispatch (worker, beams, tickets "
                      "list; no ticket key — each member's own chain "
                      "carries its claim/result)",
    "artifact_push": "a finished beam's sifted artifacts entered the "
                     "CAS by digest (blobs count) — written just "
                     "before the terminal result that names them",
    "result": "TERMINAL: the durable done/ record landed (status, "
              "rc, worker, attempt)",
    "takeover": "a janitor stole the claim from a DEAD owner "
                "(from_worker/from_pid; attempt = after the strike)",
    "drain_requeue": "attempt-neutral requeue (reason: drain | "
                     "boot_recovery | abandoned_claiming | "
                     "abandoned_takeover | scale_down)",
    "quarantined": "the beam hit the attempts cap (a terminal "
                   "failed result follows)",
    "worker_spawn": "controller spawned a worker (no ticket key)",
    "worker_exit": "controller reaped a worker exit (kind, rc)",
    "scale_up": "autoscaler added worker(s): before/after counts, "
                "policy bounds, and the triggering signals",
    "scale_down": "autoscaler retired worker(s): victims (worker, "
                  "pid, class) named for the no_elastic_strike audit",
    "chaos_action": "chaos conductor executed a timeline action",
    "chaos_run_start": "chaos conductor opened a storm",
    "chaos_run_end": "chaos conductor quiesced the storm",
    "queue_corrupt": "a durable queue backend refused to open: "
                     "integrity check failed or the database is "
                     "unreadable (path, error) — containment "
                     "evidence, never silent data loss",
    "alert_fired": "the health doctor's detector breached an alert "
                   "rule past its debounce (rule, severity, value, "
                   "threshold, window_s) — self-contained evidence",
    "alert_resolved": "a firing alert rule's signal dropped back "
                      "under its threshold (rule, severity, value)",
    "stream_open": "a stream worker opened a session ticket "
                   "(session, fingerprint, resumed flag, ack seq "
                   "when resuming from carry state)",
    "chunk_received": "one chunk acknowledged exactly once: "
                      "dedispersed + span-searched + published "
                      "(seq, latency_s ingest->trigger, slo_s, "
                      "proc_s) — the trigger_latency_bounded and "
                      "no_lost_chunk evidence",
    "chunk_gap": "a missing seq was declared a gap and zero-filled, "
                 "never silently spliced (seq, waited_s)",
    "trigger": "a completed span published single-pulse trigger "
               "records (span, n, top_sigma, digest)",
    "stream_closed": "the session drained: every seq in [0, "
                     "n_chunks) acknowledged or gapped (n_chunks, "
                     "chunks, gaps, triggers, digest)",
}

#: the one terminal event name: a ticket is finished exactly when its
#: durable done/ record lands, so exactly-once across the fleet reads
#: as "exactly one ``result`` event per ticket" in the journal
TERMINAL_EVENT = "result"
assert TERMINAL_EVENT in EVENTS


def journal_path(spool: str) -> str:
    return os.path.join(spool, EVENTS_DIR, JOURNAL_FILE)


def record(spool: str, event: str, ticket: str = "",
           worker: str = "", attempt: int | None = None,
           trace_id: str = "", **extra) -> dict | None:
    """Append one lifecycle event; returns the record, or None when
    the append failed (journal writes never break the transition
    they describe)."""
    fields: dict = dict(extra)
    if ticket:
        fields["ticket"] = ticket
    if worker:
        fields["worker"] = worker
    if attempt is not None:
        fields["attempt"] = int(attempt)
    if trace_id:
        fields["trace_id"] = trace_id
    rec = telemetry.event_record(event, **fields)
    path = journal_path(spool)
    line = (json.dumps(rec, separators=(",", ":"), sort_keys=True)
            + "\n").encode()
    try:
        # deterministic append-failure injection (chaos): the journal
        # is observational, so the fault costs this EVENT, never the
        # transition — shaped as the OSError a failing spool raises
        faults.fire("journal.append", make_exc=faults.io_error,
                    detail=event)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            if os.path.getsize(path) >= MAX_BYTES:
                # race-safe rotation: the exclusive rename picks ONE
                # rotator among N concurrent writers — a plain
                # replace(path, path+'.1') would let the loser clobber
                # the generation the winner just rotated, destroying
                # 64 MB of history.  A rotator that dies between the
                # renames strands '.rotating.<pid>', which
                # read_events still merges.
                rot = f"{path}.rotating.{os.getpid()}"
                try:
                    os.rename(path, rot)
                    os.replace(rot, path + ".1")
                except OSError:
                    pass          # another writer is rotating
        except OSError:
            pass
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                     0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)
    except OSError:
        return None
    return rec


def _parse_line(line: str) -> dict | None:
    """json.loads with torn-append recovery.  A writer that died (or
    hit ENOSPC) mid-append leaves a partial prefix with no newline;
    the NEXT O_APPEND writer's complete record then lands on the SAME
    physical line.  The trailing complete object on such a merged
    line WAS durably written — recover it instead of losing a real
    event to someone else's wreckage."""
    try:
        rec = json.loads(line)
        return rec if isinstance(rec, dict) else None
    except ValueError:
        pass
    idx = line.find("{", 1)
    while idx != -1:
        try:
            rec = json.loads(line[idx:])
            return rec if isinstance(rec, dict) else None
        except ValueError:
            idx = line.find("{", idx + 1)
    return None


def _generation_paths(spool: str) -> list[str]:
    import glob as _glob
    path = journal_path(spool)
    return [path + ".1",
            *sorted(_glob.glob(path + ".rotating.*")),  # dead rotator
            path]


def _parse_file(p: str, out: list[dict], ticket: str | None,
                bad_lines: list | None) -> None:
    """Parse one journal generation into ``out``.  Exactly ONE
    trailing partial line is tolerated (a writer crashed mid-append:
    expected wreckage); an unparseable line anywhere ELSE is real
    corruption — appended to ``bad_lines`` when the caller collects
    them (the chaos verifier), raised as JournalCorrupt otherwise."""
    try:
        with open(p) as fh:
            lines = fh.readlines()
    except OSError:
        return
    last = -1
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].strip():
            last = i
            break
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        rec = _parse_line(line)
        if rec is None:
            if i == last:
                continue          # the one tolerated torn tail
            if bad_lines is not None:
                bad_lines.append({"path": p, "line": i + 1,
                                  "text": line[:200]})
                continue
            raise JournalCorrupt(
                f"journal corrupt mid-file: {p} line {i + 1}: "
                f"{line[:120]!r}")
        if ticket is not None and rec.get("ticket") != ticket:
            continue
        out.append(rec)


def read_events(spool: str, ticket: str | None = None, *,
                after_offset: int | None = None,
                bad_lines: list | None = None):
    """Journal events, oldest first.  ``ticket`` filters to one
    beam's lifecycle.

    Torn-tail contract: exactly one TRAILING partial line per
    generation is skipped (a writer died mid-append); a merged
    torn-prefix + complete-record line recovers the complete record;
    any other unparseable line raises ``JournalCorrupt`` — or is
    collected into ``bad_lines`` when a list is passed (the chaos
    verifier reports them instead of aborting the audit).

    ``after_offset=None`` (default): every generation merged, a
    plain list — the historical behaviour.

    ``after_offset=N``: tail mode for pollers — returns ``(events,
    next_offset)`` with only the events appended past byte N of the
    CURRENT generation; ``next_offset`` never advances past an
    incomplete trailing line, so a torn append is simply re-examined
    (and recovered or skipped) once the next writer completes the
    line.  ``after_offset=0`` is the attach point: it includes the
    rotated generations once, then hands back a byte offset to tail
    from.  If the journal rotated between polls (current file shrank
    below the offset), the missed tail is read from the ``.1``
    generation — a tailer more than one full generation behind loses
    the gap, which 64 MB of slack makes a non-event in practice."""
    out: list[dict] = []
    if after_offset is None:
        for p in _generation_paths(spool):
            _parse_file(p, out, ticket, bad_lines)
        out.sort(key=lambda r: r.get("t", 0.0))
        return out

    path = journal_path(spool)
    offset = max(0, int(after_offset))
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0
    if offset == 0:
        # attach: the rotated generations are history, read whole
        for p in _generation_paths(spool)[:-1]:
            _parse_file(p, out, ticket, bad_lines)
    elif size < offset:
        # rotated under us: our unread tail now ends the .1 file
        _parse_tail(path + ".1", offset, out, ticket, bad_lines)
        offset = 0
    next_offset = offset + _parse_tail(path, offset, out, ticket,
                                       bad_lines)
    out.sort(key=lambda r: r.get("t", 0.0))
    return out, next_offset


def _parse_tail(p: str, offset: int, out: list[dict],
                ticket: str | None, bad_lines: list | None) -> int:
    """Parse complete lines of ``p`` past byte ``offset`` into
    ``out``; returns the number of bytes CONSUMED (up to and
    including the last newline — a trailing partial line stays
    unconsumed for the next poll)."""
    try:
        with open(p, "rb") as fh:
            fh.seek(offset)
            data = fh.read()
    except OSError:
        return 0
    cut = data.rfind(b"\n")
    if cut < 0:
        return 0
    for raw in data[:cut].split(b"\n"):
        line = raw.decode("utf-8", errors="replace").strip()
        if not line:
            continue
        rec = _parse_line(line)
        if rec is None:
            # every line here ENDS with a newline (complete), so an
            # unrecoverable one is mid-file corruption by definition
            if bad_lines is not None:
                bad_lines.append({"path": p, "line": -1,
                                  "text": line[:200]})
                continue
            raise JournalCorrupt(
                f"journal corrupt mid-file: {p} (tail read): "
                f"{line[:120]!r}")
        if ticket is not None and rec.get("ticket") != ticket:
            continue
        out.append(rec)
    return cut + 1


def iter_tickets(events: list[dict]) -> dict[str, list[dict]]:
    """Events grouped per ticket (worker-lifecycle events, which have
    no ticket key, are dropped)."""
    per: dict[str, list[dict]] = {}
    for ev in events:
        tid = ev.get("ticket")
        if tid:
            per.setdefault(tid, []).append(ev)
    return per


def validate_chain(events: list[dict]) -> list[str]:
    """Well-formedness problems in ONE ticket's event chain — the
    property every done/quarantined beam must satisfy:

      * it starts with ``submitted`` — or with the optional
        gateway-edge ``received`` head, in which case ``submitted``
        must follow it (an HTTP-accepted beam that never reached the
        queue is an in-flight chain, not a well-formed one);
      * exactly one terminal ``result`` event, and nothing after it;
      * ``attempt`` never decreases, and every ``takeover`` strike
        raises it by exactly 1 over the claim it stole;
      * the terminal attempt matches the last claim's.

    Returns [] for a well-formed chain."""
    problems: list[str] = []
    if not events:
        return ["no events"]
    head = events[0].get("event")
    if head == "received":
        if len(events) < 2 or events[1].get("event") != "submitted":
            problems.append(
                "gateway 'received' head not followed by 'submitted'")
    elif head != "submitted":
        problems.append(
            f"first event is {head!r}, not 'submitted' (or a "
            f"gateway 'received' head)")
    if any(ev.get("event") == "submit_failed" for ev in events):
        # a cleanly-refused submission (the incoming/ write failed):
        # the chain ends right there — no claim, no terminal
        if events[-1].get("event") != "submit_failed":
            tail = [e.get("event") for e in events
                    if e.get("event") not in ("received", "submitted",
                                              "submit_failed")]
            problems.append(
                f"events after a failed submission: {tail}")
        return problems
    terminals = [i for i, ev in enumerate(events)
                 if ev.get("event") == TERMINAL_EVENT]
    if len(terminals) != 1:
        problems.append(f"{len(terminals)} terminal '{TERMINAL_EVENT}'"
                        f" events (want exactly 1)")
    elif terminals[0] != len(events) - 1:
        tail = [e.get("event") for e in events[terminals[0] + 1:]]
        problems.append(f"events after the terminal: {tail}")
    last_attempt = 0
    last_claim_attempt = None
    quarantine_attempt = None
    for ev in events:
        att = ev.get("attempt")
        if att is None:
            continue
        if att < last_attempt:
            problems.append(
                f"attempt went backwards at {ev.get('event')!r} "
                f"({last_attempt} -> {att})")
        if ev.get("event") == "takeover" and \
                last_claim_attempt is not None and \
                att != last_claim_attempt + 1:
            problems.append(
                f"takeover attempt {att} != stolen claim's "
                f"{last_claim_attempt} + 1")
        if ev.get("event") == "claimed":
            last_claim_attempt = att
        if ev.get("event") == "quarantined":
            quarantine_attempt = att
        if ev.get("event") == TERMINAL_EVENT:
            # a quarantined beam terminates at the attempt of its
            # FINAL strike (no claim follows it); a finished beam
            # terminates at its last claim's attempt
            expect = (quarantine_attempt
                      if quarantine_attempt is not None
                      else last_claim_attempt)
            if expect is not None and att != expect:
                problems.append(
                    f"terminal attempt {att} != expected {expect}")
        last_attempt = max(last_attempt, att)
    return problems


def chain_summary(events: list[dict]) -> dict:
    """One ticket's lifecycle digest: status, the workers that
    touched it, attempts, and the SLO durations the fleet aggregator
    exports (queue_wait_s: submitted -> first claim; claim_to_start_s:
    last claim -> search start; e2e_s: submitted -> terminal)."""
    first = {ev.get("event"): ev for ev in reversed(events)}
    last = {ev.get("event"): ev for ev in events}
    terminal = last.get(TERMINAL_EVENT)
    out: dict = {
        "events": [ev.get("event") for ev in events],
        "workers": sorted({ev["worker"] for ev in events
                           if ev.get("worker")}),
        "attempts": max((ev.get("attempt", 0) for ev in events),
                        default=0),
        "takeovers": sum(1 for ev in events
                         if ev.get("event") == "takeover"),
        "status": terminal.get("status") if terminal else None,
        "trace_id": next((ev["trace_id"] for ev in events
                          if ev.get("trace_id")), ""),
        "outdir": next((ev["outdir"] for ev in events
                        if ev.get("outdir")), ""),
    }
    # queue-wait and e2e measure from the gateway-edge 'received'
    # event when one exists: the SLO a network submitter experiences
    # starts at HTTP arrival, not at the spool write behind it
    sub = first.get("received") or first.get("submitted")
    claim, start = first.get("claimed"), last.get("search_start")
    if sub and claim:
        out["queue_wait_s"] = round(claim["t"] - sub["t"], 3)
    if start and last.get("claimed"):
        out["claim_to_start_s"] = round(
            start["t"] - last["claimed"]["t"], 3)
    if sub and terminal:
        out["e2e_s"] = round(terminal["t"] - sub["t"], 3)
    if first.get("received"):
        out["tenant"] = first["received"].get("tenant", "")
    return out


def summarize(spool: str, queue=None) -> dict:
    """Spool-wide journal digest: per-ticket chains + fleet counts —
    the input both the fleet metrics aggregator (obs/fleetview.py)
    and ``tools/trace_summarize.py --spool`` read.  ``queue`` routes
    the event read through a TicketQueue backend instead of the
    spool's journal files (the ``sqlite:``/``memory:`` path)."""
    # tolerant read: the fleet aggregator and ops console must keep
    # rendering past a corrupt line (chaos verify reports it)
    if queue is not None:
        events, _ = queue.read_events_after(0)
    else:
        events = read_events(spool, bad_lines=[])
    per = iter_tickets(events)
    tickets = {tid: chain_summary(evs) for tid, evs in per.items()}
    statuses: dict[str, int] = {}
    for rec in tickets.values():
        key = rec["status"] or "in-flight"
        statuses[key] = statuses.get(key, 0) + 1
    return {
        "spool": spool,
        "n_events": len(events),
        "tickets": tickets,
        "statuses": statuses,
        "takeovers": sum(r["takeovers"] for r in tickets.values()),
        "quarantined": sum(
            1 for evs in per.values()
            if any(e.get("event") == "quarantined" for e in evs)),
    }


def render_timeline(spool: str, ticket: str, queue=None) -> str:
    """The ops-console timeline: one beam's full lifecycle across
    every worker that touched it, with the duration between
    transitions — `tpulsar obs timeline <ticket>`.  ``queue`` routes
    the event read through a TicketQueue backend."""
    if queue is not None:
        events, _ = queue.read_events_after(0, ticket=ticket)
    else:
        events = read_events(spool, ticket=ticket, bad_lines=[])
    if not events:
        return f"no journal events for ticket {ticket!r} in {spool}"
    digest = chain_summary(events)
    lines = [f"ticket {ticket}  trace_id={digest['trace_id'] or '-'}",
             f"workers: {', '.join(digest['workers']) or '-'}  "
             f"attempts: {digest['attempts']}  "
             f"status: {digest['status'] or 'in-flight'}",
             f"{'t+':>10s}  {'+dt':>9s}  {'event':16s} "
             f"{'worker':8s} {'att':>3s}  detail"]
    t0 = events[0]["t"]
    prev = t0
    for ev in events:
        detail = []
        for key in ("status", "rc", "reason", "queue_wait_s",
                    "seconds", "from_worker", "from_pid", "kind",
                    "pid", "error"):
            if key in ev:
                val = str(ev[key])
                detail.append(f"{key}={val[:40]}")
        lines.append(
            f"{ev['t'] - t0:10.3f}  {ev['t'] - prev:9.3f}  "
            f"{ev.get('event', '?'):16s} "
            f"{ev.get('worker', '') or '-':8s} "
            f"{ev.get('attempt', ''):>3}  {' '.join(detail)}")
        prev = ev["t"]
    problems = validate_chain(events)
    if problems:
        lines.append("chain problems: " + "; ".join(problems))
    return "\n".join(lines)
