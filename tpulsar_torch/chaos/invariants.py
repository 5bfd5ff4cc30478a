"""The system-invariant auditor: replay the evidence, name the crime —
counterpart of tpulsar/chaos/invariants.py (a copy: the same sweeps,
violation texts and report, so one spool gets the same verdict from
either package's verifier, whichever package stormed it).

After (or during — ``--tail``) a chaos run, this module replays the
ticket journal, the spool state, and the result store, and asserts
the serving stack's SYSTEM-level contract as named, individually
reportable invariants.  Per-layer tests prove each mechanism in
isolation; this auditor is the oracle that proves they still compose
when workers die mid-beam, the disk refuses writes, and the gateway
restarts — and it is deliberately reusable: any future queue backend
or streaming mode that claims the ticket contract is judged against
exactly this list.

The invariants (violation ``invariant`` field -> meaning):

  terminal_exactly_once   every submitted beam has EXACTLY one
                          terminal ``result`` journal event — zero
                          is a beam the fleet dropped, two is a beam
                          it double-processed (survey completeness
                          corrupts silently either way)
  no_lost_ticket          submitted => terminal, quarantined, still
                          pending/claimed at quiesce, or a clean
                          ``submit_failed`` refusal; a ticket with
                          no terminal AND no spool presence is LOST
  attempts_monotone       attempts never decrease; the k-th takeover
                          carries attempt k (every strike is +1);
                          quarantine happens exactly at the cap,
                          never below it; the terminal attempt
                          matches the final claim's (or the
                          quarantine strike's)
  result_before_release   the terminal event ends its chain; a
                          terminal ticket has a durable done/ record;
                          at quiesce nothing is both done and still
                          claimed/pending
  no_orphan_sidefiles     after quiesce no ``.claiming.<pid>`` /
                          ``.takeover.<pid>`` / ``.tmp`` transients
                          remain — every crashed two-rename was
                          reconciled
  tenant_quota            per-tenant in-flight, reconstructed from
                          the journal's claim/release instants, never
                          exceeds ``max_inflight`` at ANY instant
  trace_minted_once       one trace id per ticket, constant across
                          every steal/requeue, and never shared by
                          two tickets (re-minting would sever the
                          cross-worker timeline)
  capacity_consistent     fleet.json's advertised capacity agrees
                          with its own worker states (None/-1 shed
                          only with zero fresh workers, else >= 0)
  journal_integrity       the journal parses (one trailing torn line
                          per generation is expected wreckage;
                          anything else is corruption), and disk
                          state implied by it exists (a done record
                          without its terminal event is a lost
                          append)
  resume_consistent       a beam that rode checkpoint resume finishes
                          with candidates BYTE-IDENTICAL to an
                          uninterrupted run: the stub worker's
                          per-pass payloads are a pure function of
                          (ticket, pass), so the terminal record's
                          candidates_digest is recomputed here and
                          compared exactly
  no_pass_rerun           a journaled ``pass_complete`` (the artifact
                          is durable + manifested) is never executed
                          again after a resume — unless that
                          checkpoint was journaled invalid
                          (``checkpoint_invalid``) or checkpointing
                          was disabled (``checkpoint_disabled``),
                          the only legitimate recompute reasons

``verify()`` is the one entry point; ``tail_verify()`` runs the
online subset while a run is still in flight (riding
``journal.read_events(after_offset=)``); ``recovery_stats()``
extracts MTTR from the conductor's journaled kill actions.
"""

from __future__ import annotations

import json
import os
import time

from tpulsar_torch.frontdoor import queue as queue_mod
from tpulsar_torch.obs import journal
from tpulsar_torch.serve import protocol


def _resolve(spool_or_queue):
    """Accept a spool path, a backend URL, or a TicketQueue instance
    and return ``(queue, journal_root)`` — the auditor judges every
    backend against the same list through the backend's own verifier
    surface (``ticket_presence`` / ``read_result`` /
    ``orphan_sweep``), while the journal, fleet.json, and checkpoint
    litter stay physical reads at the journal root."""
    if isinstance(spool_or_queue, queue_mod.TicketQueue):
        q = spool_or_queue
    else:
        q = queue_mod.get_ticket_queue(str(spool_or_queue))
    root = q.journal_root
    if not root:
        raise ValueError(
            f"chaos verify needs a journal-backed queue, not "
            f"{q.backend!r} — the evidence IS the on-disk journal")
    return q, root

#: invariant name -> one-line contract (the JAX package's
#: docs/operations.md renders this table; keep the names stable —
#: they are the report API)
INVARIANTS = {
    "terminal_exactly_once":
        "exactly one terminal 'result' event per submitted ticket",
    "no_lost_ticket":
        "submitted => terminal | quarantined | pending at quiesce | "
        "submit_failed",
    "attempts_monotone":
        "attempts never decrease; takeover k carries attempt k; "
        "quarantine only at the cap",
    "result_before_release":
        "terminal ends the chain; durable done/ record backs it; "
        "nothing both done and in-flight at quiesce",
    "no_orphan_sidefiles":
        "no .claiming/.takeover/.tmp transients survive quiesce",
    "tenant_quota":
        "reconstructed per-tenant inflight never exceeds "
        "max_inflight at any journal instant",
    "trace_minted_once":
        "one trace id per ticket, constant across steals, unique "
        "across tickets",
    "capacity_consistent":
        "advertised fleet capacity matches worker freshness "
        "(shed only at zero fresh workers)",
    "journal_integrity":
        "journal parses (single torn tail per generation tolerated; "
        "a kill between durable result and journal append is a "
        "counted gap, not a violation) and chains start at "
        "submission",
    "resume_consistent":
        "a resumed beam's terminal candidates_digest equals the "
        "uninterrupted golden run's (byte-identical science)",
    "no_pass_rerun":
        "journaled pass completions are never re-executed after "
        "resume (checkpoint_invalid/_disabled are the only excuses)",
    "scaling_bounded":
        "autoscaler worker counts stay within the journaled "
        "[min, max] band, every scale event's arithmetic is "
        "consistent, and consecutive scale events respect the "
        "cooldown (no capacity thrash)",
    "no_elastic_strike":
        "autoscaler-initiated preemptions never advance a ticket "
        "toward quarantine: no takeover (strike) ever names a "
        "journaled scale-down victim's pid as the dead owner",
    "alert_no_missed":
        "every injected fault class that crossed its mapped rule's "
        "threshold raised that health alert within its detection "
        "window (judged only when a health doctor ran)",
    "alert_no_false":
        "every fired health alert is explained by an injected fault "
        "class; a clean run fires none",
    "blob_durable":
        "every artifact digest a done result names re-hashes clean "
        "in the CAS (verify-after-write held end to end)",
    "index_consistent":
        "every indexed ticket's candidate rows are byte-identical "
        "to a fresh parse of its outdir, and every done beam with "
        "candidates is indexed",
    "no_lost_chunk":
        "every closed stream session acknowledges each seq in "
        "[0, n_chunks) exactly once — as a chunk_received or a "
        "zero-filled chunk_gap, never both, never neither",
    "trigger_latency_bounded":
        "every acknowledged stream chunk was searched within the "
        "session's journaled per-chunk latency SLO (ingest-to-"
        "searched, kills and resumes included)",
}

#: events that RELEASE a claim (close an inflight interval) — drawn
#: from the journal's exported vocabulary (the assert below pins it),
#: so a new event type cannot ship without verifier awareness
_RELEASES = ("takeover", "drain_requeue", "quarantined",
             journal.TERMINAL_EVENT)
assert set(_RELEASES) <= set(journal.EVENTS)


def _v(invariant: str, ticket: str = "", detail: str = "") -> dict:
    return {"invariant": invariant, "ticket": ticket,
            "detail": detail}


def _ticket_tenant(events: list[dict]) -> str:
    for ev in events:
        t = ev.get("tenant")
        if t:
            return t
    return "default"




def _audit_chain(tid: str, events: list[dict], presence: dict,
                 max_attempts: int, quiesced: bool,
                 done_rec: dict | None = None) -> list[dict]:
    """The per-ticket audits (everything except the cross-ticket
    quota/trace/sidefile/capacity sweeps).  ``done_rec`` (the durable
    result record, when the caller has it) enables the
    resume_consistent digest check; the live tail passes None and
    leaves that to the final full verify."""
    out: list[dict] = []
    names = [e.get("event") for e in events]
    out.extend(_audit_checkpoints(tid, events, done_rec))

    if "submit_failed" in names:
        extra = [n for n in names if n not in
                 ("received", "submitted", "submit_failed")]
        if extra:
            out.append(_v("no_lost_ticket", tid,
                          f"events after a failed submission: "
                          f"{extra}"))
        return out
    if "submitted" not in names:
        # a gateway-edge 'received' whose process died before the
        # spool write: an accounted near-miss, not a lost beam —
        # unless something DID happen to a ticket never submitted
        if set(names) - {"received"}:
            out.append(_v("journal_integrity", tid,
                          f"chain without 'submitted': {names}"))
        return out

    terminals = [i for i, e in enumerate(events)
                 if e.get("event") == journal.TERMINAL_EVENT]
    if len(terminals) > 1:
        out.append(_v("terminal_exactly_once", tid,
                      f"{len(terminals)} terminal result events"))
    elif len(terminals) == 1 and terminals[0] != len(events) - 1:
        tail = [e.get("event") for e in events[terminals[0] + 1:]]
        out.append(_v("result_before_release", tid,
                      f"events after the terminal: {tail}"))
    if not terminals:
        # presence["done"] with no terminal event is NOT a violation:
        # the journal is observational, appended AFTER the durable
        # result — a SIGKILL (or journal.append fault) in that window
        # loses only the evidence, and the spool truth fills the gap.
        # verify() counts these as journal_gaps.
        if not presence["done"] and quiesced \
                and not (presence["incoming"]
                         or presence["claimed"]
                         or presence["quarantine"]):
            out.append(_v("no_lost_ticket", tid,
                          "no terminal event and no spool presence "
                          f"(chain: {names})"))
    else:
        if not presence["done"]:
            out.append(_v("result_before_release", tid,
                          "terminal event without a durable done/ "
                          "record"))
        if quiesced and (presence["incoming"] or presence["claimed"]):
            where = [s for s in ("incoming", "claimed")
                     if presence[s]]
            out.append(_v("result_before_release", tid,
                          f"terminal ticket still present in "
                          f"{where} after quiesce"))

    # ---- attempts discipline
    claims = [e for e in events if e.get("event") == "claimed"]
    takeovers = [e for e in events if e.get("event") == "takeover"]
    quarantine = next((e for e in events
                       if e.get("event") == "quarantined"), None)
    c_atts = [int(e.get("attempt", 0)) for e in claims]
    t_atts = sorted(int(e.get("attempt", 0)) for e in takeovers)
    if any(b < a for a, b in zip(c_atts, c_atts[1:])):
        out.append(_v("attempts_monotone", tid,
                      f"claim attempts decreased: {c_atts}"))
    if t_atts != list(range(1, len(t_atts) + 1)):
        out.append(_v("attempts_monotone", tid,
                      f"takeover strikes not consecutive +1: "
                      f"{t_atts}"))
    if c_atts and max(c_atts) > len(t_atts):
        out.append(_v("attempts_monotone", tid,
                      f"claim attempt {max(c_atts)} exceeds "
                      f"{len(t_atts)} recorded takeover(s)"))
    if quarantine is not None:
        q_att = int(quarantine.get("attempt", 0))
        cap = int(quarantine.get("max_attempts", max_attempts))
        if q_att < cap:
            out.append(_v("attempts_monotone", tid,
                          f"quarantined at attempt {q_att}, below "
                          f"the cap {cap}"))
    if len(terminals) == 1:
        term = events[terminals[0]]
        term_att = int(term.get("attempt", 0))
        if quarantine is not None:
            expect = int(quarantine.get("attempt", 0))
        elif c_atts:
            expect = c_atts[-1]
        else:
            out.append(_v("attempts_monotone", tid,
                          "terminal result without any claim or "
                          "quarantine"))
            expect = term_att
        if term_att != expect:
            out.append(_v("attempts_monotone", tid,
                          f"terminal attempt {term_att} != expected "
                          f"{expect}"))
    return out


def _audit_checkpoints(tid: str, events: list[dict],
                       done_rec: dict | None) -> list[dict]:
    """The checkpoint-resume discipline of one chain.

    no_pass_rerun: replay the chain tracking which passes are
    journaled durable; a second ``pass_complete`` for the same pass
    is a violation unless its checkpoint was journaled invalid in
    between (``checkpoint_invalid`` scope=entry names the pass;
    scope=manifest wipes everything) or checkpointing was disabled
    for a later attempt (``checkpoint_disabled`` — from-zero re-runs
    are then expected, not a bug).

    resume_consistent: the stub worker's science is a pure function
    of (ticket, pass index), so the uninterrupted golden digest is
    recomputable right here — a terminal ``done`` record carrying
    ``candidates_digest`` + ``passes`` must match it whether or not
    the beam was ever interrupted."""
    out: list[dict] = []
    completed: set[int] = set()
    excused = False
    for ev in events:
        name = ev.get("event")
        if name == "checkpoint_disabled":
            excused = True
        elif name == "checkpoint_invalid":
            if ev.get("scope") == "manifest":
                completed.clear()
            else:
                key = str(ev.get("key", ""))
                if key.startswith("pass_"):
                    try:
                        completed.discard(int(key[len("pass_"):]))
                    except ValueError:
                        pass
        elif name == "pass_complete":
            k = int(ev.get("pass_idx", -1))
            if k in completed and not excused:
                out.append(_v(
                    "no_pass_rerun", tid,
                    f"pass {k} journaled complete twice with no "
                    f"checkpoint_invalid between (worker "
                    f"{ev.get('worker', '?')}, attempt "
                    f"{ev.get('attempt', 0)})"))
            completed.add(k)
    if done_rec and done_rec.get("status") == "done":
        digest = done_rec.get("candidates_digest")
        npasses = done_rec.get("passes")
        if digest and npasses:
            from tpulsar_torch.chaos import worker as chaos_worker
            want = chaos_worker.expected_digest(tid, int(npasses))
            if digest != want:
                resumed = any(e.get("event") == "resume"
                              for e in events)
                out.append(_v(
                    "resume_consistent", tid,
                    f"terminal candidates_digest {digest[:12]} != "
                    f"uninterrupted golden {want[:12]}"
                    + (" (chain resumed from checkpoints)"
                       if resumed else "")))
    return out


def _checkpoint_litter_sweep(per_ticket: dict[str, list[dict]]
                             ) -> list[dict]:
    """Extend no_orphan_sidefiles over checkpoint/stage-in temp
    files: a kill during ``checkpoint.write`` leaves ``*.tmp`` inside
    a beam's ``.checkpoint`` dir — the next resume sweeps it,
    quarantine removes the dir, completion cleans it, so whatever
    remains at quiesce leaked past every janitor.  Outdirs are
    learned from the journal's submitted events (no side channel)."""
    from tpulsar_torch import checkpoint as ckpt

    out: list[dict] = []
    seen: set[str] = set()
    for tid, evs in sorted(per_ticket.items()):
        outdir = next((e.get("outdir") for e in evs
                       if e.get("outdir")), "")
        if not outdir or outdir in seen:
            continue
        seen.add(outdir)
        for d in (ckpt.default_root(outdir), outdir):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if name.endswith(".tmp"):
                    out.append(_v(
                        "no_orphan_sidefiles", tid,
                        f"{os.path.join(d, name)} survived quiesce"))
    return out


def _quota_sweep(per_ticket: dict[str, list[dict]],
                 done_recs: dict[str, dict],
                 tenants: dict) -> list[dict]:
    """Reconstruct per-tenant inflight from claim/release instants
    and flag any instant above ``max_inflight``.  A result's release
    instant is the done record's ``finished_at`` when available: the
    claim file is unlinked BETWEEN the durable write and the journal
    append, so the event timestamp alone would overcount a tenant
    whose next claim squeezed into that gap."""
    caps = {}
    for name, spec in (tenants or {}).items():
        cap = int((spec or {}).get("max_inflight", 0))
        if cap > 0:
            caps[name] = cap
    if not caps:
        return []
    points: list[tuple[float, int, str, str]] = []
    for tid, events in per_ticket.items():
        tenant = _ticket_tenant(events)
        if tenant not in caps:
            continue
        open_t = None
        for ev in events:
            name = ev.get("event")
            if name == "claimed":
                if open_t is None:
                    open_t = ev.get("t", 0.0)
            elif name in _RELEASES and open_t is not None:
                end = ev.get("t", 0.0)
                if name == journal.TERMINAL_EVENT:
                    fin = (done_recs.get(tid) or {}).get("finished_at")
                    if fin:
                        end = min(end, float(fin))
                points.append((open_t, +1, tenant, tid))
                points.append((end, -1, tenant, tid))
                open_t = None
        if open_t is not None:        # still claimed at audit time
            points.append((open_t, +1, tenant, tid))
    # releases sort before acquires at the same instant: a handoff at
    # one timestamp is a handoff, not a double-occupancy
    points.sort(key=lambda p: (p[0], p[1]))
    out, inflight = [], {}
    flagged = set()
    for t, delta, tenant, tid in points:
        n = inflight.get(tenant, 0) + delta
        inflight[tenant] = n
        if delta > 0 and n > caps[tenant] and tenant not in flagged:
            flagged.add(tenant)
            out.append(_v("tenant_quota", tid,
                          f"tenant {tenant!r} reached {n} inflight "
                          f"(max_inflight {caps[tenant]}) at "
                          f"t={t:.3f}"))
    return out


#: slack for the cooldown audit: the scale event is journaled after
#: the action executes (spawns take milliseconds), while the cooldown
#: clock is armed from the decision's signal-read instant — real
#: thrash shows deltas far BELOW the cooldown, not within this slop
_COOLDOWN_SLACK_S = 0.5


def _elastic_sweep(events: list[dict]) -> list[dict]:
    """The autoscaler's contract, replayed from the journal alone.

    scaling_bounded: every ``scale_up``/``scale_down`` event carries
    its own policy bounds (min/max/cooldown) and before/after counts
    — self-contained evidence.  Checked: the after-count stays inside
    [min, max], the arithmetic is consistent (after = before ± n),
    and consecutive scale events are at least the cooldown apart.

    no_elastic_strike: a ``scale_down`` event names its victims
    (worker, pid) — the controller wrote the elective-kill ledger
    BEFORE the signal, so a janitor must reclaim those pids' claims
    attempt-neutrally (``drain_requeue`` reason ``scale_down``).  A
    ``takeover`` naming an elective victim as its dead owner means
    elasticity charged a beam a crash strike toward quarantine."""
    out: list[dict] = []
    scale = [e for e in events
             if e.get("event") in ("scale_up", "scale_down")]
    prev = None
    for ev in scale:
        name = ev.get("event")
        before = ev.get("workers_before")
        after = ev.get("workers_after")
        lo, hi = ev.get("min_workers"), ev.get("max_workers")
        n = int(ev.get("n", 1))
        if None in (before, after, lo, hi):
            out.append(_v("scaling_bounded", "",
                          f"{name} event missing its policy "
                          f"evidence (before/after/min/max): {ev}"))
            continue
        if not lo <= after <= hi:
            out.append(_v("scaling_bounded", "",
                          f"{name} left {after} worker(s), outside "
                          f"[{lo}, {hi}]"))
        want = before + n if name == "scale_up" else before - n
        if after != want:
            out.append(_v("scaling_bounded", "",
                          f"{name} arithmetic: {before} "
                          f"{'+' if name == 'scale_up' else '-'}{n} "
                          f"!= {after}"))
        if prev is not None:
            gap = ev.get("t", 0.0) - prev.get("t", 0.0)
            cool = float(ev.get("cooldown_s", 0.0))
            if gap + _COOLDOWN_SLACK_S < cool:
                out.append(_v(
                    "scaling_bounded", "",
                    f"{prev.get('event')} -> {name} only "
                    f"{gap:.2f} s apart (cooldown {cool:g} s): "
                    f"capacity thrash"))
        prev = ev
    # elective victims: (worker, pid) -> kill instant — the PAIR,
    # exactly as the janitor's verdict matches the ledger (a pid
    # alone can be recycled into another worker's incarnation, whose
    # genuine crash strike must not read as an elastic one)
    victims: dict[tuple[str, int], float] = {}
    for ev in scale:
        if ev.get("event") != "scale_down":
            continue
        for v in ev.get("victims") or ():
            pid = v.get("pid")
            if pid:
                victims[(str(v.get("worker", "")), int(pid))] = \
                    ev.get("t", 0.0)
    if victims:
        for ev in events:
            if ev.get("event") != "takeover":
                continue
            try:
                pair = (str(ev.get("from_worker", "")),
                        int(ev.get("from_pid") or 0))
            except (TypeError, ValueError):
                continue
            t_kill = victims.get(pair)
            if t_kill is not None and ev.get("t", 0.0) >= t_kill:
                out.append(_v(
                    "no_elastic_strike", ev.get("ticket", ""),
                    f"takeover charged attempt "
                    f"{ev.get('attempt')} against pid {pair[1]} "
                    f"(worker {pair[0] or '?'}) — a journaled "
                    f"scale-down victim: an elective preemption "
                    f"advanced this beam toward quarantine"))
    return out


#: detection-deadline slack for alert_no_missed: the detector ticks
#: on its interval and the journal append races the storm's end; real
#: misses are alerts that NEVER fire, not ones a few seconds past the
#: arithmetic deadline
_ALERT_SLACK_S = 30.0


def _injected_classes(events: list[dict],
                      root: str) -> dict[str, list[float]]:
    """Every fault class this run injected, with the absolute
    instants it struck: ``action:<name>`` per conductor-journaled
    ``chaos_action``, ``fault:<point>`` per armed schedule-file
    window (``set_faults`` never journals a chaos_action — the
    windows open inside the workers), and
    ``action:worker_crash_arg`` when the run's worker command line
    carried a deterministic crash knob."""
    from tpulsar_torch.chaos import scenario as scenario_mod
    from tpulsar_torch.resilience import faults

    classes: dict[str, list[float]] = {}

    def note(cls: str, t) -> None:
        classes.setdefault(cls, []).append(float(t or 0.0))

    for ev in events:
        name = ev.get("event")
        if name == "chaos_action":
            note(f"action:{ev.get('action', '')}", ev.get("t"))
        elif name == "chaos_run_start":
            if any("crash" in str(a)
                   for a in ev.get("worker_args") or ()):
                note("action:worker_crash_arg", ev.get("t"))
    sched = protocol._read_json(scenario_mod.schedule_path(root))
    t0 = float((sched or {}).get("t0", 0.0))
    for entry in (sched or {}).get("entries") or ():
        try:
            specs = faults.parse_spec(str(entry.get("faults", "")))
        except ValueError:
            continue        # the workers refused it too — not armed
        for point in specs:
            note(f"fault:{point}",
                 t0 + float(entry.get("at", 0.0)))
    return {cls: sorted(ts) for cls, ts in classes.items()}


def _alert_sweep(events: list[dict], root: str) -> list[dict]:
    """The alert-fidelity contract of the health doctor, judged from
    the same journal the alerts were appended to.

    alert_no_false: every ``alert_fired`` rule must be in the union
    of :func:`tpulsar.obs.alerts.allowed_rules` over the run's
    injected fault classes — with NOTHING injected, any alert at all
    is a false alarm.

    alert_no_missed: for each injected class with an entry in
    ``alerts.EXPECTED_ALERTS`` whose occurrence count reached that
    entry's ``min_count``, at least one of its mapped rules must have
    fired, no later than the threshold instant plus the widest mapped
    rule's ``window_s + for_s`` plus slack.  Judged ONLY when a
    health doctor actually ran (``alerts.json`` exists at the
    journal root): a doctor-less storm has nobody to fire alerts and
    proves nothing about detection."""
    from tpulsar_torch.obs import alerts as alerts_mod, health

    out: list[dict] = []
    fired = [e for e in events if e.get("event") == "alert_fired"]
    classes = _injected_classes(events, root)

    allowed: set[str] = set()
    for cls in classes:
        allowed.update(alerts_mod.allowed_rules(cls))
    for ev in fired:
        rule = str(ev.get("rule", ""))
        if rule not in allowed:
            out.append(_v(
                "alert_no_false", "",
                f"alert {rule!r} fired with no injected fault class "
                f"allowing it (injected: "
                f"{sorted(classes) or 'none'})"))

    if not os.path.exists(health.alerts_path(root)):
        return out
    by_rule = {r.id: r for r in alerts_mod.builtin_rules()}
    first_fired: dict[str, float] = {}
    for ev in fired:
        first_fired.setdefault(str(ev.get("rule", "")),
                               float(ev.get("t", 0.0)))
    for cls, expect in sorted(alerts_mod.EXPECTED_ALERTS.items()):
        times = classes.get(cls) or []
        need = int(expect.get("min_count", 1))
        if len(times) < need:
            continue
        t_reached = times[need - 1]
        rules = tuple(expect.get("rules", ()))
        budget = max((by_rule[r].window_s + by_rule[r].for_s
                      for r in rules if r in by_rule),
                     default=0.0) + _ALERT_SLACK_S
        hits = [first_fired[r] for r in rules if r in first_fired]
        if not hits:
            out.append(_v(
                "alert_no_missed", "",
                f"{cls} struck {len(times)}x (>= threshold {need}) "
                f"but none of {list(rules)} ever fired"))
        elif min(hits) > t_reached + budget:
            out.append(_v(
                "alert_no_missed", "",
                f"{cls}: earliest mapped alert fired "
                f"{min(hits) - t_reached:.1f} s after the threshold "
                f"instant (detection budget {budget:.0f} s)"))
    return out


def _dataplane_sweep(root: str,
                     done_recs: dict[str, dict]) -> list[dict]:
    """The data plane's two contracts, judged from disk.

    blob_durable: every artifact digest a done result record names
    must exist in the CAS at the journal root and RE-HASH to its
    address (``BlobStore.verify`` — the verify-after-write promise,
    audited after the storm instead of trusted).

    index_consistent: the candidate index is a cache of the sifted
    truth — each indexed ticket's rows must equal a fresh legacy
    parse of its outdir, and every done ticket that produced
    .accelcands must be present in the index (a worker that wrote a
    result without its index rows broke the same-durable-step
    contract).  Both judgments arm themselves only when the run left
    a CAS / index behind — a plain storm proves nothing here."""
    import glob as globmod

    out: list[dict] = []
    from tpulsar_torch.dataplane import blobstore
    blob_root = blobstore.default_blob_root(root)
    if blob_root and os.path.isdir(blob_root):
        store = blobstore.BlobStore(blob_root)
        for tid, rec in sorted(done_recs.items()):
            for name, digest in sorted(
                    (rec.get("artifacts") or {}).items()):
                try:
                    ok = store.verify(str(digest))
                except (ValueError, OSError) as e:
                    ok = False
                    name = f"{name} ({e})"
                if not ok:
                    out.append(_v(
                        "blob_durable", tid,
                        f"artifact {name} {str(digest)[:12]}.. "
                        f"absent or corrupt in {blob_root}"))

    from tpulsar_torch.dataplane import index as dp_index
    ipath = dp_index.index_path(root)
    if not os.path.exists(ipath):
        return out
    idx = dp_index.CandidateIndex(ipath)
    try:
        indexed = set(idx.tickets())
        for tid in sorted(indexed):
            row = idx.result_row(tid) or {}
            outdir = row.get("outdir", "")
            if not outdir or not os.path.isdir(outdir):
                continue        # results moved/cleaned: nothing to
            want = dp_index.candidate_rows(outdir)   # compare against
            got = idx.candidate_rows(tid)
            if got != want:
                out.append(_v(
                    "index_consistent", tid,
                    f"index rows ({len(got)}) differ from the "
                    f"outdir parse ({len(want)})"))
        for tid, rec in sorted(done_recs.items()):
            if rec.get("status") != "done" or tid in indexed:
                continue
            outdir = rec.get("outdir", "")
            if outdir and globmod.glob(
                    os.path.join(outdir, "*.accelcands")):
                out.append(_v(
                    "index_consistent", tid,
                    "done ticket with .accelcands artifacts has no "
                    "index entry (result written without its index "
                    "rows)"))
    except (OSError, dp_index.IndexCorrupt) as e:
        out.append(_v("index_consistent", "",
                      f"index unreadable: {e}"))
    finally:
        idx.close()
    return out


def _stream_sweep(per_ticket: dict[str, list[dict]]) -> list[dict]:
    """The streaming plane's two contracts, judged per session chain.

    no_lost_chunk arms itself on any chain with a ``stream_closed``
    event: a drained session must account for every seq in
    [0, n_chunks) exactly once — acknowledged as a ``chunk_received``
    or declared a zero-filled ``chunk_gap``, never both, never a
    duplicate, never a seq outside the window.  A kill between the
    journal append and the checkpoint may REPLAY a chunk (the worker
    journals ``replayed``, not a second ack), so double-acks are
    real exactly-once violations, not kill-window noise.

    trigger_latency_bounded is judged on every chain with stream
    acks, closed or not: each ``chunk_received`` carries the
    ingest-to-searched ``latency_s`` and the session's ``slo_s`` —
    the bounded-latency promise the trigger mode exists for, with
    kills, takeovers, and resumes inside the budget."""
    out: list[dict] = []
    for tid, evs in sorted(per_ticket.items()):
        recv: dict[int, int] = {}
        gaps: dict[int, int] = {}
        closed_n: int | None = None
        for ev in evs:
            name = ev.get("event")
            if name == "chunk_received":
                seq = int(ev.get("seq", -1))
                recv[seq] = recv.get(seq, 0) + 1
                lat, slo = ev.get("latency_s"), ev.get("slo_s")
                if isinstance(lat, (int, float)) \
                        and not isinstance(lat, bool) \
                        and isinstance(slo, (int, float)) \
                        and not isinstance(slo, bool) and lat > slo:
                    out.append(_v(
                        "trigger_latency_bounded", tid,
                        f"chunk {seq} searched {lat:.3f} s after "
                        f"ingest (SLO {slo:.1f} s)"))
            elif name == "chunk_gap":
                seq = int(ev.get("seq", -1))
                gaps[seq] = gaps.get(seq, 0) + 1
            elif name == "stream_closed":
                closed_n = int(ev.get("n_chunks") or 0)
        if closed_n is None:
            continue        # never drained: nothing to account for
        want = set(range(closed_n))
        have = set(recv) | set(gaps)
        for seq in sorted(want - have):
            out.append(_v(
                "no_lost_chunk", tid,
                f"seq {seq} never acknowledged (no chunk_received, "
                f"no chunk_gap) in a closed {closed_n}-chunk "
                f"session"))
        for seq in sorted(have - want):
            out.append(_v("no_lost_chunk", tid,
                          f"acknowledged seq {seq} outside "
                          f"[0, {closed_n})"))
        for seq in sorted(set(recv) & set(gaps)):
            out.append(_v("no_lost_chunk", tid,
                          f"seq {seq} both received and declared a "
                          f"gap"))
        for seq, n in sorted(recv.items()):
            if n > 1:
                out.append(_v("no_lost_chunk", tid,
                              f"seq {seq} acknowledged {n}x "
                              f"(chunk_received is exactly-once)"))
        for seq, n in sorted(gaps.items()):
            if n > 1:
                out.append(_v("no_lost_chunk", tid,
                              f"seq {seq} declared a gap {n}x"))
    return out


def _sidefile_sweep(q) -> list[dict]:
    # the backend's own accounting of transaction transients: the
    # spool reports surviving .tmp/.claiming/.takeover side-files,
    # the sqlite backend has none by construction
    return [_v("no_orphan_sidefiles", o.get("ticket", ""),
               f"{o.get('state', '?')}/{o.get('name', '?')} "
               f"survived quiesce")
            for o in q.orphan_sweep()]


def _capacity_check(spool: str) -> list[dict]:
    rec = protocol._read_json(os.path.join(spool, "fleet.json"))
    if rec is None:
        return []
    cap = rec.get("capacity")
    fresh = [w["id"] for w in rec.get("workers", ())
             if w.get("state") == "fresh"]
    external = rec.get("external_workers") or []
    if cap is None:
        if fresh and not external:
            return [_v("capacity_consistent", "",
                       f"capacity advertised as load-shed (None/-1) "
                       f"with fresh worker(s) {fresh} in the same "
                       f"snapshot")]
    elif cap < 0:
        return [_v("capacity_consistent", "",
                   f"negative non-shed capacity {cap}")]
    return []


def verify(spool: str, *, tenants: dict | None = None,
           max_attempts: int = protocol.DEFAULT_MAX_ATTEMPTS,
           quiesced: bool = True) -> dict:
    """Run every invariant over the queue's journal + state.

    ``spool`` is a spool path, a backend URL (``sqlite:<path>``), or
    a TicketQueue instance — state questions go through the backend's
    verifier surface, so every backend is judged against exactly this
    list.  ``quiesced=False`` (a live or aborted run) skips the
    judgments that only hold after drain: lost-ticket (it may still
    be in flight), leftover side-files, and done-but-still-claimed.
    Returns ``{"ok", "violations", "invariants", "checked"}``."""
    q, root = _resolve(spool)
    bad_lines: list = []
    violations: list[dict] = []
    events = journal.read_events(root, bad_lines=bad_lines)
    for bad in bad_lines:
        violations.append(_v(
            "journal_integrity", "",
            f"unparseable mid-file line {bad['line']} of "
            f"{os.path.basename(bad['path'])}: {bad['text'][:80]!r}"))
    per_ticket = journal.iter_tickets(events)
    done_recs = {tid: q.read_result(tid) or {}
                 for tid in per_ticket}

    traces: dict[str, set] = {}
    counts = {"tickets": len(per_ticket), "events": len(events),
              "terminal": 0, "pending_at_quiesce": 0,
              "submit_failed": 0, "takeovers": 0, "quarantined": 0,
              "resumes": 0, "journal_gaps": 0,
              "scale_ups": sum(1 for e in events
                               if e.get("event") == "scale_up"),
              "scale_downs": sum(1 for e in events
                                 if e.get("event") == "scale_down"),
              "alerts_fired": sum(1 for e in events
                                  if e.get("event") == "alert_fired")}
    for tid, evs in sorted(per_ticket.items()):
        presence = q.ticket_presence(tid)
        violations.extend(_audit_chain(tid, evs, presence,
                                       max_attempts, quiesced,
                                       done_rec=done_recs.get(tid)))
        names = [e.get("event") for e in evs]
        if journal.TERMINAL_EVENT in names:
            counts["terminal"] += 1
        elif "submit_failed" in names:
            counts["submit_failed"] += 1
        elif presence["done"]:
            # terminal on disk, evidence lost in the kill window —
            # see _audit_chain; surfaced here so a run with gaps is
            # visibly different from one without
            counts["terminal"] += 1
            counts["journal_gaps"] += 1
        elif presence["incoming"] or presence["claimed"]:
            counts["pending_at_quiesce"] += 1
        counts["takeovers"] += names.count("takeover")
        counts["quarantined"] += names.count("quarantined")
        counts["resumes"] += names.count("resume")
        ids = {e["trace_id"] for e in evs if e.get("trace_id")}
        if len(ids) > 1:
            violations.append(_v(
                "trace_minted_once", tid,
                f"{len(ids)} distinct trace ids in one chain: "
                f"{sorted(ids)}"))
        elif not ids and "submitted" in names:
            violations.append(_v("trace_minted_once", tid,
                                 "no trace id anywhere in the chain"))
        for tr in ids:
            traces.setdefault(tr, set()).add(tid)
    for tr, tids in sorted(traces.items()):
        if len(tids) > 1:
            violations.append(_v(
                "trace_minted_once", ",".join(sorted(tids)),
                f"trace id {tr} shared by {len(tids)} tickets"))

    violations.extend(_quota_sweep(per_ticket, done_recs, tenants))
    violations.extend(_elastic_sweep(events))
    violations.extend(_alert_sweep(events, root))
    if quiesced:
        violations.extend(_sidefile_sweep(q))
        violations.extend(_checkpoint_litter_sweep(per_ticket))
    violations.extend(_capacity_check(root))
    violations.extend(_dataplane_sweep(root, done_recs))
    violations.extend(_stream_sweep(per_ticket))

    by_inv = {name: 0 for name in INVARIANTS}
    for v in violations:
        by_inv[v["invariant"]] = by_inv.get(v["invariant"], 0) + 1
    return {"ok": not violations, "violations": violations,
            "invariants": by_inv, "checked": counts,
            "spool": root, "quiesced": quiesced}


# ------------------------------------------------------------ live tail

def tail_verify(spool: str, *, tenants: dict | None = None,
                max_attempts: int = protocol.DEFAULT_MAX_ATTEMPTS,
                poll_s: float = 0.5, timeout_s: float = 0.0,
                echo=print, _stop=None) -> dict:
    """Follow the journal by offset and audit incrementally: chain,
    trace, and quota violations are reported the moment the evidence
    lands, not at the post-mortem.  Ends at a ``chaos_run_end``
    event, the optional timeout, Ctrl-C — or ``_stop()`` returning
    True (tests) — then runs one full ``verify`` (quiesced iff the
    run announced its end) and returns its report."""
    q, root = _resolve(spool)
    offset = 0
    seen: set[tuple] = set()
    ended = False
    per_ticket: dict[str, list[dict]] = {}
    traces: dict[str, set] = {}
    deadline = time.time() + timeout_s if timeout_s else None

    def _report(v: dict) -> None:
        key = (v["invariant"], v["ticket"], v["detail"])
        if key not in seen:
            seen.add(key)
            echo(f"[{v['invariant']}] {v['ticket'] or '-'}: "
                 f"{v['detail']}")

    try:
        while True:
            try:
                new, offset = journal.read_events(
                    root, after_offset=offset)
            except journal.JournalCorrupt as e:
                echo(f"[journal_integrity] {e}")
                break
            # incremental: only the chains the new batch touched are
            # re-audited — the poll cost is O(new events), not a full
            # journal replay per batch (cross-ticket sweeps like the
            # quota reconstruction wait for the final full verify)
            touched: set[str] = set()
            for ev in new:
                if ev.get("event") == "chaos_run_end":
                    ended = True
                tid = ev.get("ticket")
                if tid:
                    per_ticket.setdefault(tid, []).append(ev)
                    touched.add(tid)
            for tid in sorted(touched):
                evs = per_ticket[tid]
                presence = q.ticket_presence(tid)
                for v in _audit_chain(tid, evs, presence,
                                      max_attempts, quiesced=False):
                    _report(v)
                ids = {e["trace_id"] for e in evs
                       if e.get("trace_id")}
                if len(ids) > 1:
                    _report(_v("trace_minted_once", tid,
                               f"{len(ids)} distinct trace ids in "
                               f"one chain: {sorted(ids)}"))
                for tr in ids:
                    tids = traces.setdefault(tr, set())
                    tids.add(tid)
                    if len(tids) > 1:
                        _report(_v(
                            "trace_minted_once",
                            ",".join(sorted(tids)),
                            f"trace id {tr} shared by "
                            f"{len(tids)} tickets"))
            if ended or (deadline and time.time() >= deadline) \
                    or (_stop is not None and _stop()):
                break
            time.sleep(poll_s)
    except KeyboardInterrupt:
        pass
    return verify(q, tenants=tenants, max_attempts=max_attempts,
                  quiesced=ended)


# --------------------------------------------------------- MTTR / report

def recovery_stats(events: list[dict]) -> dict:
    """Recovery timing extracted from the journal alone: for every
    conductor-journaled worker kill, the victims are the tickets that
    worker held at the kill instant — MTTR is kill -> their terminal
    event (takeover latency is the janitor's share of it).

    ``wasted_compute_s`` is the checkpoint layer's headline: per
    victim, the compute the kill destroyed — (kill instant - that
    attempt's ``search_start``) minus what the NEXT attempt's
    ``resume`` salvaged.  Salvage is measured in WALL TIME from the
    victim attempt's own journaled ``pass_complete`` instants (the
    n-th durable pass, n = the resume event's ``passes_done``): the
    resumed attempt skips the dead worker's compute AND its
    checkpoint-write overhead, so both count as saved.  Falls back to
    the resume event's nominal ``salvaged_s`` when the chain carries
    no pass timestamps.  A from-zero control run journals no resume,
    so its whole spent interval is waste.  Summed across victims and
    kills."""
    per_ticket = journal.iter_tickets(events)
    kills = [e for e in events
             if e.get("event") == "chaos_action"
             and e.get("action") == "kill_worker"]
    out = {"kills": [], "mttr_s": None, "takeover_latency_s": None,
           "wasted_compute_s": None}
    for kill in kills:
        w, t_kill = kill.get("worker", ""), kill.get("t", 0.0)
        victims = []
        for tid, evs in per_ticket.items():
            holder, held_since, started = None, None, None
            for ev in evs:
                if ev.get("t", 0.0) > t_kill:
                    break
                name = ev.get("event")
                if name == "claimed":
                    holder = ev.get("worker", "")
                    held_since = ev.get("t")
                    started = None
                elif name == "search_start":
                    started = ev.get("t")
                elif name in _RELEASES:
                    holder = None
                    started = None
            if holder != w:
                continue
            term = next((e for e in evs
                         if e.get("event") == journal.TERMINAL_EVENT
                         and e.get("t", 0.0) >= t_kill), None)
            steal = next((e for e in evs
                          if e.get("event") == "takeover"
                          and e.get("t", 0.0) >= t_kill), None)
            resume = next((e for e in evs
                           if e.get("event") == "resume"
                           and e.get("t", 0.0) >= t_kill), None)
            spent = (round(t_kill - started, 3)
                     if started is not None else None)
            salvaged = 0.0
            if resume is not None:
                n = int(resume.get("passes_done", 0))
                pcs = [e.get("t", 0.0) for e in evs
                       if e.get("event") == "pass_complete"
                       and started is not None
                       and started <= e.get("t", 0.0) <= t_kill]
                if pcs and n:
                    salvaged = pcs[min(n, len(pcs)) - 1] - started
                else:
                    salvaged = float(resume.get("salvaged_s", 0.0))
            victims.append({
                "ticket": tid, "held_since": held_since,
                "takeover_s": (round(steal["t"] - t_kill, 3)
                               if steal else None),
                "recovered_s": (round(term["t"] - t_kill, 3)
                                if term else None),
                "spent_s": spent,
                "salvaged_s": round(salvaged, 3),
                "wasted_compute_s": (
                    round(max(0.0, spent - salvaged), 3)
                    if spent is not None else None)})
        rec = {"worker": w, "t": t_kill, "victims": victims}
        done = [v["recovered_s"] for v in victims
                if v["recovered_s"] is not None]
        steals = [v["takeover_s"] for v in victims
                  if v["takeover_s"] is not None]
        wastes = [v["wasted_compute_s"] for v in victims
                  if v["wasted_compute_s"] is not None]
        rec["mttr_s"] = max(done) if done else None
        rec["takeover_latency_s"] = min(steals) if steals else None
        rec["wasted_compute_s"] = (round(sum(wastes), 3)
                                   if wastes else None)
        out["kills"].append(rec)
    mttrs = [k["mttr_s"] for k in out["kills"]
             if k["mttr_s"] is not None]
    lats = [k["takeover_latency_s"] for k in out["kills"]
            if k["takeover_latency_s"] is not None]
    wastes = [k["wasted_compute_s"] for k in out["kills"]
              if k["wasted_compute_s"] is not None]
    if mttrs:
        out["mttr_s"] = max(mttrs)
    if lats:
        out["takeover_latency_s"] = max(lats)
    if wastes:
        out["wasted_compute_s"] = round(sum(wastes), 3)
    return out


def render_verify(report: dict) -> str:
    lines = [f"chaos verify: {report['spool']} "
             f"({'quiesced' if report['quiesced'] else 'LIVE'})"]
    c = report["checked"]
    lines.append(
        f"  {c['tickets']} tickets / {c['events']} events: "
        f"{c['terminal']} terminal, {c['pending_at_quiesce']} "
        f"pending, {c['submit_failed']} submit-failed, "
        f"{c['takeovers']} takeover(s), {c['quarantined']} "
        f"quarantined, {c.get('resumes', 0)} checkpoint resume(s), "
        f"{c['journal_gaps']} journal gap(s), "
        f"{c.get('scale_ups', 0)} scale-up(s) / "
        f"{c.get('scale_downs', 0)} scale-down(s), "
        f"{c.get('alerts_fired', 0)} alert(s) fired")
    width = max(len(n) for n in INVARIANTS)
    for name in INVARIANTS:
        n = report["invariants"].get(name, 0)
        mark = "ok " if n == 0 else "VIOLATED"
        lines.append(f"  [{mark:>8s}] {name:<{width}s} "
                     + (f"({n})" if n else ""))
    for v in report["violations"]:
        lines.append(f"    {v['invariant']}: {v['ticket'] or '-'}: "
                     f"{v['detail']}")
    lines.append("PASS: 0 invariant violations" if report["ok"]
                 else f"FAIL: {len(report['violations'])} "
                      f"violation(s)")
    return "\n".join(lines)


def render_report(spool: str) -> str:
    """The post-run digest: the conductor's manifest, the journal's
    per-status counts, recovery timing, and the invariant verdict.
    A manifest that names a ``queue_url`` routes the verify through
    that backend (a sqlite run's report works from the spool path
    alone)."""
    from tpulsar_torch.chaos import scenario as scenario_mod
    _, spool = _resolve(spool)
    lines = [f"chaos report: {spool}"]
    manifest = protocol._read_json(scenario_mod.run_path(spool))
    if manifest:
        lines.append(
            f"  scenario {manifest.get('scenario', '?')!r} seed "
            f"{manifest.get('seed')} — {manifest.get('status', '?')}"
            f" in {manifest.get('wall_s', 0):.1f} s, "
            f"{len(manifest.get('actions', []))} action(s), "
            f"{len(manifest.get('tickets', []))} beam(s)")
        for a in manifest.get("actions", []):
            lines.append(
                f"    t+{a.get('t', 0):6.2f}  {a.get('action'):16s} "
                f"{a.get('worker', '') or '-':6s} "
                f"{a.get('detail', '')}")
    else:
        lines.append("  (no run manifest — verify-only spool)")
    events = journal.read_events(spool, bad_lines=[])
    summary = journal.summarize(spool)
    lines.append(f"  statuses: {summary['statuses']}  takeovers: "
                 f"{summary['takeovers']}  quarantined: "
                 f"{summary['quarantined']}")
    rec = recovery_stats(events)
    for k in rec["kills"]:
        lines.append(
            f"  kill {k['worker']}: {len(k['victims'])} victim "
            f"beam(s), takeover latency "
            f"{k['takeover_latency_s'] if k['takeover_latency_s'] is not None else '-'} s, "
            f"mttr {k['mttr_s'] if k['mttr_s'] is not None else '-'} s, "
            f"wasted compute "
            f"{k.get('wasted_compute_s') if k.get('wasted_compute_s') is not None else '-'} s")
    tenants = (manifest or {}).get("tenants") or {}
    target = (manifest or {}).get("queue_url") or spool
    report = verify(target, tenants=tenants,
                    quiesced=bool((manifest or {}).get("quiesced",
                                                       True)))
    lines.append(render_verify(report))
    return "\n".join(lines)
