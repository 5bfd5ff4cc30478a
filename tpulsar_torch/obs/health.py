"""The fleet health doctor: detector loop + per-worker flight recorder
— counterpart of tpulsar/obs/health.py (a copy).

Two halves, both consumers of evidence other modules already emit:

**HealthDetector** evaluates the declarative alert pack
(obs/alerts.py) against the live fleet — the journal tailed by byte
offset (or through a TicketQueue backend for ``sqlite:`` fleets),
the merged per-worker metric snapshots fleetview produces, and the
queue backend's fsck surface.  Each tick it journals
``alert_fired``/``alert_resolved`` transitions (self-contained
evidence: rule id, signal value, threshold, window), persists the
active set to ``<root>/alerts.json`` (what the gateway's
``GET /v1/alerts`` and ``doctor`` read), exports
``tpulsar_alerts_active{rule,severity}`` for fleet.prom, and fans
transitions out through the pluggable notifier.  The detector is
hosted by FleetController (every fleet gets one for free) and
standalone via ``python -m tpulsar_torch doctor --watch``.  The files
and events are the JAX package's, so either package's gateway and
doctor read the other's detector.

**FlightRecorder** is the per-worker black box: a bounded in-memory
ring of recent journal appends / heartbeats / claims that is dumped
to ``<spool>/blackbox/<worker>.<pid>.json`` on crash or abnormal
exit — atexit for unexpected interpreter death, explicit ``dump()``
on the fatal paths that bypass atexit (``os._exit`` crash
injection).  The dump write is itself fault-injectable
(``blackbox.dump`` fires mid-write) and the renderer
(``load_blackbox``/``render_blackbox``, the ``obs blackbox`` command)
salvages torn dumps, because a crashing worker can die mid-dump too.

Knobs:
  TPULSAR_ALERT_INTERVAL_S  detector tick period in the controller
  TPULSAR_ALERT_NOTIFY      notifier spec (log | webhook:u | command:c)
  TPULSAR_ALERT_RULES       JSON rules file extending the built-ins
  TPULSAR_BLACKBOX          "0" disables the flight recorder
  TPULSAR_BLACKBOX_RING     ring size (entries kept before death)

stdlib only.
"""

from __future__ import annotations

import atexit
import collections
import glob
import json
import os
import threading
import time

from tpulsar_torch.obs import alerts, fleetview, journal, metrics, telemetry
from tpulsar_torch.resilience import faults
from tpulsar_torch.serve import protocol

ALERTS_FILE = "alerts.json"
BLACKBOX_DIR = "blackbox"

#: how often the detector re-runs the queue backend's fsck (it walks
#: every spool state dir / runs PRAGMA quick_check — too heavy per
#: tick)
FSCK_INTERVAL_S = 30.0


def alert_interval_s() -> float:
    """Detector tick period for hosted loops (controller / --watch);
    <= 0 disables the hosted detector entirely."""
    try:
        return float(os.environ.get("TPULSAR_ALERT_INTERVAL_S", "")
                     or 5.0)
    except ValueError:
        return 5.0


def default_rules() -> tuple:
    """The built-in pack, extended/overridden by the
    TPULSAR_ALERT_RULES JSON file when set (load failures are LOUD —
    a typo'd rules file must not silently revert to defaults)."""
    path = os.environ.get("TPULSAR_ALERT_RULES", "")
    if path:
        return alerts.load_rules(path)
    return alerts.builtin_rules()


def alerts_path(root: str) -> str:
    return os.path.join(root, ALERTS_FILE)


def read_active_alerts(root: str) -> dict | None:
    """The detector's persisted active set (``{"t", "alerts": []}``),
    or None when no detector has ever run on this root — the
    distinction the alert-fidelity invariants gate on."""
    return protocol._read_json(alerts_path(root))


def merged_metrics(spool: str, extra_snapshots: tuple = (),
                   max_age_s: float | None = None) -> dict:
    """The fleet-merged metric snapshot the metric rules read: every
    worker's exported registry (stale workers keep history, lose
    gauges — fleetview's rule) + caller extras (the controller's own
    registry, where fleet_capacity lives).  Unlike
    fleetview.fleet_snapshot this skips the journal-derived SLO
    series: the detector computes its burn rates from the journal
    tail it already holds, so re-summarizing the whole journal per
    tick would be pure overhead."""
    if max_age_s is None:
        max_age_s = protocol.heartbeat_max_age()
    now = time.time()
    snaps = []
    for rec in fleetview.worker_snapshots(spool).values():
        snap = rec.get("metrics") or {}
        if now - rec.get("t", 0.0) > max_age_s:
            snap = fleetview._strip_gauges(snap)
        snaps.append(snap)
    snaps.extend(extra_snapshots)
    return fleetview.merge_snapshots(snaps)


class HealthDetector:
    """The rule-pack evaluation loop.  One instance per watching
    process; ``tick()`` is cheap enough for the controller's main
    loop.

    ``root``   journal root: where events are read from (when no
               ``queue`` routes them) and where alert transitions
               are journaled + ``alerts.json`` persisted.
    ``queue``  optional TicketQueue: event reads, alert journaling,
               and fsck go through the backend (the ``sqlite:``
               path); the filesystem root is then
               ``queue.journal_root``.
    ``spool``  where worker metric snapshots live (defaults to root).
    """

    def __init__(self, root: str, queue=None, spool: str | None = None,
                 rules: tuple | None = None, notifier=None,
                 extra_snapshots=None,
                 persist: bool = True, journal_events: bool = True,
                 notify: bool = True):
        if queue is not None and queue.journal_root:
            root = root or queue.journal_root
        if not root:
            raise ValueError(
                "HealthDetector needs a journal root (a spool dir, "
                "or a queue backend with a journal_root)")
        self.root = root
        self.queue = queue
        self.spool = spool if spool is not None else root
        self.rules = tuple(rules) if rules is not None \
            else default_rules()
        ids = [r.id for r in self.rules]
        dupes = sorted({i for i in ids if ids.count(i) > 1})
        if dupes:
            raise ValueError(f"duplicate alert rule id(s): {dupes}")
        if notifier is None and notify:
            notifier = alerts.make_notifier(
                os.environ.get("TPULSAR_ALERT_NOTIFY", "log"))
        self.notifier = notifier
        #: callable returning extra Registry snapshots to merge (the
        #: controller passes its own registry's)
        self.extra_snapshots = extra_snapshots or (lambda: ())
        self.persist = persist
        self.journal_events = journal_events
        self.notify = notify
        self._offset = 0
        self._events: list[dict] = []
        self._samples: dict[str, list] = {
            r.id: [] for r in self.rules if r.kind == "metric_delta"}
        self._pending: dict[str, float] = {}   # rule id -> breach t0
        self._active: dict[str, dict] = {}     # rule id -> alert rec
        self._fsck_at = 0.0
        self._fsck_findings: int | None = None
        self._fsck_prev: set | None = None
        # event cache horizon: the widest rule window (+ debounce)
        # plus slack so a rule never loses in-window evidence
        self._horizon = max(
            (r.window_s + r.for_s for r in self.rules), default=0.0
        ) + 60.0

    # ------------------------------------------------------ signal io

    def _poll_events(self) -> None:
        try:
            if self.queue is not None:
                new, self._offset = self.queue.read_events_after(
                    self._offset)
            else:
                new, self._offset = journal.read_events(
                    self.root, after_offset=self._offset,
                    bad_lines=[])
        except OSError:
            return                  # journal unreadable this tick
        self._events.extend(new)

    def _trim_events(self, now: float) -> None:
        cut = now - self._horizon
        if self._events and self._events[0].get("t", 0.0) < cut:
            self._events = [e for e in self._events
                            if e.get("t", 0.0) >= cut]

    def _poll_fsck(self, now: float) -> None:
        if self.queue is None or not any(
                r.kind == "fsck" for r in self.rules):
            return
        if now - self._fsck_at < FSCK_INTERVAL_S \
                and self._fsck_findings is not None:
            return
        self._fsck_at = now
        try:
            rep = self.queue.fsck()
        except (OSError, NotImplementedError):
            self._fsck_findings = None
            self._fsck_prev = None
            return
        cur = {f"{f.get('what', '')}:{f.get('detail', '')}"
               for f in (rep.get("findings") or [])}
        # only findings that SURVIVE two consecutive polls count: a
        # live fleet's claim/takeover side-files exist for
        # milliseconds mid-rename, and an unlucky sweep catching one
        # is not wreckage — persistent findings are
        self._fsck_findings = (len(cur & self._fsck_prev)
                               if self._fsck_prev is not None else 0)
        self._fsck_prev = cur

    def _sample_deltas(self, now: float, snap: dict) -> None:
        for rule in self.rules:
            if rule.kind != "metric_delta":
                continue
            cur = alerts.metric_value(snap, rule.metric, rule.labels)
            if cur is None:
                continue
            hist = self._samples[rule.id]
            hist.append((now, cur))
            cut = now - rule.window_s - 60.0
            while hist and hist[0][0] < cut:
                hist.pop(0)

    # --------------------------------------------------- transitions

    def _journal(self, event: str, **fields) -> None:
        if not self.journal_events:
            return
        if self.queue is not None:
            self.queue.record_event(event, worker="doctor", **fields)
        else:
            journal.record(self.root, event, worker="doctor",
                           **fields)

    def _fire(self, rule, verdict: dict, now: float) -> None:
        evidence = {k: v for k, v in verdict.items()
                    if k != "breached"}
        rec = {"rule": rule.id, "severity": rule.severity,
               "state": "firing", "since": round(now, 3),
               "threshold": rule.threshold,
               "window_s": rule.window_s, "doc": rule.doc,
               **evidence}
        self._active[rule.id] = rec
        self._journal("alert_fired", rule=rule.id,
                      severity=rule.severity,
                      threshold=rule.threshold,
                      window_s=rule.window_s, **evidence)
        if self.notify and self.notifier is not None:
            self.notifier.notify(rec)

    def _resolve(self, rule, verdict: dict | None,
                 now: float) -> None:
        rec = dict(self._active.pop(rule.id))
        rec["state"] = "resolved"
        if verdict is not None:
            rec["value"] = verdict.get("value")
        self._journal("alert_resolved", rule=rule.id,
                      severity=rule.severity,
                      value=rec.get("value"))
        if self.notify and self.notifier is not None:
            self.notifier.notify(rec)

    def _persist(self, now: float) -> None:
        if not self.persist:
            return
        try:
            protocol._atomic_write_json(
                alerts_path(self.root),
                {"t": round(now, 3),
                 "alerts": sorted(self._active.values(),
                                  key=lambda a: a["rule"])})
        except OSError:
            pass                    # observational, like the journal

    # ---------------------------------------------------------- tick

    def tick(self, now: float | None = None,
             debounce: bool = True) -> list[dict]:
        """One detector evaluation; returns the active alert set.
        ``debounce=False`` waives for-duration holds (the one-shot
        doctor verdict cannot wait a for_s out)."""
        now = time.time() if now is None else now
        self._poll_events()
        self._trim_events(now)
        snap = merged_metrics(self.spool,
                              tuple(self.extra_snapshots()))
        self._sample_deltas(now, snap)
        self._poll_fsck(now)
        frame = {"now": now, "events": self._events,
                 "snapshot": snap, "samples": self._samples,
                 "queue_wait": alerts.queue_wait_samples(
                     self._events),
                 "stream_latency": alerts.stream_latency_samples(
                     self._events),
                 "fsck": self._fsck_findings}
        for rule in self.rules:
            verdict = alerts.evaluate_rule(rule, frame)
            if verdict is None:
                # signal unavailable: no verdict either way — drop
                # any pending debounce, leave an active alert active
                self._pending.pop(rule.id, None)
                continue
            if verdict["breached"]:
                t0 = self._pending.setdefault(rule.id, now)
                held = (not debounce) or (now - t0 >= rule.for_s)
                if rule.id in self._active:
                    self._active[rule.id].update(
                        {k: v for k, v in verdict.items()
                         if k != "breached"})
                elif held:
                    self._fire(rule, verdict, now)
            else:
                self._pending.pop(rule.id, None)
                if rule.id in self._active:
                    self._resolve(rule, verdict, now)
        self._persist(now)
        return sorted(self._active.values(),
                      key=lambda a: a["rule"])

    def metrics_snapshot(self) -> dict:
        """``tpulsar_alerts_active{rule,severity}`` as a local
        Registry snapshot, ready for write_fleet_prom's
        extra_snapshots (never the process-global registry: a
        resolved alert must VANISH from the export, and deleting
        global gauge series is not a thing)."""
        reg = metrics.Registry()
        g = telemetry.alerts_active(reg)
        for rec in self._active.values():
            g.set(1, rule=rec["rule"], severity=rec["severity"])
        return reg.snapshot()


def evaluate_once(root: str, queue=None, spool: str | None = None,
                  rules: tuple | None = None) -> list[dict]:
    """Read-only one-shot evaluation (``doctor``): no
    journaling, no alerts.json write, no notifier, debounce waived —
    the cron-shaped health verdict must not perturb the evidence a
    resident detector owns."""
    det = HealthDetector(root, queue=queue, spool=spool, rules=rules,
                         persist=False, journal_events=False,
                         notify=False)
    return det.tick(debounce=False)


def render_alerts(active: list[dict], title: str = "") -> str:
    lines = [title or "fleet health"]
    if not active:
        lines.append("OK: no alert rules firing")
        return "\n".join(lines)
    lines.append(f"{'rule':24s} {'sev':5s} {'value':>10s} "
                 f"{'threshold':>10s} {'window':>8s}")
    for rec in active:
        lines.append(
            f"{rec.get('rule', '?'):24s} "
            f"{rec.get('severity', '?'):5s} "
            f"{rec.get('value', ''):>10} "
            f"{rec.get('threshold', ''):>10} "
            f"{rec.get('window_s', ''):>7}s")
        if rec.get("doc"):
            lines.append(f"    {rec['doc']}")
    lines.append(f"FIRING: {len(active)} alert(s)")
    return "\n".join(lines)


# --------------------------------------------------------------------
# flight recorder (the per-worker black box)
# --------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of a worker's recent moves, dumped on death.

    The ring costs one deque append per noted event while alive; the
    dump happens exactly once (atexit OR an explicit fatal-path
    ``dump()`` — whichever comes first wins) and only while armed:
    a clean shutdown ``disarm()``s first, so healthy exits leave no
    wreckage to triage."""

    def __init__(self, worker_id: str = "", spool: str = "",
                 ring: int | None = None,
                 enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("TPULSAR_BLACKBOX", "") != "0"
        if ring is None:
            try:
                ring = int(os.environ.get("TPULSAR_BLACKBOX_RING",
                                          "") or 256)
            except ValueError:
                ring = 256
        self.worker_id = worker_id
        self.spool = spool
        self.enabled = bool(enabled and spool)
        self.ring: collections.deque = collections.deque(
            maxlen=max(8, ring))
        self._lock = threading.Lock()
        self._armed = False
        self._dumped = False

    def note(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"t": round(time.time(), 3), "kind": kind}
        rec.update(fields)
        with self._lock:
            self.ring.append(rec)

    def arm(self) -> None:
        """Register the atexit dump; call once serving starts."""
        if not self.enabled or self._armed:
            return
        self._armed = True
        atexit.register(self._atexit)

    def disarm(self) -> None:
        """Clean shutdown: the atexit hook becomes a no-op."""
        self._armed = False

    def _atexit(self) -> None:
        if self._armed:
            self.dump(reason="atexit")

    def dump(self, reason: str = "", rc: int | None = None) -> str:
        """Write the ring to ``<spool>/blackbox/<worker>.<pid>.json``
        (JSONL: header, entries, end marker).  Idempotent — first
        caller wins.  The ``blackbox.dump`` fault point fires after
        the first half of the entries has been flushed, so an armed
        spec (or a real mid-dump death) leaves a torn file the
        renderer must salvage.  Returns the path, '' when disabled
        or already dumped."""
        with self._lock:
            if not self.enabled or self._dumped:
                return ""
            self._dumped = True
            entries = list(self.ring)
        path = os.path.join(
            self.spool, BLACKBOX_DIR,
            f"{self.worker_id or 'server'}.{os.getpid()}.json")
        header = {"kind": "blackbox",
                  "worker": self.worker_id, "pid": os.getpid(),
                  "t": round(time.time(), 3), "reason": reason,
                  "rc": rc, "entries": len(entries)}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as fh:
                fh.write(json.dumps(header, sort_keys=True) + "\n")
                half = (len(entries) + 1) // 2
                for rec in entries[:half]:
                    fh.write(json.dumps(rec, sort_keys=True) + "\n")
                fh.flush()
                faults.fire("blackbox.dump", make_exc=faults.io_error,
                            detail=reason or "dump")
                for rec in entries[half:]:
                    fh.write(json.dumps(rec, sort_keys=True) + "\n")
                fh.write(json.dumps({"kind": "end",
                                     "entries": len(entries)})
                         + "\n")
        except OSError:
            pass            # torn dump: the prefix already landed
        return path


def load_blackbox(spool: str, worker_id: str = "") -> dict | None:
    """Newest dump for the worker, parsed tolerantly: unreadable or
    truncated lines are counted, not fatal, and a missing end marker
    flags the dump as torn.  None when the worker never dumped."""
    paths = glob.glob(os.path.join(
        spool, BLACKBOX_DIR, f"{worker_id or 'server'}.*.json"))
    if not paths:
        return None

    def _mtime(p):
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0
    path = max(paths, key=_mtime)
    header: dict = {}
    entries: list[dict] = []
    bad = 0
    complete = False
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return None
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            bad += 1
            continue
        if not isinstance(rec, dict):
            bad += 1
        elif rec.get("kind") == "blackbox" and not header:
            header = rec
        elif rec.get("kind") == "end":
            complete = True
        else:
            entries.append(rec)
    return {"path": path, "header": header, "entries": entries,
            "torn": not complete, "bad_lines": bad}


def render_blackbox(spool: str, worker_id: str = "") -> str:
    """``python -m tpulsar_torch obs blackbox <worker>``: the last seconds before
    death as a relative-time table."""
    box = load_blackbox(spool, worker_id)
    if box is None:
        return (f"no blackbox dump for worker "
                f"{worker_id or 'server'!s} under "
                f"{os.path.join(spool, BLACKBOX_DIR)}")
    hdr = box["header"]
    lines = [f"blackbox {box['path']}",
             f"worker={hdr.get('worker', '?') or '(single)'} "
             f"pid={hdr.get('pid', '?')} "
             f"reason={hdr.get('reason', '?') or '-'} "
             f"rc={hdr.get('rc')}"]
    if box["torn"]:
        lines.append(f"TORN DUMP: no end marker — the worker died "
                     f"mid-dump ({len(box['entries'])} entries "
                     f"salvaged)")
    if box["bad_lines"]:
        lines.append(f"({box['bad_lines']} unparseable line(s) "
                     f"skipped)")
    t_end = hdr.get("t") or (box["entries"][-1].get("t", 0.0)
                             if box["entries"] else 0.0)
    lines.append(f"{'t-death':>9s}  {'kind':16s} detail")
    for rec in box["entries"]:
        detail = " ".join(
            f"{k}={str(v)[:48]}" for k, v in rec.items()
            if k not in ("t", "kind"))
        lines.append(f"{rec.get('t', 0.0) - t_end:9.3f}  "
                     f"{str(rec.get('kind', '?')):16s} {detail}")
    if not box["entries"]:
        lines.append("  (empty ring)")
    return "\n".join(lines)
