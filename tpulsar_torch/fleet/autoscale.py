"""The elastic autoscaler: journal-derived signals in, scale events out
— counterpart of tpulsar/fleet/autoscale.py (a copy).

Checkpoint resume makes preemption nearly free (a killed beam's
durable passes are salvaged); this module cashes that in.  A
closed-loop controller-side policy engine scales the fleet's worker
count between configured min/max from three signal families, with
hysteresis and a cooldown so flapping capacity cannot thrash:

  * **queue-wait SLO** — the p95 of recent ``queue_wait_s`` values
    tailed from the ticket journal by offset (O(new events) per tick,
    riding ``journal.read_events(after_offset=)``), plus the age of
    the oldest ticket still waiting in ``incoming/`` (the live
    leading edge a quantile over finished waits cannot see);
  * **backlog pressure** — pending tickets per live worker (the
    ``state_count`` listing-only read), with the per-tenant breakdown
    recorded on every decision so the journal explains WHY;
  * **advertised headroom** — the same cached fleet-capacity probe
    federation advertises, so a fleet that is shedding or
    backpressured reads as one that needs workers.

Decisions are conservative by construction:

  * scale-UP is proportional (enough workers to bring backlog under
    ``backlog_per_worker`` each) but clamped to ``max_workers``;
  * scale-DOWN fires only after a SUSTAINED low-load window
    (``idle_window_s`` of zero backlog, an idle worker, and recent
    queue-wait p95 under ``low_water_ratio`` of the SLO), one worker
    at a time;
  * every action arms a ``cooldown_s`` during which no further
    scaling happens — the hysteresis that makes ``flap_capacity``
    chaos storms survivable (the ``scaling_bounded`` invariant audits
    both the bounds and the cooldown from the journal alone).

Scale-down is drain-or-preempt: on-demand victims get SIGTERM and a
drain deadline before SIGKILL escalation; ``spot``-class victims are
SIGKILLed outright, because checkpoint resume makes that cheap.
Either way the controller writes the victim's pid into the spool's
scale-down ledger (``protocol.record_elective_kill``) BEFORE the
signal and journals a ``scale_up``/``scale_down`` event carrying the
triggering signal values — the evidence trail ``fleet
--status`` renders and the ``no_elastic_strike`` invariant audits
(an elective preemption must never advance a beam toward
quarantine).

stdlib only; the FleetController owns process lifecycle — this
module only reads signals, decides, and writes evidence.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

from tpulsar_torch.obs import journal
from tpulsar_torch.serve import protocol

#: the journal event names scale decisions land under (the decision
#: trail API: --status and the chaos verifier both key on these)
SCALE_EVENTS = ("scale_up", "scale_down")

#: worker classes the fleet understands: "" / "ondemand" workers are
#: drained politely on scale-down; "spot" workers treat SIGKILL as
#: routine (claims requeue attempt-neutrally off the scale-down
#: ledger, checkpoint resume salvages their durable passes)
WORKER_CLASSES = ("", "ondemand", "spot")


@dataclasses.dataclass
class AutoscaleConfig:
    min_workers: int = 1
    max_workers: int = 4
    #: the queue-wait SLO: recent p95 (or the oldest waiter's age)
    #: above this triggers scale-up regardless of backlog depth
    queue_wait_slo_s: float = 30.0
    #: target backlog per live worker: pending above this * workers
    #: triggers a proportional scale-up
    backlog_per_worker: float = 2.0
    #: minimum seconds between ANY two scaling actions (hysteresis
    #: against capacity flapping)
    cooldown_s: float = 30.0
    #: sustained low-load window required before a scale-down
    idle_window_s: float = 60.0
    #: drain grace for an on-demand scale-down victim before the
    #: SIGKILL escalation (checkpoint resume prices the escalation)
    drain_deadline_s: float = 20.0
    #: class stamped on elastically-added workers ("spot" = SIGKILL
    #: is routine); base workers below min_workers stay on-demand
    worker_class: str = "spot"
    #: scale-down requires recent queue-wait p95 under this fraction
    #: of the SLO (the hysteresis low-water mark)
    low_water_ratio: float = 0.25
    #: sliding window over which "recent" queue waits are measured
    slo_lookback_s: float = 60.0

    def validate(self) -> "AutoscaleConfig":
        problems = []
        if self.min_workers < 1:
            problems.append("min_workers must be >= 1")
        if self.max_workers < self.min_workers:
            problems.append("max_workers must be >= min_workers")
        if self.queue_wait_slo_s <= 0:
            problems.append("queue_wait_slo_s must be positive")
        if self.backlog_per_worker <= 0:
            problems.append("backlog_per_worker must be positive")
        if self.cooldown_s <= 0:
            problems.append("cooldown_s must be positive")
        if self.idle_window_s <= 0:
            problems.append("idle_window_s must be positive")
        if self.drain_deadline_s < 0:
            problems.append("drain_deadline_s must be >= 0")
        if self.worker_class not in WORKER_CLASSES:
            problems.append(
                f"worker_class {self.worker_class!r} not in "
                f"{WORKER_CLASSES}")
        if not 0 < self.low_water_ratio <= 1:
            problems.append("low_water_ratio must be in (0, 1]")
        if problems:
            raise ValueError("autoscale config: "
                             + "; ".join(problems))
        return self

    @classmethod
    def from_dict(cls, doc: dict) -> "AutoscaleConfig":
        """Loud parse (unknown keys raise) — the same contract the
        chaos scenario loader honours everywhere else."""
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - fields
        if unknown:
            raise ValueError(
                f"autoscale: unknown key(s) {sorted(unknown)} "
                f"(known: {sorted(fields)})")
        return cls(**doc).validate()


@dataclasses.dataclass
class Signals:
    """One tick's observed load — everything a decision (and its
    journaled evidence) is made of."""
    t: float
    pending: int
    claimed: int
    live_workers: int
    fresh_workers: int
    capacity: int | None           # None = advertised load-shed
    oldest_wait_s: float           # age of the oldest waiting ticket
    queue_wait_p95_s: float | None  # recent-window journal p95
    tenant_backlog: dict

    def as_event(self) -> dict:
        """The signal fields a scale event records (rounded; None
        capacity journals as -1, matching the telemetry gauge)."""
        return {
            "pending": self.pending, "claimed": self.claimed,
            "live_workers": self.live_workers,
            "fresh_workers": self.fresh_workers,
            "capacity": -1 if self.capacity is None
            else self.capacity,
            "oldest_wait_s": round(self.oldest_wait_s, 3),
            "queue_wait_p95_s": (
                round(self.queue_wait_p95_s, 3)
                if self.queue_wait_p95_s is not None else -1.0),
            **({"tenant_backlog": self.tenant_backlog}
               if self.tenant_backlog else {}),
        }


@dataclasses.dataclass
class Decision:
    direction: str                 # "up" | "down"
    n: int
    reason: str
    signals: Signals


def oldest_pending_wait_s(spool: str, now: float | None = None
                          ) -> float:
    """Age of the oldest ticket waiting in incoming/, from directory
    mtimes alone (a requeue re-writes the file, which correctly
    restarts its wait — the requeued beam re-entered the queue).  The
    leading-edge signal: a p95 over FINISHED waits cannot see the
    ticket that has been starving since the last worker died."""
    if now is None:
        now = time.time()
    d = os.path.join(spool, "incoming")
    oldest = now
    try:
        with os.scandir(d) as it:
            for entry in it:
                if not entry.name.endswith(".json"):
                    continue
                try:
                    m = entry.stat().st_mtime
                except OSError:
                    continue
                if m < oldest:
                    oldest = m
    except OSError:
        return 0.0
    return max(0.0, now - oldest)


def pending_by_tenant(spool: str) -> dict[str, int]:
    """Per-tenant backlog (parsed incoming records) — computed only
    at decision time, so the per-tick cost stays listing-only."""
    counts: dict[str, int] = {}
    for rec in protocol.pending_records(spool):
        tenant = rec.get("tenant") or "default"
        counts[tenant] = counts.get(tenant, 0) + 1
    return counts


class Autoscaler:
    """The decision engine.  Owns NO processes: callers (the
    FleetController) feed it live-worker counts, execute its
    decisions, and confirm them via :meth:`note_action` (which arms
    the cooldown)."""

    def __init__(self, cfg: AutoscaleConfig, spool: str, *,
                 queue=None, clock=time.time):
        self.cfg = cfg.validate()
        self.spool = spool
        #: the ticket backend signals are read from (counts,
        #: freshness, capacity, journal tail).  None keeps the
        #: classic spool reads — existing callers and tests see
        #: identical behaviour.
        self.q = queue
        self.clock = clock
        self._last_action_at: float = float("-inf")
        self._low_since: float | None = None
        #: offset-tailed journal reader state + the sliding window of
        #: (claim instant, queue_wait_s) samples the p95 is over
        self._journal_offset = 0
        self._waits: list[tuple[float, float]] = []

    # ---------------------------------------------------------- signals

    def _tail_queue_waits(self, now: float) -> None:
        try:
            if self.q is not None:
                new, self._journal_offset = self.q.read_events_after(
                    self._journal_offset)
            else:
                new, self._journal_offset = journal.read_events(
                    self.spool, after_offset=self._journal_offset,
                    bad_lines=[])
        except OSError:
            return            # a sick journal costs a signal, never
            #                   the controller loop
        for ev in new:
            if ev.get("event") == "claimed" \
                    and "queue_wait_s" in ev:
                try:
                    self._waits.append(
                        (float(ev.get("t", now)),
                         float(ev["queue_wait_s"])))
                except (TypeError, ValueError):
                    pass
        floor = now - self.cfg.slo_lookback_s
        self._waits = [(t, w) for t, w in self._waits if t >= floor]

    def _recent_p95(self) -> float | None:
        vals = sorted(w for _, w in self._waits)
        if not vals:
            return None
        pos = 0.95 * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)

    def read_signals(self, live_workers: int) -> Signals:
        now = self.clock()
        self._tail_queue_waits(now)
        if self.q is not None:
            pending = self.q.pending_count()
            return Signals(
                t=now,
                pending=pending,
                claimed=self.q.claimed_count(),
                live_workers=live_workers,
                fresh_workers=len(self.q.fresh_workers()),
                capacity=self.q.capacity(),
                oldest_wait_s=(self.q.oldest_pending_age_s(now)
                               if pending else 0.0),
                queue_wait_p95_s=self._recent_p95(),
                tenant_backlog={},      # filled at decision time
            )
        pending = protocol.pending_count(self.spool)
        return Signals(
            t=now,
            pending=pending,
            claimed=protocol.claimed_count(self.spool),
            live_workers=live_workers,
            fresh_workers=len(protocol.fresh_workers(self.spool)),
            capacity=protocol.fleet_capacity_cached(self.spool),
            oldest_wait_s=(oldest_pending_wait_s(self.spool, now)
                           if pending else 0.0),
            queue_wait_p95_s=self._recent_p95(),
            tenant_backlog={},      # filled at decision time
        )

    # --------------------------------------------------------- decision

    def note_action(self, t: float | None = None) -> None:
        """Arm the cooldown (called by the controller AFTER it
        executes a decision, so a failed spawn does not burn it)."""
        self._last_action_at = self.clock() if t is None else t

    def in_cooldown(self, now: float) -> bool:
        return now - self._last_action_at < self.cfg.cooldown_s

    def decide(self, sig: Signals) -> Decision | None:
        cfg = self.cfg
        now = sig.t
        live = sig.live_workers

        # ---- scale-up triggers (any of them suffices)
        reasons = []
        want = live
        if sig.pending > cfg.backlog_per_worker * max(1, live):
            # proportional: enough workers to bring backlog per
            # worker back under target
            want = max(want, math.ceil(
                sig.pending / cfg.backlog_per_worker))
            reasons.append(
                f"backlog {sig.pending} > "
                f"{cfg.backlog_per_worker:g}/worker x {live}")
        if sig.oldest_wait_s > cfg.queue_wait_slo_s:
            want = max(want, live + 1)
            reasons.append(
                f"oldest waiter {sig.oldest_wait_s:.1f} s > SLO "
                f"{cfg.queue_wait_slo_s:g} s")
        if sig.queue_wait_p95_s is not None \
                and sig.queue_wait_p95_s > cfg.queue_wait_slo_s \
                and sig.pending:
            want = max(want, live + 1)
            reasons.append(
                f"queue-wait p95 {sig.queue_wait_p95_s:.1f} s > SLO "
                f"{cfg.queue_wait_slo_s:g} s")
        if sig.pending and (sig.capacity is None
                            or sig.capacity <= 0):
            # the federation-advertised headroom: a fleet that is
            # shedding (no fresh workers — they may all be mid-boot
            # or mid-restart) or backpressured (saturated advertised
            # depth) with work waiting needs workers, whatever the
            # per-worker backlog ratio says
            want = max(want, live + 1)
            reasons.append(
                "advertised headroom "
                + ("SHED (0 fresh workers)" if sig.capacity is None
                   else "0 (backpressure)")
                + f" with backlog {sig.pending}")
        if reasons:
            self._low_since = None        # load is back: reset
            if live >= cfg.max_workers or self.in_cooldown(now):
                return None
            n = min(want, cfg.max_workers) - live
            if n > 0:
                return Decision("up", n, "; ".join(reasons), sig)
            return None

        # ---- scale-down hysteresis: sustained low load only
        p95 = sig.queue_wait_p95_s
        low = (sig.pending == 0
               and sig.claimed < max(1, live)
               and (p95 is None
                    or p95 <= cfg.low_water_ratio
                    * cfg.queue_wait_slo_s))
        if not low:
            self._low_since = None
            return None
        if self._low_since is None:
            self._low_since = now
            return None
        idle_for = now - self._low_since
        if idle_for < cfg.idle_window_s:
            return None
        if live <= cfg.min_workers or self.in_cooldown(now):
            return None
        return Decision(
            "down", 1,
            f"low load {idle_for:.1f} s >= idle window "
            f"{cfg.idle_window_s:g} s "
            f"(pending 0, claimed {sig.claimed}/{live}"
            + (f", p95 {p95:.2f} s" if p95 is not None else "")
            + ")", sig)


# --------------------------------------------------------- evidence

def journal_scale_event(spool: str, decision: Decision,
                        cfg: AutoscaleConfig,
                        workers_before: int, workers_after: int,
                        victims: list[dict] | None = None,
                        queue=None) -> dict | None:
    """One journaled scale event per executed decision, carrying the
    triggering signals AND the policy bounds — self-contained
    evidence the ``scaling_bounded`` invariant and the --status
    decision trail replay with no side channel.  ``spool`` is the
    journal root; ``queue`` (optional) supplies the tenant backlog
    for non-spool backends."""
    sig = dict(decision.signals.as_event())
    sig["tenant_backlog"] = (queue.pending_by_tenant() if queue
                             is not None
                             else pending_by_tenant(spool)) or {}
    if not sig["tenant_backlog"]:
        sig.pop("tenant_backlog")
    extra: dict = {}
    if victims:
        extra["victims"] = victims
    return journal.record(
        spool, f"scale_{decision.direction}",
        n=decision.n, reason=decision.reason,
        workers_before=workers_before, workers_after=workers_after,
        min_workers=cfg.min_workers, max_workers=cfg.max_workers,
        cooldown_s=cfg.cooldown_s, **sig, **extra)


def decision_trail(spool: str, limit: int = 8) -> list[dict]:
    """The last ``limit`` journaled scale events, oldest first (the
    operator's "why is my fleet this size" audit)."""
    events = journal.read_events(spool, bad_lines=[])
    scale = [e for e in events if e.get("event") in SCALE_EVENTS]
    return scale[-limit:] if limit else scale


def render_trail(events: list[dict]) -> list[str]:
    """Human lines for ``fleet --status``."""
    lines = []
    for ev in events:
        when = time.strftime("%H:%M:%S",
                             time.localtime(ev.get("t", 0.0)))
        arrow = ("+" if ev.get("event") == "scale_up" else "-")
        victims = ev.get("victims") or ()
        vic = (" [" + ", ".join(
            f"{v.get('worker', '?')}"
            + (f"/{v.get('worker_class')}" if v.get("worker_class")
               else "")
            + f" {v.get('mode', '?')}" for v in victims) + "]"
            if victims else "")
        p95 = ev.get("queue_wait_p95_s", -1.0)
        lines.append(
            f"  {when}  {ev.get('event', '?'):10s} "
            f"{ev.get('workers_before', '?')}->"
            f"{ev.get('workers_after', '?')} ({arrow}{ev.get('n', 1)})"
            f"  pending={ev.get('pending', '?')} "
            f"p95={'-' if p95 is None or p95 < 0 else f'{p95:.2f}s'} "
            f"oldest={ev.get('oldest_wait_s', 0.0):.1f}s{vic}\n"
            f"            {ev.get('reason', '')}")
    return lines
