"""Declarative fleet alert rules: the health doctor's vocabulary —
counterpart of tpulsar/obs/alerts.py (a copy: the rule schema, the
built-in pack, the fault-class -> alert mapping, the evaluation
primitives and the notifier plane).

The stack *emits* everything — journal lifecycle events, merged
fleet metrics, SLO quantiles — and this module says what to *watch*:
an alert rule names a signal (journal events, a merged-snapshot
metric, a metric's delta over a window, a multi-window SLO burn
rate, or a queue fsck), a window, a threshold, a severity, and an
optional for-duration debounce.  The detector loop (obs/health.py)
evaluates the pack.

Burn-rate rules follow the Google SRE multi-window shape: the SLO
is "at most ``budget`` of beams may wait longer than
``objective_s``"; the burn rate is (bad fraction / budget), and the
rule fires only when BOTH the long window and the short window burn
faster than ``threshold`` — the long window proves the budget is
really burning, the short window proves it is burning *now* (so a
recovered incident stops paging).

``compile_miss_on_warm`` watches ``tpulsar_compile_cache_misses_total``
with ``program="(inline)"``: a shared library built at first use
(aot/warmstart.py::record_build) instead of by the boot gate, whose
misses carry the library's name.  A serve process that builds after
boot fires it.

Fan-out is a pluggable spec — ``log`` (the default),
``webhook:<url>`` (HTTP POST of the alert JSON), or
``command:<argv>`` (the alert JSON on stdin) — parsed loudly like a
fault spec.  The daemons' crash reports go through it too
(cli/main.py::_notify).

stdlib only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import shlex
import subprocess
import urllib.request

from tpulsar_torch.obs import journal

SEVERITIES = ("page", "warn")

#: rule signal kinds: journal-event counting, a merged-snapshot
#: metric reading, a metric's delta over the window (needs a
#: resident detector feeding samples), the multi-window SLO burn
#: rate, and the queue backend's fsck findings
KINDS = ("event_count", "metric", "metric_delta", "burn_rate", "fsck")

_COMPARES = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative alert rule.  ``events``/``where``/
    ``where_not`` drive event_count rules; ``metric``/``labels``
    the metric kinds; ``short_window_s``/``objective_s``/``budget``
    the burn-rate kind (where ``threshold`` is the burn factor)."""
    id: str
    severity: str
    kind: str
    doc: str = ""
    window_s: float = 300.0
    threshold: float = 1.0
    compare: str = "ge"
    for_s: float = 0.0
    min_count: int = 1          # burn_rate: samples needed to judge
    events: tuple = ()          # journal event names
    where: tuple = ()           # ((field, value), ...) all must match
    where_not: tuple = ()       # ((field, value), ...) none may match
    metric: str = ""
    labels: tuple = ()          # ((labelname, value), ...)
    short_window_s: float = 0.0
    objective_s: float = 0.0
    budget: float = 0.1
    #: burn_rate: which frame sample stream to judge — "queue_wait"
    #: (beam admission latency) or "stream_latency" (per-chunk
    #: ingest->trigger latency from chunk_received events)
    samples_key: str = "queue_wait"


def validate_rule(rule: Rule) -> Rule:
    """Loud structural validation (the scenario-schema idiom): a rule
    that cannot evaluate must fail at load, not fire never."""
    def bad(msg: str):
        return ValueError(f"alert rule {rule.id!r}: {msg}")
    if not rule.id or not isinstance(rule.id, str):
        raise ValueError(f"alert rule needs a non-empty id "
                         f"(got {rule.id!r})")
    if rule.severity not in SEVERITIES:
        raise bad(f"severity {rule.severity!r} not in {SEVERITIES}")
    if rule.kind not in KINDS:
        raise bad(f"kind {rule.kind!r} not in {KINDS}")
    if rule.compare not in _COMPARES:
        raise bad(f"compare {rule.compare!r} not in "
                  f"{tuple(_COMPARES)}")
    if not isinstance(rule.threshold, (int, float)) \
            or isinstance(rule.threshold, bool):
        raise bad(f"threshold must be a number "
                  f"(got {rule.threshold!r})")
    if rule.for_s < 0:
        raise bad("for_s must be >= 0")
    if rule.kind == "event_count":
        if not rule.events:
            raise bad("event_count rules need at least one event")
        unknown = [e for e in rule.events if e not in journal.EVENTS]
        if unknown:
            raise bad(f"unknown journal event(s) {unknown} — the "
                      f"journal vocabulary is journal.EVENTS")
    if rule.kind in ("metric", "metric_delta") and not rule.metric:
        raise bad(f"{rule.kind} rules need a metric name")
    if rule.kind in ("event_count", "metric_delta", "burn_rate") \
            and rule.window_s <= 0:
        raise bad("window_s must be > 0")
    if rule.kind == "burn_rate":
        if not 0 < rule.short_window_s < rule.window_s:
            raise bad(f"short_window_s must sit in (0, window_s) "
                      f"(got {rule.short_window_s!r} vs window_s "
                      f"{rule.window_s!r})")
        if rule.objective_s <= 0:
            raise bad("objective_s must be > 0")
        if not 0 < rule.budget < 1:
            raise bad(f"budget must sit in (0, 1) "
                      f"(got {rule.budget!r})")
        if not rule.samples_key or not isinstance(rule.samples_key,
                                                  str):
            raise bad(f"samples_key must be a non-empty string "
                      f"(got {rule.samples_key!r})")
    return rule


_PAIR_FIELDS = ("where", "where_not", "labels")


def rule_from_dict(d: dict) -> Rule:
    """Build + validate a Rule from JSON-shaped data (the
    ``--rules`` file / TPULSAR_ALERT_RULES path).  Unknown keys fail
    loudly — a typo'd field must not silently weaken a rule."""
    if not isinstance(d, dict):
        raise ValueError(f"alert rule must be an object, "
                         f"got {type(d).__name__}")
    known = {f.name for f in dataclasses.fields(Rule)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"alert rule {d.get('id', '?')!r}: unknown "
                         f"key(s) {unknown} (known: {sorted(known)})")
    kw = dict(d)
    if "events" in kw:
        kw["events"] = tuple(kw["events"])
    for field in _PAIR_FIELDS:
        if field in kw:
            pairs = kw[field]
            if isinstance(pairs, dict):
                pairs = sorted(pairs.items())
            kw[field] = tuple((str(k), v) for k, v in pairs)
    return validate_rule(Rule(**kw))


def load_rules(path: str) -> tuple[Rule, ...]:
    """A JSON rules file: either a list of rule objects or
    ``{"rules": [...], "replace": bool}``.  By default the file
    EXTENDS the built-in pack (same-id rules override); ``replace``
    true drops the built-ins entirely."""
    with open(path) as fh:
        obj = json.load(fh)
    replace = False
    if isinstance(obj, dict):
        replace = bool(obj.get("replace", False))
        obj = obj.get("rules", [])
    if not isinstance(obj, list):
        raise ValueError(f"alert rules file {path}: expected a list "
                         f"of rules or {{'rules': [...]}}")
    loaded = [rule_from_dict(d) for d in obj]
    ids = [r.id for r in loaded]
    dupes = sorted({i for i in ids if ids.count(i) > 1})
    if dupes:
        raise ValueError(f"alert rules file {path}: duplicate rule "
                         f"id(s) {dupes}")
    if replace:
        return tuple(loaded)
    merged = {r.id: r for r in builtin_rules()}
    merged.update({r.id: r for r in loaded})
    return tuple(merged.values())


def builtin_rules() -> tuple[Rule, ...]:
    """The built-in pack: one rule per known failure smell.  Metric
    names come from the telemetry catalog getters; journal event
    names are validated against journal.EVENTS."""
    from tpulsar_torch.obs import telemetry
    return tuple(validate_rule(r) for r in (
        Rule(id="queue_wait_slo_burn", severity="page",
             kind="burn_rate", window_s=600.0, short_window_s=120.0,
             objective_s=30.0, budget=0.1, threshold=2.0,
             doc="queue-wait SLO error budget burning >= 2x in both "
                 "the 10 min and 2 min windows (SLO: <= 10% of "
                 "beams wait > 30 s for their first claim)"),
        Rule(id="stream_latency_burn", severity="page",
             kind="burn_rate", window_s=600.0, short_window_s=120.0,
             objective_s=5.0, budget=0.1, threshold=2.0,
             samples_key="stream_latency",
             doc="streaming trigger-latency SLO error budget burning "
                 ">= 2x in both the 10 min and 2 min windows (SLO: "
                 "<= 10% of acknowledged chunks take > 5 s from "
                 "ingest to trigger publication)"),
        Rule(id="takeover_rate", severity="warn", kind="event_count",
             events=("takeover",), window_s=300.0, threshold=1,
             doc="crash-shaped takeovers: a worker died holding a "
                 "claim and a janitor stole the beam back"),
        Rule(id="quarantine", severity="page", kind="event_count",
             events=("quarantined",), window_s=600.0, threshold=1,
             doc="a beam repeatedly killed its workers and hit the "
                 "attempts cap — poisoned input or a poisoned host"),
        Rule(id="worker_flap", severity="page", kind="event_count",
             events=("worker_exit",), window_s=300.0, threshold=2,
             where_not=(("kind", "drain"), ("kind", "scale_down"),
                        ("rc", 0)),
             doc="workers crash-exiting repeatedly (drain, "
                 "scale-down, and clean rc-0 exits excluded) — the "
                 "restart-backoff budget is being spent"),
        Rule(id="compile_miss_on_warm", severity="warn",
             kind="metric_delta",
             metric=telemetry.compile_cache_misses_total().name,
             labels=(("program", "(inline)"),),
             window_s=300.0, threshold=1,
             doc="inline compile-cache misses during serving: a "
                 "silent recompile the AOT gate should have "
                 "absorbed (tpulsar aot verify localizes it)"),
        Rule(id="checkpoint_sick", severity="warn",
             kind="event_count",
             events=("checkpoint_invalid", "checkpoint_disabled"),
             window_s=600.0, threshold=1,
             doc="checkpoint store discarding corrupt entries or "
                 "degrading beams to un-checkpointed — a sick "
                 "checkpoint volume wastes every future crash"),
        Rule(id="accel_breaker_pinned", severity="warn",
             kind="metric_delta",
             metric=telemetry.accel_undispatched_rows_total().name,
             window_s=300.0, threshold=1,
             doc="the accel circuit breaker is open: rows routed "
                 "straight to host rescue without a dispatch "
                 "attempt — the chip path is pinned off"),
        Rule(id="queue_corrupt", severity="page", kind="event_count",
             events=("queue_corrupt",), window_s=600.0, threshold=1,
             doc="the durable queue backend refused a corrupt "
                 "database — serving continues only on whatever "
                 "state fsck can salvage"),
        Rule(id="fsck_findings", severity="page", kind="fsck",
             window_s=300.0, threshold=1,
             doc="queue fsck reports findings (orphan side-files, "
                 "integrity failures) on the live backend"),
        Rule(id="fleet_saturated", severity="warn", kind="metric",
             metric=telemetry.fleet_capacity().name,
             compare="le", threshold=0, for_s=60.0,
             doc="aggregate admission capacity pinned at <= 0 "
                 "(backpressure or zero fresh workers) for a "
                 "sustained minute — the fleet cannot absorb its "
                 "offered load and the autoscaler (if any) is "
                 "already at its bound"),
    ))


# --------------------------------------------------------------------
# fault class -> alert mapping (the alert-fidelity contract)
# --------------------------------------------------------------------
# A chaos storm's injected disruption is classified as
# ``action:<timeline action>`` (from chaos_action journal events),
# ``fault:<fault point>`` (from armed schedule windows), or
# ``action:worker_crash_arg`` (a --crash-* stub-worker argument
# recorded on chaos_run_start).  ALLOWED says which alerts a class
# may legitimately raise (anything else fired = a false alarm);
# EXPECTED says which alerts MUST fire once the class occurs
# ``min_count`` times (none fired = a missed alarm).

#: the alerts any worker-disrupting injection may legitimately raise
_DISRUPTION = ("worker_flap", "takeover_rate", "quarantine",
               "queue_wait_slo_burn", "stream_latency_burn",
               "fleet_saturated",
               "checkpoint_sick")

ALLOWED_ALERTS: dict[str, tuple[str, ...]] = {
    "action:restart_gateway": ("queue_wait_slo_burn",
                               "fleet_saturated"),
    "action:surge_submit": ("queue_wait_slo_burn",
                            "fleet_saturated"),
    "action:flap_capacity": ("queue_wait_slo_burn",
                             "fleet_saturated"),
    "action:submit_refused": ("queue_wait_slo_burn",
                              "fleet_saturated"),
    "fault:queue.db": _DISRUPTION + ("queue_corrupt",
                                     "fsck_findings"),
    "fault:spool.io": _DISRUPTION + ("fsck_findings",),
    "fault:checkpoint.write": _DISRUPTION,
    "fault:checkpoint.load": _DISRUPTION,
    #: injected ingest-read failures cost the stream worker retries
    #: (latency), so the latency burn alert is earned, never false
    "fault:stream.ingest": _DISRUPTION,
    "fault:accel.row_dispatch": ("accel_breaker_pinned",),
    "fault:accel.chunk": ("accel_breaker_pinned",),
}

EXPECTED_ALERTS: dict[str, dict] = {
    "action:kill_worker": {"min_count": 2,
                           "rules": ("worker_flap",)},
    "fault:fleet.worker": {"min_count": 1,
                           "rules": ("worker_flap",
                                     "takeover_rate")},
}


def allowed_rules(fault_class: str) -> tuple[str, ...]:
    """Alerts the class may raise without being a false alarm; any
    class not explicitly tabled gets the generic disruption set
    (every timeline action perturbs serving somehow)."""
    return ALLOWED_ALERTS.get(fault_class, _DISRUPTION)


# --------------------------------------------------------------------
# evaluation primitives (pure: frame in, verdict out)
# --------------------------------------------------------------------

def _matches(ev: dict, rule: Rule) -> bool:
    if ev.get("event") not in rule.events:
        return False
    for k, v in rule.where:
        if ev.get(k) != v:
            return False
    for k, v in rule.where_not:
        if ev.get(k) == v:
            return False
    return True


def metric_value(snapshot: dict, metric: str,
                 labels: tuple = ()) -> float | None:
    """Sum of the metric's series whose labels superset-match
    ``labels`` in a Registry.snapshot()-shaped dict; None when the
    instrument (or any matching series) is absent — an absent signal
    SKIPS its rule rather than reading as zero."""
    rec = snapshot.get(metric)
    if rec is None:
        return None
    names = rec.get("labelnames") or []
    want = [(str(k), str(v)) for k, v in labels]
    total, found = 0.0, False
    for key, val in (rec.get("series") or {}).items():
        kv = dict(zip(names, key.split("|"))) if key else {}
        if any(kv.get(k) != v for k, v in want):
            continue
        total += float(val["count"] if isinstance(val, dict) else val)
        found = True
    return total if found else None


def queue_wait_samples(events: list[dict]) -> list[tuple]:
    """``(t_first_claim, wait_s)`` per ticket, the burn-rate rule's
    sample stream: first receipt (gateway ``received``, else
    ``submitted``) to first ``claimed`` — the SLO definition
    fleetview's quantiles use, from the same journal."""
    starts: dict[str, float] = {}
    claims: dict[str, dict] = {}
    for e in events:
        tid = e.get("ticket")
        if not tid:
            continue
        name = e.get("event")
        t = e.get("t", 0.0)
        if name in ("received", "submitted"):
            if tid not in starts or t < starts[tid]:
                starts[tid] = t
        elif name == "claimed" and tid not in claims:
            claims[tid] = e
    out = []
    for tid, ev in claims.items():
        t0 = starts.get(tid)
        if t0 is None:
            continue
        out.append((ev.get("t", 0.0), ev.get("t", 0.0) - t0))
    out.sort()
    return out


def stream_latency_samples(events: list[dict]) -> list[tuple]:
    """``(t, latency_s)`` per acknowledged stream chunk — the
    stream_latency_burn rule's sample stream, straight from the
    ``chunk_received`` events the stream worker journals (latency =
    ingest receipt to trigger publication for that chunk)."""
    out = []
    for e in events:
        if e.get("event") != "chunk_received":
            continue
        lat = e.get("latency_s")
        if isinstance(lat, (int, float)) and not isinstance(lat, bool):
            out.append((e.get("t", 0.0), float(lat)))
    out.sort()
    return out


def burn_rate(samples: list[tuple], now: float, window_s: float,
              objective_s: float, budget: float,
              min_count: int) -> tuple | None:
    """``(burn, n_samples)`` over one window, or None when fewer
    than ``min_count`` samples landed in it (no claims = no
    verdict, not a clean bill)."""
    in_w = [(t, w) for t, w in samples if t >= now - window_s]
    if len(in_w) < min_count:
        return None
    bad = sum(1 for _, w in in_w if w > objective_s)
    return (bad / len(in_w)) / budget, len(in_w)


def evaluate_rule(rule: Rule, frame: dict) -> dict | None:
    """One rule against one signal frame: ``{"value", "breached",
    ...evidence}``, or None when the rule's signal is unavailable
    (instrument absent, no fsck surface, no burn samples) — a
    skipped rule neither fires nor resolves."""
    now = frame["now"]
    extra: dict = {}
    if rule.kind == "event_count":
        hits = [e for e in frame.get("events", ())
                if e.get("t", 0.0) >= now - rule.window_s
                and _matches(e, rule)]
        value = float(len(hits))
        if hits:
            extra["last_event_t"] = round(hits[-1].get("t", 0.0), 3)
    elif rule.kind == "metric":
        value = metric_value(frame.get("snapshot") or {},
                             rule.metric, rule.labels)
        if value is None:
            return None
    elif rule.kind == "metric_delta":
        hist = (frame.get("samples") or {}).get(rule.id) or []
        if not hist:
            return None
        base = next((v for t, v in hist
                     if t >= now - rule.window_s), None)
        if base is None:
            return None
        value = hist[-1][1] - base
        extra["current"] = hist[-1][1]
    elif rule.kind == "burn_rate":
        samples = frame.get(rule.samples_key) or []
        long = burn_rate(samples, now, rule.window_s,
                         rule.objective_s, rule.budget,
                         rule.min_count)
        short = burn_rate(samples, now, rule.short_window_s,
                          rule.objective_s, rule.budget,
                          rule.min_count)
        if long is None or short is None:
            return None
        value = min(long[0], short[0])
        extra = {"burn_long": round(long[0], 4),
                 "burn_short": round(short[0], 4),
                 "n_samples": long[1]}
    elif rule.kind == "fsck":
        findings = frame.get("fsck")
        if findings is None:
            return None
        value = float(findings)
    else:                                     # pragma: no cover
        raise ValueError(f"unknown rule kind {rule.kind!r}")
    return {"value": round(float(value), 6),
            "breached": _COMPARES[rule.compare](value,
                                               rule.threshold),
            **extra}


# --------------------------------------------------------------------
# notifier plane
# --------------------------------------------------------------------

class LogNotifier:
    """The default sink: one structured log line per transition."""

    kind = "log"

    def __init__(self, logger: logging.Logger | None = None):
        self.log = logger or logging.getLogger("tpulsar_torch.alerts")

    def notify(self, alert: dict) -> bool:
        state = alert.get("state", "firing")
        line = (f"ALERT {state}: {alert.get('rule', '?')} "
                f"[{alert.get('severity', '?')}] "
                f"value={alert.get('value')} "
                f"threshold={alert.get('threshold')} "
                f"window={alert.get('window_s')}s")
        (self.log.warning if state == "firing"
         else self.log.info)("%s", line)
        return True


class WebhookNotifier(LogNotifier):
    """HTTP POST of the alert JSON; delivery failure is logged and
    swallowed (an unreachable webhook must never stall the
    detector loop, let alone the fleet controller hosting it)."""

    kind = "webhook"

    def __init__(self, url: str, timeout_s: float = 5.0,
                 logger: logging.Logger | None = None):
        super().__init__(logger)
        if not url:
            raise ValueError("webhook notifier needs a URL "
                             "(webhook:<url>)")
        self.url = url
        self.timeout_s = timeout_s

    def notify(self, alert: dict) -> bool:
        req = urllib.request.Request(
            self.url, data=json.dumps(alert).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                return 200 <= resp.status < 300
        except (OSError, ValueError) as e:
            self.log.warning("alert webhook %s failed: %s",
                             self.url, e)
            return False


class CommandNotifier(LogNotifier):
    """Run a command per transition with the alert JSON on stdin —
    the operator's escape hatch to pagers this module has never
    heard of."""

    kind = "command"

    def __init__(self, argv_spec: str, timeout_s: float = 10.0,
                 logger: logging.Logger | None = None):
        super().__init__(logger)
        self.argv = shlex.split(argv_spec)
        if not self.argv:
            raise ValueError("command notifier needs an argv "
                             "(command:<cmd args...>)")
        self.timeout_s = timeout_s

    def notify(self, alert: dict) -> bool:
        try:
            proc = subprocess.run(
                self.argv, input=json.dumps(alert).encode(),
                timeout=self.timeout_s,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            return proc.returncode == 0
        except (OSError, subprocess.SubprocessError) as e:
            self.log.warning("alert command %s failed: %s",
                             self.argv[0], e)
            return False


def make_notifier(spec: str,
                  logger: logging.Logger | None = None):
    """``log`` | ``webhook:<url>`` | ``command:<argv>`` — unknown
    schemes fail loudly at configure time, like a fault spec."""
    spec = (spec or "log").strip()
    scheme, _, rest = spec.partition(":")
    if scheme == "log" and not rest:
        return LogNotifier(logger)
    if scheme == "webhook":
        return WebhookNotifier(rest, logger=logger)
    if scheme == "command":
        return CommandNotifier(rest, logger=logger)
    raise ValueError(
        f"unknown alert notifier spec {spec!r} (expected log, "
        f"webhook:<url>, or command:<argv>)")
