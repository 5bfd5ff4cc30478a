"""Declarative, seeded chaos scenarios — counterpart of
tpulsar/chaos/scenario.py (a copy: the schema, the validation and the
schedule file are the JAX package's, so one scenario file drives
either package's storm).

A scenario is one JSON document (or dict) describing everything a
chaos run needs — fleet shape, synthetic workload, and a TIMELINE of
coordinated actions — so a fleet-wide failure storm is a committed
file, not a shell script of sleeps and kills:

    {
      "name": "ci-smoke",
      "seed": 42,
      "duration_s": 60.0,          # hard wall for the whole run
      "workers": 2,
      "worker_kind": "stub",       # stub (torch-free, ms beams) | serve
      "beam_s": 0.4,               # stub beam duration
      "max_attempts": 3,
      "gateway": true,             # submit through the HTTP edge
      "tenants": {"surveyA": {"max_inflight": 2}},
      "workload": {
        "beams": 12, "interval_s": 0.25, "via": "gateway",
        "tenant": "", "priority": null, "datafiles": null
      },
      "timeline": [
        {"t": 1.5, "action": "kill_worker", "worker": "w0",
         "signal": "KILL"},
        {"t": 2.0, "action": "set_faults", "worker": "w1",
         "until": 20.0,
         "faults": "spool.io:unimplemented:count=2,errno=ENOSPC"},
        {"t": 3.5, "action": "restart_gateway"},
        {"t": 4.0, "action": "pause_janitor", "seconds": 2.0}
      ],
      "quiesce_timeout_s": 45.0
    }

Actions split into two transports:

  * ``set_faults`` entries are compiled into the SCHEDULE FILE
    (``<spool>/chaos/schedule.json``) that every process's
    resilience.faults layer polls (TPULSAR_CHAOS_SCHEDULE /
    TPULSAR_CHAOS_WORKER) — per-worker fault windows open and close
    with no conductor involvement, which is what makes one spec drive
    N processes deterministically;
  * everything else (``kill_worker``, ``stop_worker``,
    ``cont_worker``, ``restart_gateway``, ``pause_janitor``) is
    executed by the conductor (runner.py) at its ``t``, and journaled
    as a ``chaos_action`` event so the run's own violence is part of
    the auditable record.

Validation is LOUD (unknown keys/actions/signals raise at load): a
typo'd scenario that silently does nothing would make a chaos run
meaningless — the same contract the faults spec parser honours.
"""

from __future__ import annotations

import dataclasses
import json
import os

from tpulsar_torch.resilience import faults

CHAOS_DIR = "chaos"
SCHEDULE_FILE = "schedule.json"
RUN_FILE = "run.json"

ACTIONS = ("kill_worker", "stop_worker", "cont_worker",
           "restart_gateway", "pause_janitor", "set_faults",
           "surge_submit", "flap_capacity")
KILL_SIGNALS = ("KILL", "TERM")
WORKER_KINDS = ("stub", "serve", "stream")
SUBMIT_VIAS = ("spool", "gateway")


def chaos_dir(spool: str) -> str:
    return os.path.join(spool, CHAOS_DIR)


def schedule_path(spool: str) -> str:
    return os.path.join(chaos_dir(spool), SCHEDULE_FILE)


def run_path(spool: str) -> str:
    return os.path.join(chaos_dir(spool), RUN_FILE)


@dataclasses.dataclass
class Action:
    t: float
    action: str
    worker: str = ""
    signal: str = "KILL"
    seconds: float = 5.0        # pause_janitor duration
    until: float | None = None  # set_faults window close (None = open)
    faults: str = ""
    #: surge_submit: a thundering herd of `beams` extra submissions
    #: at instant t (on top of the steady workload) — the autoscaler
    #: storm; flap_capacity: `cycles` alternations of a `beams` burst
    #: followed by `period_s` of silence — load that OSCILLATES
    #: faster than naive scaling reacts, the thrash the cooldown/
    #: hysteresis must absorb
    beams: int = 0
    cycles: int = 2
    period_s: float = 1.0


@dataclasses.dataclass
class Workload:
    beams: int = 8
    interval_s: float = 0.25
    via: str = "spool"
    tenant: str = ""
    priority: object = None
    datafiles: list | None = None   # None = synthetic stub inputs
    #: passes > 0 turns each stub beam into a MULTI-PASS checkpointed
    #: beam (chaos/worker.py _run_pass_beam): `passes` units of
    #: `pass_s` seconds each, dumped through the real checkpoint
    #: store so kill-mid-beam scenarios exercise pass-level resume
    passes: int = 0
    pass_s: float = 0.05
    #: > 0 turns each "beam" into a STREAMING SESSION
    #: (worker_kind=stream): the conductor opens a session under
    #: <chaos>/stream, submits its stream ticket, then a feeder
    #: thread lands `stream_chunks` framed chunks at
    #: `stream_interval_s` cadence through the real ingest module —
    #: skipping every seq in `stream_drop_seqs` (a declared gap the
    #: worker must zero-fill, never splice) — and closes the
    #: session.  Chunk payloads are a pure function of
    #: (scenario, seed, session, seq), so a storm run and its
    #: timeline-stripped control run must produce identical
    #: trigger digests.
    stream_chunks: int = 0
    stream_chunk_len: int = 256
    stream_nchan: int = 16
    stream_ndms: int = 8
    stream_interval_s: float = 0.2
    stream_drop_seqs: list = dataclasses.field(default_factory=list)
    #: per-chunk ingest-to-searched latency objective journaled on
    #: every chunk_received — the trigger_latency_bounded invariant
    #: judges against THIS number, so it must absorb a worker kill
    #: plus controller restart plus session resume
    stream_slo_s: float = 30.0


@dataclasses.dataclass
class Scenario:
    name: str = "chaos"
    seed: int = 0
    duration_s: float = 60.0
    workers: int = 2
    worker_kind: str = "stub"
    beam_s: float = 0.2
    max_attempts: int = 3
    max_worker_restarts: int = 5
    gateway: bool = False
    #: > 1 = batched admission: every worker claims up to `batch`
    #: compatible tickets per ordering pass (protocol.claim_batch)
    #: and journals a batch_dispatch per coalesced group — the storm
    #: then audits exactly-once/attempts under batch claims too
    batch: int = 1
    #: ticket-queue backend for the whole storm: "" = the spool
    #: itself (the default, byte-identical to every pre-queue_url
    #: scenario), the token "sqlite" = a queue.db INSIDE the run
    #: spool (sqlite:<spool>/queue.db — journal and artifacts stay
    #: where every consumer expects them), or a full backend URL.
    #: The conductor, every worker, and the verifier all resolve the
    #: same backend from this one field
    queue_url: str = ""
    #: true = SPOOL-LESS data plane: the conductor uploads each beam's
    #: synthetic input bytes into the gateway CAS and submits tickets
    #: carrying ``blobs:`` {filename: sha256} refs instead of shared
    #: paths; workers stage in BY DIGEST over HTTP (TPULSAR_DATA_URL),
    #: write real .accelcands artifacts, push them back into the CAS,
    #: and index candidates — arming the blob_durable and
    #: index_consistent invariants.  Requires gateway: true (the CAS
    #: is mounted on the gateway's blob routes)
    dataplane: bool = False
    tenants: dict = dataclasses.field(default_factory=dict)
    #: non-empty = run the fleet ELASTIC: the dict is an
    #: autoscale.AutoscaleConfig (validated at load, same loud
    #: contract), `workers` becomes the initial count (clamped into
    #: [min, max] by the controller), and the new scaling_bounded /
    #: no_elastic_strike invariants arm themselves on the journal
    autoscale: dict = dataclasses.field(default_factory=dict)
    workload: Workload = dataclasses.field(default_factory=Workload)
    timeline: list[Action] = dataclasses.field(default_factory=list)
    quiesce_timeout_s: float = 45.0
    poll_s: float = 0.3             # controller supervision cadence

    def effective_queue_url(self, spool: str,
                            override: str = "") -> str:
        """The backend URL this run actually uses: '' stays the
        spool, the 'sqlite' token expands to a queue.db inside it,
        anything else is taken verbatim.  ``override`` (the CLI's
        ``chaos run --queue``) wins over the scenario's own field —
        same token rules."""
        url = override or self.queue_url
        if not url:
            return f"spool:{spool}"
        if url == "sqlite":
            return f"sqlite:{os.path.join(spool, 'queue.db')}"
        return url

    def fault_windows(self) -> list[Action]:
        return [a for a in self.timeline if a.action == "set_faults"]

    def conductor_actions(self) -> list[Action]:
        return sorted((a for a in self.timeline
                       if a.action != "set_faults"),
                      key=lambda a: a.t)


def _take(src: dict, cls, what: str, **overrides):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(src) - fields
    if unknown:
        raise ValueError(
            f"{what}: unknown key(s) {sorted(unknown)} "
            f"(known: {sorted(fields)})")
    return cls(**{**src, **overrides})


def from_dict(doc: dict) -> Scenario:
    """Parse + validate one scenario document.  Raises ValueError on
    anything unknown or inconsistent."""
    if not isinstance(doc, dict):
        raise ValueError("scenario must be a JSON object")
    doc = dict(doc)
    wl_doc = doc.pop("workload", {}) or {}
    tl_doc = doc.pop("timeline", []) or []
    wl = _take(dict(wl_doc), Workload, "workload")
    if wl.via not in SUBMIT_VIAS:
        raise ValueError(f"workload.via {wl.via!r} not in "
                         f"{SUBMIT_VIAS}")
    if wl.beams <= 0:
        raise ValueError("workload.beams must be positive")
    if wl.passes < 0 or (wl.passes and wl.pass_s <= 0):
        raise ValueError("workload.passes must be >= 0 with a "
                         "positive pass_s")
    if wl.passes and wl.via != "spool":
        # the gateway client does not plumb the pass-beam extras —
        # refuse loudly rather than run a storm whose beams silently
        # never checkpoint
        raise ValueError("workload.passes needs via=spool")
    timeline = []
    for i, a_doc in enumerate(tl_doc):
        a = _take(dict(a_doc), Action, f"timeline[{i}]")
        if a.action not in ACTIONS:
            raise ValueError(
                f"timeline[{i}]: unknown action {a.action!r} "
                f"(known: {', '.join(ACTIONS)})")
        if a.action in ("kill_worker", "stop_worker", "cont_worker") \
                and not a.worker:
            raise ValueError(f"timeline[{i}]: {a.action} needs a "
                             f"worker id")
        if a.action == "kill_worker" \
                and a.signal.upper() not in KILL_SIGNALS:
            raise ValueError(
                f"timeline[{i}]: kill signal {a.signal!r} not in "
                f"{KILL_SIGNALS}")
        if a.action == "set_faults":
            if not a.faults:
                raise ValueError(f"timeline[{i}]: set_faults needs a "
                                 f"faults spec")
            faults.parse_spec(a.faults)     # validate NOW, loudly
            if a.until is not None and a.until <= a.t:
                raise ValueError(f"timeline[{i}]: until {a.until} "
                                 f"<= t {a.t}")
        if a.action in ("surge_submit", "flap_capacity") \
                and a.beams < 1:
            raise ValueError(f"timeline[{i}]: {a.action} needs "
                             f"beams >= 1")
        if a.action == "flap_capacity" \
                and (a.cycles < 1 or a.period_s <= 0):
            raise ValueError(f"timeline[{i}]: flap_capacity needs "
                             f"cycles >= 1 and a positive period_s")
        timeline.append(a)
    sc = _take(doc, Scenario, "scenario", workload=wl,
               timeline=timeline)
    if sc.worker_kind not in WORKER_KINDS:
        raise ValueError(f"worker_kind {sc.worker_kind!r} not in "
                         f"{WORKER_KINDS}")
    if sc.workers < 1:
        raise ValueError("workers must be >= 1")
    if sc.batch < 1:
        raise ValueError("batch must be >= 1")
    if sc.queue_url and sc.queue_url != "sqlite" \
            and ":" not in sc.queue_url:
        raise ValueError(
            f"queue_url {sc.queue_url!r} is neither the 'sqlite' "
            f"token nor a backend URL (sqlite:<path>, spool:<dir>)")
    if sc.queue_url == "memory" or sc.queue_url.startswith("memory:"):
        raise ValueError("queue_url=memory cannot host a multi-"
                         "process storm (no cross-process state)")
    if sc.gateway is False and wl.via == "gateway":
        raise ValueError("workload.via=gateway needs gateway: true")
    if sc.dataplane and not sc.gateway:
        raise ValueError("dataplane: true needs gateway: true (the "
                         "CAS rides the gateway's blob routes)")
    if sc.dataplane and sc.worker_kind != "stub":
        raise ValueError("dataplane: true needs worker_kind=stub "
                         "(the stub worker implements the synthetic "
                         "by-digest beam)")
    if sc.worker_kind == "serve" and wl.datafiles is None:
        raise ValueError("worker_kind=serve needs workload.datafiles "
                         "(real beams for real workers)")
    if (sc.worker_kind == "stream") != (wl.stream_chunks > 0):
        raise ValueError("worker_kind=stream and workload."
                         "stream_chunks > 0 come together (both or "
                         "neither)")
    if sc.worker_kind == "stream":
        if wl.via != "spool":
            raise ValueError("stream workloads need via=spool (the "
                             "conductor feeds frames through the "
                             "ingest module directly)")
        if sc.batch > 1:
            raise ValueError("stream workloads need batch=1 (the "
                             "stream worker claims one session "
                             "ticket at a time)")
        if wl.passes:
            raise ValueError("workload.passes is a stub-beam knob — "
                             "not valid with worker_kind=stream")
        if wl.stream_chunk_len <= 0 or wl.stream_nchan <= 0 \
                or wl.stream_ndms <= 0:
            raise ValueError("stream geometry fields (stream_chunk_"
                             "len, stream_nchan, stream_ndms) must "
                             "be positive")
        if wl.stream_interval_s < 0 or wl.stream_slo_s <= 0:
            raise ValueError("stream_interval_s must be >= 0 and "
                             "stream_slo_s positive")
        bad = [s for s in wl.stream_drop_seqs
               if not isinstance(s, int) or isinstance(s, bool)
               or s < 0 or s >= wl.stream_chunks]
        if bad:
            raise ValueError(f"stream_drop_seqs entries must be "
                             f"ints in [0, stream_chunks); got "
                             f"{bad}")
    if sc.tenants:
        # validate the tenant table exactly as the claim path will
        from tpulsar_torch.frontdoor.tenancy import TenantPolicy
        TenantPolicy(sc.tenants)
    if sc.autoscale:
        # validate the elastic policy exactly as the controller will
        from tpulsar_torch.fleet.autoscale import AutoscaleConfig
        AutoscaleConfig.from_dict(sc.autoscale)
    return sc


def load(path: str) -> Scenario:
    """Load a scenario file — an absolute/relative path, or the name
    of a packaged scenario (``ci_smoke`` ->
    tpulsar_torch/chaos/scenarios/ci_smoke.json)."""
    if not os.path.exists(path) and "/" not in path:
        candidate = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "scenarios",
            path if path.endswith(".json") else path + ".json")
        if os.path.exists(candidate):
            path = candidate
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except OSError as e:
        raise ValueError(f"cannot read scenario {path!r}: {e}") \
            from None
    except ValueError as e:
        raise ValueError(f"scenario {path!r} is not valid JSON: {e}") \
            from None
    sc = from_dict(doc)
    return sc


def write_schedule(spool: str, sc: Scenario, t0: float,
                   arm: bool = True) -> str:
    """Compile the scenario's ``set_faults`` windows into the
    schedule file the fleet's faults layers poll.  Written even when
    empty: a worker pointed at the file must find it (a missing
    schedule and a typo'd path look identical otherwise).
    ``arm=False`` writes the file with NO entries — the conductor's
    boot-time placeholder, so windows cannot open against a fleet
    that is still booting (boot time is variable; the armed rewrite
    re-anchors t0 at the workload start, which is what makes
    same-seed runs the same storm)."""
    os.makedirs(chaos_dir(spool), exist_ok=True)
    entries = []
    for a in (sc.fault_windows() if arm else ()):
        entry = {"worker": a.worker or "*", "at": a.t,
                 "faults": a.faults}
        if a.until is not None:
            entry["until"] = a.until
        entries.append(entry)
    path = schedule_path(spool)
    # the blessed atomic write (same helper the runner's manifest
    # uses): a worker's faults poller must never observe a torn
    # schedule, and the conductor process is not itself armed, so
    # the helper's spool.io fault point cannot sever the storm
    from tpulsar_torch.serve import protocol
    protocol._atomic_write_json(
        path, {"version": 1, "t0": t0, "seed": sc.seed,
               "scenario": sc.name, "entries": entries})
    return path
