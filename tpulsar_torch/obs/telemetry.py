"""The instrument catalog of the search path — counterpart of
tpulsar/obs/telemetry.py, with the JAX package's metric names, help
texts, labels and buckets, so a beam's metrics.json reads the same
whichever package searched it.

  * ``trace`` / ``metrics`` — the span tracer (obs/trace.py) and the
    process-wide metrics registry (obs/metrics.py), re-exported;
  * the instruments the executor, the stage timers, the hi-accel
    stage (its path-labelled trials and seconds, and the ladder's
    rescued/lost rows and breaker-skipped rows) and the checkpoint
    store record, the tree family's gauges and the batch-of-beams
    families;
  * the resident server's: the serve family, the queue backends'
    op latency, the tenant quota gauge, the retry/backoff/circuit
    counters of resilience/policy.py;
  * the front door's (frontdoor/gateway.py and federation.py: the
    gateway request and submission families, the router's member
    capacity and routing counters) and the blob data plane's
    (dataplane/blobstore.py, transfer.py and the server's stage-in:
    bytes, blob operations, verify failures, transfer seconds);
  * the fleet's (fleet/controller.py: worker states, restarts,
    requeues, quarantines, scale decisions, capacity; the
    journal-derived SLO, ticket and event-rate gauges fleetview.py
    builds into a caller-owned registry) and the health doctor's
    ``tpulsar_alerts_active`` (obs/health.py);
  * the chaos harness's (chaos/runner.py's timeline actions, the
    verifier's violations);
  * ``event_record``, the one heartbeat/journal event shape.

  * the compile-cache family (aot/warmstart.py::record_build): a hit
    or a miss for every lookup of a shared library in the build
    directory, by the registered library being gated or ``(inline)``
    for a build at first use, and the build's seconds.

stdlib only.
"""

from __future__ import annotations

import time

from tpulsar_torch.obs import metrics, trace  # re-exported  # noqa: F401

# Getters, not module-level instances: the registry get-or-create
# makes each call cheap, and a test that resets metrics.REGISTRY never
# holds stale instrument handles through this module.

#: histogram buckets for per-stage beam timings (seconds): chunk-level
#: scopes land in the sub-second decades, full stages in the minutes
STAGE_BUCKETS = (0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 180.0, 600.0,
                 1800.0)


def stage_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_stage_seconds",
        "wall seconds per executor timing scope (one observation per "
        "scope entry, so chunked stages observe once per chunk)",
        labelnames=("stage",), buckets=STAGE_BUCKETS)


def passes_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_passes_total",
        "completed dedispersion passes")


def dm_trials_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_dm_trials_total",
        "DM trials searched")


def dedisp_trials_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_dedisp_trials_total",
        "DM trials dedispersed, by stage-2 kernel family (direct "
        "shift-and-sum vs log-depth shift tree) — with "
        "tpulsar_dedisp_stage_seconds this yields trials/sec per "
        "family",
        labelnames=("family",))


def dedisp_stage_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_dedisp_stage_seconds",
        "wall seconds of stage-2 dedispersion per pass, by kernel "
        "family (tree observations include the shared level "
        "evaluation, the per-chunk residual layers, and the fused "
        "detrend)",
        labelnames=("family",), buckets=STAGE_BUCKETS)


def dedisp_tree_depth() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_dedisp_tree_depth",
        "merge-level depth of the most recent pass's tree plan (0 = "
        "the plan cut at the leaves, i.e. direct-equivalent; the "
        "budget governor cuts shallower when level tensors would "
        "exceed TPULSAR_TREE_BUDGET)")


def dedisp_residual_fraction() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_dedisp_residual_fraction",
        "fraction of the most recent tree pass's row-ops spent in "
        "the per-trial residual layer (the rest is the shared "
        "merge levels every trial reuses); near 1.0 means the grid "
        "shares almost nothing and direct would do as well")


def rescue_rows_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_rescue_rows_total",
        "refused accel rows by FINAL outcome — rescued (host "
        "recompute) or lost (zero-filled); disjoint, so the outcome "
        "series sum to the refused row count",
        labelnames=("outcome",))


def accel_undispatched_rows_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_accel_undispatched_rows_total",
        "accel rows never dispatched because the open breaker routed "
        "them straight to rescue (diagnostic overlay: these rows ALSO "
        "appear in tpulsar_rescue_rows_total under their final "
        "outcome)")


def accel_batch_trials_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_accel_batch_trials_total",
        "hi-accel DM trials by the dispatch path that produced their "
        "final powers — batched (the fused DM-batch chunk program or "
        "its native CPU consumer), per_dm (the per-trial row "
        "dispatch a degraded batch fell back to), rescued (host-CPU "
        "recompute of refused rows).  Disjoint, and only REAL powers "
        "count: zero-filled losses live in "
        "tpulsar_rescue_rows_total{outcome=lost} and the degraded "
        "ledger, never here — with "
        "tpulsar_accel_stage_seconds this yields dm_trials_per_sec "
        "per dispatch path",
        labelnames=("path",))


def accel_kernel_rows_total() -> metrics.Counter:
    """The port's own family (the JAX package has no stage kernel)."""
    return metrics.counter(
        "tpulsar_accel_kernel_rows_total",
        "hi-accel DM trials whose batched powers the card's stage "
        "kernel (csrc/accel_stage.cu) summed and reduced: a subset of "
        "tpulsar_accel_batch_trials_total{path=batched}, all of them "
        "on the card and none on the CPU")


def accel_stage_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_accel_stage_seconds",
        "wall seconds per hi-accel stage call, by path: batched = "
        "at least one fused DM-batch dispatch resolved rows (the "
        "healthy route), per_dm = the per-trial ladder handled the "
        "whole call, rescued = the executor's whole-chunk host "
        "rescue after the runtime refused every dispatch",
        labelnames=("path",), buckets=STAGE_BUCKETS)


def beam_batch_beams_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_beam_batch_beams_total",
        "beams searched by dispatch path: batched = inside a "
        "coalesced multi-beam group (kernels/beam_batch.py), solo = "
        "the single-beam path (no batchmates, resume state, an "
        "operator cap of 1, a ragged group remainder, or per-beam "
        "degradation out of a failed group).  Disjoint: together "
        "they count every beam a batch entry point searched",
        labelnames=("path",))


def beam_batch_occupancy() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_beam_batch_occupancy",
        "beams in the most recent coalesced dispatch group (a "
        "BATCH_QUANTA rung; compare against the serve worker's "
        "--batch admission size to see how full batches actually "
        "run)")


def beam_batch_trials_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_beam_batch_trials_total",
        "DM trials searched through a batch-of-beams entry point by "
        "path: batched trials rode coalesced B-beam dispatches, solo "
        "trials a beam that fell out of (or never joined) a batch — "
        "the beams/dispatch occupancy story in trial units",
        labelnames=("path",))


def checkpoint_events_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_checkpoint_events_total",
        "checkpoint-store lifecycle events (tpulsar/checkpoint/): "
        "written = artifact durable+manifested, resumed = artifact "
        "verified and loaded on re-entry, invalid = corrupt/torn "
        "entry discarded and recomputed, disabled = ENOSPC/EROFS "
        "degraded the beam to un-checkpointed — 'invalid' at any "
        "sustained rate means a sick checkpoint volume",
        labelnames=("outcome",))


def retry_attempts_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_retry_attempts_total",
        "retries issued by the shared resilience policy engine",
        labelnames=("point",))


def backoff_seconds_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_backoff_seconds_total",
        "seconds slept in policy backoff",
        labelnames=("point",))


def circuit_transitions_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_circuit_transitions_total",
        "circuit-breaker state transitions",
        labelnames=("point", "state"))


# the orchestration daemons (orchestrate/)

def pool_rotate_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_pool_rotate_seconds",
        "job-pool scheduler iteration latency")


def download_bytes_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_download_bytes_total",
        "bytes fetched by completed downloads")


def download_failures_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_download_failures_total",
        "download failures by kind",
        labelnames=("kind",))        # transfer | verify


def upload_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_upload_seconds",
        "per-category upload timing (the debugflags 'upload' "
        "summary, aggregated as a histogram)",
        labelnames=("category",))


def uploads_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_uploads_total",
        "upload attempts by outcome",
        # uploaded | deferred | failed | error (unexpected exception)
        labelnames=("outcome",))


def heartbeats_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_heartbeats_total",
        "telemetry heartbeat events emitted",
        labelnames=("event",))


#: histogram buckets for backend-compile time.  The three families keep
#: the JAX package's names, help texts, labels and buckets, as every
#: family here does; in the port a "module" is a shared library, and
#: its builds take seconds
COMPILE_BUCKETS = (0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 180.0, 600.0,
                   1800.0)


def compile_cache_hits_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_compile_cache_hits_total",
        "persistent compilation-cache hits (one per XLA module served "
        "from the cache dir); program = the registered AOT program "
        "being gated, or (inline) for runtime dispatch compiles",
        labelnames=("program",))


def compile_cache_misses_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_compile_cache_misses_total",
        "persistent compilation-cache misses — an (inline) miss "
        "during a measured run is a silent recompile the AOT gate "
        "should have absorbed (tpulsar aot verify localizes it)",
        labelnames=("program",))


def backend_compile_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_backend_compile_seconds",
        "XLA backend compile time per module (cache hits skip the "
        "backend compile entirely, so every observation here is a "
        "real compile)",
        labelnames=("program",), buckets=COMPILE_BUCKETS)


#: histogram buckets for serve-loop waits: admission latencies from
#: immediate claims up to a queue that backed up for most of an hour
SERVE_WAIT_BUCKETS = (0.1, 0.5, 2.0, 10.0, 30.0, 120.0, 600.0, 3600.0)


def serve_queue_depth() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_serve_queue_depth",
        "tickets waiting in the serve spool admission queue "
        "(incoming, not yet claimed by the server)")


def serve_admission_wait_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_serve_admission_wait_seconds",
        "ticket submit -> server claim latency (how long beams wait "
        "in the admission queue before the warm worker picks them up)",
        buckets=SERVE_WAIT_BUCKETS)


def serve_beam_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_serve_beam_seconds",
        "per-beam wall time inside the resident server, labelled by "
        "compile temperature: cold = the beam paid at least one "
        "compile-cache miss, warm = it compiled nothing",
        labelnames=("mode",), buckets=STAGE_BUCKETS)


def serve_beams_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_serve_beams_total",
        "beams processed by the resident server, by outcome "
        "(done | failed | skipped)",
        labelnames=("outcome",))


def serve_drain_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_serve_drain_seconds",
        "SIGTERM-to-exit drain duration (finishing the in-flight "
        "beam, stopping the prefetch thread, final heartbeat)",
        buckets=SERVE_WAIT_BUCKETS)


def serve_stagein_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_serve_stagein_seconds",
        "host-side stage-in + preprocess time per beam in the "
        "prefetch thread (overlapped with device compute of the "
        "previous beam, so this only costs wall time when it exceeds "
        "the device time)",
        buckets=STAGE_BUCKETS)


def fleet_workers() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_fleet_workers",
        "fleet workers by state: fresh (heartbeat current, accepting "
        "work), stale (process alive, heartbeat old — wedged?), dead "
        "(process gone)",
        labelnames=("state",))


def fleet_restarts_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_fleet_restarts_total",
        "worker restarts issued by the fleet controller (crash "
        "restarts count against the backoff budget; rolling-restart "
        "cycles do not)",
        labelnames=("worker", "kind"))       # kind: crash | rolling


def fleet_requeued_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_fleet_requeued_total",
        "tickets the fleet janitor reclaimed from dead workers "
        "(work-stealing requeues; each increments the ticket's "
        "attempts counter)")


def fleet_quarantined_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_fleet_quarantined_total",
        "poisoned beams isolated in quarantine/ after repeatedly "
        "killing their worker (attempts reached the cap)")


def fleet_scale_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_fleet_scale_total",
        "autoscaler decisions executed, by direction (up = workers "
        "added from journal-derived load signals, down = a victim "
        "drained or — spot class — SIGKILLed; every decision is also "
        "journaled as a scale_up/scale_down event with its signals)",
        labelnames=("direction",))


def fleet_autoscale_workers() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_fleet_autoscale_workers",
        "the autoscaler's current active worker-slot count (within "
        "configured [min, max]); absent when autoscaling is off")


def fleet_capacity() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_fleet_capacity",
        "aggregate remaining admission capacity: sum of fresh "
        "workers' advertised queue depths minus tickets waiting "
        "(what the warm backend's can_submit consults); 0 = fresh "
        "workers but a saturated queue (backpressure), -1 = ZERO "
        "fresh workers (clients load-shed to process-per-beam)")


#: histogram buckets for gateway HTTP handling: sub-millisecond local
#: routing up to multi-second federation forwards and staging waits
GATEWAY_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0)


def gateway_requests_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_gateway_requests_total",
        "HTTP requests handled by the front-door gateway, by route "
        "and response code",
        labelnames=("route", "code"))


def gateway_request_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_gateway_request_seconds",
        "gateway HTTP handling latency per route (submission "
        "includes admission checks and the queue write; streaming "
        "routes observe the full stream duration)",
        labelnames=("route",), buckets=GATEWAY_BUCKETS)


def gateway_submissions_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_gateway_submissions_total",
        "beam submissions at the gateway by tenant and outcome: "
        "accepted (ticket written), routed (forwarded to a "
        "federation member), quota (tenant max_pending refused, "
        "HTTP 429), backpressure (fleet queue full, HTTP 429), "
        "load_shed (zero fresh workers / every member shedding, "
        "HTTP 503), invalid (bad request), error (router: every "
        "member transport-failed, HTTP 502)",
        labelnames=("tenant", "outcome"))


def frontdoor_quota_deferred() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_frontdoor_quota_deferred",
        "pending tickets skipped in the most recent claim-ordering "
        "pass because their tenant is at its max_inflight quota "
        "(deferred, not dropped: they re-enter ordering as the "
        "tenant's in-flight beams finish)",
        labelnames=("tenant",))


def frontdoor_host_capacity() -> metrics.Gauge:
    return metrics.gauge(
        "tpulsar_frontdoor_host_capacity",
        "per-member-host advertised admission capacity as last "
        "polled by the federation router: >0 = accepting, 0 = "
        "saturated (backpressure), -1 = load-shedding or "
        "unreachable (routed around)",
        labelnames=("host",))


def frontdoor_routed_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_frontdoor_routed_total",
        "federation router submissions by member host and outcome "
        "(ok | error)",
        labelnames=("host", "outcome"))


# the journal-derived fleet SLO instruments: built into a CALLER-
# OWNED registry, not the process-global one — the fleet aggregator
# derives them from the spool journal on every aggregation pass and
# merges the fresh registry into fleet.prom, so a half-updated
# global series is never scraped.  Catalog membership is what the
# contract linter checks; the registry handle is the caller's.

def fleet_slo_seconds(reg: metrics.Registry) -> metrics.Gauge:
    return reg.gauge(
        "tpulsar_fleet_slo_seconds",
        "journal-derived fleet latency quantiles: queue_wait = "
        "gateway receipt (HTTP arrival; spool submit when no "
        "gateway) -> first claim, claim_to_start = claim -> device "
        "work, beam_e2e = receipt -> terminal result (exact "
        "quantiles over the journal's raw durations, spanning every "
        "worker that touched each beam)",
        labelnames=("series", "quantile"))


def fleet_slo_source_workers(reg: metrics.Registry) -> metrics.Gauge:
    return reg.gauge(
        "tpulsar_fleet_slo_source_workers",
        "distinct workers whose journal events feed each SLO series",
        labelnames=("series",))


def fleet_tickets(reg: metrics.Registry) -> metrics.Gauge:
    return reg.gauge(
        "tpulsar_fleet_tickets",
        "journal tickets by lifecycle status (terminal statuses "
        "from the result event; in-flight = no terminal yet)",
        labelnames=("status",))


def fleet_event_rate(reg: metrics.Registry) -> metrics.Gauge:
    return reg.gauge(
        "tpulsar_fleet_event_rate",
        "journal takeovers/quarantines per TERMINAL ticket — the "
        "fleet's crash-recovery and poison pressure",
        labelnames=("event",))


def alerts_active(reg: metrics.Registry) -> metrics.Gauge:
    return reg.gauge(
        "tpulsar_alerts_active",
        "health-doctor alert rules currently firing (value 1 per "
        "active rule), by rule id and severity — each transition is "
        "also journaled as an alert_fired/alert_resolved event "
        "carrying the rule's signal values and window, so the gauge "
        "is the live view and the journal the evidence",
        labelnames=("rule", "severity"))


#: histogram buckets for ticket-queue backend operations: healthy
#: sub-millisecond spool renames / SQLite commits up to lock-contended
#: multi-second waits (TPULSAR_QUEUE_BUSY_TIMEOUT_S territory)
QUEUE_OP_BUCKETS = (0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0, 30.0)


def queue_op_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_queue_op_seconds",
        "ticket-queue backend operation latency by backend (spool | "
        "sqlite) and op (submit/claim/claim_batch/requeue_scan/"
        "result/heartbeat/...) — both backends observe the same op "
        "vocabulary so an A/B between the spool protocol and the "
        "durable SQLite queue is one PromQL ratio",
        labelnames=("backend", "op"), buckets=QUEUE_OP_BUCKETS)


#: histogram buckets for data-plane blob transfers: millisecond-scale
#: candidate artifacts up to multi-minute beam stage-ins over a
#: congested link
DATAPLANE_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0,
                     300.0)


def dataplane_bytes_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_dataplane_bytes_total",
        "bytes moved through the content-addressed blob store, by op "
        "(put = ingested writes incl. dedup hits, get = reads served "
        "to stage-in/fetch callers)",
        labelnames=("op",))


def dataplane_blobs_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_dataplane_blobs_total",
        "blob-store operations by op and outcome: put "
        "(stored | dedup | error), get (hit | miss | error), gc "
        "(collected | kept) — verify failures count as error here "
        "AND in tpulsar_dataplane_verify_failures_total",
        labelnames=("op", "outcome"))


def dataplane_verify_failures_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_dataplane_verify_failures_total",
        "content-integrity failures in the data plane: bytes whose "
        "re-hash disagreed with their address (torn/corrupt object, "
        "tampered transfer) — the paper's verify-after-write "
        "discipline; alert at ANY sustained rate",
        labelnames=("where",))       # store | transfer | stagein


def dataplane_transfer_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_dataplane_transfer_seconds",
        "wall seconds per blob transfer, by op (put | get) — local "
        "CAS I/O and HTTP blob-route streams observe the same "
        "series, so a congested data plane shows as the histogram "
        "tail walking right",
        labelnames=("op",), buckets=DATAPLANE_BUCKETS)


STREAM_LATENCY_BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0,
                          2.5, 5.0, 15.0, 60.0)


def stream_latency_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_stream_latency_seconds",
        "per-chunk ingest->trigger latency of the streaming plane "
        "(frame t_ingest to chunk acknowledgment, spans searched "
        "and triggers published) — THE stream SLO series; the "
        "stream_latency_burn alert rule burns against the same "
        "samples from the journal",
        buckets=STREAM_LATENCY_BUCKETS)


def stream_chunks_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_stream_chunks_total",
        "stream chunks acknowledged, by outcome (received = "
        "dedispersed+searched exactly once, gap = missing seq "
        "zero-filled and journaled, replayed = reprocessed after a "
        "resume without re-acknowledgment) — gap or replayed at a "
        "sustained rate means a sick ingest path",
        labelnames=("outcome",))


def stream_triggers_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_stream_triggers_total",
        "single-pulse trigger records published by the streaming "
        "plane (post span search, post dedup) — the science output "
        "rate; zero over a session with injected pulses is a "
        "detection regression, not quiet sky",
    )


def chaos_actions_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_chaos_actions_total",
        "chaos-conductor timeline actions executed (kill_worker | "
        "stop_worker | cont_worker | restart_gateway | "
        "pause_janitor | submit_refused)",
        labelnames=("action",))


def chaos_violations_total() -> metrics.Counter:
    return metrics.counter(
        "tpulsar_chaos_violations_total",
        "invariant violations reported by the chaos verifier, by "
        "invariant name — nonzero means the serving contract BROKE "
        "under the scenario, alert at any value",
        labelnames=("invariant",))


# --------------------------------------------------------------------
# the shared heartbeat/progress event shape
# --------------------------------------------------------------------

def event_record(event: str, stage: str = "", info: str = "",
                 t_stage: float = 0.0, **extra) -> dict:
    """The canonical telemetry event: ``{"t": now, "event": ...}``
    plus stage attribution when present — the shape of the stage
    heartbeat (search/report.py) and of every journal line
    (obs/journal.py), as in the JAX package.  ``extra`` keys are
    additive — consumers key on the names above and ignore the
    rest."""
    rec: dict = {"t": time.time(), "event": event}
    if stage:
        rec["stage"] = stage
    if t_stage:
        rec["t_stage"] = t_stage
    if info:
        rec["info"] = info
    rec.update(extra)
    heartbeats_total().inc(event=event or "?")
    return rec
