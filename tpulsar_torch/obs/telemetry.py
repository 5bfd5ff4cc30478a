"""The instrument catalog of the search path — counterpart of
tpulsar/obs/telemetry.py, with the JAX package's metric names, help
texts, labels and buckets, so a beam's metrics.json reads the same
whichever package searched it.

  * ``trace`` / ``metrics`` — the span tracer (obs/trace.py) and the
    process-wide metrics registry (obs/metrics.py), re-exported;
  * the instruments the executor, the stage timers, the hi-accel
    stage and the checkpoint store record.

The serve, fleet, download, upload and compile-cache families come
with the modules that record them.  stdlib only.
"""

from __future__ import annotations

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


def accel_stage_seconds() -> metrics.Histogram:
    return metrics.histogram(
        "tpulsar_accel_stage_seconds",
        "wall seconds per hi-accel stage call, by path: batched = "
        "at least one fused DM-batch dispatch resolved rows (the "
        "healthy route), per_dm = the per-trial ladder handled the "
        "whole call, rescued = the executor's whole-chunk host "
        "rescue after the runtime refused every dispatch",
        labelnames=("path",), buckets=STAGE_BUCKETS)


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
