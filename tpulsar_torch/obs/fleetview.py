"""Fleet-wide metrics: merge per-worker registries + journal SLOs —
counterpart of tpulsar/obs/fleetview.py (a copy; the files it reads
and writes have the JAX package's layout, so either package's fleet
merges the other's workers).

The metrics registry is per-process; the fleet is N serve workers
plus a controller, each with its own registry.  This module is the
fleet's single pane:

  * every serve worker drops its registry snapshot into
    ``<spool>/metrics/<worker>.json`` on each heartbeat
    (``export_worker_snapshot``: the JSON-round-trip contract of
    ``Registry.snapshot()`` makes the files mergeable);
  * ``merge_snapshots`` folds them into ONE snapshot — counters and
    histograms sum across workers (bucket edges are part of the
    instrument definition, so bucket-wise addition is exact), gauges
    take the max (fleet workers report the same spool-level
    readings, e.g. queue depth, so max == any fresh reading);
  * the ticket journal (obs/journal.py) contributes the SLO series no
    single process can compute — queue-wait, claim-to-start, and
    end-to-end beam latency p50/p95/p99 span submitters, claimers,
    janitors, and finishers in different processes;
  * ``write_fleet_prom`` renders the merged result as
    ``<spool>/fleet.prom`` — what the fleet controller exports each
    loop; ``render_top`` is one refresh of the JAX CLI's
    ``obs top`` (the port's ``obs`` command is still to come).

Also here: ``stitch`` — merge a beam's journal events and its trace
spans (matched by the ticket's trace id, rebased from each worker's
trace epoch to shared unix time) into one Perfetto timeline, even
when a steal split the beam's life across two worker processes.

stdlib only.
"""

from __future__ import annotations

import glob
import json
import os
import time

from tpulsar_torch.obs import journal, metrics, telemetry
from tpulsar_torch.serve import protocol

METRICS_DIR = "metrics"

#: journal-derived SLO series exported on the merged snapshot
SLO_SERIES = ("queue_wait", "claim_to_start", "beam_e2e")


def snapshot_path(spool: str, worker_id: str = "") -> str:
    return os.path.join(spool, METRICS_DIR,
                        f"{worker_id or 'server'}.json")


def export_worker_snapshot(spool: str, worker_id: str = "") -> None:
    """Drop this process's registry snapshot into the spool (atomic
    replace; failure never disturbs the worker)."""
    path = snapshot_path(spool, worker_id)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        protocol._atomic_write_json(path, {
            "t": time.time(), "worker": worker_id,
            "metrics": metrics.REGISTRY.snapshot()})
    except OSError:
        pass


def worker_snapshots(spool: str) -> dict[str, dict]:
    """Every worker snapshot on the spool, keyed by worker id."""
    out: dict[str, dict] = {}
    for path in sorted(glob.glob(
            os.path.join(spool, METRICS_DIR, "*.json"))):
        rec = protocol._read_json(path)
        if rec is None or "metrics" not in rec:
            continue
        wid = rec.get("worker", "")
        out[wid or os.path.basename(path)[:-5]] = rec
    return out


def merge_snapshots(snaps: list[dict]) -> dict:
    """Fold N ``Registry.snapshot()`` dicts into one: counter and
    histogram series SUM per label key, gauges take the MAX.
    Instruments that disagree on type/buckets across processes are
    skipped rather than merged wrongly (a version skew between
    workers must not corrupt the fleet export)."""
    out: dict = {}
    for snap in snaps:
        for name, rec in snap.items():
            have = out.get(name)
            if have is None:
                out[name] = json.loads(json.dumps(rec))  # deep copy
                continue
            if (have["type"] != rec["type"]
                    or have.get("buckets") != rec.get("buckets")
                    or have["labelnames"] != rec["labelnames"]):
                continue
            for key, val in rec["series"].items():
                hval = have["series"].get(key)
                if rec["type"] == "histogram":
                    if hval is None:
                        have["series"][key] = json.loads(
                            json.dumps(val))
                    else:
                        hval["counts"] = [
                            a + b for a, b in zip(hval["counts"],
                                                  val["counts"])]
                        hval["sum"] += val["sum"]
                        hval["count"] += val["count"]
                elif rec["type"] == "gauge":
                    have["series"][key] = max(hval or 0.0, val) \
                        if hval is not None else val
                else:
                    have["series"][key] = (hval or 0.0) + val
    # re-derive histogram quantiles over the MERGED counts (the
    # per-worker estimates cannot be averaged)
    for rec in out.values():
        if rec["type"] == "histogram":
            for val in rec["series"].values():
                val["quantiles"] = metrics._hist_quantiles(
                    tuple(rec["buckets"]), val["counts"])
    return out


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Exact linear-interpolated quantile of a sorted sample (the
    journal yields raw durations, so no bucket estimate is needed)."""
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) \
        * (pos - lo)


def slo_snapshot(spool: str, summary: dict | None = None) -> dict:
    """Journal-derived fleet SLO series, as a Registry snapshot dict
    ready to merge: per-series p50/p95/p99 latency gauges
    (``tpulsar_fleet_slo_seconds``), the number of distinct workers
    whose data feeds each series
    (``tpulsar_fleet_slo_source_workers`` — a fleet-wide SLO sourced
    from one worker is a red flag), per-status terminal counts, and
    takeover/quarantine rates per terminal ticket."""
    if summary is None:
        summary = journal.summarize(spool)
    reg = metrics.Registry()
    # instruments come from the telemetry catalog (the contract the
    # lint metrics checker enforces); the registry stays local so a
    # half-derived series is never scraped mid-aggregation
    slo = telemetry.fleet_slo_seconds(reg)
    src = telemetry.fleet_slo_source_workers(reg)
    tickets_g = telemetry.fleet_tickets(reg)
    rate = telemetry.fleet_event_rate(reg)
    key_of = {"queue_wait": "queue_wait_s",
              "claim_to_start": "claim_to_start_s",
              "beam_e2e": "e2e_s"}
    for series in SLO_SERIES:
        vals, workers = [], set()
        for rec in summary["tickets"].values():
            v = rec.get(key_of[series])
            if v is None:
                continue
            vals.append(float(v))
            workers.update(rec["workers"])
        vals.sort()
        if vals:           # an empty series is absent, not 0.0 s
            for q, label in ((0.5, "p50"), (0.95, "p95"),
                             (0.99, "p99")):
                slo.set(round(_quantile(vals, q), 6),
                        series=series, quantile=label)
        src.set(len(workers), series=series)
    for status, n in summary["statuses"].items():
        tickets_g.set(n, status=status)
    terminal = sum(n for s, n in summary["statuses"].items()
                   if s != "in-flight")
    rate.set(round(summary["takeovers"] / terminal, 6)
             if terminal else 0.0, event="takeover")
    rate.set(round(summary["quarantined"] / terminal, 6)
             if terminal else 0.0, event="quarantine")
    return reg.snapshot()


def _strip_gauges(snap: dict) -> dict:
    return {name: rec for name, rec in snap.items()
            if rec["type"] != "gauge"}


def fleet_snapshot(spool: str,
                   extra_snapshots: tuple = (),
                   max_age_s: float | None = None) -> dict:
    """The merged fleet-wide snapshot: every worker's exported
    registry + the journal SLO series + any caller-supplied
    snapshots (the controller passes its own registry).  A STALE
    worker snapshot (older than the heartbeat grace — its worker is
    gone) contributes its counters and histograms (history survives
    the process) but NOT its gauges: a dead worker's point-in-time
    readings would otherwise haunt fleet.prom forever via the
    gauge-max merge rule."""
    if max_age_s is None:
        max_age_s = protocol.heartbeat_max_age()
    now = time.time()
    snaps = []
    for rec in worker_snapshots(spool).values():
        snap = rec["metrics"]
        if now - rec.get("t", 0.0) > max_age_s:
            snap = _strip_gauges(snap)
        snaps.append(snap)
    snaps.extend(extra_snapshots)
    snaps.append(slo_snapshot(spool))
    return merge_snapshots(snaps)


def write_fleet_prom(spool: str, extra_snapshots: tuple = (),
                     path: str | None = None) -> str:
    """Render the merged fleet snapshot as Prometheus text —
    ``<spool>/fleet.prom`` unless ``path`` overrides."""
    if path is None:
        path = os.path.join(spool, "fleet.prom")
    text = metrics.prometheus_text_from_snapshot(
        fleet_snapshot(spool, extra_snapshots))
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------- ops top

def render_top(spool: str,
               max_age_s: float | None = None,
               queue=None) -> str:
    """One refresh of ``obs top``: live per-worker state,
    queue depths, spool counts, and the journal SLO gauges.  With a
    TicketQueue in ``queue``, every queue-state read (heartbeats,
    counts, capacity) goes through the backend — a sqlite fleet's
    top looks identical to a spool fleet's; ``spool`` stays the
    journal root the SLO series are derived from."""
    if max_age_s is None:
        max_age_s = protocol.heartbeat_max_age()
    now = time.time()
    lines = [f"fleet spool {spool}  "
             f"({time.strftime('%H:%M:%S', time.localtime(now))})"]
    heartbeats = (queue.list_heartbeats() if queue is not None
                  else protocol.list_heartbeats(spool))
    lines.append(
        f"{'worker':10s} {'state':6s} {'pid':>7s} {'hb age':>7s} "
        f"{'depth':>7s}  {'done':>5s} {'fail':>5s} {'skip':>5s}")
    for wid, hb in heartbeats.items():
        age = now - hb.get("t", 0.0)
        fresh = protocol._hb_fresh(hb, max_age_s)
        beams = hb.get("beams") or {}
        lines.append(
            f"{wid or '(single)':10s} "
            f"{'fresh' if fresh else hb.get('status', 'STALE'):6s} "
            f"{hb.get('pid', '?'):>7} {age:6.0f}s "
            f"{hb.get('queue_depth', '?')!s:>3s}/"
            f"{hb.get('max_queue_depth', '?')!s:<3s} "
            f"{beams.get('done', 0):>5} {beams.get('failed', 0):>5} "
            f"{beams.get('skipped', 0):>5}")
    if not heartbeats:
        lines.append("  (no worker heartbeats)")
    if queue is not None:
        cap = queue.capacity(max_age_s)
        pending, claimed = queue.pending_count(), \
            queue.claimed_count()
        done = queue.state_count("done")
        quarantined = queue.state_count("quarantine")
    else:
        cap = protocol.fleet_capacity(spool, max_age_s)
        pending = protocol.pending_count(spool)
        claimed = protocol.claimed_count(spool)
        done = protocol.state_count(spool, "done")
        quarantined = protocol.state_count(spool, "quarantine")
    lines.append(
        f"spool: pending={pending} claimed={claimed} done={done} "
        f"quarantined={quarantined} "
        f"capacity={'SHED (0 fresh)' if cap is None else cap}")
    summary = journal.summarize(spool)
    if summary["tickets"]:
        snap = slo_snapshot(spool, summary)
        slo = snap["tpulsar_fleet_slo_seconds"]["series"]
        lines.append(f"{'SLO (journal)':14s} {'p50':>9s} {'p95':>9s} "
                     f"{'p99':>9s}")
        for series in SLO_SERIES:
            row = [slo.get(f"{series}|{q}") for q in ("p50", "p95",
                                                      "p99")]
            if all(v is None for v in row):
                continue
            lines.append(
                f"{series:14s} " + " ".join(
                    f"{v if v is not None else 0.0:8.3f}s"
                    for v in row))
        lines.append(
            f"tickets: {summary['statuses']}  "
            f"takeovers={summary['takeovers']} "
            f"quarantined={summary['quarantined']}")
    else:
        lines.append("journal: no ticket events yet")
    return "\n".join(lines)


# ------------------------------------------------------------- stitch

def stitch(spool: str, ticket: str) -> dict:
    """One Perfetto timeline for one beam across the whole fleet:
    the ticket's journal events as instant markers plus every trace
    span carrying its trace id, pulled from ``*_trace.json`` files
    under the outdirs its result events name.  Each trace file's
    events are rebased from that process's trace epoch
    (``otherData.trace_epoch_unix_s``) onto the journal's shared
    unix clock, so spans recorded by DIFFERENT workers (a claim on
    w0, the finish on w1 after a steal) land on one consistent time
    axis."""
    events = journal.read_events(spool, ticket=ticket, bad_lines=[])
    if not events:
        raise FileNotFoundError(
            f"no journal events for ticket {ticket!r} in {spool}")
    trace_id = next((e["trace_id"] for e in events
                     if e.get("trace_id")), "")
    t0 = min(e["t"] for e in events)
    out_events: list[dict] = []
    for ev in events:
        out_events.append({
            "name": f"journal:{ev.get('event', '?')}",
            "cat": "journal", "ph": "i", "s": "t",
            "ts": round((ev["t"] - t0) * 1e6, 1),
            "pid": 0, "tid": 0,
            "args": {k: v for k, v in ev.items() if k != "t"},
        })
    out_events.append({"name": "process_name", "ph": "M", "pid": 0,
                       "args": {"name": "journal"}})
    outdirs = {ev.get("outdir") for ev in events if ev.get("outdir")}
    for res in (protocol.read_result(spool, ticket),):
        if res and res.get("outdir"):
            outdirs.add(res["outdir"])
    named: set[int] = set()
    for outdir in sorted(outdirs):
        for tf in sorted(glob.glob(
                os.path.join(outdir, "**", "*_trace.json"),
                recursive=True)):
            try:
                with open(tf) as fh:
                    obj = json.load(fh)
            except (OSError, ValueError):
                continue
            epoch = (obj.get("otherData") or {}).get(
                "trace_epoch_unix_s")
            if epoch is None:
                continue
            for ev in obj.get("traceEvents", []):
                if trace_id and \
                        ev.get("args", {}).get("trace_id") != trace_id:
                    continue
                ev = dict(ev)
                ev["ts"] = round(
                    ev.get("ts", 0.0) + (epoch - t0) * 1e6, 1)
                out_events.append(ev)
                pid = ev.get("pid")
                if pid not in named:
                    named.add(pid)
                    out_events.append({
                        "name": "process_name", "ph": "M",
                        "pid": pid,
                        "args": {"name": f"worker pid {pid}"}})
    return {"traceEvents": out_events, "displayTimeUnit": "ms",
            "otherData": {"producer": "tpulsar.fleetview",
                          "ticket": ticket, "trace_id": trace_id,
                          "stitch_epoch_unix_s": t0}}
