"""Process-wide metrics registry: counters, gauges, histograms —
counterpart of tpulsar/obs/metrics.py, the same instruments,
snapshot shape and exporters, so a metrics.json written by either
package reads the same.

Design constraints:
  * stdlib only — importable where torch and numpy are not;
  * thread-safe — concurrent threads record into one registry;
  * fixed histogram buckets — two snapshots from different runs are
    comparable bucket-by-bucket (the whole point of the bench/v2
    schema), so bucket edges are part of the instrument definition,
    never data-dependent.

Exporters: ``snapshot()`` (plain dict, JSON-safe), ``write_jsonl()``
(one snapshot line appended per call — a time series a supervisor can
tail), and ``prometheus_text()`` (the text exposition format, so a
scrape target is one ``open().write()`` away).
"""

from __future__ import annotations

import json
import os
import threading
import time

#: default histogram bucket upper bounds, seconds-flavoured: the
#: pipeline's latencies of interest span jobtracker lock retries
#: (~ms) to full-beam stages (~hundreds of s).  +Inf is implicit.
DEFAULT_BUCKETS = (0.005, 0.02, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0,
                   300.0, 1200.0)


class MetricError(ValueError):
    """Registry misuse: re-registering a name with a different type,
    shape, or bucket layout — two call sites that disagree about an
    instrument would silently split its data."""


#: the percentiles every histogram series reports (as ``quantiles``
#: in series()/snapshot()): the SLO set the fleet aggregator and the
#: ops console read, so each consumer stops re-deriving them by hand
QUANTILES = (0.5, 0.95, 0.99)


def bucket_quantile(buckets: tuple, counts: list, q: float) -> float:
    """Bucket-interpolated quantile estimate (Prometheus
    ``histogram_quantile`` semantics): linear interpolation inside
    the bucket holding the rank; a rank landing in the +Inf bucket
    clamps to the highest finite bound (the estimate cannot exceed
    what the instrument can resolve)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0
    for i, ub in enumerate(buckets):
        prev = cum
        cum += counts[i]
        if cum >= rank:
            lb = buckets[i - 1] if i else 0.0
            frac = (rank - prev) / counts[i] if counts[i] else 1.0
            return lb + (ub - lb) * frac
    return float(buckets[-1])


def _hist_quantiles(buckets: tuple, counts: list) -> dict:
    return {f"p{int(q * 100)}": round(bucket_quantile(buckets,
                                                      counts, q), 6)
            for q in QUANTILES}


def _labelkey(labelnames: tuple[str, ...], labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise MetricError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Instrument:
    kind = "?"

    def __init__(self, name: str, help: str,
                 labelnames: tuple[str, ...]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def _signature(self) -> tuple:
        return (self.kind, self.labelnames)


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise MetricError(f"counter {self.name} cannot decrease")
        key = _labelkey(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _labelkey(self.labelnames, labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _labelkey(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labelkey(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = _labelkey(self.labelnames, labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: tuple[str, ...],
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(set(b)):
            raise MetricError(
                f"histogram {name} buckets must be a sorted, "
                f"deduplicated, non-empty tuple (got {buckets!r})")
        self.buckets = b

    def _signature(self) -> tuple:
        return (self.kind, self.labelnames, self.buckets)

    def observe(self, value: float, **labels) -> None:
        key = _labelkey(self.labelnames, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = {"counts": [0] * (len(self.buckets) + 1),
                          "sum": 0.0, "count": 0}
                self._series[key] = series
            # first bucket whose upper bound holds the value; the
            # trailing slot is +Inf
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    series["counts"][i] += 1
                    break
            else:
                series["counts"][-1] += 1
            series["sum"] += float(value)
            series["count"] += 1

    def series(self, **labels) -> dict:
        key = _labelkey(self.labelnames, labels)
        with self._lock:
            s = self._series.get(key)
            s = (dict(s, counts=list(s["counts"])) if s else
                 {"counts": [0] * (len(self.buckets) + 1),
                  "sum": 0.0, "count": 0})
        s["quantiles"] = _hist_quantiles(self.buckets, s["counts"])
        return s

    def quantiles(self, **labels) -> dict:
        """Bucket-interpolated {p50, p95, p99} for one series."""
        return self.series(**labels)["quantiles"]


class Registry:
    """Named instruments, get-or-create: the Nth registration of a
    name returns the first instrument iff the definitions agree —
    telemetry call sites never need import-order coordination."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: tuple[str, ...] = (), **kw):
        with self._lock:
            have = self._instruments.get(name)
            if have is not None:
                probe = cls(name, help, labelnames, **kw)
                if have._signature() != probe._signature():
                    raise MetricError(
                        f"metric {name!r} re-registered with a "
                        f"different definition: {have._signature()} "
                        f"vs {probe._signature()}")
                return have
            inst = cls(name, help, labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def reset(self) -> None:
        """Drop every instrument (tests only — production code never
        unregisters, so names stay stable for a process lifetime)."""
        with self._lock:
            self._instruments.clear()

    # ------------------------------------------------------- exporters

    def snapshot(self) -> dict:
        """JSON-safe dump of every instrument and series.  The shape
        round-trips through json.dumps/loads unchanged, which is the
        contract the snapshot tests pin: a snapshot written by one
        process is byte-comparable to one parsed by another."""
        out: dict = {}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            with inst._lock:
                series = {"|".join(k) if k else "": (
                    dict(v, counts=list(v["counts"]))
                    if isinstance(v, dict) else v)
                    for k, v in inst._series.items()}
            rec: dict = {"type": inst.kind, "help": inst.help,
                         "labelnames": list(inst.labelnames),
                         "series": series}
            if isinstance(inst, Histogram):
                rec["buckets"] = list(inst.buckets)
                for v in series.values():
                    v["quantiles"] = _hist_quantiles(inst.buckets,
                                                     v["counts"])
            out[inst.name] = rec
        return out

    def write_jsonl(self, path: str,
                    max_bytes: int | None = None, **extra) -> None:
        """Append one timestamped snapshot line; atomic enough for a
        tail-reader (one write() of one line).  max_bytes bounds the
        file: on overflow the current file rotates to ``path.1``
        (one generation kept) — a daemon appending every loop
        iteration for months must not fill the log volume."""
        rec = {"t": time.time(), "metrics": self.snapshot(), **extra}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        if max_bytes is not None:
            try:
                if os.path.getsize(path) >= max_bytes:
                    os.replace(path, path + ".1")
            except OSError:
                pass
        with open(path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        return prometheus_text_from_snapshot(self.snapshot())

    def write_prom(self, path: str) -> None:
        """Atomic-replace write of the Prometheus text dump (the
        scrape/read side must never see a torn file)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.prometheus_text())
        os.replace(tmp, path)


def prometheus_text_from_snapshot(snap: dict) -> str:
    """Render ANY ``Registry.snapshot()``-shaped dict as Prometheus
    text — a module function (not a Registry method) so the fleet
    aggregator can render a MERGED multi-process snapshot it built
    itself.  Histogram help lines advertise the bucket-interpolated
    p50/p95/p99, and each histogram series emits them as a trailing
    comment row (a plain ``#`` comment: ignored by scrapers, read by
    operators and the ops console — raw buckets stay the only real
    series)."""
    lines: list[str] = []
    for name in sorted(snap):
        rec = snap[name]
        if rec["help"]:
            help_txt = rec["help"]
            if rec["type"] == "histogram":
                help_txt += (" [p50/p95/p99 bucket-interpolated in "
                             "the trailing comment rows]")
            lines.append(f"# HELP {name} {help_txt}")
        lines.append(f"# TYPE {name} {rec['type']}")
        labelnames = rec["labelnames"]

        def fmt(extra_label: str = "", key: str = "",
                suffix: str = "") -> str:
            pairs = ([f'{n}="{v}"' for n, v in
                      zip(labelnames, key.split("|"))]
                     if key else [])
            if extra_label:
                pairs.append(extra_label)
            body = "{" + ",".join(pairs) + "}" if pairs else ""
            return f"{name}{suffix}{body}"

        for key, val in sorted(rec["series"].items()):
            if rec["type"] == "histogram":
                edges = [*rec["buckets"], "+Inf"]
                cum = 0
                for ub, n in zip(edges, val["counts"]):
                    cum += n
                    le = 'le="%s"' % ub
                    lines.append(
                        f"{fmt(le, key, '_bucket')} {cum}")
                lines.append(f"{fmt('', key, '_sum')} "
                             f"{val['sum']:.9g}")
                lines.append(f"{fmt('', key, '_count')} "
                             f"{val['count']}")
                quant = val.get("quantiles") or _hist_quantiles(
                    tuple(rec["buckets"]), val["counts"])
                lines.append(
                    f"# {fmt('', key)} " + " ".join(
                        f"{k}={v:.9g}"
                        for k, v in sorted(quant.items())))
            else:
                lines.append(f"{fmt('', key)} {val:.9g}")
    return "\n".join(lines) + ("\n" if lines else "")


def diff_snapshots(now: dict, base: dict) -> dict:
    """Per-interval view between two ``Registry.snapshot()`` dicts:
    counter and histogram series are subtracted (``now - base``),
    gauges keep their current value (a gauge is a point-in-time
    reading; subtracting two of them means nothing).  Series whose
    delta is zero are dropped, as are instruments left with no
    series — the result reads as 'what happened in this interval',
    which is what a per-beam metrics artifact must say (a cumulative
    process snapshot attributes beam A's refusals to beam B)."""
    out: dict = {}
    for name, rec in now.items():
        brec = base.get(name)
        bseries = (brec or {}).get("series", {})
        series: dict = {}
        for key, val in rec["series"].items():
            bval = bseries.get(key)
            if rec["type"] == "gauge":
                series[key] = val
            elif rec["type"] == "histogram":
                if bval is not None:
                    val = {"counts": [a - b for a, b in
                                      zip(val["counts"],
                                          bval["counts"])],
                           "sum": val["sum"] - bval["sum"],
                           "count": val["count"] - bval["count"]}
                if val["count"]:
                    # quantiles describe the subtracted interval, not
                    # the cumulative series they were computed from
                    val = dict(val, quantiles=_hist_quantiles(
                        tuple(rec["buckets"]), val["counts"]))
                    series[key] = val
            else:
                delta = val - (bval or 0.0)
                if delta:
                    series[key] = delta
        if series:
            out[name] = dict(rec, series=series)
    return out


def merge_deltas(a: dict, b: dict) -> dict:
    """Sum two ``diff_snapshots`` results into one interval view:
    counter series add, histogram counts/sum/count add (quantiles
    recomputed over the summed counts), gauges take ``b``'s reading
    when both carry one (the later point in time).  Used by the
    batch-of-beams finish phase to compose a beam's metrics artifact
    from the group-shared plan-loop delta plus that beam's own
    sift/fold/finalize delta — without it, sequential per-beam
    finishes against one base snapshot would attribute every earlier
    batchmate's finish-phase counters to the later beams."""
    out: dict = {}
    for name in set(a) | set(b):
        arec, brec = a.get(name), b.get(name)
        if arec is None or brec is None:
            rec = arec or brec
            out[name] = dict(rec, series=dict(rec["series"]))
            continue
        series: dict = dict(arec["series"])
        for key, bval in brec["series"].items():
            aval = series.get(key)
            if aval is None or arec["type"] == "gauge":
                series[key] = bval
            elif arec["type"] == "histogram":
                counts = [x + y for x, y in zip(aval["counts"],
                                                bval["counts"])]
                val = {"counts": counts,
                       "sum": aval["sum"] + bval["sum"],
                       "count": aval["count"] + bval["count"],
                       "quantiles": _hist_quantiles(
                           tuple(arec["buckets"]), counts)}
                series[key] = val
            else:
                series[key] = aval + bval
        out[name] = dict(arec, series=series)
    return out


#: the process-wide default registry every pipeline layer records into
REGISTRY = Registry()


def counter(name: str, help: str = "",
            labelnames: tuple[str, ...] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: tuple[str, ...] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "",
              labelnames: tuple[str, ...] = (),
              buckets: tuple[float, ...] = DEFAULT_BUCKETS
              ) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)
