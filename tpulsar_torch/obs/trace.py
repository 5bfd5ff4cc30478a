"""Span tracer with Chrome-trace/Perfetto JSON export — counterpart of
tpulsar/obs/trace.py, the same events, file format and rollup, so
the JAX package's tools (tools/trace_summarize.py, `tpulsar trace`)
read this package's trace files.

Nested ``span`` scopes record wall time per stage/pass/chunk, and the
whole beam exports as one Chrome-trace JSON — load the file into
https://ui.perfetto.dev (or chrome://tracing) and the stage/chunk
structure of a search is a timeline instead of a percentage table.

Wall time vs device time: CUDA kernels launch asynchronously, so a
span around an enqueue measures launch cost, not compute.  Spans are
wall-clock (cheap, safe to leave on); the device's own time comes
from CUDA events (search/report.py's StageTimers), written here as
complete events on a device track (``device_interval``: ``pid``
"cuda:N", ``cat`` "device"), placed on this module's clock and left
out of the rollup.

One clock: the export states its time base as the torch profiler's
traces do (``baseTimeNanoseconds``, unix nanoseconds, with every
``ts`` in microseconds after it), and while a torch profiler runs
each span also opens a ``torch.profiler.record_function`` range of
its name, so this file and a profiler's line up without conversion.

Enabling: ``TPULSAR_TRACE=1`` in the environment, or ``start()``
programmatically (tests).  Disabled spans cost two attribute reads
and the profiler's is-enabled test — cheap enough for per-chunk
loops.  Thread safety: events append under
a lock; span nesting state is thread-local, and each thread's spans
carry its tid, which is exactly how Perfetto reconstructs nesting
(same-track time containment).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time

#: completed-event cap: a full survey beam emits ~10 events per chunk
#: x ~1300 chunks — far below this; the cap is a runaway backstop so
#: an unbounded loop cannot OOM the host through its own telemetry
MAX_EVENTS = 200_000

_LOCK = threading.Lock()
_EVENTS: list[dict] = []
_DROPPED = 0
_ENABLED: bool | None = None     # None = consult TPULSAR_TRACE env
_T0 = time.time()                # trace epoch (perf counter origin)
_TLS = threading.local()


def enabled() -> bool:
    if _ENABLED is not None:
        return _ENABLED
    return os.environ.get("TPULSAR_TRACE", "") == "1"


def start(clear: bool = True) -> None:
    """Enable tracing programmatically (overrides the env)."""
    global _ENABLED, _T0
    with _LOCK:
        _ENABLED = True
        if clear:
            _EVENTS.clear()
            _T0 = time.time()


def stop() -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = False


def reset() -> None:
    """Back to env-controlled, events dropped (tests).  Clears the
    calling thread's trace-id context too."""
    global _ENABLED, _T0, _DROPPED
    with _LOCK:
        _ENABLED = None
        _EVENTS.clear()
        _DROPPED = 0
        _T0 = time.time()
    _TLS.trace_id = ""


def _stack() -> list[str]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def set_trace_id(trace_id: str) -> None:
    """Adopt a cross-process trace context on THIS thread: every
    span/instant/complete event recorded while it is set carries
    ``trace_id`` in its args.  The id is minted once at ticket
    submission (serve/protocol.write_ticket) and travels in the
    ticket JSON, so the spans a beam leaves behind in DIFFERENT
    worker processes — a claim, a crash, a steal, a finish — all
    carry the same id and can be stitched into one Perfetto timeline
    (tools/trace_summarize.py --stitch).  Thread-local on purpose:
    the serve worker's main thread processes beam N while its
    stage-in thread prepares beam N+1, and each must stamp its own
    beam's id.  Pass '' to clear."""
    _TLS.trace_id = trace_id


def get_trace_id() -> str:
    return getattr(_TLS, "trace_id", "") or ""


def _ctx_args(args: dict) -> dict:
    tid = get_trace_id()
    if tid:
        args.setdefault("trace_id", tid)
    return args


def current_span() -> str:
    """Name of the innermost open span on this thread ('' if none)."""
    st = _stack()
    return st[-1] if st else ""


def _append(event: dict) -> None:
    global _DROPPED
    with _LOCK:
        if len(_EVENTS) >= MAX_EVENTS:
            _DROPPED += 1
            return
        _EVENTS.append(event)


def _profiler_range(name: str):
    """A torch.profiler.record_function range of ``name`` while a torch
    profiler runs (TPULSAR_PROFILE's, or any outer one), else None.
    The profiler's own is-enabled test, read without importing torch:
    a process that never imported it runs no profiler."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Record a nested Chrome-trace complete event around the scope,
    and open a profiler range of the same name while a torch profiler
    runs (_profiler_range).

    Exception-safe: the span closes (and records ``error``) when the
    body raises.  Nesting is per-thread; the parent span's name and
    depth ride in args so a flat event list still states the tree."""
    rng = _profiler_range(name)
    if rng is None and not enabled():
        yield
        return
    with rng or contextlib.nullcontext(), _span(name, attrs):
        yield


@contextlib.contextmanager
def _span(name: str, attrs: dict):
    if not enabled():
        yield
        return
    st = _stack()
    parent = st[-1] if st else ""
    depth = len(st)
    st.append(name)
    t_begin = time.time()
    error = ""
    try:
        yield
    except BaseException as exc:
        error = f"{type(exc).__name__}: {exc}"[:200]
        raise
    finally:
        t_end = time.time()
        if st and st[-1] == name:
            st.pop()
        args = {k: v for k, v in attrs.items()}
        if parent:
            args["parent"] = parent
        args["depth"] = depth
        if error:
            args["error"] = error
        _append({
            "name": name, "cat": "tpulsar", "ph": "X",
            "ts": round((t_begin - _T0) * 1e6, 1),
            "dur": round((t_end - t_begin) * 1e6, 1),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": _ctx_args(args),
        })


def complete(name: str, dur_s: float, **attrs) -> None:
    """Retroactive completed span ending NOW with the given duration.

    For durations learned after the fact (a compile or a transfer
    reported only once it finishes).  The event still lands on the
    caller's thread track with the enclosing span noted in args, so
    Perfetto shows it inside the stage that triggered it."""
    if not enabled():
        return
    t_end = time.time()
    args = dict(attrs)
    parent = current_span()
    if parent:
        args["parent"] = parent
    _append({
        "name": name, "cat": "tpulsar", "ph": "X",
        "ts": round((t_end - dur_s - _T0) * 1e6, 1),
        "dur": round(dur_s * 1e6, 1),
        "pid": os.getpid(), "tid": threading.get_ident(),
        "args": _ctx_args(args),
    })


def device_interval(name: str, device: str, t_begin: float,
                    dur_s: float) -> None:
    """A complete event on the device track ``device`` ("cuda:0"):
    device work between two CUDA events, placed on this module's clock
    (t_begin in unix seconds).  Its ``cat`` is "device", so the rollup
    of host spans leaves it out."""
    if not enabled():
        return
    _append({
        "name": name, "cat": "device", "ph": "X",
        "ts": round((t_begin - _T0) * 1e6, 1),
        "dur": round(dur_s * 1e6, 1),
        "pid": device, "tid": "stream", "args": _ctx_args({}),
    })


def instant(name: str, **attrs) -> None:
    """Zero-duration marker (circuit transitions, rescue decisions):
    shows as a tick on the Perfetto track."""
    if not enabled():
        return
    args = dict(attrs)
    parent = current_span()
    if parent:
        args["parent"] = parent
    _append({
        "name": name, "cat": "tpulsar", "ph": "i",
        "ts": round((time.time() - _T0) * 1e6, 1),
        "pid": os.getpid(), "tid": threading.get_ident(),
        "s": "t", "args": _ctx_args(args),
    })


def events() -> list[dict]:
    """Copy of the recorded events (tests / exporters)."""
    with _LOCK:
        return [dict(e, args=dict(e["args"])) for e in _EVENTS]


def export() -> dict:
    """The Chrome-trace JSON object (the ``save`` payload)."""
    with _LOCK:
        evs = [dict(e, args=dict(e["args"])) for e in _EVENTS]
        dropped = _DROPPED
    # the torch profiler's convention: unix ns, each ts us after it
    obj = {"traceEvents": evs, "displayTimeUnit": "ms",
           "baseTimeNanoseconds": round(_T0 * 1e9),
           "otherData": {"producer": "tpulsar",
                         "trace_epoch_unix_s": _T0}}
    if dropped:
        obj["otherData"]["dropped_events"] = dropped
    return obj


def save(path: str) -> str:
    """Write the Chrome-trace file (atomic replace: a kill mid-write
    must not leave a half-JSON that ui.perfetto.dev rejects)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(export(), fh)
    os.replace(tmp, path)
    return path


def find_trace_file(path: str) -> str:
    """`path` itself when it is a file, else the newest *_trace.json
    beneath it (recursive) — 'the last beam's trace'."""
    import glob
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*_trace.json"),
                            recursive=True),
                  key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(
            f"no *_trace.json under {path} (run the search with "
            f"TPULSAR_TRACE=1)")
    return hits[-1]


def summarize_events(trace_events: list, trace_file: str = "") -> dict:
    """Rollup summary of a traceEvents list: {trace_file, rollup,
    root_seconds, n_events}.  The one implementation behind both
    `tpulsar trace` and tools/trace_summarize.py — root_seconds is
    the search_block span when present, else the total of top-level
    (depth-0) spans.  Split from summarize_file so a caller that
    already parsed the JSON (trace_summarize's compile rollup shares
    the same load) doesn't parse it twice."""
    roll = rollup(trace_events)
    root_s = roll.get("search_block", {}).get("seconds", 0.0)
    if not root_s:
        root_s = sum(e.get("dur", 0.0) / 1e6 for e in trace_events
                     if e.get("ph") == "X"
                     and e.get("args", {}).get("depth") == 0)
    return {"trace_file": trace_file, "rollup": roll,
            "root_seconds": round(root_s, 3),
            "n_events": len(trace_events)}


def summarize_file(trace_path: str) -> dict:
    """summarize_events over a saved trace file."""
    with open(trace_path) as fh:
        obj = json.load(fh)
    return summarize_events(obj.get("traceEvents", []),
                            trace_file=trace_path)


def render_summary(summary: dict) -> str:
    """The per-span seconds/share/scopes table."""
    roll = summary["rollup"]
    root_s = max(summary["root_seconds"], 1e-9)
    lines = [f"trace: {summary['trace_file']} "
             f"({summary['n_events']} events)",
             f"{'span':>18s}  {'seconds':>9s}  {'share':>6s}  "
             f"{'scopes':>6s}"]
    for name in sorted(roll, key=lambda n: -roll[n]["seconds"]):
        rec = roll[name]
        lines.append(f"{name:>18.18s}  {rec['seconds']:9.2f}  "
                     f"{100.0 * rec['seconds'] / root_s:5.1f}%  "
                     f"{rec['count']:6d}")
    return "\n".join(lines)


def rollup(trace_events: list[dict] | None = None
           ) -> dict[str, dict]:
    """Per-name {seconds, count} totals over the host's complete ('X')
    events (the device track's are left out).

    Over the events StageTimers emits this reproduces the .report
    stage totals: one span per timing scope, same begin/end clocks
    (tools/trace_summarize.py renders this as the rollup table)."""
    evs = trace_events if trace_events is not None else events()
    out: dict[str, dict] = {}
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") == "device":
            continue
        rec = out.setdefault(e["name"], {"seconds": 0.0, "count": 0})
        rec["seconds"] += e.get("dur", 0.0) / 1e6
        rec["count"] += 1
    for rec in out.values():
        rec["seconds"] = round(rec["seconds"], 6)
    return out
