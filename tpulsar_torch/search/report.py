"""Per-stage timing and the .report artifact.

Reproduces the reference's search instrumentation: per-stage timers
started in obs_info (PALFA2_presto_search.py:277-288), timed execution
of every stage (:95-139), and the percentage-breakdown report file
written at the end of the search (write_report, :336-372).  The
.report format is the JAX package's, byte for byte in layout, so
results directories from both packages line up.

Each timed scope is also one span of the tracer and one observation
of the tpulsar_stage_seconds histogram (obs/), as in the JAX package,
and one begin and one end beat of the stage heartbeat below.

Beside the wall-clock ``times`` (which the .report prints), a bound
StageTimers (StageTimers.bind) keeps a per-call ``record``: the device
seconds of each stage, from a pair of timing-enabled CUDA events a
scope (wall seconds on the CPU), and two counters — ``host_wait_s``
(the host blocked on the device: host_wait) and ``checkpoint_s``
(checkpoint saves and journal lines: checkpoint_save).  Timers are
bound only where something reads the record: by the caller that
reads it, or by the search itself while the tracer is on (its device
track); a search with tracing off records no event.  Events are read
only where the program already waits for the device (resolve): an
event not yet complete stays pending, and nothing here synchronizes
or copies to the host.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

from tpulsar_torch.obs import telemetry, trace


STAGES = ("rfifind", "subbanding", "dedispersing", "single-pulse",
          "FFT", "lo-accelsearch", "hi-accelsearch", "sifting", "folding")

# TPULSAR_STAGE_TRACE=1: print begin/end of every timed stage to
# stderr, flushed, so a wedged pass names the stage it is stuck in.
_TRACE = os.environ.get("TPULSAR_STAGE_TRACE", "") == "1"

# TPULSAR_STAGE_HEARTBEAT=<path>: write a JSON beat to <path> at every
# stage begin/end and at drains inside long stages.  A supervising
# parent tells a stalled child (no beat for many minutes: kill it)
# from a slow but progressing one (fresh beats: let it run), and the
# beat carries the current stage's name and begin time, so a kill can
# always name the stage it interrupted.
_HEARTBEAT = os.environ.get("TPULSAR_STAGE_HEARTBEAT", "")

# current innermost timed stage: (name, begin_time) — module-level so
# progress_beat() callers (the hi stage's drain) need no handle on the
# StageTimers instance
_CUR_STAGE: list[tuple[str, float]] = []

# the bound StageTimers a search block runs under (StageTimers.attached):
# host_wait, checkpoint_save and resolve count into the innermost, so
# the kernels' waits need no handle on it either
_ACTIVE: list["StageTimers"] = []


def _beat(stage: str = "", event: str = "", info: str = "") -> None:
    if not _HEARTBEAT:
        return
    t_stage = _CUR_STAGE[-1][1] if _CUR_STAGE else 0.0
    # the one event shape (telemetry.event_record); the stage/t_stage
    # keys stay present even when empty, as the JAX package writes them
    rec = telemetry.event_record(event, stage=stage, info=info,
                                 t_stage=t_stage)
    rec.setdefault("stage", stage)
    rec.setdefault("t_stage", t_stage)
    try:
        # atomic replace: a reader between polls never sees a torn
        # half-written beat
        tmp = _HEARTBEAT + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(rec, fh)
        os.replace(tmp, _HEARTBEAT)
    except OSError:
        pass


def progress_beat(info: str = "") -> None:
    """Refresh the heartbeat from inside a long timed stage (a DM
    batch drained).  Keeps the stage's begin time, so a per-stage
    budget still measures the whole stage while a stall detector sees
    live progress."""
    if _HEARTBEAT and _CUR_STAGE:
        _beat(_CUR_STAGE[-1][0], "progress", info)


def new_record() -> dict:
    """An empty per-call record (see the module docstring)."""
    return {"device_s": {}, "host_wait_s": 0.0, "checkpoint_s": 0.0}


class _EventClock:
    """Timing-enabled CUDA events on one device's current stream: a
    pool (a scope takes two and resolve hands them back, so the hot
    path allocates nothing once warm), the scopes whose closing event
    has not been read yet, and the anchor that places device time on
    the host clock: an event recorded when the stream was empty, right
    after a wait, whose device time is therefore its host time.
    ``event`` and ``stream`` make the events and read the current
    stream (tests hand in fakes); the stream is read again at each
    resolve, not at each scope, which would cost a scope more than its
    two records."""

    def __init__(self, device, event=None, stream=None):
        import torch

        index = device.index
        if index is None:
            index = torch.cuda.current_device()
        self.track = f"cuda:{index}"
        self._event = event or (
            lambda: torch.cuda.Event(enable_timing=True))
        self._stream = stream or (
            lambda: torch.cuda.current_stream(device))
        self.stream = self._stream()
        self.free: list = []
        self.pending: list = []      # [stage, seq, e0, e1, seconds|None]
        self.seq = 0
        self.anchor = None           # (seq, event, unix seconds)

    def record(self):
        ev = self.free.pop() if self.free else self._event()
        ev.record(self.stream)
        self.seq += 1
        return self.seq, ev

    def _place(self, seq, ev) -> float | None:
        """Unix seconds at which the device reached ``ev``, from a
        complete anchor, else None."""
        if self.anchor is None:
            return None
        a_seq, a_ev, a_t = self.anchor
        if not a_ev.query():
            return None
        if a_seq < seq:
            return a_t + a_ev.elapsed_time(ev) / 1e3
        return a_t - ev.elapsed_time(a_ev) / 1e3

    def resolve(self, record: dict, place: bool) -> None:
        """Add each scope whose closing event has completed to
        ``record``; with ``place``, also write it on the device track
        once an anchor is complete.  Then refresh the anchor if the
        stream is empty.  Only queries: never a wait."""
        keep = []
        dev_s = record["device_s"]
        for item in self.pending:
            stage, seq, e0, e1, secs = item
            if secs is None:
                if not e1.query():
                    keep.append(item)
                    continue
                secs = item[4] = e0.elapsed_time(e1) / 1e3
                dev_s[stage] = dev_s.get(stage, 0.0) + secs
            if place:
                t0 = self._place(seq, e0)
                if t0 is None:
                    keep.append(item)
                    continue
                trace.device_interval(stage, self.track, t0, secs)
            self.free += (e0, e1)
        self.pending = keep
        self.stream = self._stream()
        if self.stream.query():
            ev = self.anchor[1] if self.anchor else self._event()
            ev.record(self.stream)
            self.seq += 1
            self.anchor = (self.seq, ev, time.time())


class StageTimers:
    def __init__(self) -> None:
        self.times: dict[str, float] = {s: 0.0 for s in STAGES}
        self._t0 = time.time()
        self.record = new_record()
        self.bound = False
        self._clock: _EventClock | None = None

    def bind(self, device, event=None, stream=None) -> None:
        """Keep the record from now on: time the device work of later
        scopes with CUDA events on ``device`` (a torch.device); on any
        other device a scope's device seconds are its wall seconds.  A
        device already bound stays.  ``event`` / ``stream``:
        _EventClock's (tests hand in fakes)."""
        if self.bound:
            return
        self.bound = True
        if device.type == "cuda":
            self._clock = _EventClock(device, event, stream)

    def bind_if_traced(self, device) -> None:
        """bind, while the tracer is on: its device track reads the
        record.  Otherwise the timers stay as the caller made them."""
        if trace.enabled():
            self.bind(device)

    @contextlib.contextmanager
    def attached(self, device):
        """The scope of a search block on ``device``: bound if traced
        (bind_if_traced), and, while bound, the timers that host_wait /
        checkpoint_save / drained count into, resolved once more at
        exit.  Unbound timers pass straight through."""
        self.bind_if_traced(device)
        if not self.bound:
            yield self
            return
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            if _ACTIVE and _ACTIVE[-1] is self:
                _ACTIVE.pop()
            self.resolve()

    def resolve(self) -> None:
        """Read every completed scope into the record (see
        _EventClock.resolve); call it only right after a wait the
        program makes anyway."""
        if self._clock is not None:
            self._clock.resolve(self.record, trace.enabled())

    @contextlib.contextmanager
    def timing(self, stage: str):
        """One timed scope = one trace span + one histogram observation
        + the times[] accumulation: a trace-file rollup reproduces the
        .report totals (the JAX package's contract), and the .report
        text is unchanged.  On a bound device, a CUDA event at entry
        and one at exit (record)."""
        self.times.setdefault(stage, 0.0)
        start = time.time()
        clock = self._clock
        seq0, ev0 = clock.record() if clock is not None else (0, None)
        _CUR_STAGE.append((stage, start))
        try:
            with trace.span(stage):
                # beat and stderr line inside the span: their I/O then
                # counts toward the span and the timer alike
                _beat(stage, "begin")
                if _TRACE:
                    print(f"[stage-trace +{start - self._t0:8.1f}s] "
                          f"begin {stage}", file=sys.stderr,
                          flush=True)
                yield
        finally:
            if clock is not None:
                clock.pending.append([stage, seq0, ev0,
                                      clock.record()[1], None])
            end = time.time()
            self.times[stage] += end - start
            if clock is None and self.bound:
                dev_s = self.record["device_s"]
                dev_s[stage] = dev_s.get(stage, 0.0) + (end - start)
            telemetry.stage_seconds().observe(end - start, stage=stage)
            if _CUR_STAGE and _CUR_STAGE[-1][0] == stage:
                _CUR_STAGE.pop()
            _beat(stage, "end")
            if _TRACE:
                print(f"[stage-trace +{end - self._t0:8.1f}s] end   "
                      f"{stage} ({end - start:.1f} s)",
                      file=sys.stderr, flush=True)

    @property
    def total(self) -> float:
        return time.time() - self._t0

    def report_text(self, basenm: str) -> str:
        total = max(self.total, 1e-9)
        lines = [f"---------------------------------------------------------",
                 f"Timing report for {basenm}",
                 f"---------------------------------------------------------",
                 f"   Total time: {total:.2f} s", ""]
        accounted = 0.0
        for stage, secs in self.times.items():
            accounted += secs
            lines.append(f"{stage:>18s}: {secs:9.2f} s  ({100*secs/total:5.1f}%)")
        lines.append(f"{'other':>18s}: {total-accounted:9.2f} s  "
                     f"({100*(total-accounted)/total:5.1f}%)")
        return "\n".join(lines) + "\n"

    def write_report(self, path: str, basenm: str,
                     degraded: dict[str, str] | None = None,
                     rescued: dict[str, str] | None = None) -> None:
        """degraded / rescued: the fallback-path and host-rescue
        ledgers (search.degraded), appended under their own headings
        so a results directory says which code paths produced it."""
        with open(path, "w") as fh:
            fh.write(self.report_text(basenm))
            if degraded:
                fh.write("\nDegraded modes (fallback paths taken):\n")
                for flag, detail in sorted(degraded.items()):
                    fh.write(f"  {flag}: {detail}\n")
            if rescued:
                fh.write("\nRescued work (recomputed on a fallback "
                         "device; science complete):\n")
                for flag, detail in sorted(rescued.items()):
                    fh.write(f"  {flag}: {detail}\n")


@contextlib.contextmanager
def host_wait(site: str, device):
    """The host blocked on ``device`` (a synchronize, a device-to-host
    copy): its seconds go to the active record's host_wait_s and a
    span ``host-wait:<site>``.  On the CPU nothing waits: a plain
    scope."""
    if getattr(device, "type", None) != "cuda":
        yield
        return
    t0 = time.perf_counter()
    try:
        with trace.span("host-wait:" + site):
            yield
    finally:
        if _ACTIVE:
            _ACTIVE[-1].record["host_wait_s"] += time.perf_counter() - t0


@contextlib.contextmanager
def checkpoint_save():
    """A checkpoint save or journal line of the active search block:
    its seconds go to checkpoint_s and a span ``checkpoint-save``."""
    t0 = time.perf_counter()
    try:
        with trace.span("checkpoint-save"):
            yield
    finally:
        if _ACTIVE:
            _ACTIVE[-1].record["checkpoint_s"] += time.perf_counter() - t0


def drained() -> None:
    """The active search block's host just waited for its device (the
    hi stage's window drains): read its completed scopes."""
    if _ACTIVE:
        _ACTIVE[-1].resolve()
