"""StageTimers' per-call record (tpulsar_torch/search/report.py) and the
tracer's one clock (tpulsar_torch/obs/trace.py): device seconds per
stage from a pair of CUDA events a scope, read only where the search
already waits (here with a fake event clock, since the CPU has no
CUDA events), kept only by bound timers, the host-wait and checkpoint
counters, the device track and the profiler's time base in the
export, and the profiler ranges the spans open only while a profiler
runs."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from test_torch_slice import one_torch_thread  # noqa: F401 (autouse)
from tpulsar_torch.kernels import accel
from tpulsar_torch.obs import trace
from tpulsar_torch.plan import ddplan
from tpulsar_torch.search import executor as tex
from tpulsar_torch.search import report
from tpulsar_torch.search.report import StageTimers

CARD = torch.device("cuda", 0)


class FakeClock:
    """The device's clock and stream: an event records the device time
    at which the stream reaches it, and completes once ``done`` says
    so."""

    def __init__(self):
        self.now = 100.0          # device seconds
        self.done = True          # events recorded so far complete
        self.empty = True         # the stream's query()
        self.events: list = []

    def event(self):
        clock = self

        class Event:
            t = None
            complete = False

            def record(self, _stream):
                self.t = clock.now
                self.complete = clock.done
                clock.events.append(self)

            def query(self):
                return self.complete

            def elapsed_time(self, other):
                assert self.complete and other.complete
                return (other.t - self.t) * 1e3

            def synchronize(self):
                raise AssertionError("an event was waited for")

        return Event()

    def stream(self):
        clock = self

        class Stream:
            def query(self):
                return clock.empty

            def synchronize(self):
                raise AssertionError("the stream was waited for")

        return Stream()

    def finish(self):
        """The device catches up: every event recorded is complete."""
        for ev in self.events:
            ev.complete = True


def bound(clock) -> StageTimers:
    t = StageTimers()
    t.bind(CARD, event=clock.event, stream=clock.stream)
    return t


def scope(timers, clock, stage, device_s):
    """One timed scope whose device work takes ``device_s``."""
    with timers.timing(stage):
        clock.now += device_s


@pytest.fixture
def no_waits(monkeypatch):
    """Any synchronize or host copy fails the test."""
    def boom(*_a, **_k):
        raise AssertionError("resolution waited for the device")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.Tensor, "cpu", boom)
    monkeypatch.setattr(torch.Tensor, "item", boom)


def test_the_records_arithmetic_on_a_fake_event_clock(no_waits):
    clock = FakeClock()
    timers = bound(clock)
    with timers.attached(CARD):
        scope(timers, clock, "single-pulse", 0.25)
        scope(timers, clock, "FFT", 0.5)
        clock.done = False               # the lo stage still runs
        scope(timers, clock, "lo-accelsearch", 2.0)
        timers.resolve()
        rec = timers.record
        assert rec["device_s"] == {"single-pulse": 0.25, "FFT": 0.5}
        clock.finish()
        clock.done = True
        scope(timers, clock, "single-pulse", 0.125)
        timers.resolve()
        assert rec["device_s"] == pytest.approx(
            {"single-pulse": 0.375, "FFT": 0.5, "lo-accelsearch": 2.0})
    assert set(rec) == {"device_s", "host_wait_s", "checkpoint_s"}
    assert rec["host_wait_s"] == 0.0 and rec["checkpoint_s"] == 0.0
    # the wall times are their own: the .report reads only those
    assert set(timers.times) >= {"single-pulse", "FFT", "lo-accelsearch"}
    assert "device_s" not in timers.times
    # every scope's pair went back to the pool, and the fourth scope
    # took its pair from there
    assert len(timers._clock.free) == 6 and not timers._clock.pending


def test_on_the_cpu_device_seconds_are_wall_seconds():
    timers = StageTimers()
    timers.bind(torch.device("cpu"))
    with timers.timing("FFT"):
        time.sleep(0.01)
    assert timers.record["device_s"]["FFT"] == timers.times["FFT"] >= 0.01


def test_only_bound_timers_keep_the_record(monkeypatch):
    """Untraced, a search block's timers stay unbound: no event, no
    record, no count of waits or saves (the production search pays
    nothing for them); the tracer's device track binds them."""
    clock = FakeClock()
    real = report._EventClock
    monkeypatch.setattr(
        report, "_EventClock",
        lambda dev, event=None, stream=None: real(dev, clock.event,
                                                  clock.stream))
    timers = StageTimers()
    with timers.attached(CARD):
        scope(timers, clock, "FFT", 0.5)
        with report.host_wait("fence", CARD):
            pass
        with report.checkpoint_save():
            pass
    assert not timers.bound and clock.events == []
    assert timers.record == report.new_record() and "FFT" in timers.times
    cpu = StageTimers()
    rng = np.random.default_rng(3)
    data = rng.integers(0, 16, (16, 4096)).astype(np.uint8)
    params = tex.SearchParams(nsub=8, run_hi_accel=False,
                              topk_per_stage=4, max_cands_to_fold=0,
                              make_plots=False)
    tex.search_block(data, np.linspace(1214.0, 1536.0, 16), 1e-3,
                     [ddplan.DedispStep(10.0, 2.0, 4, 1, 8, 1)], params,
                     timers=cpu, device="cpu")
    assert not cpu.bound and cpu.record == report.new_record()
    assert cpu.times["FFT"] > 0.0
    trace.start(clear=True)
    try:
        with timers.attached(CARD):
            scope(timers, clock, "FFT", 0.5)
    finally:
        trace.reset()
    assert timers.bound and timers.record["device_s"] == {"FFT": 0.5}


def test_resolution_never_waits_through_a_whole_search(monkeypatch):
    """A CPU search_block under timers bound to a fake card: every scope
    records its pair, each pass's drain resolves them, and nothing
    synchronizes."""
    def boom(*_a, **_k):
        raise AssertionError("resolution waited for the device")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    clock = FakeClock()
    timers = bound(clock)
    resolves = []
    real = StageTimers.resolve

    def counting(self):
        resolves.append(len(self._clock.pending))
        clock.finish()
        return real(self)

    monkeypatch.setattr(StageTimers, "resolve", counting)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 16, (16, 4096)).astype(np.uint8)
    plan = [ddplan.DedispStep(10.0, 2.0, 4, 2, 8, 1)]
    params = tex.SearchParams(nsub=8, run_hi_accel=False,
                              topk_per_stage=4, max_cands_to_fold=0,
                              make_plots=False)
    tex.search_block(data, np.linspace(1214.0, 1536.0, 16), 1e-3, plan,
                     params, timers=timers, device="cpu")
    assert len(resolves) == 3           # two passes, then the return
    assert resolves[0] > 0 and resolves[1] > 0
    dev_s = timers.record["device_s"]
    for stage in ("subbanding", "dedispersing", "single-pulse", "FFT",
                  "lo-accelsearch", "pipeline-drain"):
        assert stage in dev_s, stage
    assert not timers._clock.pending


def test_the_report_is_byte_identical_with_the_record(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(report.time, "time", lambda: 1000.0)
    plain = StageTimers()
    clock = FakeClock()
    kept = bound(clock)
    for t in (plain, kept):
        t.times.update({"FFT": 1.5, "single-pulse": 0.25})
    with kept.attached(CARD):
        scope(kept, clock, "sifting", 0.5)
        with report.checkpoint_save():
            pass
        kept.resolve()
    kept.times["sifting"] = plain.times["sifting"] = 0.5
    assert kept.record["device_s"] == {"sifting": 0.5}
    plain.write_report(str(tmp_path / "a.report"), "beam")
    kept.write_report(str(tmp_path / "b.report"), "beam")
    assert (tmp_path / "a.report").read_bytes() == \
        (tmp_path / "b.report").read_bytes()


def test_profiler_ranges_only_while_a_profiler_runs(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def recording(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    timers = StageTimers()
    with timers.timing("FFT"), trace.span("dm_chunk"):
        pass
    assert opened == []
    with torch.profiler.profile() as prof:
        with timers.timing("FFT"), trace.span("dm_chunk"):
            with report.checkpoint_save():
                pass
    assert opened == ["FFT", "dm_chunk", "checkpoint-save"]
    names = {e.name for e in prof.events()}
    assert {"FFT", "dm_chunk", "checkpoint-save"} <= names


def test_a_span_and_its_range_nest_on_the_unix_clock(tmp_path):
    trace.start(clear=True)
    try:
        with torch.profiler.profile() as prof:
            with trace.span("one-clock"):
                time.sleep(0.02)
        prog = trace.export()
    finally:
        trace.reset()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    pdoc = json.loads(path.read_text())
    rng = [e for e in pdoc["traceEvents"] if e.get("name") == "one-clock"
           and e.get("cat") == "user_annotation"]
    span = [e for e in prog["traceEvents"] if e["name"] == "one-clock"]
    assert len(rng) == 1 and len(span) == 1

    def unix(doc, e):
        t0 = doc["baseTimeNanoseconds"] / 1e9 + e["ts"] / 1e6
        return t0, t0 + e["dur"] / 1e6

    r0, r1 = unix(pdoc, rng[0])
    s0, s1 = unix(prog, span[0])
    # the range opens first and closes last, both within 1 ms
    assert r0 - 1e-3 <= s0 <= r0 + 1e-3
    assert r1 - 1e-3 <= s1 <= r1 + 1e-3
    assert s1 - s0 >= 0.02


def test_the_device_track_and_time_base_in_the_export(monkeypatch):
    clock = FakeClock()
    host = [5000.0]
    monkeypatch.setattr(report.time, "time", lambda: host[0])
    trace.start(clear=True)
    try:
        timers = bound(clock)
        with timers.attached(CARD):
            scope(timers, clock, "single-pulse", 0.25)   # before an anchor
            timers.resolve()          # counted; anchor at host 5000.0
            assert timers.record["device_s"] == {"single-pulse": 0.25}
            assert len(timers._clock.pending) == 1   # not yet placed
            clock.now += 1.0
            host[0] = 5003.0          # device 101.25 <-> host 5000.0
            scope(timers, clock, "FFT", 0.5)
            timers.resolve()
        doc = trace.export()
        roll = trace.rollup(doc["traceEvents"])
    finally:
        trace.reset()
    assert doc["baseTimeNanoseconds"] == round(
        doc["otherData"]["trace_epoch_unix_s"] * 1e9)
    dev = {e["name"]: e for e in doc["traceEvents"]
           if e.get("cat") == "device"}
    assert set(dev) == {"single-pulse", "FFT"}
    t0 = doc["otherData"]["trace_epoch_unix_s"]
    for name, begin, dur in (("single-pulse", 5000.0 - 0.25, 0.25),
                             ("FFT", 5000.0 + 1.0, 0.5)):
        e = dev[name]
        assert e["pid"] == "cuda:0" and e["ph"] == "X"
        assert e["ts"] == pytest.approx((begin - t0) * 1e6, abs=1.0)
        assert e["dur"] == pytest.approx(dur * 1e6, abs=1.0)
    # the host spans' rollup leaves the device track out
    assert roll["FFT"]["count"] == 1 and roll["single-pulse"]["count"] == 1


def test_host_wait_and_checkpoint_spans():
    class OnCard:
        """What _device_get reads of a tensor on the card."""
        device = CARD

        def cpu(self):
            time.sleep(0.005)
            return torch.zeros(2)

    clock = FakeClock()
    trace.start(clear=True)
    try:
        timers = bound(clock)
        with report.host_wait("fence", CARD):
            pass                      # no search block: counted nowhere
        with timers.attached(CARD):
            with report.host_wait("fence", CARD):
                time.sleep(0.005)
            got = accel._device_get([(0, 2, (OnCard(),))])
            with report.host_wait("drain", torch.device("cpu")):
                time.sleep(0.005)     # the CPU waits for nothing
            with report.checkpoint_save():
                time.sleep(0.005)
        evs = trace.events()
    finally:
        trace.reset()
    names = [e["name"] for e in evs]
    assert got[0][2][0].tolist() == [0.0, 0.0]
    rec = timers.record

    def spans_s(prefix):
        return sum(e["dur"] for e in evs[1:]
                   if e["name"].startswith(prefix)) / 1e6

    assert rec["host_wait_s"] >= 0.01
    assert rec["host_wait_s"] == pytest.approx(spans_s("host-wait:"),
                                               abs=1e-3)
    assert rec["checkpoint_s"] >= 0.005
    assert rec["checkpoint_s"] == pytest.approx(
        spans_s("checkpoint-save"), abs=1e-3)
    assert names.count("host-wait:fence") == 2
    assert names.count("host-wait:accel") == 1
    assert "host-wait:drain" not in names
    assert names.count("checkpoint-save") == 1


def test_a_search_block_counts_its_checkpoint_saves(tmp_path):
    """Each pass's save and journal line, the sifted list and each fold
    is one checkpoint-save span, counted in checkpoint_s."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 16, (16, 4096)).astype(np.uint8)
    plan = [ddplan.DedispStep(10.0, 2.0, 4, 3, 8, 1)]
    params = tex.SearchParams(nsub=8, run_hi_accel=False,
                              topk_per_stage=4, max_cands_to_fold=0,
                              make_plots=False)
    timers = StageTimers()
    trace.start(clear=True)
    try:
        tex.search_block(data, np.linspace(1214.0, 1536.0, 16), 1e-3,
                         plan, params, timers=timers,
                         checkpoint_dir=str(tmp_path / "ck"), device="cpu")
        saves = [e for e in trace.events()
                 if e["name"] == "checkpoint-save"]
    finally:
        trace.reset()
    assert len(saves) == 3 + 1                 # 3 passes, the sifted list
    assert timers.record["checkpoint_s"] == pytest.approx(
        sum(e["dur"] for e in saves) / 1e6, rel=0.2, abs=2e-3)
    assert timers.record["host_wait_s"] == 0.0     # nothing to wait for
