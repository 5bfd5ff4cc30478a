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


class StageTimers:
    def __init__(self) -> None:
        self.times: dict[str, float] = {s: 0.0 for s in STAGES}
        self._t0 = time.time()

    @contextlib.contextmanager
    def timing(self, stage: str):
        """One timed scope = one trace span + one histogram observation
        + the times[] accumulation: a trace-file rollup reproduces the
        .report totals (the JAX package's contract), and the .report
        text is unchanged."""
        self.times.setdefault(stage, 0.0)
        start = time.time()
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
            end = time.time()
            self.times[stage] += end - start
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
