"""Per-stage timing and the .report artifact.

Reproduces the reference's search instrumentation: per-stage timers
started in obs_info (PALFA2_presto_search.py:277-288), timed execution
of every stage (:95-139), and the percentage-breakdown report file
written at the end of the search (write_report, :336-372).  The
.report format is the JAX package's, byte for byte in layout, so
results directories from both packages line up.

The span tracer, heartbeat file and metrics histogram that the JAX
package's StageTimers also feeds belong to its observability layer,
which this package does not carry yet: here a timer is a wall clock.
"""

from __future__ import annotations

import contextlib
import time


STAGES = ("rfifind", "subbanding", "dedispersing", "single-pulse",
          "FFT", "lo-accelsearch", "hi-accelsearch", "sifting", "folding")


class StageTimers:
    def __init__(self) -> None:
        self.times: dict[str, float] = {s: 0.0 for s in STAGES}
        self._t0 = time.time()

    @contextlib.contextmanager
    def timing(self, stage: str):
        """Accumulate the wall time of one scope into times[stage]."""
        self.times.setdefault(stage, 0.0)
        start = time.time()
        try:
            yield
        finally:
            self.times[stage] += time.time() - start

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
