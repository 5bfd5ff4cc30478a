"""Degraded-mode registry: which fallback code paths produced a
result.

The search has several silent fallbacks (Pallas dedispersion ->
XLA scan, batched accel FFT -> per-DM, sharded hi stage ->
re-dedispersing single-device route).  Correctness is preserved by
construction, but a results directory must be self-explaining about
WHICH code path produced it — a beam searched at 2x dedispersion cost
or without the flagship kernel should say so in its own artifacts
(round-2 verdict weakness #8).  Flags land in `search_params.txt` and
the `.report` (reference artifact contract:
PALFA2_presto_search.py:336-372).

Process-global by design: the fallback decisions themselves are
process-global (smoke-gate verdicts, runtime downgrades), and a
search run snapshots + resets around its own execution.

Two ledgers, one taxonomy:
  * degraded (note/count)            — science LOST or a slower path
    taken; lands in `degraded_modes`;
  * provenance (provenance_count)    — work RESCUED on another device
    (host recompute of refused rows): the science is complete, only
    provenance differs; lands in `rescued_modes` so operators can
    tell "complete beam, some rows slower" from "degraded beam".
"""

from __future__ import annotations

_FLAGS: dict[str, str] = {}
_COUNTS: dict[str, list[int]] = {}
_PROV_FLAGS: dict[str, str] = {}
_PROV_COUNTS: dict[str, list[int]] = {}


def note(flag: str, detail: str = "") -> None:
    """Record a degraded-mode event (first detail wins — the first
    occurrence is the decision point; repeats are the same verdict)."""
    _FLAGS.setdefault(flag, detail)


def count(flag: str, n: int, of: int, extra: str = "") -> None:
    """Accumulate a COUNTED degraded event across calls.  note() is
    first-wins, which under-reports events that recur per chunk/pass
    (a run where chunk 0 loses 1 row and chunk 3 loses 32 must not
    record only the 1): the flag's detail is rewritten with the
    running totals on every call.

    Call with n=0 for clean chunks too — the denominator must cover
    every chunk the path processed or the recorded fraction
    overstates the loss.  The flag itself is only written (the run
    only counts as degraded) once the cumulative n is positive."""
    _accumulate(_FLAGS, _COUNTS, flag, n, of, extra)


def _accumulate(flags: dict, counts: dict, flag: str, n: int, of: int,
                extra: str) -> None:
    c = counts.setdefault(flag, [0, 0, 0])
    c[0] += n
    c[1] += of
    c[2] += 1
    if c[0] > 0:
        flags[flag] = (f"{c[0]}/{c[1]} across {c[2]} call(s)"
                       + (f"; {extra}" if extra else ""))


def provenance_count(flag: str, n: int, of: int, extra: str = "") -> None:
    """Accumulate a RESCUED-work count: same running-total semantics
    as count() (call with n=0 so clean chunks feed the denominator),
    but recorded as provenance, not degradation — rescued rows are
    complete science from a slower device, and flagging them as a
    loss would teach operators to ignore the loss ledger."""
    _accumulate(_PROV_FLAGS, _PROV_COUNTS, flag, n, of, extra)


def snapshot() -> dict[str, str]:
    return dict(_FLAGS)


def counts() -> dict[str, tuple[int, int, int]]:
    """Running (n, of, calls) of every counted flag, clean calls
    included (the denominators: e.g. how many DM trials went through
    the hi-accel stage)."""
    return {k: tuple(v) for k, v in _COUNTS.items()}


def provenance_snapshot() -> dict[str, str]:
    return dict(_PROV_FLAGS)


def reset() -> None:
    _FLAGS.clear()
    _COUNTS.clear()
    _PROV_FLAGS.clear()
    _PROV_COUNTS.clear()
