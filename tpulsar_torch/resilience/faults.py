"""Deterministic fault injection at named points — counterpart of
tpulsar/resilience/faults.py.

Instrumented sites call ``fire(point)`` and a spec (env
``TPULSAR_FAULTS`` or ``configure()``) decides deterministically
whether that call raises a refusal-shaped or disk-shaped error,
sleeps past a watchdog deadline, or poisons the whole session, so
every degrade path reproduces on the CPU.

The point catalog and the grammar are the JAX package's, point for
point, so one ``TPULSAR_FAULTS`` value (set by a queue backend for
either package) parses in both.  In this package the instrumented
sites are ``checkpoint.write``/``checkpoint.load`` (checkpoint/
store.py), ``spool.io``, ``journal.append``, ``blackbox.dump``,
``dataplane.io``, ``serve.beam``, ``fleet.worker`` and
``stream.ingest`` (stream/ingest.py); the other points name sites of
modules still to be ported.

Spec grammar (``;``-separated specs, ``,``-separated options)::

    TPULSAR_FAULTS="accel.row_dispatch:unimplemented:rate=0.25,seed=7"
    TPULSAR_FAULTS="download.transfer:hang:seconds=5;queue.submit:unimplemented:count=2"

    spec  := <point> ":" <mode> [":" key=val ("," key=val)*]
    mode  := unimplemented   raise a refusal-shaped runtime error
           | hang            sleep `seconds`, then proceed (a hung
                             dispatch — policy.run_with_deadline
                             converts it into a classified failure)
           | delay           sleep `seconds` (default 0.25), then
                             proceed: SLOW I/O, not a stall — models
                             a congested spool volume or network
                             mount without tripping any watchdog
           | poison          raise AND poison the session: every
                             later fire() at any point raises too
    keys  := rate=<0..1>     trigger probability per call (default 1)
             seed=<int>      RNG seed for the rate draw (default 0)
             after=<int>     first N calls never trigger (default 0)
             count=<int>     trigger at most N times (default 0 = inf)
             seconds=<float> hang/delay duration (default 30 / 0.25)
             errno=<NAME>    shape the raised error as OSError with
                             this errno (ENOSPC, EIO, ...) — the
                             spool I/O points default to EIO

Determinism: each fault point keeps its own call counter and its own
``random.Random(seed)`` stream, so the same spec over the same call
sequence triggers the same calls — a degrade-path reproduction is a
command line, not a lucky hardware flake.

Unknown points or modes raise at configure time: a typo'd spec that
silently never fired would make a reproduction run meaningless.

Fleet-wide coordination (the chaos harness, tpulsar/chaos/): besides
the process-local TPULSAR_FAULTS baseline, this layer can poll a
SCHEDULE FILE shared by every process of a serving fleet
(``TPULSAR_CHAOS_SCHEDULE=<path>`` + ``TPULSAR_CHAOS_WORKER=<id>``,
or ``configure_schedule()``).  The schedule is a timeline of fault
windows written once by the chaos conductor::

    {"t0": <unix>, "entries": [
       {"worker": "w0", "at": 5.0, "until": 20.0,
        "faults": "spool.io:unimplemented:count=2,errno=ENOSPC"},
       {"worker": "*", "at": 10.0,
        "faults": "journal.append:unimplemented:rate=0.5,seed=7"}]}

Each process activates the entries addressed to its worker id (``*``
matches everyone) while ``t0+at <= now < t0+until`` — so ONE file
drives a deterministic, coordinated failure storm across N processes
that share nothing but the spool.  Scheduled specs layer OVER the
baseline (a scheduled point shadows the env spec for that point while
its window is open) and keep their trigger counters across polls, so
``count=`` limits hold for the whole window.
"""

from __future__ import annotations

import dataclasses
import errno as errno_mod
import json
import os
import random
import threading
import time

#: the fault-point catalog — every instrumented site, enforced at
#: parse time (docs/operations.md documents what each one exercises)
FAULT_POINTS = (
    "accel.row_dispatch",   # per-DM hi-accel row program dispatch
    "accel.chunk",          # batched hi-accel DM-chunk dispatch
    "dedisperse.pallas",    # Pallas stage-2 dedispersion kernel
    "download.transfer",    # transport fetch inside a download thread
    "upload.write",         # results-DB upload transaction
    "queue.submit",         # queue-manager job submission
    "serve.beam",           # resident-server per-beam device work
    "fleet.worker",         # fleet worker-crash injection: the server
    #                         hard-exits (os._exit) mid-beam — claim
    #                         left in place, no result, no drain
    "spool.io",             # serve/protocol.py ticket/result/heartbeat
    #                         writes: EIO/ENOSPC on the tmp-write +
    #                         rename path (the transition must fail
    #                         cleanly, never leave a torn .json)
    "journal.append",       # obs/journal.py event append: the journal
    #                         is observational, so an injected failure
    #                         here must cost evidence, never the
    #                         transition the event describes
    "checkpoint.write",     # checkpoint/store.py artifact+manifest
    #                         writes: ENOSPC/EROFS must disable the
    #                         store for the rest of the beam (the
    #                         search finishes un-checkpointed); other
    #                         errnos skip one artifact
    "checkpoint.load",      # checkpoint/store.py verified reads: a
    #                         failure is treated as corruption — the
    #                         entry is discarded + journaled
    #                         (checkpoint_invalid) and recomputed,
    #                         never resumed from garbage
    "queue.db",             # frontdoor/sqlite_queue.py: fired before
    #                         EVERY SQLite statement (BEGIN/claim CAS/
    #                         result insert/requeue/heartbeat), shaped
    #                         as sqlite3.OperationalError unless an
    #                         errno= option makes it a disk-shaped
    #                         OSError; delay mode models a congested
    #                         database volume without failing anything
    "blackbox.dump",        # obs/health.py flight-recorder crash dump:
    #                         fired MID-WRITE (after the first half of
    #                         the ring has landed) so an armed spec
    #                         leaves a torn blackbox file — the render
    #                         path must salvage the prefix, because a
    #                         real crashing worker can die mid-dump too
    "dataplane.io",         # dataplane/blobstore.py + index.py CAS and
    #                         index I/O: fired before blob writes/reads
    #                         and before every index SQL statement —
    #                         EIO/ENOSPC on the tmp+fsync+rename path
    #                         must never leave a torn object under
    #                         objects/, and an index failure must never
    #                         cost the result transition it rides on
    "stagein.fetch",        # serve/stagein.py by-digest blob fetch:
    #                         errno mode fails the transfer (contained
    #                         as a per-ticket stagein_failed result),
    #                         delay mode models a congested data plane
    "stream.ingest",        # stream/ingest.py chunk-frame append and
    #                         verified read: a failure on the read
    #                         path is retried by the stream worker
    #                         (costs latency, never data — the frame
    #                         stays on disk); delay mode models a
    #                         congested ingest volume
)

MODES = ("unimplemented", "hang", "delay", "poison")


@dataclasses.dataclass
class FaultSpec:
    point: str
    mode: str
    rate: float = 1.0
    seed: int = 0
    after: int = 0
    count: int = 0          # 0 = unlimited
    seconds: float = 30.0
    errno_name: str = ""    # raise OSError(<errno>) instead of the
    #                         refusal-shaped default (spool I/O specs)

    # runtime state (not part of the parsed spec)
    calls: int = 0
    fired: int = 0
    _rng: random.Random | None = None

    def rng(self) -> random.Random:
        if self._rng is None:
            self._rng = random.Random(self.seed)
        return self._rng


_LOCK = threading.Lock()
_SPECS: dict[str, FaultSpec] | None = None   # None = env not read yet
_POISONED: str = ""                          # point that poisoned us

#: chaos-schedule state (see module docstring).  _SCHED_PATH: None =
#: env not read yet, "" = disabled, else the schedule file to poll.
SCHEDULE_POLL_S = 0.25
_SCHED_PATH: str | None = None
_SCHED_WORKER: str = ""
_SCHED_NEXT_POLL: float = 0.0
_SCHED_MTIME: float = -1.0
_SCHED_DOC: dict | None = None
#: entry index -> parsed specs (spec OBJECTS persist across polls
#: while their window stays open, so counters/count= limits hold)
_SCHED_ACTIVE: dict[int, dict[str, FaultSpec]] = {}
#: the merged point -> spec view fire() consults (later entries win)
_SCHED_MERGED: dict[str, FaultSpec] = {}


class DispatchRefused(RuntimeError):
    """An injected refusal of device work: the UNIMPLEMENTED-shaped
    error that ``fire`` raises at a site that gives no ``make_exc``.
    The JAX package raises its runtime's own error class there; this
    package has none, and a plain RuntimeError would be
    indistinguishable from a CUDA error that poisons the context (an
    illegal address, a launch failure), which must never be retried.
    The hi stage's refusal set (kernels/accel.py) names this class."""


class SessionPoisoned(RuntimeError):
    """A `poison` fault fired earlier: the simulated session refuses
    everything from here on (the wedged-chip failure mode)."""


def io_error(msg: str) -> OSError:
    """EIO-shaped default for the spool I/O fault points — sites pass
    this as make_exc so an armed ``spool.io``/``journal.append`` spec
    without an ``errno=`` option still raises what a failing disk
    would (a spec errno, e.g. ENOSPC, overrides it)."""
    return OSError(errno_mod.EIO, msg)


def parse_spec(text: str) -> dict[str, FaultSpec]:
    """Parse a TPULSAR_FAULTS value.  Raises ValueError loudly on any
    unknown point/mode/option — see module docstring."""
    specs: dict[str, FaultSpec] = {}
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (2, 3):
            raise ValueError(
                f"fault spec {part!r} is not point:mode[:opts]")
        point, mode = fields[0].strip(), fields[1].strip()
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (catalog: "
                f"{', '.join(FAULT_POINTS)})")
        if mode not in MODES:
            raise ValueError(
                f"unknown fault mode {mode!r} (modes: "
                f"{', '.join(MODES)})")
        spec = FaultSpec(point=point, mode=mode)
        if mode == "delay":
            spec.seconds = 0.25   # slow I/O, not a watchdog stall
        if len(fields) == 3 and fields[2].strip():
            for opt in fields[2].split(","):
                if "=" not in opt:
                    raise ValueError(
                        f"fault option {opt!r} is not key=val")
                key, val = (s.strip() for s in opt.split("=", 1))
                if key == "rate":
                    spec.rate = float(val)
                    if not 0.0 <= spec.rate <= 1.0:
                        raise ValueError(f"rate={val} outside [0, 1]")
                elif key == "seed":
                    spec.seed = int(val)
                elif key == "after":
                    spec.after = int(val)
                elif key == "count":
                    spec.count = int(val)
                elif key == "seconds":
                    spec.seconds = float(val)
                elif key == "errno":
                    name = val.strip().upper()
                    if not isinstance(getattr(errno_mod, name, None),
                                      int):
                        raise ValueError(
                            f"unknown errno name {val!r}")
                    spec.errno_name = name
                else:
                    raise ValueError(f"unknown fault option {key!r}")
        if point in specs:
            raise ValueError(f"duplicate fault point {point!r}")
        specs[point] = spec
    return specs


def configure(text: str | None = None) -> None:
    """Arm the layer from a spec string (tests) or from the
    TPULSAR_FAULTS env (text=None).  Clears poisoned state and
    re-reads the chaos-schedule env (TPULSAR_CHAOS_SCHEDULE)."""
    global _SPECS, _POISONED, _SCHED_PATH
    with _LOCK:
        if text is None:
            text = os.environ.get("TPULSAR_FAULTS", "")
        _SPECS = parse_spec(text)
        _POISONED = ""
        _SCHED_PATH = None       # re-read env on next use
        _clear_schedule_state()


def reset() -> None:
    """Disarm everything (including the env spec and any chaos
    schedule — tests call this in teardown so one test's faults never
    leak into the next)."""
    global _SPECS, _POISONED, _SCHED_PATH
    with _LOCK:
        _SPECS = {}
        _POISONED = ""
        _SCHED_PATH = ""
        _clear_schedule_state()


def configure_schedule(path: str | None, worker: str = "") -> None:
    """Point this process at a chaos schedule file (the conductor's
    in-process components call this; workers inherit the env vars).
    ``path`` None/"" disables polling."""
    global _SCHED_PATH, _SCHED_WORKER
    with _LOCK:
        _SCHED_PATH = path or ""
        _SCHED_WORKER = worker or ""
        _clear_schedule_state()


def _clear_schedule_state() -> None:
    global _SCHED_NEXT_POLL, _SCHED_MTIME, _SCHED_DOC
    _SCHED_NEXT_POLL = 0.0
    _SCHED_MTIME = -1.0
    _SCHED_DOC = None
    _SCHED_ACTIVE.clear()
    _SCHED_MERGED.clear()


def _sched_poll() -> None:
    """Refresh the scheduled-fault view (call sites hold no lock;
    this takes it).  Cheap when nothing changed: one time comparison,
    one stat every SCHEDULE_POLL_S, a rebuild only when a window
    opens/closes or the file is rewritten."""
    global _SCHED_PATH, _SCHED_WORKER, _SCHED_NEXT_POLL, \
        _SCHED_MTIME, _SCHED_DOC
    with _LOCK:
        if _SCHED_PATH is None:
            _SCHED_PATH = os.environ.get("TPULSAR_CHAOS_SCHEDULE", "")
            _SCHED_WORKER = os.environ.get("TPULSAR_CHAOS_WORKER", "")
        if not _SCHED_PATH:
            return
        now = time.time()
        if now < _SCHED_NEXT_POLL:
            return
        _SCHED_NEXT_POLL = now + SCHEDULE_POLL_S
        try:
            mtime = os.stat(_SCHED_PATH).st_mtime
        except OSError:
            if _SCHED_DOC is not None:
                _SCHED_DOC = None
                _SCHED_ACTIVE.clear()
                _SCHED_MERGED.clear()
            return
        if mtime != _SCHED_MTIME or _SCHED_DOC is None:
            _SCHED_MTIME = mtime
            try:
                with open(_SCHED_PATH) as fh:
                    _SCHED_DOC = json.load(fh)
            except (OSError, ValueError):
                return           # mid-write; next poll retries
            _SCHED_ACTIVE.clear()   # entry indices may have moved
        doc = _SCHED_DOC or {}
        t0 = float(doc.get("t0", 0.0))
        live: set[int] = set()
        for idx, entry in enumerate(doc.get("entries", ())):
            who = str(entry.get("worker", "*"))
            if who not in ("*", _SCHED_WORKER):
                continue
            at = t0 + float(entry.get("at", 0.0))
            until = entry.get("until")
            if now < at or (until is not None
                            and now >= t0 + float(until)):
                continue
            live.add(idx)
            if idx not in _SCHED_ACTIVE:
                try:
                    _SCHED_ACTIVE[idx] = parse_spec(
                        str(entry.get("faults", "")))
                except ValueError:
                    # a bad entry must be loud, not silent — but a
                    # worker mid-beam cannot crash over it either
                    _SCHED_ACTIVE[idx] = {}
        for idx in [i for i in _SCHED_ACTIVE if i not in live]:
            del _SCHED_ACTIVE[idx]
        _SCHED_MERGED.clear()
        for idx in sorted(_SCHED_ACTIVE):
            _SCHED_MERGED.update(_SCHED_ACTIVE[idx])


def _specs() -> dict[str, FaultSpec]:
    global _SPECS
    if _SPECS is None:
        configure()
    return _SPECS  # type: ignore[return-value]


def active() -> bool:
    _sched_poll()
    return bool(_specs()) or bool(_SCHED_MERGED)


def targets(point: str) -> bool:
    """Is this exact point armed (env spec or an open schedule
    window)?  Used by path gates: a spec naming accel.row_dispatch
    pins the per-DM path so the fault actually fires (the
    batched/native paths never dispatch rows)."""
    _sched_poll()
    return point in _specs() or point in _SCHED_MERGED


def targets_prefix(prefix: str) -> bool:
    _sched_poll()
    return any(p.startswith(prefix) for p in _specs()) \
        or any(p.startswith(prefix) for p in _SCHED_MERGED)


def fired(point: str) -> int:
    """How many times this point's fault has triggered (tests)."""
    spec = _SCHED_MERGED.get(point) or _specs().get(point)
    return spec.fired if spec else 0


def _default_exc(msg: str) -> Exception:
    """UNIMPLEMENTED-shaped refusal (a RuntimeError, so every site that
    catches RuntimeError still catches it)."""
    return DispatchRefused(msg)


def fire(point: str, make_exc=None, detail: str = "") -> None:
    """Trip the fault at `point` if its spec says so.

    make_exc: optional callable(message) -> Exception letting the
    instrumented site shape the error to ITS failure taxonomy (the
    downloader raises IOError, the uploader a connection error, ...);
    default is the UNIMPLEMENTED-shaped runtime error.

    No-spec calls are two dict lookups — cheap enough for per-row
    dispatch loops.
    """
    global _POISONED
    _sched_poll()
    specs = _specs()
    if not specs and not _SCHED_MERGED and not _POISONED:
        return
    with _LOCK:
        if _POISONED:
            # shaped through the SITE's taxonomy like any other
            # injected error (the downloader must see its IOError,
            # the uploader its connection error — a raw
            # SessionPoisoned would crash paths the injection exists
            # to exercise); sites without a make_exc get the marker
            # class, which the accel REFUSED set catches by name
            pmsg = (f"session poisoned by fault at {_POISONED!r}; "
                    f"refusing {point}"
                    + (f" ({detail})" if detail else ""))
            raise make_exc(pmsg) if make_exc is not None \
                else SessionPoisoned(pmsg)
        # an open schedule window shadows the env baseline for its
        # point: the conductor's storm is authoritative while it lasts
        spec = _SCHED_MERGED.get(point)
        if spec is None:
            spec = specs.get(point)
        if spec is None:
            return
        spec.calls += 1
        if spec.calls <= spec.after:
            return
        if spec.count and spec.fired >= spec.count:
            return
        if spec.rate < 1.0 and spec.rng().random() >= spec.rate:
            return
        spec.fired += 1
        n = spec.fired
        if spec.mode == "poison":
            _POISONED = point
    msg = (f"UNIMPLEMENTED: injected fault at {point} "
           f"(trigger #{n}, mode={spec.mode}"
           + (f", {detail}" if detail else "") + ")")
    if spec.mode in ("hang", "delay"):
        # hang: sleep past the watchdog deadline, then proceed —
        # policy.run_with_deadline converts the stall into a
        # classified DeadlineExceeded instead of an unbounded hang.
        # delay: the same sleep at slow-I/O magnitude (default
        # 0.25 s) — latency the caller must absorb, not a failure.
        time.sleep(spec.seconds)
        return
    if spec.errno_name:
        # operator-shaped error wins over the site's taxonomy: an
        # errno= spec exists to exercise exactly that OSError path
        raise OSError(getattr(errno_mod, spec.errno_name), msg)
    raise make_exc(msg) if make_exc is not None else _default_exc(msg)


def snapshot() -> dict[str, dict]:
    """Armed specs + trigger counts (doctor/debug output).  Scheduled
    specs (open chaos windows) are included and marked."""
    _sched_poll()
    out = {p: {"mode": s.mode, "rate": s.rate, "calls": s.calls,
               "fired": s.fired}
           for p, s in _specs().items()}
    for p, s in _SCHED_MERGED.items():
        out[p] = {"mode": s.mode, "rate": s.rate, "calls": s.calls,
                  "fired": s.fired, "scheduled": True}
    return out
