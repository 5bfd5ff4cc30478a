"""The serve spool: a filesystem job-ticket protocol — counterpart of
tpulsar/serve/protocol.py (a copy).  Tickets, claims, side-files,
takeovers, quarantine, results and heartbeats are file-compatible with
the JAX package in both directions: either package's workers and
clients can share one spool.  Quarantine reads checkpoint progress
through this package's checkpoint/.

The resident servers and their clients (the ``warm`` queue backend,
the fleet controller, ``bench.py --serve/--fleet``, CI smoke scripts)
coordinate through a spool directory — job tickets in, result records
out — so no network stack is needed and every state transition is a
crash-safe rename:

    <spool>/incoming/<ticket_id>.json     admission queue (bounded)
    <spool>/claimed/<ticket_id>.json      accepted, being processed
    <spool>/done/<ticket_id>.json         result/status record
    <spool>/quarantine/<ticket_id>.json   poisoned beams (attempts cap)
    <spool>/server.json                   single-server heartbeat
    <spool>/server.<worker_id>.json       per-worker fleet heartbeats

A ticket moves ``incoming -> claimed`` by atomic rename (exactly-one
claimer even with several workers on one spool) and is deleted from
``claimed`` only after its result record is durable in ``done/``.
The claim itself lands in two renames — ``incoming/<tid>.json`` ->
``claimed/<tid>.json.claiming.<pid>`` (the exclusive step), stamp the
owner pid/worker into that private file, then promote it to the plain
claim — so a plain claim ALWAYS carries its owner and a concurrently
scanning janitor can never mistake a half-made claim for an ownerless
orphan.  A
worker that dies mid-beam therefore leaves the ticket in ``claimed``;
``requeue_stale_claims`` (run at worker boot and continuously by the
fleet controller's janitor) moves such orphans back to ``incoming`` —
but ONLY when the claim's recorded owner is dead, so with N workers on
one spool the requeue is a safe work-stealing protocol, never a way to
double-process a beam a live co-worker still holds.

Every crash-shaped requeue increments the ticket's ``attempts``
counter; a beam that has killed its worker ``max_attempts`` times is
poisoned — it is moved to ``quarantine/`` and failed into ``done/``
(status ``failed``, reason ``max_attempts``) so no worker in the fleet
ever claims it again.  Graceful-drain requeues (``requeue_own_claims``)
are attempt-neutral: a beam a stopping worker simply hadn't started is
not a suspect.

All writes are tmp-file + ``os.replace`` so a reader can never observe
a torn JSON document.  Requeues first take exclusive ownership of the
claim file by renaming it aside (``.takeover.<pid>``), so two janitors
racing over one dead worker's claim cannot resurrect a ticket a third
process just re-claimed.

Ticket shape (written by clients):
    {"ticket": ..., "datafiles": [...], "outdir": ..., "job_id": ...,
     "submitted_at": unix_time, "attempts": 0}

Result shape (written by the server):
    {"ticket": ..., "status": "done"|"failed"|"skipped", "rc": int,
     "error": str, "beam_seconds": float, "compile_misses": int,
     "warm": bool, "outdir": ..., "worker": str, "attempts": int,
     "finished_at": unix_time}
"""

from __future__ import annotations

import functools
import json
import os
import time
import uuid

from tpulsar_torch.obs import journal
from tpulsar_torch.resilience import faults


def _timed(op: str):
    """Land a hot-path spool operation's wall time in the
    ``tpulsar_queue_op_seconds`` histogram (``backend="spool"``) —
    the same series the sqlite backend observes around its
    transactions, so a queue-backend migration is an
    apples-to-apples latency comparison, not two dashboards.
    Failed operations are not observed: the histogram answers "how
    long does a successful claim take", errors have their own
    counters."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from tpulsar_torch.obs import telemetry
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            telemetry.queue_op_seconds().observe(
                time.perf_counter() - t0, backend="spool", op=op)
            return out
        return wrapper
    return deco

#: heartbeats older than this are stale: the worker is gone (crashed,
#: drained, or never started); with zero fresh workers clients must
#: fall back to process-per-beam submission.  This is the BUILT-IN
#: default only — every freshness judgment resolves the effective
#: value through :func:`heartbeat_max_age` (config
#: ``jobpooler.heartbeat_max_age_s`` via set_heartbeat_max_age, or
#: the ``TPULSAR_HEARTBEAT_MAX_AGE_S`` env var), so the autoscaler's
#: reaction time and the tests are knobs, not a module constant.
HEARTBEAT_MAX_AGE_S = 120.0

_heartbeat_max_age_override: float | None = None


def set_heartbeat_max_age(seconds: float | None) -> None:
    """Install the deployment's heartbeat staleness window (the CLI
    calls this from config; ``None`` reverts to env/default
    resolution).  Invalid values are rejected loudly — a zero or
    negative window would declare every worker dead."""
    global _heartbeat_max_age_override
    if seconds is not None and seconds <= 0:
        raise ValueError(
            f"heartbeat max age must be positive, got {seconds!r}")
    _heartbeat_max_age_override = seconds


def heartbeat_max_age() -> float:
    """The effective heartbeat staleness window: config override >
    TPULSAR_HEARTBEAT_MAX_AGE_S env > the 120 s built-in.  Every
    signature that used to bake HEARTBEAT_MAX_AGE_S in as a default
    now resolves through here at CALL time, so one knob moves the
    whole stack (freshness, capacity, janitor grace) together."""
    if _heartbeat_max_age_override is not None:
        return _heartbeat_max_age_override
    env = os.environ.get("TPULSAR_HEARTBEAT_MAX_AGE_S", "")
    if env:
        try:
            val = float(env)
            if val > 0:
                return val
        except ValueError:
            pass
    return HEARTBEAT_MAX_AGE_S

#: crash-shaped claims a ticket may accumulate before it is judged
#: poisoned and quarantined (overridable per call / via
#: jobpooler.serve_max_attempts)
DEFAULT_MAX_ATTEMPTS = 3

_STATES = ("incoming", "claimed", "done", "quarantine")


def default_spool_dir(cfg=None) -> str:
    """One spool per deployment, under the working-directory root the
    workers and the job-pool daemon already share."""
    if cfg is None:
        from tpulsar_torch.config import settings
        cfg = settings()
    return os.path.join(cfg.processing.base_working_directory,
                        ".serve_spool")


def ensure_spool(spool: str) -> str:
    for state in _STATES:
        os.makedirs(os.path.join(spool, state), exist_ok=True)
    return spool


def _atomic_write_json(path: str, rec: dict) -> None:
    # tmp name unique per writer: the heartbeat is written by both
    # the server's main thread and its heartbeat thread, and two
    # writers sharing one tmp path can interleave truncate/rename
    # into a torn server.json — which reads as a DEAD server and
    # makes the warm backend abandon live tickets
    import threading
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    # the spool I/O fault point (EIO/ENOSPC on protocol writes):
    # every ticket/result/heartbeat write funnels through here, so
    # one spec exercises the whole containment story
    faults.fire("spool.io", make_exc=faults.io_error, detail=path)
    try:
        with open(tmp, "w") as fh:
            json.dump(rec, fh, indent=1)
        os.replace(tmp, path)
    except BaseException:
        # ENOSPC mid-dump (or a kill) must not leave the partial tmp
        # behind: claimers already ignore .tmp names, but an orphaned
        # tmp would read as un-quiesced work to the chaos auditor —
        # and the FAILED write must fail the transition cleanly with
        # nothing half-visible at the destination path
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def ticket_path(spool: str, ticket_id: str, state: str) -> str:
    assert state in _STATES, state
    return os.path.join(spool, state, f"{ticket_id}.json")


# ------------------------------------------------------------- tickets

@_timed("submit")
def write_ticket(spool: str, ticket_id: str, datafiles: list[str],
                 outdir: str, job_id: int | None = None,
                 **extra) -> str:
    """Enqueue a beam: one JSON file in incoming/.  Returns the
    ticket id.  Callers enforce admission depth via fleet_capacity()
    BEFORE writing (the queue-backend contract's can_submit).

    Submission mints the beam's ``trace_id`` (unless the caller
    supplied one): it rides in the ticket JSON through every claim,
    steal, and requeue, is adopted by obs/trace.py spans in whichever
    worker holds the beam, and keys the journal events — the one
    correlation id a beam keeps across the whole fleet."""
    ensure_spool(spool)
    rec = {"ticket": ticket_id, "datafiles": list(datafiles),
           "outdir": outdir, "job_id": job_id,
           "submitted_at": time.time(), "attempts": 0, **extra}
    rec.setdefault("trace_id", uuid.uuid4().hex[:16])
    # the ONE journal event recorded before its transition: the
    # instant the incoming/ write lands the ticket is claimable, and
    # a fast worker's 'claimed' event must never carry an earlier
    # timestamp than 'submitted' (validate_chain would flag a
    # healthy beam).  A crash between the two leaves a spurious
    # in-flight journal entry for a ticket that never existed —
    # honest, and harmless to every consumer.
    journal.record(spool, "submitted", ticket=ticket_id,
                   attempt=0, trace_id=rec["trace_id"],
                   outdir=outdir,
                   **({"tenant": rec["tenant"]} if rec.get("tenant")
                      else {}))
    try:
        _atomic_write_json(ticket_path(spool, ticket_id, "incoming"),
                           rec)
    except OSError as e:
        # the incoming/ write failed (full disk, injected spool.io):
        # the submission FAILED — compensate the already-journaled
        # 'submitted' head so the auditor can tell a cleanly-refused
        # beam from a lost one, then surface the error to the caller
        journal.record(spool, "submit_failed", ticket=ticket_id,
                       attempt=0, trace_id=rec["trace_id"],
                       error=str(e)[:200])
        raise
    _invalidate_capacity(spool)
    return ticket_id


def list_tickets(spool: str, state: str) -> list[str]:
    """Ticket ids in a spool state, oldest submission first (FIFO
    admission — directory listing order is not arrival order)."""
    d = os.path.join(spool, state)
    try:
        names = [n for n in os.listdir(d) if n.endswith(".json")]
    except OSError:
        return []
    def _key(name: str):
        rec = _read_json(os.path.join(d, name)) or {}
        return (rec.get("submitted_at", 0.0), name)
    return [n[:-5] for n in sorted(names, key=_key)]


def pending_count(spool: str) -> int:
    """Waiting tickets, counted from the directory listing alone —
    the controller loop, fleet_capacity, and every can_submit call
    come through here, and only list_tickets (which must SORT by
    submission time) needs to open and parse the ticket files."""
    return state_count(spool, "incoming")


def state_count(spool: str, state: str) -> int:
    """Ticket count in a spool state from the directory listing alone
    (the controller's poll loop and status rendering need counts, not
    parsed-and-sorted records — a fleet that has completed 50k beams
    must not re-parse 50k result files every second)."""
    assert state in _STATES, state
    d = os.path.join(spool, state)
    try:
        return sum(1 for n in os.listdir(d) if n.endswith(".json"))
    except OSError:
        return 0


def claimed_count(spool: str) -> int:
    """Outstanding claims INCLUDING those momentarily renamed aside —
    by a janitor for requeue (``.takeover.<pid>``) or by a claimer
    mid-stamp (``.claiming.<pid>``): a requeue or claim in flight is
    still outstanding work, and an exit check that reads only plain
    claims could declare the spool drained in the microseconds
    between the rename and the next write — stranding the ticket with
    no worker left."""
    d = os.path.join(spool, "claimed")
    try:
        names = os.listdir(d)
    except OSError:
        return 0
    return sum(1 for n in names
               if not n.endswith(".tmp")      # _atomic_write_json's
               and (n.endswith(".json") or ".json.takeover." in n
                    or ".json.claiming." in n))


def pending_records(spool: str) -> list[dict]:
    """Parsed incoming ticket records (unsorted; torn files skipped)
    — the input a claim policy orders."""
    d = os.path.join(spool, "incoming")
    try:
        names = [n for n in os.listdir(d) if n.endswith(".json")]
    except OSError:
        return []
    out = []
    for name in names:
        rec = _read_json(os.path.join(d, name))
        if rec is not None:
            rec.setdefault("ticket", name[:-5])
            out.append(rec)
    return out


def inflight_by_tenant(spool: str) -> dict[str, int]:
    """Currently claimed beams per tenant, INCLUDING tickets held in
    transient side-files (``.claiming.<pid>`` mid-claim,
    ``.takeover.<pid>`` mid-requeue) — same reasoning as
    claimed_count: a ticket between its two claim renames is neither
    pending nor a plain claim, and a quota pass that saw it as
    neither would let a concurrent worker overshoot the tenant's
    max_inflight through that window.  The claimed/ directory is
    bounded by fleet in-flight depth, so the per-claim parse here is
    cheap — unlike incoming/, which can hold a deep backlog."""
    d = os.path.join(spool, "claimed")
    try:
        names = [n for n in os.listdir(d)
                 if not n.endswith(".tmp")
                 and (n.endswith(".json") or ".json.claiming." in n
                      or ".json.takeover." in n)]
    except OSError:
        return {}
    counts: dict[str, int] = {}
    for name in names:
        rec = _read_json(os.path.join(d, name)) or {}
        tenant = rec.get("tenant") or "default"
        counts[tenant] = counts.get(tenant, 0) + 1
    return counts


@_timed("claim")
def claim_next_ticket(spool: str, worker_id: str = "",
                      policy=None,
                      worker_class: str = "") -> dict | None:
    """Atomically move the oldest incoming ticket to claimed/ and
    return its record (None when the queue is empty).  Rename is the
    claim: two workers on one spool cannot claim the same ticket.
    The claim records the owner (pid + worker id) so the requeue
    machinery can tell a dead owner's orphan from a live co-worker's
    in-flight beam.

    ``policy`` (a frontdoor.tenancy.TenantPolicy) replaces the FIFO
    scan order with priority-class ordering and skips tickets of
    tenants at their in-flight quota — ordering and eligibility only:
    the claim itself is the same exclusive two-rename either way, so
    the exactly-once guarantees below hold unchanged under any
    policy.

    The claim lands in two renames: ``incoming/<tid>.json`` ->
    ``claimed/<tid>.json.claiming.<pid>`` (exclusive), stamp the owner
    into that private file, then rename it to the plain claim.  An
    OWNERLESS plain claim therefore never exists, so a janitor
    scanning ``claimed/`` mid-claim cannot mistake a live worker's
    half-stamped claim for a dead worker's orphan and requeue a beam
    that is about to be processed (the ticket would then exist in both
    incoming/ and claimed/ — two workers, one beam).  A claimer that
    dies between the renames leaves ``.claiming.<pid>``, which
    _recover_abandoned_claimings returns to incoming/.

    A claimer that STALLS (SIGSTOP, VM pause) long enough for the
    janitor's grace window to expire may find its staging file stolen
    when it resumes.  Every step after the exclusive rename is
    theft-safe: the stamp write is bracketed by in-process hold-age
    checks (a claimer past half the grace window withdraws — renames
    the ticket back to incoming, or discards its re-created staging
    copy when the ticket demonstrably moved on without it — instead
    of racing the janitor), and promotion is ``os.link`` + unlink of
    the staging, which refuses (EEXIST) to clobber a plain claim a
    co-claimer promoted in the meantime and raises ENOENT when the
    staging was stolen — a lost claim is abandoned, never
    fabricated."""
    grace = orphan_sidefile_grace()
    for tid in _claim_order(spool, policy):
        rec = _try_claim_one(spool, tid, worker_id, worker_class,
                             grace)
        if rec is not None:
            return rec
    return None


@_timed("claim_batch")
def claim_batch(spool: str, n: int, worker_id: str = "",
                policy=None, worker_class: str = "",
                compat: str | None = None) -> list[dict]:
    """Claim up to ``n`` COMPATIBLE tickets in ONE tenant-policy
    ordering pass — the batched admission primitive behind ``serve
    --batch N``.

    Batchmates are picked inside the existing claim ordering: the
    first claimable ticket fixes the batch's compatibility key (its
    declared ``compat`` field, ``""`` when unstamped) unless
    ``compat`` pins one; subsequent tickets are claimed only when
    their declared key matches, and mismatching tickets are SKIPPED
    in place — left pending for the next (solo or batch) claimer,
    never displaced out of their priority slot.  Unstamped tickets
    batch with other unstamped tickets: the executor's batch entry
    point re-derives the true key from each beam's header and
    degrades any liar (or stranger) to the solo path, so a declared
    key is an admission OPTIMIZATION, never a correctness input.

    Each member is still claimed by the same exclusive two-rename as
    :func:`claim_next_ticket` and journaled individually, so
    exactly-once, owner stamping, attempts accounting, work-stealing,
    and quarantine are untouched — the only new property is the
    shared ordering pass, which makes an N-beam claim O(backlog)
    instead of O(N x backlog).  The policy's quota budgeting already
    spans the whole ordered list, so a batch cannot overshoot a
    tenant's max_inflight either."""
    if n < 1:
        return []
    grace = orphan_sidefile_grace()
    claimed: list[dict] = []
    for tid in _claim_order(spool, policy):
        if len(claimed) >= n:
            break
        if compat is not None or claimed:
            want = compat if compat is not None \
                else str(claimed[0].get("compat", "") or "")
            rec0 = _read_json(ticket_path(spool, tid, "incoming"))
            if rec0 is None:
                continue     # raced away; the rename would fail too
            if str(rec0.get("compat", "") or "") != str(want or ""):
                continue     # incompatible: stays pending, in place
        rec = _try_claim_one(spool, tid, worker_id, worker_class,
                             grace)
        if rec is not None:
            claimed.append(rec)
    return claimed


def _claim_order(spool: str, policy) -> list[str]:
    """The ONE ordering pass single and batch claims share: FIFO for
    a trivial policy (no tenants configured — skip the per-pending
    parse entirely), else the TenantPolicy's priority/quota ordering
    over the parsed backlog.  Factored out so an N-ticket batch claim
    parses the backlog once, not once per member."""
    if policy is None or getattr(policy, "is_trivial", False):
        return list_tickets(spool, "incoming")
    return policy.claim_order(pending_records(spool),
                              inflight_by_tenant(spool))


def _journal_claim(spool: str, rec: dict, worker_id: str) -> None:
    journal.record(
        spool, "claimed", ticket=rec.get("ticket", "?"),
        worker=worker_id, pid=os.getpid(),
        attempt=int(rec.get("attempts", 0)),
        trace_id=rec.get("trace_id", ""),
        queue_wait_s=round(
            rec["claimed_at"] - rec.get("submitted_at",
                                        rec["claimed_at"]), 3),
        # the tenant rides the claim event so per-tenant inflight
        # can be reconstructed from the journal alone (the chaos
        # verifier's quota invariant)
        **({"tenant": rec["tenant"]} if rec.get("tenant")
           else {}),
        # the worker CLASS rides it too: a spot worker's claims
        # are expected to be SIGKILLed by the autoscaler, and the
        # no_elastic_strike audit wants that context in-band
        **({"worker_class": rec["claimed_by_class"]}
           if rec.get("claimed_by_class") else {}))


def _try_claim_one(spool: str, tid: str, worker_id: str,
                   worker_class: str, grace: float) -> dict | None:
    """One ticket's exclusive two-rename claim (the contract
    narrative lives on claim_next_ticket): returns the stamped
    record, or None when the ticket was lost to a race or theft --
    the caller just moves on to the next id in its ordering."""
    src = ticket_path(spool, tid, "incoming")
    dst = ticket_path(spool, tid, "claimed")
    staging = f"{dst}.claiming.{os.getpid()}"
    held_at = time.time()
    try:
        _rename_held(src, staging)
    except OSError:
        return None          # lost the race; try the next ticket
    rec = _read_json(staging)
    if rec is None:
        try:
            os.unlink(staging)   # torn/garbage ticket: drop it
        except OSError:
            pass
        return None
    if time.time() - held_at > grace / 2:
        # we stalled mid-claim: a janitor may be about to judge
        # (or has judged) our staging file abandoned — withdraw
        # instead of racing it
        try:
            os.rename(staging, src)
        except OSError:
            pass            # already stolen: the ticket is safe
        return None
    rec["claimed_at"] = time.time()
    rec["claimed_by"] = os.getpid()
    if worker_id:
        rec["claimed_by_worker"] = worker_id
    if worker_class:
        # spot vs on-demand: elasticity context the requeue
        # machinery and the journal audit read off the claim
        rec["claimed_by_class"] = worker_class
    try:
        _atomic_write_json(staging, rec)
    except OSError:
        # the stamp write failed (ENOSPC, injected spool.io):
        # withdraw the claim CLEANLY — the ticket goes straight
        # back to incoming instead of idling in its .claiming
        # side-file until the grace-window recovery notices it
        try:
            os.rename(staging, src)
        except OSError:
            pass         # stolen meanwhile: the ticket is safe
        raise
    # the replace above refreshed the staging mtime, so from here
    # we hold a fresh full grace window — but if we stalled BEFORE
    # it, the write may have re-created a path a janitor already
    # recovered; the ticket existing anywhere else proves the
    # theft, and our staging copy is the duplicate to discard
    if time.time() - held_at > grace / 2 \
            and _ticket_exists_elsewhere(spool, tid):
        try:
            os.unlink(staging)
        except OSError:
            pass
        return None
    try:
        os.link(staging, dst)
    except FileExistsError:
        # a co-claimer (fed by a janitor's requeue of this very
        # ticket) promoted first: theirs is the claim, ours is
        # the duplicate
        try:
            os.unlink(staging)
        except OSError:
            pass
        return None
    except FileNotFoundError:
        return None          # stolen while we stalled post-stamp
    except OSError:
        # hard links unsupported here (some network/FUSE mounts:
        # EPERM/ENOTSUP): promote by plain rename — losing only
        # the refuse-to-clobber hardening, never stranding the
        # ticket in its .claiming side-file for the grace window
        try:
            os.rename(staging, dst)
        except OSError:
            return None
        _invalidate_capacity(spool)
        _journal_claim(spool, rec, worker_id)
        return rec
    try:
        os.unlink(staging)
    except OSError:
        pass
    _invalidate_capacity(spool)
    _journal_claim(spool, rec, worker_id)
    return rec


def cancel_ticket(spool: str, ticket_id: str) -> bool:
    """Remove a ticket still waiting for admission.  A claimed ticket
    cannot be cancelled from outside (the worker owns it — there is
    no cross-process way to abort the in-flight device work)."""
    try:
        os.unlink(ticket_path(spool, ticket_id, "incoming"))
    except OSError:
        return False
    _invalidate_capacity(spool)
    return True


def _pid_alive(pid) -> bool:
    try:
        os.kill(int(pid), 0)
    except (ProcessLookupError, ValueError, TypeError, OverflowError):
        return False
    except PermissionError:
        return True
    return True


#: a ``.takeover.<pid>`` / ``.claiming.<pid>`` file is held for
#: milliseconds by a live process; one this old is abandoned even if
#: its pid reads alive (pid recycled by an unrelated process) — the
#: age fallback keeps a recycled pid from stranding a ticket forever.
#: The effective grace follows heartbeat_max_age() (one staleness
#: knob for the whole stack) but never drops below this floor: a
#: deployment tuning heartbeats to seconds for autoscaler reaction
#: must not also shrink the stall-withdrawal window claims depend on.
ORPHAN_SIDEFILE_GRACE_S = HEARTBEAT_MAX_AGE_S
ORPHAN_SIDEFILE_GRACE_FLOOR_S = 30.0


def orphan_sidefile_grace() -> float:
    return max(ORPHAN_SIDEFILE_GRACE_FLOOR_S, heartbeat_max_age())


def _sidefile_owner_live(path: str, pid,
                         grace_s: float | None = None) -> bool:
    """Does a transient claim side-file still belong to a live owner?
    Liveness is pid-alive AND recently renamed: past the grace window
    the pid must be a recycled one, because no healthy claim or
    takeover holds its side-file for minutes.  The age read here is
    HOLD time, not content age — every exclusive rename that creates
    a side-file re-touches it (_rename_held), since os.rename
    preserves mtime and a ticket that waited minutes in incoming/
    (or a claim held through a long beam) would otherwise make a
    fresh side-file look ancient and steal-able."""
    if grace_s is None:
        grace_s = orphan_sidefile_grace()
    if not _pid_alive(pid):
        return False
    try:
        age = time.time() - os.stat(path).st_mtime
    except OSError:
        return False             # gone already: nothing to recover
    return age <= grace_s


def _rename_held(src: str, dst: str) -> None:
    """Exclusive-rename a ticket into a transient side-file with its
    mtime stamped to NOW: the grace-window scans must measure how
    long the side-file has been held, and a plain rename carries the
    source's (possibly minutes-old) mtime along.  The touch happens
    BEFORE the rename so the side-file is never observable with an
    ancient mtime — a touch-after ordering would leave a syscall-wide
    window in which a janitor could stat a freshly renamed side-file,
    read the backpressure-aged mtime, and steal a live claim.  A
    failed touch aborts the claim attempt (OSError propagates and the
    ticket stays put): proceeding with a stale mtime would re-open
    exactly that theft window.  Source mtimes carry no meaning of
    their own (FIFO order is the ticket's submitted_at field), so a
    touch whose rename then loses the race is harmless."""
    os.utime(src)
    os.rename(src, dst)


def _strip_claim_stamps(rec: dict) -> dict:
    rec.pop("claimed_at", None)
    rec.pop("claimed_by", None)
    rec.pop("claimed_by_worker", None)
    rec.pop("claimed_by_class", None)
    return rec


# --------------------------------------------------- elective kills

#: the autoscaler's kill ledger (<spool>/scale_downs.json): pids the
#: controller killed ON PURPOSE while scaling down.  The journal's
#: ``scale_down`` event is the audit evidence; this file is the
#: hot-path index every janitor consults, so an elective victim's
#: claims requeue attempt-neutrally (reason ``scale_down``) instead
#: of charging a crash strike — elasticity must never advance a beam
#: toward quarantine (the no_elastic_strike invariant).
SCALEDOWN_FILE = "scale_downs.json"

#: ledger entries older than this are pruned on write: the only
#: window that matters is kill -> the claim's reclamation, which the
#: janitor closes within seconds
SCALEDOWN_TTL_S = 3600.0


def scaledown_path(spool: str) -> str:
    return os.path.join(spool, SCALEDOWN_FILE)


def record_elective_kill(spool: str, worker_id: str, pid: int,
                         reason: str = "scale_down") -> None:
    """Record an autoscaler-initiated kill BEFORE the signal is sent
    (the ordering the neutral requeue depends on: by the time the pid
    reads dead, the ledger already names it elective).  Single
    writer — the fleet controller — so read-modify-write is safe."""
    now = time.time()
    rec = _read_json(scaledown_path(spool)) or {}
    kills = [k for k in rec.get("kills", ())
             if now - k.get("t", 0.0) <= SCALEDOWN_TTL_S]
    kills.append({"worker": worker_id, "pid": int(pid), "t": now,
                  "reason": reason})
    _atomic_write_json(scaledown_path(spool),
                       {"kills": kills, "updated": now})


def elective_kill_pids(spool: str) -> set[int]:
    """Pids the autoscaler killed on purpose.  Tolerant: a
    missing/torn ledger means no elective kills."""
    rec = _read_json(scaledown_path(spool)) or {}
    return {int(k["pid"]) for k in rec.get("kills", ())
            if k.get("pid") is not None}


def elective_kills(spool: str) -> set[tuple[str, int]]:
    """(worker_id, pid) pairs from the scale-down ledger — what the
    janitor's neutral verdict matches against.  The PAIR matters: a
    pid alone can be recycled within the ledger's TTL (this codebase
    already defends against that in _sidefile_owner_live), and a
    recycled pid must not turn a genuine crash strike into a neutral
    requeue and defeat quarantine.  Elastic worker ids are minted
    from a monotone counter and never reused, so the pair uniquely
    names one incarnation."""
    rec = _read_json(scaledown_path(spool)) or {}
    return {(str(k.get("worker", "")), int(k["pid"]))
            for k in rec.get("kills", ())
            if k.get("pid") is not None}


def _ticket_exists_elsewhere(spool: str, ticket_id: str) -> bool:
    """Does the ticket exist in ANY spool state (a side-file holder
    checking whether the ticket has already moved on without it)?"""
    return any(os.path.exists(ticket_path(spool, ticket_id, state))
               for state in _STATES)


def _takeover_claim(spool: str, ticket_id: str) -> str | None:
    """Take exclusive ownership of a claim file before requeueing it:
    the rename is atomic, so of N janitors racing over one dead
    worker's claim exactly one proceeds — the others see ENOENT and
    skip.  Without this, a slow janitor could re-create an incoming
    ticket another worker already re-claimed (a duplicate beam) or
    unlink that worker's live claim (a lost one).  The takeover is
    re-touched (_rename_held): it must read as freshly held, not
    inherit the claim's possibly-minutes-old stamp time, or a
    concurrent janitor's grace-window scan would judge it abandoned
    while this one is live mid-requeue."""
    src = ticket_path(spool, ticket_id, "claimed")
    tmp = f"{src}.takeover.{os.getpid()}"
    try:
        _rename_held(src, tmp)
    except OSError:
        return None
    return tmp


def _recover_abandoned_takeovers(spool: str) -> None:
    """A janitor that died between taking a claim over and finishing
    the requeue left ``<tid>.json.takeover.<pid>``.  If the ticket
    already moved on without it — the dead janitor DID finish the
    incoming/ write (or quarantine), or another worker has since
    re-claimed or completed the beam — the takeover file is a stale
    duplicate and is deleted: restoring it would clobber the live
    claim (or fork the ticket into two states) and double-process the
    beam.  Only when the ticket exists NOWHERE else is the takeover
    restored to a plain claim for the normal stale-claim scan — a
    ticket must never be lost to a crashed janitor.

    Abandonment is judged by _sidefile_owner_live — owner pid dead,
    OR the file older than the grace window (a recycled pid must not
    hide a dead janitor's takeover from recovery: the ticket would be
    stuck invisible to requeue yet counted by claimed_count, so a
    --once fleet could never report the spool drained)."""
    d = os.path.join(spool, "claimed")
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        base, sep, pid = name.partition(".takeover.")
        if not sep or not base.endswith(".json"):
            continue
        path = os.path.join(d, name)
        if _sidefile_owner_live(path, pid):
            continue
        tid = base[:-len(".json")]
        if _ticket_exists_elsewhere(spool, tid):
            try:
                os.unlink(path)
            except OSError:
                pass
            continue
        rec = _read_json(path)
        if rec is not None and "claimed_by" not in rec:
            # an UNSTAMPED takeover: the dead janitor was recovering a
            # .claiming file (or had already stripped the stamps for
            # requeue).  Restoring it as a plain claim would create an
            # ownerless claim and the main scan would charge an
            # attempts strike for a beam that was never started —
            # route it straight back to incoming, attempt-neutrally,
            # after re-owning it so a racing janitor can't duplicate
            # the incoming write around a fresh re-claim.
            tmp = os.path.join(d, f"{base}.takeover.{os.getpid()}")
            try:
                _rename_held(path, tmp)
            except OSError:
                continue         # another janitor beat us to it
            _atomic_write_json(ticket_path(spool, tid, "incoming"),
                               _strip_claim_stamps(rec))
            journal.record(spool, "drain_requeue", ticket=tid,
                           attempt=int(rec.get("attempts", 0)),
                           trace_id=rec.get("trace_id", ""),
                           reason="abandoned_takeover")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
        try:
            os.rename(path, os.path.join(d, base))
        except OSError:
            pass


def _recover_abandoned_claimings(spool: str) -> None:
    """A claimer that died between renaming a ticket to
    ``<tid>.json.claiming.<pid>`` and promoting the stamped file to a
    plain claim left the ticket in neither incoming/ nor claimed/ —
    invisible to workers and to the stale-claim scan.  The beam was
    never started (the promotion rename precedes any processing), so
    the recovery is attempt-neutral: strip any claim stamp and return
    the ticket to incoming/ for the next claimer.  Abandonment is
    judged by _sidefile_owner_live (dead pid, or older than the grace
    window so a recycled pid cannot strand the ticket).

    The recovery first renames the claiming file to a takeover of its
    OWN (``.takeover.<mypid>``): of N janitors racing over one dead
    claimer's file exactly one proceeds, so a slow second janitor can
    never re-create an incoming ticket a worker has since re-claimed
    — and a janitor that dies mid-recovery leaves an ordinary
    abandoned takeover, which the next scan reconciles."""
    d = os.path.join(spool, "claimed")
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        if name.endswith(".tmp"):       # a stamp write's tmp file,
            continue                    # not the staging file itself
        base, sep, pid = name.partition(".claiming.")
        if not sep or not base.endswith(".json"):
            continue
        path = os.path.join(d, name)
        if _sidefile_owner_live(path, pid):
            continue
        tid = base[:-len(".json")]
        tmp = os.path.join(d, f"{base}.takeover.{os.getpid()}")
        try:
            _rename_held(path, tmp)
        except OSError:
            continue             # another janitor beat us to it
        if _ticket_exists_elsewhere(spool, tid):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
        rec = _read_json(tmp)
        if rec is None:
            try:
                os.unlink(tmp)       # torn/garbage ticket: drop it
            except OSError:
                pass
            continue
        _strip_claim_stamps(rec)
        _atomic_write_json(ticket_path(spool, tid, "incoming"), rec)
        journal.record(spool, "drain_requeue", ticket=tid,
                       attempt=int(rec.get("attempts", 0)),
                       trace_id=rec.get("trace_id", ""),
                       reason="abandoned_claiming")
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _checkpoint_progress(rec: dict) -> int:
    """How many checkpoint artifacts this beam's outdir holds (see
    tpulsar/checkpoint/.progress_marker): -1 = no readable manifest.
    Guarded — a sick outdir volume must not fail a janitor pass."""
    outdir = rec.get("outdir") or ""
    if not outdir:
        return -1
    from tpulsar_torch import checkpoint as ckpt
    try:
        return ckpt.progress_marker(ckpt.default_root(outdir))
    except OSError:
        return -1


def _quarantine(spool: str, rec: dict, max_attempts: int) -> None:
    """Isolate a poisoned beam: the ticket record (with its crash
    history) is kept in quarantine/ for the operator, and a failed
    result is written into done/ so the submitting pool stops waiting
    — no worker in the fleet will ever claim this beam again.  Its
    checkpoint dir is removed too: resume state for a beam nothing
    will resume is dead weight, and a ``*.tmp`` a kill left inside it
    must not outlive janitor cleanup (the chaos auditor's
    no_orphan_sidefiles sweep covers checkpoint dirs)."""
    tid = rec.get("ticket", "?")
    rec["quarantined_at"] = time.time()
    outdir = rec.get("outdir") or ""
    if outdir:
        from tpulsar_torch import checkpoint as ckpt
        ckpt.clean(ckpt.default_root(outdir))
    _atomic_write_json(ticket_path(spool, tid, "quarantine"), rec)
    journal.record(spool, "quarantined", ticket=tid,
                   attempt=int(rec.get("attempts", 0)),
                   trace_id=rec.get("trace_id", ""),
                   max_attempts=max_attempts)
    write_result(
        spool, tid, "failed", rc=1,
        error=(f"quarantined after {rec.get('attempts', 0)} "
               f"crash-shaped claim(s) (max_attempts {max_attempts}): "
               f"this beam repeatedly killed its worker"),
        reason="max_attempts", attempts=rec.get("attempts", 0),
        outdir=rec.get("outdir", ""),
        trace_id=rec.get("trace_id", ""))


@_timed("requeue")
def _requeue_claims(spool: str, verdict_fn,
                    max_attempts: int = DEFAULT_MAX_ATTEMPTS,
                    neutral_reason: str = "drain") -> list[str]:
    """The one crash-safe requeue skeleton both public requeues run:
    reconcile claims that already have a done record, judge the rest
    via ``verdict_fn(rec)`` (None = leave the claim alone, 'neutral'
    = requeue without a strike, 'strike' = crash-shaped requeue that
    counts attempts and quarantines at the cap; a ``('neutral',
    reason)`` tuple overrides the journaled reason per ticket — how a
    scale-down victim's claims are distinguished from drain requeues
    within one janitor pass), take the claim file over exclusively,
    and make the incoming/ record durable BEFORE unlinking the
    takeover — the ordering a crashed requeuer depends on to never
    lose a ticket.  Every requeue lands in the journal: a strike as
    ``takeover`` (naming the dead owner — the crash evidence the
    crashed worker could not write itself), a neutral one as
    ``drain_requeue`` with its reason."""
    requeued = []
    for tid in list_tickets(spool, "claimed"):
        src = ticket_path(spool, tid, "claimed")
        if os.path.exists(ticket_path(spool, tid, "done")):
            try:
                os.unlink(src)
            except OSError:
                pass
            continue
        rec = _read_json(src)
        if rec is None:
            continue
        verdict = verdict_fn(rec)
        if verdict is None:
            continue
        reason = neutral_reason
        if isinstance(verdict, tuple):
            verdict, reason = verdict
        tmp = _takeover_claim(spool, tid)
        if tmp is None:
            continue            # another janitor beat us to it
        raw = _read_json(tmp) or rec
        owner_pid = raw.get("claimed_by")
        owner_worker = raw.get("claimed_by_worker", "")
        rec = _strip_claim_stamps(raw)
        progressed = False
        if verdict == "strike":
            # the owner died holding this beam: one more strike
            rec["attempts"] = int(rec.get("attempts", 0)) + 1
            # Quarantine fairness: a worker that ADVANCED the beam's
            # checkpoint before dying made progress — preemptions of
            # a long beam are not a crash loop, and a beam that gains
            # a pass per attempt eventually finishes.  ``attempts``
            # stays monotone (the journal/verifier contract: takeover
            # k carries attempt k); what resets is the crash-loop
            # BUDGET — quarantine fires on attempts since the last
            # recorded progress, so a worker failing repeatedly at
            # the SAME pass still quarantines at the cap.
            # floor the watermark at 0: a just-opened EMPTY store
            # (manifest, no artifacts) is not progress — a beam that
            # kills its worker at search start must not earn a free
            # extra strike just for creating the manifest
            progress = _checkpoint_progress(rec)
            if progress > max(0, int(rec.get("ckpt_progress", 0))):
                progressed = True
                rec["ckpt_progress"] = progress
                rec["attempts_at_progress"] = rec["attempts"]
            stuck = rec["attempts"] - int(
                rec.get("attempts_at_progress", 0))
            if stuck >= max_attempts:
                _quarantine(spool, rec, max_attempts)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                continue
        # the requeue's journal time is taken BEFORE the record lands
        # in incoming/: a live worker may claim it at once, and the
        # journal (read in time order) must show this event before
        # that claim however long this process stalls in between
        t_requeue = time.time()
        _atomic_write_json(ticket_path(spool, tid, "incoming"), rec)
        _invalidate_capacity(spool)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if verdict == "strike":
            journal.record(
                spool, "takeover", ticket=tid,
                attempt=int(rec.get("attempts", 0)),
                trace_id=rec.get("trace_id", ""),
                from_worker=owner_worker, from_pid=owner_pid,
                by_pid=os.getpid(), t=t_requeue,
                # the fairness evidence: checkpoint artifacts the dead
                # owner left, and whether they reset the crash-loop
                # budget (progress != crash loop)
                **({"ckpt_progress": rec.get("ckpt_progress", -1),
                    "budget_reset": True} if progressed else {}))
        else:
            journal.record(
                spool, "drain_requeue", ticket=tid,
                worker=owner_worker,
                attempt=int(rec.get("attempts", 0)),
                trace_id=rec.get("trace_id", ""),
                reason=reason, t=t_requeue)
        requeued.append(tid)
    return requeued


def requeue_stale_claims(spool: str,
                         max_attempts: int = DEFAULT_MAX_ATTEMPTS
                         ) -> list[str]:
    """Move claimed-but-unfinished tickets whose owning worker is DEAD
    back to incoming (boot recovery and the fleet janitor: any worker
    may then claim them — work stealing).  Claims whose recorded owner
    pid is still alive belong to a LIVE co-worker on this spool and
    are left alone — stealing them would double-process the beam.
    Tickets that already have a result record are completed work the
    dead worker just failed to unlink — finish the bookkeeping instead
    of re-running the beam.

    Every dead-owner requeue is crash-shaped and increments the
    ticket's ``attempts`` — EXCEPT when the owner's death was an
    autoscaler decision (its pid is in the scale-down ledger): an
    elective preemption is priced into elasticity, not evidence the
    beam is poisoned, so those claims requeue attempt-neutrally with
    reason ``scale_down`` (the no_elastic_strike invariant).
    At ``max_attempts`` the beam is judged poisoned and quarantined
    (see _quarantine) instead of requeued.  Returns the requeued
    ticket ids (quarantined ones are visible via
    ``list_tickets(spool, "quarantine")``)."""
    ensure_spool(spool)
    _recover_abandoned_takeovers(spool)
    _recover_abandoned_claimings(spool)
    me = os.getpid()
    elective = elective_kills(spool)

    def verdict(rec):
        owner = rec.get("claimed_by")
        if owner == me:
            return "neutral"    # our own claim (boot recovery)
        if owner is not None and _pid_alive(owner):
            return None         # a live co-worker owns this beam
        try:
            pair = (str(rec.get("claimed_by_worker", "")),
                    int(owner))
            if pair in elective:
                # the autoscaler killed this owner on purpose: the
                # beam did nothing wrong — no strike.  Matched on
                # (worker, pid) so a recycled pid in some OTHER
                # worker slot still strikes normally.
                return ("neutral", "scale_down")
        except (TypeError, ValueError):
            pass
        return "strike"
    return _requeue_claims(spool, verdict, max_attempts,
                           neutral_reason="boot_recovery")


def requeue_own_claims(spool: str) -> list[str]:
    """Graceful-drain requeue: move claims owned by THIS process back
    to incoming without touching ``attempts`` — a stopping worker
    returning beams it never started (the staged prefetch tail) is
    not a crash, and the beams are not suspects.  Claims with a done
    record are just reconciled."""
    ensure_spool(spool)
    me = os.getpid()
    return _requeue_claims(
        spool,
        lambda rec: "neutral" if rec.get("claimed_by") == me else None,
        neutral_reason="drain")


# ------------------------------------------------------------- results

@_timed("result")
def write_result(spool: str, ticket_id: str, status: str,
                 rc: int = 0, error: str = "", **extra) -> None:
    """Record a beam's outcome in done/ and release its claim.  The
    result is durable BEFORE the claim is unlinked, so a crash
    between the two leaves a finished ticket (requeue_stale_claims
    reconciles it), never a lost one.  This is the ticket's ONE
    terminal journal event (``result``): exactly-once across the
    fleet reads as exactly one such event per ticket."""
    ensure_spool(spool)
    trace_id = extra.get("trace_id", "")
    if not trace_id:
        # quarantine and the stub workers don't thread the id through
        # their extras; the claim they are finishing still carries it
        claim = _read_json(ticket_path(spool, ticket_id, "claimed"))
        trace_id = (claim or {}).get("trace_id", "")
    rec = {"ticket": ticket_id, "status": status, "rc": rc,
           "error": error, "finished_at": time.time(), **extra}
    if trace_id:
        rec["trace_id"] = trace_id
    _atomic_write_json(ticket_path(spool, ticket_id, "done"), rec)
    try:
        os.unlink(ticket_path(spool, ticket_id, "claimed"))
    except OSError:
        pass
    journal.record(spool, "result", ticket=ticket_id,
                   worker=str(extra.get("worker", "") or ""),
                   attempt=int(extra.get("attempts", 0) or 0),
                   trace_id=trace_id, status=status, rc=rc)


def read_result(spool: str, ticket_id: str) -> dict | None:
    return _read_json(ticket_path(spool, ticket_id, "done"))


def ticket_state(spool: str, ticket_id: str) -> str:
    """'incoming' | 'claimed' | 'done' | 'unknown'.  (A quarantined
    ticket reads 'done' — its failed result record is the terminal
    truth clients act on.)"""
    for state in ("done", "claimed", "incoming"):
        if os.path.exists(ticket_path(spool, ticket_id, state)):
            return state
    # a claim mid-takeover by a janitor, or mid-stamp by a claimer
    # (.claiming.<pid>), is still claimed work — don't let a poller
    # observe a transient 'unknown' and declare it lost
    d = os.path.join(spool, "claimed")
    try:
        for name in os.listdir(d):
            if name.startswith((f"{ticket_id}.json.takeover.",
                                f"{ticket_id}.json.claiming.")):
                return "claimed"
    except OSError:
        pass
    return "unknown"


# ----------------------------------------------------------- heartbeat

def heartbeat_path(spool: str, worker_id: str = "") -> str:
    """The single-server heartbeat (server.json) or, in a fleet, one
    worker's heartbeat (server.<worker_id>.json)."""
    if worker_id:
        return os.path.join(spool, f"server.{worker_id}.json")
    return os.path.join(spool, "server.json")


@_timed("heartbeat")
def write_heartbeat(spool: str, worker_id: str = "", **fields) -> None:
    ensure_spool(spool)
    rec = {"t": time.time(), "pid": os.getpid(),
           "worker": worker_id, **fields}
    _atomic_write_json(heartbeat_path(spool, worker_id), rec)
    _invalidate_capacity(spool)


def read_heartbeat(spool: str, worker_id: str = "") -> dict | None:
    return _read_json(heartbeat_path(spool, worker_id))


def list_heartbeats(spool: str) -> dict[str, dict]:
    """Every heartbeat on the spool, keyed by worker id (the legacy
    single-server server.json appears under '')."""
    out: dict[str, dict] = {}
    try:
        names = os.listdir(spool)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith("server") and name.endswith(".json")):
            continue
        wid = name[len("server."):-len(".json")] \
            if name != "server.json" else ""
        rec = _read_json(os.path.join(spool, name))
        if rec is not None:
            out[wid] = rec
    return out


def _hb_fresh(rec: dict | None,
              max_age_s: float | None = None) -> bool:
    """A live worker wrote this heartbeat recently AND is not
    draining.  A draining worker still finishes its claimed beams but
    must receive no new work."""
    if max_age_s is None:
        max_age_s = heartbeat_max_age()
    if rec is None or rec.get("status") in ("draining", "stopped"):
        return False
    return (time.time() - rec.get("t", 0.0)) <= max_age_s


def fresh_workers(spool: str,
                  max_age_s: float | None = None
                  ) -> dict[str, dict]:
    """Heartbeats of workers currently accepting work."""
    return {wid: rec for wid, rec in list_heartbeats(spool).items()
            if _hb_fresh(rec, max_age_s)}


def heartbeat_fresh(spool: str,
                    max_age_s: float | None = None) -> bool:
    """True while ANY worker on the spool is accepting work — a fleet
    with one fresh worker of N still serves tickets."""
    return bool(fresh_workers(spool, max_age_s))


def fleet_capacity(spool: str,
                   max_age_s: float | None = None,
                   default_depth: int = 8) -> int | None:
    """Aggregate remaining admission capacity: the sum of fresh
    workers' advertised queue depths minus the tickets already
    waiting.  Returns None when ZERO workers are fresh — the signal
    for clients to load-shed to process-per-beam submission (a full
    queue, by contrast, is backpressure: wait, don't shed)."""
    if max_age_s is None:
        max_age_s = heartbeat_max_age()
    fresh = fresh_workers(spool, max_age_s)
    if not fresh:
        return None
    depth = sum(int(rec.get("max_queue_depth", default_depth))
                for rec in fresh.values())
    return max(0, depth - pending_count(spool))


#: how long a cached capacity reading may serve admission decisions.
#: Short on purpose: the probe's cost is O(heartbeat files) stat+parse
#: per call and it sits on the submitter's can_submit loop, the
#: controller's poll loop, and every gateway admission — but a
#: reading more than ~a second old could admit into a fleet that just
#: drained.  Same-process writes that change the answer (a new
#: ticket, a heartbeat) invalidate immediately; cross-process churn
#: is visible within the TTL.
CAPACITY_PROBE_TTL_S = 1.0

#: spool -> (expires_at, max_age_s, default_depth, capacity)
_capacity_cache: dict[str, tuple] = {}


def _invalidate_capacity(spool: str) -> None:
    _capacity_cache.pop(spool, None)


def fleet_capacity_cached(spool: str,
                          max_age_s: float | None = None,
                          default_depth: int = 8,
                          ttl_s: float = CAPACITY_PROBE_TTL_S
                          ) -> int | None:
    """``fleet_capacity`` behind a short-TTL per-spool cache — the
    hot-loop spelling.  A cached entry is only served for the same
    (max_age_s, default_depth) question; ``ttl_s=0`` bypasses the
    cache entirely."""
    if max_age_s is None:
        max_age_s = heartbeat_max_age()
    now = time.time()
    hit = _capacity_cache.get(spool)
    if hit is not None and hit[0] > now and hit[1] == max_age_s \
            and hit[2] == default_depth:
        return hit[3]
    cap = fleet_capacity(spool, max_age_s, default_depth)
    if ttl_s > 0:
        _capacity_cache[spool] = (now + ttl_s, max_age_s,
                                  default_depth, cap)
    return cap
