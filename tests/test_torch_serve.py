"""The port's resident search server against the JAX package's: the
spool protocol in both directions, the TicketQueue contract on the
port's spool and memory backends (the JAX package's own contract
tests, run on the port's modules), the server loop with stubbed
device work, one real beam served by each package, the stage
heartbeat, the custom-zaplist refresh, and the CLI entry point.

Tolerances: spool records, journal events, heartbeats and zaplists
compare exactly; the two packages' results directories compare under
tools/torch_results_diff.py at rtol 1e-5 of each float array's
largest magnitude and of each printed decimal (plus one unit of its
last printed digit): the two packages sum float32 values in other
orders.  Everything else in those directories (candidate lists, file
sets, tarball members, integer fields) compares exactly.

Device work is stubbed wherever the point is the server loop, so the
file adds little CPU time to the suite; the real served beam is the
small Mock subband pair of test_torch_search_job.py."""

from __future__ import annotations

import importlib.util
import json
import os
import signal
import subprocess
import sys
import tarfile
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

import test_frontdoor as jax_contracts  # noqa: E402
from test_torch_checkpoint import ROOT  # noqa: E402
from test_torch_search_job import (  # noqa: E402, F401 (a fixture)
    _subband_pair, _zaplist_store, configured)
from test_torch_slice import one_torch_thread  # noqa: E402, F401
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
from tpulsar import config as jcfg  # noqa: E402
from tpulsar.obs import journal as jjournal  # noqa: E402
from tpulsar.orchestrate import zaplists as jzaplists  # noqa: E402
from tpulsar.orchestrate.queue_managers.warm import (  # noqa: E402
    WarmServerManager)
from tpulsar.search import report as jreport  # noqa: E402
from tpulsar.serve import protocol as jprotocol  # noqa: E402
from tpulsar.serve.server import SearchServer as JSearchServer  # noqa: E402
from tpulsar_torch import config as tcfg  # noqa: E402
from tpulsar_torch.cli import search_job as tjob  # noqa: E402
from tpulsar_torch.dataplane import index as tindex  # noqa: E402
from tpulsar_torch.frontdoor import queue as tfq  # noqa: E402
from tpulsar_torch.frontdoor import tenancy as ttenancy  # noqa: E402
from tpulsar_torch.io import synth  # noqa: E402
from tpulsar_torch.obs import journal as tjournal  # noqa: E402
from tpulsar_torch.orchestrate import zaplists as tzaplists  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402
from tpulsar_torch.search import report as treport  # noqa: E402
from tpulsar_torch.serve import protocol as tprotocol  # noqa: E402
from tpulsar_torch.serve.server import SearchServer  # noqa: E402

PROTOCOLS = {"jax": jprotocol, "torch": tprotocol}


def _results_diff():
    path = os.path.join(ROOT, "tools", "torch_results_diff.py")
    spec = importlib.util.spec_from_file_location("torch_results_diff",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def cfg(tmp_path):
    """The port's configuration with every path under tmp_path."""
    cfg = tcfg.TpulsarConfig()
    cfg.basic.log_dir = str(tmp_path / "logs")
    cfg.background.jobtracker_db = str(tmp_path / "jt.db")
    cfg.download.datadir = str(tmp_path / "raw")
    cfg.processing.base_working_directory = str(tmp_path / "work")
    cfg.processing.base_results_directory = str(tmp_path / "res")
    cfg.resultsdb.url = str(tmp_path / "results.db")
    cfg.check_sanity(create_dirs=True)
    tcfg.set_settings(cfg)
    yield cfg
    tcfg.set_settings(None)


@pytest.fixture(autouse=True)
def _no_fault_leak():
    yield
    tfaults.reset()


def _beam_files(tmp_path, n=1):
    out = []
    for i in range(n):
        spec = synth.BeamSpec(nchan=16, nsamp=512, nsblk=64,
                              scan=100 + i)
        out.append(synth.synth_beam(str(tmp_path / f"data{i}"), spec,
                                    merged=True))
    return out


def _fake_outcome(misses=0):
    return types.SimpleNamespace(compile_misses=misses, compile_hits=3,
                                 candidates=[], num_dm_trials=8)


def _server(spool, cfg, **kw):
    kw.setdefault("warm_boot", False)
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("device", "cpu")
    return SearchServer(spool=str(spool), cfg=cfg, **kw)


# ------------------------------------------------ spool, both directions

@pytest.mark.parametrize("writer,claimer", [("jax", "torch"),
                                            ("torch", "jax")])
def test_spool_ticket_roundtrip_across_packages(tmp_path, writer,
                                                claimer):
    """A ticket one package writes, the other claims; the claimer's
    result record and heartbeat, the writer reads (test_serve.py's
    roundtrip with the two ends in different packages)."""
    w, c = PROTOCOLS[writer], PROTOCOLS[claimer]
    spool = str(tmp_path / "spool")
    w.write_ticket(spool, "t1", ["/a/x.fits"], "/out1", job_id=7)
    time.sleep(0.01)
    w.write_ticket(spool, "t2", ["/a/y.fits"], "/out2", job_id=8)
    assert c.pending_count(spool) == 2
    assert c.ticket_state(spool, "t1") == "incoming"

    rec = c.claim_next_ticket(spool, "w1")
    assert rec["ticket"] == "t1"            # FIFO by submitted_at
    assert rec["job_id"] == 7 and rec["datafiles"] == ["/a/x.fits"]
    assert rec["claimed_by"] == os.getpid()
    assert w.ticket_state(spool, "t1") == "claimed"
    assert w.pending_count(spool) == 1

    c.write_result(spool, "t1", "done", beam_seconds=1.5, warm=True,
                   compile_misses=0, worker="w1")
    assert w.ticket_state(spool, "t1") == "done"
    out = w.read_result(spool, "t1")
    assert out == c.read_result(spool, "t1")
    assert out["status"] == "done" and out["warm"] is True
    assert not os.path.exists(w.ticket_path(spool, "t1", "claimed"))

    assert not w.heartbeat_fresh(spool)
    c.write_heartbeat(spool, status="running")
    assert w.heartbeat_fresh(spool)
    c.write_heartbeat(spool, status="draining")
    assert not w.heartbeat_fresh(spool)
    c.write_heartbeat(spool, "w1", status="running", max_queue_depth=3)
    assert w.fresh_workers(spool) == c.fresh_workers(spool)
    assert list(w.fresh_workers(spool)) == ["w1"]

    # boot recovery: the claimed-but-unfinished ticket is requeued;
    # both packages' journals read the same chain
    c.claim_next_ticket(spool)
    assert w.requeue_own_claims(spool) == ["t2"]
    assert c.ticket_state(spool, "t2") == "incoming"
    chains = [mod.read_events(spool, ticket="t1")
              for mod in (jjournal, tjournal)]
    assert chains[0] == chains[1]
    assert [e["event"] for e in chains[0]] == ["submitted", "claimed",
                                               "result"]
    assert jjournal.validate_chain(chains[0]) == []
    assert tjournal.validate_chain(chains[0]) == []


def _forge_owner(protocol, spool, tid, pid):
    path = protocol.ticket_path(spool, tid, "claimed")
    with open(path) as fh:
        rec = json.load(fh)
    rec["claimed_by"] = pid
    protocol._atomic_write_json(path, rec)


def test_requeues_give_the_same_lists(tmp_path):
    """requeue_own_claims returns this process's claims and
    requeue_stale_claims only those whose owner is dead: on one spool
    state
    (tickets written and claimed alternately by the two packages), the
    JAX package's janitor and the port's return the same lists and
    leave the same states and attempts."""
    dead = subprocess.Popen(["true"])
    dead.wait()
    got = {}
    for name, jan in PROTOCOLS.items():
        spool = str(tmp_path / name)
        mods = (jprotocol, tprotocol)
        for i, tid in enumerate("abcd"):
            mods[i % 2].write_ticket(spool, tid, [f"/{tid}"], "/o",
                                     job_id=i)
            time.sleep(0.002)
        for i in range(3):
            mods[i % 2].claim_next_ticket(spool, "w0")
        _forge_owner(jan, spool, "a", 1)          # a live owner (init)
        _forge_owner(jan, spool, "b", dead.pid)   # a dead owner
        own = jan.requeue_own_claims(spool)
        stale = jan.requeue_stale_claims(spool)
        states = {}
        for t in "abcd":
            st = jan.ticket_state(spool, t)
            rec = jan._read_json(jan.ticket_path(spool, t, st))
            states[t] = (st, int(rec.get("attempts", 0)))
        got[name] = (stale, own, states)
    assert got["jax"] == got["torch"]
    assert got["torch"] == (["b"], ["c"], {
        "a": ("claimed", 0), "b": ("incoming", 1),
        "c": ("incoming", 0), "d": ("incoming", 0)})
    # at boot a server's stale requeue also returns its own pid's
    # claims, attempt-neutral, in both packages
    for name, jan in PROTOCOLS.items():
        spool = str(tmp_path / name)
        assert [jan.claim_next_ticket(spool, "w1")["ticket"]
                for _ in range(2)] == ["b", "c"]
        assert jan.requeue_stale_claims(spool) == ["b", "c"]
        assert [jan._read_json(jan.ticket_path(
            spool, t, "incoming"))["attempts"] for t in "bc"] == [1, 0]


# ------------------------------------------- the TicketQueue contract

class _PortSpool:
    name = "spool"

    def url(self, tmp_path):
        return f"spool:{tmp_path / 'spool'}"

    def make(self, tmp_path):
        return tfq.FilesystemSpoolQueue(str(tmp_path / "spool"))

    def forge_claim_owner(self, q, tid, pid, worker=""):
        path = tprotocol.ticket_path(q.spool, tid, "claimed")
        with open(path) as fh:
            rec = json.load(fh)
        rec["claimed_by"] = pid
        if worker:
            rec["claimed_by_worker"] = worker
        tprotocol._atomic_write_json(path, rec)


class _PortSqlite:
    name = "sqlite"

    def url(self, tmp_path):
        return f"sqlite:{tmp_path / 'q.db'}"

    def make(self, tmp_path):
        return tfq.get_ticket_queue(self.url(tmp_path))

    def forge_claim_owner(self, q, tid, pid, worker=""):
        jax_contracts._SqliteBackend().forge_claim_owner(q, tid, pid,
                                                         worker)


class _PortMemory:
    name = "memory"

    def make(self, tmp_path):
        return tfq.MemoryTicketQueue("contract-test")

    def forge_claim_owner(self, q, tid, pid, worker=""):
        with q._lock:
            rec = q._states["claimed"][tid]
            rec["claimed_by"] = pid
            rec.pop("claimed_by_thread", None)
            if worker:
                rec["claimed_by_worker"] = worker


_PORT_CLAIMER_CHILD = """
import sys, time
from tpulsar_torch.frontdoor.queue import get_ticket_queue
q = get_ticket_queue(sys.argv[1])
rec = q.claim_next("w-victim")
print(rec["ticket"], flush=True)
time.sleep(120)            # hold the claim until SIGKILLed
"""


def _contract(name: str):
    """test_frontdoor.py's contract test `name`, its module globals
    pointed at the port's modules (and its claimer child at the
    port's queue): the same test body holds the port's backends to
    the JAX package's contract."""
    fn = getattr(jax_contracts, name)
    glb = dict(fn.__globals__, fq=tfq, tenancy=ttenancy,
               journal=tjournal, protocol=tprotocol,
               _CLAIMER_CHILD=_PORT_CLAIMER_CHILD)
    return types.FunctionType(fn.__code__, glb, fn.__name__,
                              fn.__defaults__, fn.__closure__)


@pytest.fixture(params=[_PortSpool(), _PortMemory(), _PortSqlite()],
                ids=["spool", "memory", "sqlite"])
def backend(request):
    return request.param


@pytest.fixture()
def q(backend, tmp_path):
    return backend.make(tmp_path)


def test_contract_claims_record_their_owner(q):
    _contract("test_contract_claims_record_their_owner")(q)


def test_contract_exactly_once_under_contention(q):
    _contract("test_contract_exactly_once_under_contention")(q)


def test_contract_crash_requeue_counts_attempts_then_quarantines(
        q, backend):
    _contract("test_contract_crash_requeue_counts_attempts_then_"
              "quarantines")(q, backend)


def test_contract_live_owner_claims_are_not_stolen(q, backend):
    _contract("test_contract_live_owner_claims_are_not_stolen")(
        q, backend)


def test_contract_drain_requeue_is_attempt_neutral(q):
    _contract("test_contract_drain_requeue_is_attempt_neutral")(q)


def test_contract_scaledown_racing_admission(q):
    _contract("test_contract_scaledown_racing_admission")(q)


def test_contract_result_durable_and_one_terminal_event(q):
    _contract("test_contract_result_durable_and_one_terminal_event")(q)


def test_contract_cancel_only_while_pending(q):
    _contract("test_contract_cancel_only_while_pending")(q)


def test_contract_capacity_shed_vs_backpressure(q):
    _contract("test_contract_capacity_shed_vs_backpressure")(q)


def test_contract_tenancy_priority_and_quota_in_claim_order(q, backend):
    _contract("test_contract_tenancy_priority_and_quota_in_claim_"
              "order")(q, backend)


def test_contract_claim_batch_compat_grouping_exactly_once(q):
    _contract("test_contract_claim_batch_compat_grouping_exactly_"
              "once")(q)


def test_contract_claim_batch_pinned_compat_and_empty(q):
    _contract("test_contract_claim_batch_pinned_compat_and_empty")(q)


def test_contract_batch_claims_respect_quota_and_priority(q):
    _contract("test_contract_batch_claims_respect_quota_and_"
              "priority")(q)


def test_contract_sigkill_mid_claim_exactly_once_takeover(tmp_path):
    """The spool backend only (a SIGKILLed process must leave
    recoverable state): a port process claims and is killed; the
    port's janitor recovers the beam exactly once."""
    _contract("test_contract_sigkill_mid_claim_exactly_once_"
              "takeover")(_PortSpool(), tmp_path)


def test_contract_sqlite_sigkill_mid_claim_exactly_once_takeover(
        tmp_path):
    """The same SIGKILL takeover on the port's sqlite backend: a port
    process claims from the database and is killed; the port's
    janitor pass recovers the beam exactly once."""
    _contract("test_contract_sigkill_mid_claim_exactly_once_"
              "takeover")(_PortSqlite(), tmp_path)


@pytest.mark.parametrize("durable", [_PortSpool(), _PortSqlite()],
                         ids=["spool", "sqlite"])
def test_queue_fsck_clean_and_orphan_reporting(durable, tmp_path):
    _contract("test_queue_fsck_clean_and_orphan_reporting")(
        durable, tmp_path)


def test_sqlite_corrupt_database_refused_loudly(tmp_path):
    """A database that fails its integrity check is refused at open
    with a journaled queue_corrupt event (test_frontdoor.py's test on
    the port's backend)."""
    from tpulsar_torch.frontdoor import sqlite_queue
    db = tmp_path / "q.db"
    db.write_bytes(b"not a sqlite database " * 64)
    with pytest.raises(sqlite_queue.QueueCorrupt):
        tfq.get_ticket_queue(f"sqlite:{db}")
    evs = tjournal.read_events(str(tmp_path))
    assert [e["event"] for e in evs] == ["queue_corrupt"]
    assert evs[0]["path"] == str(db)


def test_sqlite_busy_and_fault_injection_shapes(tmp_path):
    """The queue.db fault point fires before statements: an injected
    failure is an EIO-shaped OSError with a journaled submit_failed
    head; delay mode succeeds (test_frontdoor.py's test on the port's
    backend)."""
    q = tfq.get_ticket_queue(f"sqlite:{tmp_path / 'q.db'}")
    tfaults.configure("queue.db:unimplemented:rate=1.0")
    try:
        with pytest.raises(OSError):
            q.submit("t1", ["/x"], "/o")
    finally:
        tfaults.reset()
    names = [e["event"] for e in q.read_events(ticket="t1")]
    assert names == ["submitted", "submit_failed"]
    tfaults.configure("queue.db:delay:seconds=0.01,count=2")
    try:
        q.submit("t2", ["/x"], "/o")
    finally:
        tfaults.reset()
    assert q.ticket_state("t2") == "incoming"


def test_sqlite_busy_timeout_knob_is_the_reference_one(monkeypatch):
    from tpulsar.frontdoor import sqlite_queue as jsq
    from tpulsar_torch.frontdoor import sqlite_queue as tsq
    assert tsq.busy_timeout_s() == jsq.busy_timeout_s()
    monkeypatch.setenv("TPULSAR_QUEUE_BUSY_TIMEOUT_S", "2.5")
    assert tsq.busy_timeout_s() == jsq.busy_timeout_s() == 2.5


@pytest.mark.parametrize("writer,claimer", [("jax", "torch"),
                                            ("torch", "jax")])
def test_sqlite_database_across_packages(tmp_path, writer, claimer):
    """A database one package's SqliteTicketQueue wrote is claimed,
    completed and fsck'd by the other's: the same schema, the same
    table names, the same journal artifact beside it.  The writer
    also records an elective kill the claimer's ledger must see."""
    from tpulsar.frontdoor import queue as jfq
    queues = {"jax": jfq, "torch": tfq}
    url = f"sqlite:{tmp_path / 'q.db'}"
    w = queues[writer].get_ticket_queue(url)
    w.submit("x1", ["/data/a.fits"], str(tmp_path / "o1"), job_id=1,
             tenant="ops", blobs={"a.fits": "a" * 64})
    w.submit("x2", ["/data/b.fits"], str(tmp_path / "o2"), job_id=2)
    w.heartbeat("w-writer", status="running", max_queue_depth=4)
    w.record_elective_kill("w-gone", 4242)
    c = queues[claimer].get_ticket_queue(url)
    assert c.pending_count() == 2
    assert c.pending_by_tenant() == w.pending_by_tenant()
    assert ("w-gone", 4242) in c.elective_kills()
    rec = c.claim_next("w-claimer")
    assert rec["ticket"] == "x1" and rec["blobs"] == {"a.fits": "a" * 64}
    c.write_result("x1", "done", rc=0, worker="w-claimer",
                   outdir=rec["outdir"], trace_id=rec["trace_id"])
    rec2 = w.claim_next("w-writer")
    w.write_result("x2", "failed", rc=1, worker="w-writer",
                   trace_id=rec2["trace_id"])
    for q in (w, c):
        assert q.read_result("x1")["status"] == "done"
        assert q.read_result("x2")["status"] == "failed"
        assert sorted(q.list_tickets("done")) == ["x1", "x2"]
        report = q.fsck()
        assert report["findings"] == [], report
        assert report["counts"]["done"] == 2
        for tid in ("x1", "x2"):
            evs = q.read_events(ticket=tid)
            assert jjournal.validate_chain(evs) == [], evs
    assert w.read_events() == c.read_events()
    from tpulsar.cli.main import main as jmain
    from tpulsar_torch.cli.main import main as tmain
    assert jmain(["queue", "fsck", url]) == 0
    assert tmain(["queue", "fsck", url]) == 0


# ------------------------------------------------------------ the loop

def test_serve_once_processes_spool(tmp_path, cfg):
    """Two real synthetic beams through the loop (stubbed device
    work): stage-in runs for real, every ticket gets a result record,
    the index and the journal chains are written, the heartbeat ends
    'stopped'."""
    spool = tmp_path / "spool"
    beams = _beam_files(tmp_path, 2)
    for i, fns in enumerate(beams):
        tprotocol.write_ticket(str(spool), f"w{i}", fns,
                               str(tmp_path / f"out{i}"), job_id=i)
    seen = []

    def stub(prepared):
        assert prepared.ppfns and all(
            os.path.exists(f) for f in prepared.ppfns)
        assert prepared.workdir != os.path.dirname(beams[0][0])
        seen.append(prepared.ticket_id)
        return _fake_outcome(misses=2 if not seen[:-1] else 0)

    srv = _server(spool, cfg, beam_fn=stub)
    assert srv.serve(once=True) == 0
    assert sorted(seen) == ["w0", "w1"]
    by_id = {t: tprotocol.read_result(str(spool), t) for t in seen}
    assert {r["status"] for r in by_id.values()} == {"done"}
    first, second = seen
    assert by_id[first]["warm"] is False      # paid a compile
    assert by_id[second]["warm"] is True
    assert by_id[second]["compile_hits"] == 3
    assert tprotocol.read_heartbeat(str(spool))["status"] == "stopped"
    assert srv.beams == {"done": 2, "failed": 0, "skipped": 0}
    for t in seen:
        evs = tjournal.read_events(str(spool), ticket=t)
        assert [e["event"] for e in evs] == [
            "submitted", "claimed", "stagein_done", "search_start",
            "result"]
        assert jjournal.validate_chain(evs) == []
    idx = tindex.CandidateIndex(tindex.index_path(str(spool)))
    assert idx.tickets() == ["w0", "w1"]
    assert os.path.exists(os.path.join(str(spool), "metrics",
                                       "server.json"))


def test_heartbeat_reports_the_accel_batch_pin(tmp_path, cfg,
                                               monkeypatch):
    """The hi stage's batch breaker pins the per-DM path for the life
    of the process; the server's heartbeat says so, so that an operator
    sees why later beams run slower and restarts the worker."""
    from tpulsar_torch.kernels import accel

    srv = _server(tmp_path / "spool", cfg)
    monkeypatch.setattr(accel, "_BATCH_OK", None)
    srv._heartbeat("running", force=True)
    assert tprotocol.read_heartbeat(str(tmp_path / "spool"))[
        "accel_batch_pinned"] is False
    monkeypatch.setattr(accel, "_BATCH_OK", False)
    srv._heartbeat("running", force=True)
    assert tprotocol.read_heartbeat(str(tmp_path / "spool"))[
        "accel_batch_pinned"] is True


def test_drain_completes_inflight_beam(tmp_path, cfg):
    """SIGTERM mid-beam: the in-flight beam finishes and its result
    is durable; unstarted tickets go back to incoming; the final
    heartbeat says 'stopped'."""
    spool = tmp_path / "spool"
    beams = _beam_files(tmp_path, 3)
    for i, fns in enumerate(beams):
        tprotocol.write_ticket(str(spool), f"d{i}", fns,
                               str(tmp_path / f"out{i}"), job_id=i)
    started = threading.Event()

    def slow(prepared):
        started.set()
        time.sleep(0.8)
        return _fake_outcome()

    srv = _server(spool, cfg, beam_fn=slow)
    old_term = signal.getsignal(signal.SIGTERM)
    old_int = signal.getsignal(signal.SIGINT)
    srv.install_signal_handlers()
    try:
        th = threading.Thread(target=srv.serve, daemon=True)
        th.start()
        assert started.wait(timeout=20.0)
        signal.raise_signal(signal.SIGTERM)   # delivered to main thread
        th.join(timeout=30.0)
        assert not th.is_alive()
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
    done = tprotocol.list_tickets(str(spool), "done")
    assert "d0" in done
    assert tprotocol.read_result(str(spool), "d0")["status"] == "done"
    assert tprotocol.list_tickets(str(spool), "claimed") == []
    assert len(done) + tprotocol.pending_count(str(spool)) == 3
    assert tprotocol.read_heartbeat(str(spool))["status"] == "stopped"


def test_poisoned_beam_isolation(tmp_path, cfg, monkeypatch):
    """A beam that raises a refusal-shaped error (fault point
    serve.beam) fails ITS ticket; the server and the next beam are
    unaffected.  Uses the real _search_one runner."""
    monkeypatch.setattr(tjob, "run_search",
                        lambda *a, **k: _fake_outcome())
    tfaults.configure("serve.beam:unimplemented:count=1")
    spool = tmp_path / "spool"
    beams = _beam_files(tmp_path, 2)
    for i, fns in enumerate(beams):
        tprotocol.write_ticket(str(spool), f"p{i}", fns,
                               str(tmp_path / f"out{i}"), job_id=i)
    srv = _server(spool, cfg)
    assert srv.serve(once=True) == 0
    r0 = tprotocol.read_result(str(spool), "p0")
    r1 = tprotocol.read_result(str(spool), "p1")
    assert r0["status"] == "failed" and "UNIMPLEMENTED" in r0["error"]
    assert r1["status"] == "done"
    assert srv.beams["failed"] == 1 and srv.beams["done"] == 1
    assert tfaults.fired("serve.beam") == 1


def test_stagein_failure_fails_only_that_ticket(tmp_path, cfg):
    """A missing file and a ticket with blobs: refs but no data plane
    configured each fail their own stage-in, with the reference's
    error; the server serves the good ticket."""
    spool = tmp_path / "spool"
    tprotocol.write_ticket(str(spool), "bad", ["/nonexistent.fits"],
                           str(tmp_path / "outbad"), job_id=1)
    tprotocol.write_ticket(str(spool), "blob", [],
                           str(tmp_path / "outblob"), job_id=2,
                           blobs={"x.fits": "0" * 64})
    (good,) = _beam_files(tmp_path, 1)
    tprotocol.write_ticket(str(spool), "good", good,
                           str(tmp_path / "outgood"), job_id=3)
    srv = _server(spool, cfg, beam_fn=lambda p: _fake_outcome())
    assert srv.serve(once=True) == 0
    bad = tprotocol.read_result(str(spool), "bad")
    assert bad["status"] == "failed" and "stage-in failed" in bad["error"]
    blob = tprotocol.read_result(str(spool), "blob")
    assert blob["status"] == "failed"
    assert "no data plane is configured" in blob["error"]
    assert tprotocol.read_result(str(spool), "good")["status"] == "done"
    assert [e["event"] for e in tjournal.read_events(
        str(spool), ticket="bad")] == ["submitted", "claimed",
                                       "stagein_failed", "result"]


def test_beam_deadline_fails_ticket_not_server(tmp_path, cfg):
    spool = tmp_path / "spool"
    beams = _beam_files(tmp_path, 2)
    for i, fns in enumerate(beams):
        tprotocol.write_ticket(str(spool), f"t{i}", fns,
                               str(tmp_path / f"out{i}"), job_id=i)
    calls = []

    def maybe_hang(prepared):
        calls.append(prepared.ticket_id)
        if len(calls) == 1:
            time.sleep(5.0)                  # a wedged dispatch
        return _fake_outcome()

    srv = _server(spool, cfg, beam_fn=maybe_hang, beam_deadline_s=0.3)
    assert srv.serve(once=True) == 0
    hung, ok = calls[0], calls[1]
    rec = tprotocol.read_result(str(spool), hung)
    assert rec["status"] == "failed" and "deadline" in rec["error"]
    assert tprotocol.read_result(str(spool), ok)["status"] == "done"


def test_jax_warm_backend_submits_to_the_port_server(tmp_path, cfg):
    """The JAX package's warm queue backend sees the port server's
    heartbeat as fresh, submits a ticket, and reads its result."""
    spool = tmp_path / "spool"
    (fns,) = _beam_files(tmp_path, 1)
    srv = _server(spool, cfg, beam_fn=lambda p: _fake_outcome(),
                  heartbeat_interval_s=0.2)
    th = threading.Thread(target=srv.serve, daemon=True)
    th.start()
    try:
        qm = WarmServerManager(spool=str(spool), max_queue_depth=4)
        deadline = time.time() + 20
        while not qm.server_available():
            assert time.time() < deadline, "no fresh heartbeat"
            time.sleep(0.05)
        assert qm.can_submit()
        qid = qm.submit(fns, str(tmp_path / "o"), 11)
        assert qid.startswith("warm-")
        while qm.is_running(qid):
            assert time.time() < deadline, "ticket never finished"
            time.sleep(0.05)
        assert not qm.had_errors(qid)
        assert jprotocol.read_result(str(spool), qid)["status"] == "done"
    finally:
        srv.request_drain()
        th.join(timeout=30)
    assert not th.is_alive()
    assert not WarmServerManager(spool=str(spool)).server_available()


def test_warm_boot_searches_a_mock_block(tmp_path, cfg, monkeypatch):
    """Boot's warm search: one synthesized uint8 block of the Mock
    geometry (960 channels, the scale's share of 3,932,160 samples on
    the 30720-sample quantum) through search_block on the server's
    device, with the Mock survey plan and the deployment's search
    parameters."""
    from tpulsar_torch.plan import ddplan
    from tpulsar_torch.search import executor

    calls = []
    monkeypatch.setattr(executor, "search_block",
                        lambda *a, **k: calls.append((a, k)))
    srv = _server(tmp_path / "spool", cfg, warm_boot=True,
                  warm_boot_scale=0.05)
    srv.boot()
    (args, kw), = calls
    block, freqs, dt, plan, params = args
    assert block.dtype == torch.uint8 and block.device.type == "cpu"
    assert tuple(block.shape) == (960, 184320)
    assert freqs.shape == (960,) and dt == 65.476e-6
    assert [(s.lodm, s.downsamp) for s in plan] == \
        [(s.lodm, s.downsamp) for s in ddplan.survey_plan("pdev")]
    assert params.provenance() == executor.SearchParams.from_config(
        cfg.searching).provenance()
    assert kw["device"].type == "cpu"
    assert srv.boot_seconds >= 0.0
    assert tprotocol.read_heartbeat(str(tmp_path / "spool"))[
        "status"] == "running"


# -------------------------------------------------- one real served beam

def test_one_real_beam_served_by_each_package(tmp_path, configured,
                                              monkeypatch):
    """The Mock subband pair served from each package's own spool by
    its own SearchServer (the JAX one without its AOT warm-start, the
    port's on the CPU without the warm search): equal result records
    apart from timing keys, equal results directories under
    tools/torch_results_diff.py at rtol 1e-5, and the same journal
    events in the same order."""
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")
    fns = _subband_pair(tmp_path / "beam")
    recs, evs = {}, {}
    for name, mod, make in (
            ("jax", jprotocol, lambda sp: JSearchServer(
                spool=sp, cfg=jcfg.settings(), warm_boot=False,
                poll_s=0.05)),
            ("torch", tprotocol, lambda sp: SearchServer(
                spool=sp, cfg=tcfg.settings(), warm_boot=False,
                poll_s=0.05, device="cpu"))):
        spool = str(tmp_path / f"spool_{name}")
        mod.write_ticket(spool, "t0", fns, str(tmp_path / f"out_{name}"),
                         job_id=1)
        srv = make(spool)
        assert srv.serve(once=True) == 0
        assert srv.beams == {"done": 1, "failed": 0, "skipped": 0}
        recs[name] = mod.read_result(spool, "t0")
        evs[name] = [e["event"] for e in
                     jjournal.read_events(spool, ticket="t0")]
    # timing keys, the per-ticket identity, and each package's own
    # compile accounting differ; everything else is equal
    differ = {"beam_seconds", "finished_at", "trace_id", "outdir",
              "compile_hits", "compile_misses", "warm"}
    assert recs["torch"].keys() == recs["jax"].keys()
    assert {k: v for k, v in recs["torch"].items() if k not in differ} \
        == {k: v for k, v in recs["jax"].items() if k not in differ}
    assert recs["torch"]["status"] == "done"
    assert recs["torch"]["candidates"] >= 1
    assert recs["torch"]["compile_misses"] == 0 and recs["torch"]["warm"]
    assert evs["torch"] == evs["jax"]
    assert evs["torch"][:4] == ["submitted", "claimed", "stagein_done",
                                "search_start"]
    assert evs["torch"][-1] == "result"
    assert "pass_complete" in evs["torch"]
    problems = _results_diff().diff_results(
        str(tmp_path / "out_torch"), str(tmp_path / "out_jax"),
        rtol=1e-5)
    assert problems == []
    rows = tindex.CandidateIndex(tindex.index_path(
        str(tmp_path / "spool_torch"))).candidate_rows("t0")
    assert rows == tindex.candidate_rows(str(tmp_path / "out_torch"))
    assert len(rows) == recs["torch"]["candidates"]


# --------------------------------------------------------- entry point

def _cli(tmp_path, *args, **env):
    cfgfile = tmp_path / "cfg.yaml"
    cfgfile.write_text(
        f"processing:\n  base_working_directory: {tmp_path / 'work'}\n"
        f"  base_results_directory: {tmp_path / 'res'}\n"
        f"basic:\n  log_dir: {tmp_path / 'logs'}\n"
        f"download:\n  datadir: {tmp_path / 'raw'}\n"
        f"background:\n  jobtracker_db: {tmp_path / 'jt.db'}\n"
        f"resultsdb:\n  url: {tmp_path / 'results.db'}\n")
    return subprocess.run(
        [sys.executable, "-m", "tpulsar_torch", "--config", str(cfgfile),
         "serve", "--once", "--spool", str(tmp_path / "spool"), *args],
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                 **env),
        capture_output=True, text=True, timeout=240, cwd=str(tmp_path))


def test_serve_entry_point_on_the_cpu(tmp_path):
    """`python -m tpulsar_torch serve --once --device cpu` answers the
    spool's tickets (here a ticket the JAX package wrote, whose file
    is missing: a failed stage-in) and exits 0 with the heartbeat
    stopped and the registry exported."""
    spool = str(tmp_path / "spool")
    jprotocol.write_ticket(spool, "t0", ["/nonexistent.fits"],
                           str(tmp_path / "out"), job_id=1)
    res = _cli(tmp_path, "--device", "cpu", "--no-warmstart")
    assert res.returncode == 0, res.stderr
    assert "device cpu" in res.stdout
    rec = jprotocol.read_result(spool, "t0")
    assert rec["status"] == "failed" and "stage-in failed" in rec["error"]
    assert jprotocol.read_heartbeat(spool)["status"] == "stopped"
    assert os.path.exists(tmp_path / "logs" / "metrics" / "serve.prom")


def test_serve_without_a_gpu_fails_and_names_the_device(tmp_path):
    spool = str(tmp_path / "spool")
    tprotocol.write_ticket(spool, "t0", ["/x.fits"], "/o", job_id=1)
    res = _cli(tmp_path, CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "device='cpu'" in res.stderr
    assert tprotocol.ticket_state(spool, "t0") == "incoming"


# ------------------------------------------------- the stage heartbeat

@pytest.fixture(params=["jax", "torch"])
def report(request, monkeypatch, tmp_path):
    rep = {"jax": jreport, "torch": treport}[request.param]
    hb = str(tmp_path / "hb.json")
    monkeypatch.setattr(rep, "_HEARTBEAT", hb)
    monkeypatch.setattr(rep, "_CUR_STAGE", [])
    return rep, hb


def _read(hb):
    with open(hb) as fh:
        return json.load(fh)


def test_timing_scope_writes_stage_named_beats(report):
    rep, hb = report
    t = rep.StageTimers()
    with t.timing("dedispersing"):
        beat = _read(hb)
        assert beat["stage"] == "dedispersing"
        assert beat["event"] == "begin"
        assert abs(beat["t_stage"] - time.time()) < 5.0
    beat = _read(hb)
    assert beat["event"] == "end"
    assert beat["stage"] == "dedispersing"
    assert sorted(beat) == ["event", "stage", "t", "t_stage"]


def test_progress_beat_keeps_stage_begin_time(report):
    rep, hb = report
    t = rep.StageTimers()
    with t.timing("hi-accelsearch"):
        t0 = _read(hb)["t_stage"]
        rep.progress_beat("accel window dm 32/128")
        beat = _read(hb)
        assert beat["event"] == "progress"
        assert beat["stage"] == "hi-accelsearch"
        assert beat["info"] == "accel window dm 32/128"
        assert beat["t_stage"] == t0


def test_progress_beat_outside_scope_is_noop(report):
    rep, hb = report
    rep.progress_beat("orphan")
    assert not os.path.exists(hb)


def test_hi_stage_beats_once_per_drained_dm_batch(monkeypatch, tmp_path):
    """The port's accel_search_batch beats the heartbeat once for each
    DM batch it drains, with the JAX package's 'accel window dm
    done/total' text (the torch consumer); the native CPU consumer
    beats before each batch, with the JAX package's 'accel native dm
    start/total' text."""
    import numpy as np

    from tpulsar_torch.kernels import accel

    hb = str(tmp_path / "hb.json")
    monkeypatch.setattr(treport, "_HEARTBEAT", hb)
    monkeypatch.setattr(treport, "_CUR_STAGE", [])
    beats = []
    real = treport._beat
    monkeypatch.setattr(treport, "_beat", lambda *a: (
        beats.append(a), real(*a)))
    bank = accel.build_template_bank(4)
    rng = np.random.default_rng(1)
    spec = torch.from_numpy((rng.standard_normal((5, 4096))
                             + 1j * rng.standard_normal((5, 4096)))
                            .astype(np.complex64))
    usable = accel._native_cpu_path_usable
    for native, want in ((False, ["accel window dm 2/5",
                                  "accel window dm 4/5",
                                  "accel window dm 5/5"]),
                         (True, ["accel native dm 0/5",
                                 "accel native dm 2/5",
                                 "accel native dm 3/5"])):
        monkeypatch.setattr(
            accel, "_native_cpu_path_usable",
            (lambda dev, _n=native: _n and usable(dev)))
        beats.clear()
        with treport.StageTimers().timing("hi-accelsearch"):
            accel.accel_search_batch(spec, bank, max_numharm=2, topk=4,
                                     dm_chunk=2)
        infos = [a[2] for a in beats if a[1] == "progress"]
        assert infos == want
        assert _read(hb)["event"] == "end"


# ------------------------------------------------- the zaplist refresh

def test_refresh_zaplists_matches_the_jax_package(tmp_path):
    """Both packages' refresh over a local-directory transport: the
    same extracted files with the same bytes, the same manifest; a
    second refresh with an unchanged remote is a no-op in both."""
    store = _zaplist_store(tmp_path)
    out = {}
    for name, mod in (("jax", jzaplists), ("torch", tzaplists)):
        zapdir = tmp_path / f"zap_{name}"
        assert mod.refresh_zaplists(str(zapdir), store) is True
        assert mod.refresh_zaplists(str(zapdir), store) is False
        out[name] = {n: (zapdir / n).read_bytes()
                     for n in sorted(os.listdir(zapdir))
                     if not n.startswith(".refresh_lock")}
    assert out["torch"] == out["jax"]
    assert ".extracted_zaplists" in out["torch"]
    assert "escape.txt" not in out["torch"]
    assert sorted(n for n in out["torch"] if n.endswith(".zaplist")) \
        == ["P2030.20101225.all.zaplist", "P2030.20101225.b3.zaplist"]


# -------------------------------------------------- configuration knobs

def test_runtime_knob_and_tenants_check_mirror_the_jax_package(
        monkeypatch):
    """settings() installs the heartbeat window only for a non-default
    value (the env var stays live otherwise), and a bad
    frontdoor.tenants entry is the same problem in both packages."""
    monkeypatch.setenv("TPULSAR_HEARTBEAT_MAX_AGE_S", "7")
    try:
        for cfgmod, proto in ((jcfg, jprotocol), (tcfg, tprotocol)):
            cfg = cfgmod.TpulsarConfig()
            cfgmod.set_settings(cfg)
            assert proto.heartbeat_max_age() == 7.0
            cfg.jobpooler.heartbeat_max_age_s = 45.0
            cfgmod.set_settings(cfg)
            assert proto.heartbeat_max_age() == 45.0
    finally:
        for cfgmod, proto in ((jcfg, jprotocol), (tcfg, tprotocol)):
            cfgmod.set_settings(cfgmod.TpulsarConfig())
            proto.set_heartbeat_max_age(None)
    problems = []
    for cfgmod in (jcfg, tcfg):
        cfg = cfgmod.TpulsarConfig()
        cfg.frontdoor.tenants = {"bulk": {"priority": "urgent"}}
        with pytest.raises(cfgmod.InsaneConfigsError) as ei:
            cfg.check_sanity()
        problems.append(ei.value.problems)
    assert problems[0] == problems[1]
    assert any(p.startswith("frontdoor.tenants") for p in problems[0])
