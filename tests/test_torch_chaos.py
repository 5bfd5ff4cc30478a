"""The port's chaos harness (tpulsar_torch/chaos/) against the JAX
package's: the cases of tests/test_chaos.py run with each package as
the writer (its scenario, runner, stub worker, protocol, journal and
faults) and BOTH verifiers as the judge; the deterministic payloads
bit-equal; the scenario schema refusing the same documents with the
same messages; the seven packaged scenarios byte-equal; the cross
audit (the JAX verifier on the port's storms, the port's verifier on
the JAX package's); the port's stub under batched claims and a
mid-batch SIGKILL; the packaged stream scenario on the port's stream
worker (its host backend); the ``chaos`` command of both CLIs; and
one storm of the port's real ``serve`` workers on the CPU with w0
SIGKILLed mid-beam, its results equal to the port's solo job.

Every comparison is exact: reports (``render_verify`` text and the
report dict), recovery stats, digests, payload bytes and arrays,
error messages, exit codes, results directories (one package, one
thread, the same beam)."""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_chaos as jcases  # noqa: E402
from test_torch_checkpoint import ROOT  # noqa: E402
from test_torch_search_job import (  # noqa: E402, F401 (a fixture)
    _subband_pair, configured)
from test_torch_serve import _results_diff  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
import tpulsar.frontdoor  # noqa: E402
from tpulsar.chaos import invariants as jinv  # noqa: E402
from tpulsar.chaos import runner as jrunner  # noqa: E402
from tpulsar.chaos import scenario as jscenario  # noqa: E402
from tpulsar.chaos import worker as jworker  # noqa: E402
from tpulsar.cli.main import main as jcli_main  # noqa: E402
from tpulsar.obs import journal as jjournal  # noqa: E402
from tpulsar.resilience import faults as jfaults  # noqa: E402
from tpulsar.serve import protocol as jprotocol  # noqa: E402
from tpulsar_torch.chaos import invariants as tinv  # noqa: E402
from tpulsar_torch.chaos import runner as trunner  # noqa: E402
from tpulsar_torch.chaos import scenario as tscenario  # noqa: E402
from tpulsar_torch.chaos import worker as tworker  # noqa: E402
from tpulsar_torch.cli import search_job as tjob  # noqa: E402
from tpulsar_torch.cli.main import main as tcli_main  # noqa: E402
from tpulsar_torch.frontdoor import queue as tfq  # noqa: E402
from tpulsar_torch.obs import journal as tjournal  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402
from tpulsar_torch.serve import protocol as tprotocol  # noqa: E402


class _BothVerifiers:
    """The port's invariants module, each verdict held against the JAX
    verifier's on the same spool: verify's report and render_verify
    text, tail_verify's echoed lines and report, recovery_stats and
    render_report must be equal; the port's result is returned."""

    def __getattr__(self, name):
        return getattr(tinv, name)

    def verify(self, spool, **kw):
        got, want = tinv.verify(spool, **kw), jinv.verify(spool, **kw)
        assert tinv.render_verify(got) == jinv.render_verify(want)
        assert got == want
        return got

    def tail_verify(self, spool, echo=print, **kw):
        lines: list[str] = []
        got = tinv.tail_verify(spool, echo=lines.append, **kw)
        jlines: list[str] = []
        want = jinv.tail_verify(spool, echo=jlines.append, **kw)
        assert lines == jlines and got == want
        for line in lines:
            echo(line)
        return got

    def recovery_stats(self, events):
        got = tinv.recovery_stats(events)
        assert got == jinv.recovery_stats(events)
        return got

    def render_report(self, spool):
        got = tinv.render_report(spool)
        assert got == jinv.render_report(spool)
        return got


BOTH = _BothVerifiers()

#: each package's modules the cases of tests/test_chaos.py reach
#: through their module globals (the writer of a case's spool, its
#: storms and its schedule files)
PACKAGES = {
    "jax": dict(runner=jrunner, scenario=jscenario, journal=jjournal,
                faults=jfaults, protocol=jprotocol),
    "torch": dict(runner=trunner, scenario=tscenario, journal=tjournal,
                  faults=tfaults, protocol=tprotocol),
}
CHAOS = {"jax": dict(invariants=jinv, runner=jrunner,
                     scenario=jscenario, worker=jworker),
         "torch": dict(invariants=tinv, runner=trunner,
                       scenario=tscenario, worker=tworker)}
SCENARIOS = ("alert_smoke", "autoscale_surge", "batch_smoke",
             "ci_smoke", "dataplane_smoke", "kill_mid_beam",
             "stream_smoke")


@pytest.fixture(autouse=True)
def _no_fault_leak():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


@pytest.fixture(params=sorted(PACKAGES))
def writer(request, monkeypatch):
    """The package whose scenario, runner, worker, protocol, journal and
    faults a case of tests/test_chaos.py runs on; both verifiers judge
    it (_BothVerifiers)."""
    for name, mod in PACKAGES[request.param].items():
        monkeypatch.setattr(jcases, name, mod)
    monkeypatch.setattr(jcases, "invariants", BOTH)
    if request.param == "torch":
        # the cases that import inside their bodies
        monkeypatch.setattr(tpulsar.frontdoor, "queue", tfq)
    return request.param


def _call(fn, **fixtures):
    names = inspect.signature(fn).parameters
    return fn(**{n: fixtures[n] for n in names})


@pytest.mark.parametrize("case", [
    "test_scenario_validates_loudly",
    "test_packaged_ci_scenario_loads",
    "test_schedule_windows_open_close_and_address_workers",
    "test_schedule_window_closes_at_until",
    "test_delay_mode_sleeps_and_proceeds",
    "test_failed_ticket_write_fails_cleanly",
    "test_failed_result_write_leaves_claim_intact",
    "test_failed_claim_stamp_withdraws_cleanly",
    "test_claimer_never_parses_a_torn_ticket",
    "test_journal_append_fault_never_fails_the_transition",
    "test_clean_chain_passes_every_invariant",
    "test_verifier_names_doubled_terminal",
    "test_verifier_names_lost_ticket",
    "test_verifier_names_quota_overshoot",
    "test_verifier_names_reminted_trace_and_shared_trace",
    "test_verifier_names_orphaned_sidefile",
    "test_verifier_names_attempts_violations",
    "test_verifier_counts_journal_gap_and_flags_corruption",
    "test_verifier_names_capacity_inconsistency",
    "test_recovery_stats_computes_mttr_from_the_journal",
    "test_tail_verify_reports_live_and_stops_at_run_end",
    "test_scenario_batch_field_validates_and_reaches_worker_cmd",
    "test_packaged_stream_scenario_loads",
    "test_stream_chunk_payload_is_pure_function",
    "test_verifier_passes_clean_stream_chain",
    "test_verifier_names_lost_chunk",
    "test_verifier_names_doubled_and_conflicting_chunks",
    "test_verifier_names_out_of_window_chunk",
    "test_verifier_names_latency_breach",
])
def test_chaos_case(case, writer, tmp_path):
    """Each case of tests/test_chaos.py, unchanged, on the writer
    package, every verdict equal from both verifiers."""
    _call(getattr(jcases, case), tmp_path=tmp_path)


@pytest.mark.parametrize("backend", ["spool", "memory"])
def test_read_events_after_contract(backend, writer, tmp_path):
    jcases.test_read_events_after_contract(backend, tmp_path)


def test_mini_storm_kill_recovers_exactly_once(writer, tmp_path):
    """The mini storm (two stub workers, w0 SIGKILLed mid-backlog, a
    spool.io window on w1) run by the writer package's runner and stub:
    exactly once, and both verifiers report it clean with the same
    report, recovery stats and rendered report."""
    jcases.test_mini_storm_kill_recovers_exactly_once(tmp_path)


@pytest.mark.parametrize("writer", ["torch"], indirect=True)
def test_batch_admission_storm_passes_invariants(writer, tmp_path):
    """The batched-admission storm on the port's runner and stub (the
    JAX package's own runs in tests/test_chaos.py)."""
    jcases.test_batch_admission_storm_passes_invariants(tmp_path)


# ------------------------------------------------ deterministic payloads

@pytest.mark.parametrize("ticket, npasses", [
    ("t0", 1), ("kill-mid-beam-003", 8), ("beam-x", 57)])
def test_pass_payload_and_digest_bit_equal(ticket, npasses):
    for k in range(npasses):
        assert tworker.pass_payload(ticket, k) == \
            jworker.pass_payload(ticket, k)
    assert tworker.expected_digest(ticket, npasses) == \
        jworker.expected_digest(ticket, npasses)


@pytest.mark.parametrize("name, seed, i, size", [
    ("dp-mini", 7, 0, 16384), ("dataplane-smoke", 18, 9, 16384),
    ("x", 0, 3, 100)])
def test_beam_payload_bit_equal(name, seed, i, size):
    got = trunner.beam_payload(name, seed, i, size=size)
    assert got == jrunner.beam_payload(name, seed, i, size=size)
    assert len(got) == size


@pytest.mark.parametrize("seq", [0, 1, 5, 11])
def test_stream_chunk_payload_bit_equal(seq):
    got = trunner.stream_chunk_payload("stream-smoke", 19, 1, seq, 16,
                                       256)
    want = jrunner.stream_chunk_payload("stream-smoke", 19, 1, seq, 16,
                                        256)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_synth_candidates_equal():
    for tid in ("dp-mini-000", "t1"):
        assert [dataclasses.asdict(c)
                for c in tworker.synth_candidates(tid)] == \
            [dataclasses.asdict(c) for c in jworker.synth_candidates(tid)]


# ------------------------------------------------------ scenario schema

def _doc(**over):
    doc = {"name": "t", "workers": 1,
           "workload": {"beams": 2, "interval_s": 0.01},
           "timeline": []}
    doc.update(over)
    return doc


def _wl(**over):
    return _doc(workload={"beams": 2, "interval_s": 0.01, **over})


def _stream(**over):
    doc = _doc(worker_kind="stream",
               workload={"beams": 1, "stream_chunks": 4})
    doc.update(over)
    return doc


@pytest.mark.parametrize("doc", [
    [],
    _doc(typo=1),
    _doc(timeline=[{"t": 0, "action": "explode"}]),
    _doc(timeline=[{"t": 0, "action": "kill_worker"}]),
    _doc(timeline=[{"t": 0, "action": "kill_worker", "worker": "w0",
                    "signal": "HUP"}]),
    _doc(timeline=[{"t": 0, "action": "set_faults", "worker": "w0"}]),
    _doc(timeline=[{"t": 0, "action": "set_faults", "worker": "w0",
                    "faults": "nope:hang"}]),
    _doc(timeline=[{"t": 5, "action": "set_faults", "worker": "w0",
                    "until": 2.0, "faults": "spool.io:unimplemented"}]),
    _doc(timeline=[{"t": 1, "action": "surge_submit"}]),
    _doc(timeline=[{"t": 1, "action": "flap_capacity", "beams": 2,
                    "cycles": 0}]),
    _doc(timeline=[{"t": 1, "bogus": 2, "action": "kill_worker"}]),
    _wl(via="carrier-pigeon"),
    _wl(beams=0),
    _wl(passes=-1),
    _wl(passes=3, via="gateway"),
    _wl(typo=True),
    _doc(worker_kind="gpu"),
    _doc(workers=0),
    _doc(batch=0),
    _doc(queue_url="nowhere"),
    _doc(queue_url="memory"),
    _doc(workload={"beams": 1, "via": "gateway"}),
    _doc(dataplane=True),
    _doc(dataplane=True, gateway=True, worker_kind="serve",
         workload={"beams": 1, "datafiles": ["a.fits"]}),
    _doc(worker_kind="serve"),
    _doc(workload={"beams": 1, "stream_chunks": 3}),
    _doc(worker_kind="stream"),
    _stream(gateway=True, workload={"beams": 1, "stream_chunks": 4,
                                    "via": "gateway"}),
    _stream(batch=2),
    _stream(workload={"beams": 1, "stream_chunks": 4, "passes": 2}),
    _stream(workload={"beams": 1, "stream_chunks": 4,
                      "stream_nchan": 0}),
    _stream(workload={"beams": 1, "stream_chunks": 4,
                      "stream_slo_s": 0}),
    _stream(workload={"beams": 1, "stream_chunks": 4,
                      "stream_drop_seqs": [9, True]}),
    _doc(tenants={"a": {"bogus": 1}}),
    _doc(tenants={"a": {"priority": "nope"}}),
    _doc(autoscale={"max_workers": 0}),
])
def test_scenario_refusals_equal(doc):
    """The same document is refused by both schemas with the same
    ValueError message (worker_kind=serve without datafiles among
    them)."""
    with pytest.raises(ValueError) as want:
        jscenario.from_dict(doc)
    with pytest.raises(ValueError) as got:
        tscenario.from_dict(doc)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", SCENARIOS)
def test_packaged_scenarios_byte_equal_and_parse_equal(name, tmp_path):
    """The seven packaged scenarios: the same bytes, the same parse,
    the same effective queue URL and schedule file."""
    jpath = os.path.join(os.path.dirname(jscenario.__file__),
                         "scenarios", name + ".json")
    tpath = os.path.join(os.path.dirname(tscenario.__file__),
                         "scenarios", name + ".json")
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    jsc, tsc = jscenario.load(name), tscenario.load(name)
    assert dataclasses.asdict(tsc) == dataclasses.asdict(jsc)
    spool = str(tmp_path / "s")
    assert tsc.effective_queue_url(spool) == jsc.effective_queue_url(spool)
    docs = {}
    for pkg, mod, sc in (("jax", jscenario, jsc),
                         ("torch", tscenario, tsc)):
        path = mod.write_schedule(str(tmp_path / pkg), sc, 1000.0)
        docs[pkg] = json.load(open(path))
    assert docs["torch"] == docs["jax"]


def test_worker_commands_name_the_ports_processes(tmp_path, monkeypatch):
    """stub: python -m tpulsar_torch.chaos.worker; stream: the port's
    stream worker on its host backend; serve: python -m tpulsar_torch
    serve on the card (no --device unless worker_extra_args carries
    one), with --config $TPULSAR_CONFIG when it is set.  The other
    arguments are the JAX runner's."""
    cfg = str(tmp_path / "cfg.py")
    monkeypatch.setenv("TPULSAR_CONFIG", cfg)
    kinds = {"stub": _doc(batch=2),
             "stream": _stream(),
             "serve": _doc(worker_kind="serve", workload={
                 "beams": 1, "datafiles": ["a.fits"]})}
    for kind, doc in kinds.items():
        spool = str(tmp_path / kind)
        t = trunner.ChaosRunner(tscenario.from_dict(doc), spool,
                                worker_extra_args=("--x",))
        j = jrunner.ChaosRunner(jscenario.from_dict(doc), spool,
                                worker_extra_args=("--x",))
        got, want = t._worker_cmd("w0"), j._worker_cmd("w0")
        assert t._worker_env("w0") == j._worker_env("w0")
        if kind == "stub":
            assert got[1:3] == ["-m", "tpulsar_torch.chaos.worker"]
            assert got[3:] == want[3:]
        elif kind == "stream":
            assert got[1:3] == ["-m", "tpulsar_torch.stream.worker"]
            assert got[-5:] == ["--backend", "numpy", "--device", "cpu",
                                "--x"]
            assert got[3:-5] == want[3:-1]
        else:
            assert got[1:5] == ["-m", "tpulsar_torch", "--config", cfg]
            assert got[3:] == want[3:] and "--device" not in got
            assert got[got.index("serve"):][:2] == ["serve", "--spool"]


def test_stream_scenario_validates_and_spawns_the_ports_worker(tmp_path):
    """tests/test_chaos.py's stream validation case, its last
    assertion naming the port's stream worker."""
    sc = tscenario.from_dict(jcases._stream_doc())
    assert sc.worker_kind == "stream" and sc.workload.stream_chunks == 4
    for doc, word in ((jcases._stream_doc(workload={
            "beams": 1, "stream_chunks": 0}), "come together"),
            ({"workload": {"beams": 1}, "worker_kind": "stream"},
             "come together"),
            (jcases._stream_doc(batch=2), "batch=1")):
        with pytest.raises(ValueError, match=word):
            tscenario.from_dict(doc)
    cmd = trunner.ChaosRunner(sc, str(tmp_path / "s"))._worker_cmd("w0")
    assert "tpulsar_torch.stream.worker" in cmd and "--worker-id" in cmd


# --------------------------------------------------------- cross audit

@pytest.mark.parametrize("stormer", sorted(PACKAGES))
def test_each_verifier_passes_the_other_packages_storm(stormer,
                                                       tmp_path):
    """The packaged kill_mid_beam scenario (multi-pass checkpointed
    beams, w0 SIGKILLed mid-beam, the victims resumed from their
    checkpoints) stormed by one package and audited by the other's
    verifier: clean, with the same report from both, the resumed
    beams' candidates_digest recomputed by the other package."""
    chaos = CHAOS[stormer]
    other = CHAOS["torch" if stormer == "jax" else "jax"]
    spool = str(tmp_path / "spool")
    sc = chaos["scenario"].load("kill_mid_beam")
    manifest = chaos["runner"].run_scenario(sc, spool)
    assert manifest["quiesced"], manifest
    report = other["invariants"].verify(spool,
                                        max_attempts=sc.max_attempts)
    assert report["ok"], report["violations"]
    assert report["checked"]["terminal"] == sc.workload.beams
    assert BOTH.verify(spool, max_attempts=sc.max_attempts) == report
    evs = jjournal.read_events(spool)
    assert BOTH.recovery_stats(evs)["kills"]
    assert "PASS" in BOTH.render_report(spool)
    done = [tprotocol.read_result(spool, t) for t in manifest["tickets"]]
    assert all(r["candidates_digest"] == other["worker"].expected_digest(
        r["ticket"], r["passes"]) for r in done)


# ------------------------------------------------ the port's stub worker

def test_mid_batch_sigkill_requeues_each_batchmate_exactly_once(
        tmp_path):
    """tests/test_chaos.py's mid-batch SIGKILL case on the port's stub
    (``python -m tpulsar_torch.chaos.worker``): the first beam of a
    3-ticket batch durable, its batchmates requeued individually with
    one strike each and finished by a second batch worker; both
    verifiers clean."""
    spool = str(tmp_path / "spool")
    for i in range(5):
        tprotocol.write_ticket(spool, f"t{i}", ["f"],
                               str(tmp_path / f"out{i}"), beam_s=0.05)
    stub = [sys.executable, "-m", "tpulsar_torch.chaos.worker"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([*stub, "--spool", spool, "--worker-id", "w0",
                        "--batch", "3", "--crash-mid-batch", "--beam-s",
                        "0.05", "--once"], env=env, timeout=120)
    assert p.returncode == 70
    assert tprotocol.state_count(spool, "done") == 1
    assert tprotocol.claimed_count(spool) == 2
    assert sorted(tprotocol.requeue_stale_claims(spool)) == ["t1", "t2"]
    p2 = subprocess.run([*stub, "--spool", spool, "--worker-id", "w1",
                         "--batch", "3", "--beam-s", "0.05", "--once"],
                        env=env, timeout=120)
    assert p2.returncode == 0
    assert sorted(tprotocol.list_tickets(spool, "done")) == \
        [f"t{i}" for i in range(5)]
    evs = tjournal.read_events(spool)
    assert any(e["event"] == "batch_dispatch" and e["tickets"]
               for e in evs)
    takeovers = [e for e in evs if e["event"] == "takeover"]
    assert sorted(e["ticket"] for e in takeovers) == ["t1", "t2"]
    assert all(e["attempt"] == 1 for e in takeovers)
    report = BOTH.verify(spool)
    assert report["ok"], report["violations"]
    assert report["checked"]["terminal"] == 5


def test_stub_worker_exit_rc_and_crash_after(tmp_path):
    """--exit-rc dies at boot with that code; --crash-after 1 exits 70
    right after its first claim, the claim in place; a drained spool
    ends a --once worker with 0 and a 'stopped' heartbeat."""
    spool = str(tmp_path / "spool")
    stub = [sys.executable, "-m", "tpulsar_torch.chaos.worker",
            "--spool", spool]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    assert subprocess.run([*stub, "--worker-id", "w0", "--exit-rc", "3"],
                          env=env, timeout=60).returncode == 3
    tprotocol.write_ticket(spool, "a", ["f"], str(tmp_path / "o"))
    assert subprocess.run([*stub, "--worker-id", "w0", "--crash-after",
                           "1", "--once"], env=env,
                          timeout=60).returncode == 70
    assert tprotocol.claimed_count(spool) == 1
    assert tprotocol.requeue_stale_claims(spool) == ["a"]
    assert subprocess.run([*stub, "--worker-id", "w1", "--beam-s", "0.01",
                           "--once"], env=env, timeout=60).returncode == 0
    assert tprotocol.read_result(spool, "a")["worker"] == "w1"
    assert tprotocol.read_heartbeat(spool, "w1")["status"] == "stopped"
    assert BOTH.verify(spool)["ok"]


def test_packaged_stream_scenario_storm_on_the_host_backend(tmp_path):
    """The packaged stream_smoke storm on the port's stream worker with
    ``--backend numpy`` (two sessions with a declared gap, w0 SIGKILLed,
    stream.ingest and spool.io windows on w1): every session done, no
    chunk lost or doubled, every verdict equal from both verifiers."""
    spool = str(tmp_path / "spool")
    sc = tscenario.load("stream_smoke")
    r = trunner.ChaosRunner(sc, spool)
    assert "--backend" in r._worker_cmd("w0")
    manifest = r.run()
    assert manifest["quiesced"], manifest
    for tid in manifest["tickets"]:
        rec = tprotocol.read_result(spool, tid)
        assert rec is not None and rec["status"] == "done", (tid, rec)
        assert rec["gaps"] == 1, rec
    report = BOTH.verify(spool, max_attempts=sc.max_attempts)
    assert report["ok"], report["violations"]


# ----------------------------------------------------- the chaos command

def test_chaos_cli_verify_exit_codes_equal(writer, tmp_path, capsys):
    """`chaos verify` of both CLIs on a spool with a doubled terminal
    (exit 1, FAIL naming the invariant) and on a clean one (exit 0,
    PASS), with the same output."""
    bad, good = str(tmp_path / "bad"), str(tmp_path / "good")
    jcases._chain(bad, "a")
    jcases.journal.record(bad, "result", ticket="a", worker="w1",
                          attempt=0, trace_id="tr-a", status="done",
                          rc=0)
    jcases._chain(good, "b")
    for spool, rc, word in ((bad, 1, "FAIL"), (good, 0, "PASS")):
        out = {}
        for name, cli in (("jax", jcli_main), ("torch", tcli_main)):
            assert cli(["chaos", "verify", "--spool", spool]) == rc
            out[name] = capsys.readouterr().out
        assert out["torch"] == out["jax"]
        assert word in out["torch"]
        assert ("terminal_exactly_once: a" in out["torch"]) == (rc == 1)


def test_chaos_cli_takes_the_jax_clis_arguments():
    """`chaos run|verify|report` have the JAX CLI's arguments (dests and
    defaults)."""
    from tpulsar.cli.main import build_parser as jparser
    from tpulsar_torch.cli.main import build_parser as tparser

    def args(p):
        sub = next(a for a in p._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        csub = next(a for a in sub.choices["chaos"]._actions
                    if a.__class__.__name__ == "_SubParsersAction")
        return {name: sorted((a.dest, repr(a.default))
                             for a in sp._actions)
                for name, sp in csub.choices.items()}
    assert args(tparser()) == args(jparser())
    assert sorted(args(tparser())) == ["report", "run", "verify"]


def test_chaos_cli_run_verify_report(tmp_path, capsys):
    """`python -m tpulsar_torch chaos run` of a small stub scenario file
    exits 0 once the storm quiesced, `chaos verify` exits 0 on its
    spool and `chaos report` prints the kill's MTTR; the JAX CLI
    reports the same spool identically."""
    path = tmp_path / "mini.json"
    path.write_text(json.dumps({
        "name": "cli-mini", "seed": 2, "duration_s": 60.0,
        "workers": 2, "beam_s": 0.1, "poll_s": 0.2, "gateway": True,
        "tenants": {"survey": {"max_inflight": 3}},
        "workload": {"beams": 4, "interval_s": 0.05, "via": "gateway",
                     "tenant": "survey"},
        "timeline": [{"t": 0.3, "action": "kill_worker", "worker": "w0",
                      "signal": "KILL"},
                     {"t": 0.5, "action": "restart_gateway"}],
        "quiesce_timeout_s": 40.0}))
    spool = str(tmp_path / "spool")
    assert tcli_main(["chaos", "run", "--scenario", str(path),
                      "--spool", spool]) == 0
    run = capsys.readouterr().out
    assert '"quiesced": true' in run
    assert tcli_main(["chaos", "verify", "--spool", spool]) == 0
    assert "PASS" in capsys.readouterr().out
    assert tcli_main(["chaos", "report", "--spool", spool]) == 0
    got = capsys.readouterr().out
    assert jcli_main(["chaos", "report", "--spool", spool]) == 0
    assert got == capsys.readouterr().out
    assert "kill w0:" in got and "mttr" in got


# --------------------------------- the port's real serve workers (CPU)

#: w1's command: `python -m tpulsar_torch` with the rest of the command
#: line, its server held after boot (heartbeat written, so the storm
#: sees a fresh fleet) until the journal records a claim by w0 — so w0
#: holds a beam at the kill whichever worker's prefetch would have won
_HOLD_W1 = r"""
import json, os, runpy, sys, time
from tpulsar_torch.serve import server
path = os.environ["CHAOS_TEST_JOURNAL"]
boot = server.SearchServer.boot


def held_boot(self):
    boot(self)
    deadline = time.time() + 300
    while time.time() < deadline:
        if os.path.exists(path) and any(
                '"claimed"' in ln and json.loads(ln).get("worker") == "w0"
                for ln in open(path)):
            return
        time.sleep(0.02)


server.SearchServer.boot = held_boot
sys.argv = ["tpulsar_torch"] + sys.argv[1:]
runpy.run_module("tpulsar_torch", run_name="__main__", alter_sys=True)
"""


class _HeldRunner(trunner.ChaosRunner):
    def _worker_cmd(self, worker_id):
        argv = super()._worker_cmd(worker_id)
        if worker_id != "w1":
            return argv
        assert argv[1:3] == ["-m", "tpulsar_torch"]
        return [sys.executable, "-c", _HOLD_W1, *argv[3:]]


def test_serve_storm_of_the_ports_workers_on_the_cpu(
        tmp_path, configured, monkeypatch):
    """A worker_kind=serve storm of two of the port's `serve` workers
    (``--device cpu`` through worker_extra_args) on a Mock subband
    pair: three tickets through the gateway on a sqlite queue under a
    tenant cap, a spool.io window on w1, a gateway restart, w0
    SIGKILLed mid-beam, a janitor pause.  The storm quiesces, each
    ticket is done once, w0's claims are taken over, both verifiers
    report it clean, and every results directory equals the port's
    solo job on that beam."""
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    fns = _subband_pair(tmp_path / "beam")
    monkeypatch.setenv("DATAFILES", ";".join(fns))
    monkeypatch.setenv("OUTDIR", str(tmp_path / "solo"))
    assert tjob.main(["--device", "cpu"]) == 0

    spool = str(tmp_path / "spool")
    monkeypatch.setenv("CHAOS_TEST_JOURNAL", tjournal.journal_path(spool))
    sc = tscenario.from_dict({
        "name": "serve-cpu", "seed": 5, "duration_s": 400.0,
        "workers": 2, "worker_kind": "serve", "gateway": True,
        "queue_url": "sqlite", "max_attempts": 3, "poll_s": 0.2,
        "tenants": {"survey": {"max_inflight": 3}},
        "workload": {"beams": 3, "interval_s": 0.25, "via": "gateway",
                     "tenant": "survey", "datafiles": fns},
        "timeline": [
            {"t": 0.5, "action": "set_faults", "worker": "w1",
             "until": 30.0,
             "faults": "spool.io:unimplemented:count=2,errno=ENOSPC"},
            {"t": 1.0, "action": "restart_gateway"},
            {"t": 4.0, "action": "kill_worker", "worker": "w0",
             "signal": "KILL"},
            {"t": 5.0, "action": "pause_janitor", "seconds": 1.0}],
        "quiesce_timeout_s": 350.0})
    r = _HeldRunner(sc, spool, worker_extra_args=("--device", "cpu"))
    try:
        manifest = r.run()
    finally:
        ctrl = r._ctrl
        for w in (ctrl.workers if ctrl is not None else ()):
            if w.alive:
                w.proc.send_signal(signal.SIGKILL)
                w.proc.wait(timeout=30)
    assert manifest["quiesced"], manifest
    assert [a["action"] for a in manifest["actions"]] == [
        "restart_gateway", "kill_worker", "pause_janitor"]
    assert len(manifest["tickets"]) == 3
    q = tfq.get_ticket_queue(manifest["queue_url"])
    for tid in manifest["tickets"]:
        rec = q.read_result(tid)
        assert rec is not None and rec["status"] == "done", (tid, rec)
        evs = tjournal.read_events(spool, ticket=tid)
        assert tjournal.validate_chain(evs) == [], evs
        assert _results_diff().diff_results(
            rec["outdir"], str(tmp_path / "solo")) == []
    evs = tjournal.read_events(spool)
    steals = [e for e in evs if e["event"] == "takeover"]
    assert steals and all(e["from_worker"] == "w0" for e in steals)
    report = BOTH.verify(manifest["queue_url"],
                         tenants=sc.tenants, max_attempts=3)
    assert report["ok"], report["violations"]
    assert report["checked"]["terminal"] == 3
    kill = BOTH.recovery_stats(evs)["kills"][0]
    assert kill["victims"] and kill["mttr_s"] is not None
