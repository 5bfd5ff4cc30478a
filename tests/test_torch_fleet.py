"""The port's fleet controller (tpulsar_torch/fleet/) against the JAX
package's: the controller cases of tests/test_fleet.py run on both
packages' controllers (drain with two workers, spawn failure, crash
recovery exactly once with its journal chain and fleet.prom, restart
budget and backoff, quarantine of a crash-looping beam, rolling
restart and drain control), the capacity gauge, the ``fleet`` CLI of
both packages, one fleet of the port's real ``serve`` workers on the
CPU (w0 crashed mid-beam by the ``fleet.worker`` fault, its beam
taken over by w1 and equal to the port's solo job on that beam), and
the controller's import without torch.

The stub worker of every controller case is the port's
protocol-faithful ``python -m tpulsar_torch.chaos.worker`` (given
through ``worker_cmd``; tests/test_torch_chaos.py holds it to the JAX
package's): the spool, journal and heartbeat files are the same in
both packages, so one stub drives either controller.

Tolerances: spool records, journal chains, fleet.json and fleet.prom
lines compare exactly; the served results directory and the solo
job's compare exactly under tools/torch_results_diff.py (one package,
one thread, the same beam)."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import test_fleet as jfleet  # noqa: E402
from test_torch_checkpoint import ROOT  # noqa: E402
from test_torch_search_job import (  # noqa: E402, F401 (a fixture)
    _subband_pair, configured)
from test_torch_serve import _results_diff  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
from tpulsar.cli.main import main as jcli_main  # noqa: E402
from tpulsar.fleet import controller as jctl  # noqa: E402
from tpulsar.obs import journal as jjournal  # noqa: E402
from tpulsar.obs import telemetry as jtelemetry  # noqa: E402
from tpulsar.resilience import faults as jfaults  # noqa: E402
from tpulsar.serve import protocol as jprotocol  # noqa: E402
from tpulsar_torch.cli import search_job as tjob  # noqa: E402
from tpulsar_torch.cli.main import main as tcli_main  # noqa: E402
from tpulsar_torch.fleet import controller as tctl  # noqa: E402
from tpulsar_torch.obs import journal as tjournal  # noqa: E402
from tpulsar_torch.obs import telemetry as ttelemetry  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402
from tpulsar_torch.serve import protocol as tprotocol  # noqa: E402

#: each package's modules the JAX controller cases reach through
#: their module globals
PACKAGES = {
    "jax": dict(fleet_ctl=jctl, protocol=jprotocol, journal=jjournal,
                faults=jfaults),
    "torch": dict(fleet_ctl=tctl, protocol=tprotocol, journal=tjournal,
                  faults=tfaults),
}
TELEMETRY = {"jax": jtelemetry, "torch": ttelemetry}
#: the port's stub worker, in place of the JAX package's
#: (tests/test_fleet.py's _STUB_ARGV)
PORT_STUB = [sys.executable, "-m", "tpulsar_torch.chaos.worker"]
CLI = {"jax": jcli_main, "torch": tcli_main}


@pytest.fixture(autouse=True)
def _no_fault_leak():
    yield
    jfaults.reset()
    tfaults.reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request, monkeypatch):
    """The package under test: tests/test_fleet.py's module globals
    pointed at its controller, protocol, journal and faults."""
    for name, mod in PACKAGES[request.param].items():
        monkeypatch.setattr(jfleet, name, mod)
    monkeypatch.setattr(jfleet, "_STUB_ARGV", PORT_STUB)
    return request.param


@pytest.mark.parametrize("case", [
    "test_controller_drains_spool_with_two_workers",
    "test_spawn_failure_still_shuts_down_spawned_workers",
    "test_controller_crash_recovery_exactly_once",
    "test_controller_restart_budget_backoff",
    "test_controller_quarantines_crash_looping_beam",
    "test_controller_rolling_restart_and_drain_control",
])
def test_controller_case_on_both_packages(case, pkg, tmp_path):
    """Each controller case of tests/test_fleet.py, unchanged, on the
    package's controller (the port's stub worker on the package's
    spool)."""
    getattr(jfleet, case)(tmp_path)


def test_capacity_gauge_distinguishes_down_from_saturated(pkg, tmp_path):
    """tpulsar_fleet_capacity tells a DOWN fleet (-1: zero fresh
    workers) from a BUSY one (0: a saturated queue) in both
    packages."""
    telemetry = TELEMETRY[pkg]
    protocol = PACKAGES[pkg]["protocol"]
    spool = str(tmp_path / "spool")
    ctrl = jfleet._controller(spool, workers=0)
    ctrl._aggregate()
    assert telemetry.fleet_capacity().value() == -1
    protocol.write_heartbeat(spool, worker_id="w0", status="running",
                             max_queue_depth=1)
    protocol.write_ticket(spool, "t1", ["/x"], "/o")
    ctrl._aggregate()
    assert telemetry.fleet_capacity().value() == 0


def test_fleet_cli_status_and_control(pkg, tmp_path, capsys):
    """`fleet --status` renders a heartbeat either package wrote, and
    `fleet --drain` leaves a control file the other package's
    controller consumes."""
    cli, other = CLI[pkg], PACKAGES["jax" if pkg == "torch"
                                    else "torch"]
    spool = str(tmp_path / "spool")
    other["protocol"].write_heartbeat(spool, worker_id="w0",
                                      status="running",
                                      max_queue_depth=4)
    assert cli(["fleet", "--status", "--spool", spool]) == 0
    out = capsys.readouterr().out
    assert "w0" in out and "fresh" in out
    assert cli(["fleet", "--drain", "--spool", spool]) == 0
    assert other["fleet_ctl"].read_control(spool) == "drain"
    assert other["fleet_ctl"].read_control(spool) is None   # consumed
    assert cli(["fleet", "--rolling-restart", "--spool", spool]) == 0
    assert PACKAGES[pkg]["fleet_ctl"].read_control(spool) == \
        "rolling-restart"


def test_fleet_and_doctor_take_the_jax_clis_arguments():
    """`fleet` and `doctor` have the JAX CLI's arguments (their
    dests and defaults)."""
    from tpulsar.cli.main import build_parser as jparser
    from tpulsar_torch.cli.main import build_parser as tparser

    def args(p, name):
        sub = next(a for a in p._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return sorted((a.dest, repr(a.default))
                      for a in sub.choices[name]._actions)
    for name in ("fleet", "doctor"):
        assert args(tparser(), name) == args(jparser(), name), name


def test_status_of_one_package_reads_the_others_fleet(tmp_path):
    """A fleet.json the JAX controller wrote renders the same through
    both packages' render_status (the port's status over a JAX
    fleet, and the reverse)."""
    spool = str(tmp_path / "spool")
    ctrl = jctl.FleetController(spool, workers=0, poll_s=0.05)
    ctrl._aggregate(status="stopped")
    jprotocol.write_heartbeat(spool, worker_id="w0", status="running",
                              max_queue_depth=2)

    def strip_ages(text):
        return "\n".join(line.split(" s old")[0].split(", heartbeat")[0]
                         for line in text.splitlines())
    assert strip_ages(tctl.render_status(spool)) == \
        strip_ages(jctl.render_status(spool))
    assert tctl.status_rc(spool) == jctl.status_rc(spool) == 0


def test_default_worker_is_the_ports_serve_on_the_card(tmp_path,
                                                       monkeypatch):
    """The default worker command is `python -m tpulsar_torch serve`:
    no --device unless the caller passes one (the card by default),
    the queue URL and --once ride its command line."""
    monkeypatch.delenv("TPULSAR_CONFIG", raising=False)
    spool = str(tmp_path / "spool")
    ctrl = tctl.FleetController(spool, workers=1, once=True)
    argv = ctrl._default_worker_cmd("w0")
    assert argv[:4] == [sys.executable, "-m", "tpulsar_torch", "serve"]
    assert argv[argv.index("--worker-id") + 1] == "w0"
    assert "--once" in argv and "--device" not in argv
    ctrl = tctl.FleetController(
        spool, workers=1, queue=tctl.queue_mod.get_ticket_queue(
            f"sqlite:{tmp_path / 'q.db'}"),
        worker_args=("--device", "cpu"))
    argv = ctrl._default_worker_cmd("w1")
    assert argv[argv.index("--queue") + 1] == f"sqlite:{tmp_path / 'q.db'}"
    assert argv[-2:] == ["--device", "cpu"]


def test_controller_imports_no_torch():
    """The controller is control plane: importing the fleet, the
    health doctor and the CLI in a fresh interpreter loads no torch
    (and no numpy)."""
    probe = ("import sys\n"
             "import tpulsar_torch.fleet, tpulsar_torch.fleet.autoscale\n"
             "import tpulsar_torch.obs.health, tpulsar_torch.obs.alerts\n"
             "import tpulsar_torch.obs.fleetview\n"
             "import tpulsar_torch.cli.main\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'numpy', 'jax', 'tpulsar'))\n"
             "print('BAD:' + ','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "BAD:"


def test_requeue_journals_the_takeover_before_a_racing_claim(tmp_path,
                                                            monkeypatch):
    """A live worker may claim a requeued ticket the moment it lands in
    incoming/; however long the janitor stalls before its journal
    append, the victim's chain reads claim, takeover, claim (the race
    the JAX package's _requeue_claims still has under load, ROADMAP
    Queue 3).  The stall is played deterministically: the claim is
    made inside the janitor, just before its takeover append."""
    spool = str(tmp_path / "spool")
    tprotocol.write_ticket(spool, "t0", ["/x"], "/o", job_id=0)
    crashed = subprocess.run(
        PORT_STUB + ["--spool", spool, "--worker-id", "w0", "--once",
                     "--crash-after", "1"],
        env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert crashed.returncode == 70
    record = tjournal.record

    def claim_then_record(sp, event, *a, **kw):
        if event == "takeover":
            assert tprotocol.claim_next_ticket(sp, "w1")["ticket"] == "t0"
        return record(sp, event, *a, **kw)

    monkeypatch.setattr(tjournal, "record", claim_then_record)
    assert tprotocol.requeue_stale_claims(spool, 3) == ["t0"]
    evs = tjournal.read_events(spool, ticket="t0")
    assert [(e["event"], e.get("attempt")) for e in evs] == [
        ("submitted", 0), ("claimed", 0), ("takeover", 1),
        ("claimed", 1)]
    tprotocol.write_result(spool, "t0", "done", worker="w1", attempts=1)
    assert tjournal.validate_chain(
        tjournal.read_events(spool, ticket="t0")) == []


# ------------------------------------- the port's real serve workers

#: w1's command: wait until the journal records the janitor's takeover
#: of w0's claim, then run `python -m tpulsar_torch` with the rest of
#: the command line (so w1 is idle until w0 has crashed, whichever
#: worker would have won the first claim)
_HOLD = r"""
import os, runpy, sys, time
path, needle = os.environ["FLEET_TEST_HOLD"].split("|")
deadline = time.time() + 300
while time.time() < deadline:
    if os.path.exists(path) and needle in open(path).read():
        break
    time.sleep(0.05)
sys.argv = ["tpulsar_torch"] + sys.argv[1:]
runpy.run_module("tpulsar_torch", run_name="__main__", alter_sys=True)
"""


def test_real_serve_workers_crash_and_takeover_on_the_cpu(
        tmp_path, configured, monkeypatch):
    """Two of the port's `serve` workers (`--device cpu`) under the
    port's controller on a Mock subband pair: w0 claims the beam and
    crashes on it (TPULSAR_FAULTS=fleet.worker:unimplemented:count=1
    through worker_env), the janitor requeues its claim as a takeover,
    w1 finishes the beam; the controller exits 0, the journal chain
    validates, fleet.json shows w0 given up with rc 70, and the
    results equal the port's solo job on that beam."""
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")
    fns = _subband_pair(tmp_path / "beam")
    monkeypatch.setenv("DATAFILES", ";".join(fns))
    monkeypatch.setenv("OUTDIR", str(tmp_path / "solo"))
    assert tjob.main(["--device", "cpu"]) == 0

    spool = str(tmp_path / "spool")
    tprotocol.write_ticket(spool, "t0", fns, str(tmp_path / "out"),
                           job_id=1)
    jpath = tjournal.journal_path(spool)
    env = {"w0": {"TPULSAR_FAULTS": "fleet.worker:unimplemented:count=1"},
           "w1": {"FLEET_TEST_HOLD": f'{jpath}|"takeover"'}}
    ctrl = tctl.FleetController(
        spool, workers=2, once=True, max_worker_restarts=0,
        ticket_max_attempts=3, poll_s=0.1, drain_timeout_s=60.0,
        worker_args=("--device", "cpu", "--no-warmstart"),
        worker_env=lambda wid: dict(env[wid], OMP_NUM_THREADS="1",
                                    PYTHONPATH=str(ROOT)))
    default = ctrl._default_worker_cmd
    ctrl.worker_cmd = lambda wid: (
        default(wid) if wid == "w0"
        else [sys.executable, "-c", _HOLD, *default(wid)[3:]])
    try:
        assert ctrl.run() == 0
    finally:
        for w in ctrl.workers:          # reap whatever is left
            if w.alive:
                w.proc.send_signal(signal.SIGKILL)
                w.proc.wait(timeout=30)

    rec = tprotocol.read_result(spool, "t0")
    assert rec["status"] == "done" and rec["worker"] == "w1"
    assert rec["attempts"] == 1
    evs = tjournal.read_events(spool, ticket="t0")
    assert tjournal.validate_chain(evs) == [], evs
    names = [(e["event"], e.get("worker")) for e in evs]
    claims = [w for n, w in names if n == "claimed"]
    assert claims == ["w0", "w1"]
    steals = [e for e in evs if e["event"] == "takeover"]
    assert len(steals) == 1 and steals[0]["from_worker"] == "w0"
    assert sum(1 for n, _ in names
               if n == tjournal.TERMINAL_EVENT) == 1
    assert len({e["trace_id"] for e in evs if e.get("trace_id")}) == 1
    fleet = json.load(open(os.path.join(spool, "fleet.json")))
    w0 = next(w for w in fleet["workers"] if w["id"] == "w0")
    assert w0["gave_up"] and w0["last_rc"] == 70
    assert fleet["status"] == "stopped" and fleet["done"] == 1
    assert _results_diff().diff_results(
        str(tmp_path / "out"), str(tmp_path / "solo")) == []
    # the blackbox w0 dumped on its way down, and the doctor's verdict
    assert os.listdir(os.path.join(spool, "blackbox"))
    alerts = json.load(open(os.path.join(spool, "alerts.json")))
    assert "takeover_rate" in {a["rule"] for a in alerts["alerts"]}
