"""The port's health doctor (tpulsar_torch/obs/alerts.py, health.py),
its fleet view (obs/fleetview.py) and its fleet and alert families
(obs/telemetry.py) against the JAX package's: the rule, schema and
detector cases of tests/test_health.py run on both packages; the
built-in pack equal field by field; evaluate_rule, burn_rate and
render_alerts equal on the same seeded frames; a HealthDetector tick
of each package on copies of one journal and spool persisting the
same alerts.json rule set; merge_snapshots, slo_snapshot, render_top
and stitch equal on one fleet's spool; the 12 new families matching
the JAX catalog; both halves of the port's ``doctor``; and the
alert-fidelity cases of tests/test_health.py (the chaos verifier's
alert sweeps and injected fault classes) on both packages' chaos
harnesses.

Every comparison is exact (the modules are copies working on the
same files); wall-clock fields (alerts' ``since``, a file's ``t``)
are left out of them.  The stub fleet's worker is the port's ``python
-m tpulsar_torch.chaos.worker``.  The blackbox reader cases
(load_blackbox/render_blackbox) of tests/test_health.py run on both
packages in test_torch_cli_ops.py, beside the ``obs`` command."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_fleet as jfleet  # noqa: E402
import test_health as jhealth_cases  # noqa: E402
import tpulsar.chaos  # noqa: E402
from test_torch_fleet import PORT_STUB  # noqa: E402
from test_torch_checkpoint import ROOT  # noqa: E402
from test_torch_obs import _catalog  # noqa: E402
from tpulsar.cli.main import main as jcli_main  # noqa: E402
from tpulsar.obs import alerts as jalerts  # noqa: E402
from tpulsar.obs import fleetview as jfleetview  # noqa: E402
from tpulsar.obs import health as jhealth  # noqa: E402
from tpulsar.obs import journal as jjournal  # noqa: E402
from tpulsar.obs import metrics as jmetrics  # noqa: E402
from tpulsar.obs import telemetry as jtelemetry  # noqa: E402
from tpulsar.resilience import faults as jfaults  # noqa: E402
from tpulsar.serve import protocol as jprotocol  # noqa: E402
from tpulsar_torch.chaos import invariants as tinvariants  # noqa: E402
from tpulsar_torch.chaos import scenario as tscenario  # noqa: E402
from tpulsar_torch.cli.main import main as tcli_main  # noqa: E402
from tpulsar_torch.obs import alerts as talerts  # noqa: E402
from tpulsar_torch.obs import fleetview as tfleetview  # noqa: E402
from tpulsar_torch.obs import health as thealth  # noqa: E402
from tpulsar_torch.obs import journal as tjournal  # noqa: E402
from tpulsar_torch.obs import metrics as tmetrics  # noqa: E402
from tpulsar_torch.obs import telemetry as ttelemetry  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402

PACKAGES = {
    "jax": dict(alerts=jalerts, health=jhealth, journal=jjournal,
                metrics=jmetrics, telemetry=jtelemetry, faults=jfaults),
    "torch": dict(alerts=talerts, health=thealth, journal=tjournal,
                  metrics=tmetrics, telemetry=ttelemetry,
                  faults=tfaults),
}
NOW = jhealth_cases.NOW


@pytest.fixture(autouse=True)
def _no_fault_leak():
    yield
    jfaults.reset()
    tfaults.reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request, monkeypatch):
    """The package under test: tests/test_health.py's module globals
    pointed at its alerts, health, journal, metrics, telemetry and
    faults."""
    for name, mod in PACKAGES[request.param].items():
        monkeypatch.setattr(jhealth_cases, name, mod)
    return request.param


@pytest.mark.parametrize("case,args", [
    ("test_rule_queue_wait_slo_burn_threshold_and_clean", ()),
    ("test_rule_stream_latency_burn_threshold_and_clean", ()),
    ("test_stream_latency_samples_extraction", ()),
    ("test_event_count_rules_threshold_and_clean",
     ("takeover_rate", "takeover", 1)),
    ("test_event_count_rules_threshold_and_clean",
     ("quarantine", "quarantined", 1)),
    ("test_event_count_rules_threshold_and_clean",
     ("queue_corrupt", "queue_corrupt", 1)),
    ("test_event_count_rules_threshold_and_clean",
     ("checkpoint_sick", "checkpoint_invalid", 1)),
    ("test_rule_worker_flap_threshold_and_exclusions", ()),
    ("test_metric_delta_rules_threshold_and_clean",
     ("compile_miss_on_warm",)),
    ("test_metric_delta_rules_threshold_and_clean",
     ("accel_breaker_pinned",)),
    ("test_rule_fsck_findings_threshold_and_clean", ()),
    ("test_rule_fleet_saturated_threshold_and_clean", ()),
    ("test_rule_from_dict_rejects_unknown_and_bad_fields", ()),
])
def test_rule_case_on_both_packages(case, args, pkg):
    """Each rule and schema case of tests/test_health.py, unchanged,
    on the package's rule engine."""
    getattr(jhealth_cases, case)(*args)


@pytest.mark.parametrize("case", [
    "test_load_rules_extends_and_replaces",
    "test_detector_fire_and_resolve_transitions",
    "test_detector_for_duration_debounce",
    "test_detector_fsck_two_poll_intersection",
])
def test_detector_case_on_both_packages(case, pkg, tmp_path):
    """Each rules-file and detector case of tests/test_health.py,
    unchanged, on the package's detector."""
    getattr(jhealth_cases, case)(tmp_path)


@pytest.mark.parametrize("case", [
    "test_alert_sweep_false_alarm_detected",
    "test_alert_sweep_missed_alarm_gated_on_doctor",
    "test_injected_classes_from_schedule_and_worker_args",
])
def test_alert_fidelity_case_on_both_packages(case, pkg, tmp_path,
                                              monkeypatch):
    """Each alert-fidelity case of tests/test_health.py, unchanged, on
    the package's chaos verifier and scenario paths (the cases import
    them inside their bodies, from the package the fixture names)."""
    if pkg == "torch":
        monkeypatch.setattr(tpulsar.chaos, "invariants", tinvariants)
        monkeypatch.setattr(tpulsar.chaos, "scenario", tscenario)
    getattr(jhealth_cases, case)(tmp_path)


def test_alert_fidelity_invariants_registered(pkg, monkeypatch):
    """The alert-fidelity invariants are registered in the package's
    verifier, and every rule its fault-class maps name is a rule of
    the package's pack."""
    if pkg == "torch":
        monkeypatch.setattr(tpulsar.chaos, "invariants", tinvariants)
    jhealth_cases.test_alert_fidelity_invariants_registered()


def test_flight_recorder_disabled_and_clean_exit(pkg, tmp_path,
                                                 monkeypatch):
    """test_health.py's disable-switch case read without the blackbox
    reader (test_torch_cli_ops.py runs it with the reader): a disabled,
    a spool-less and a disarmed recorder leave no dump."""
    health = PACKAGES[pkg]["health"]
    monkeypatch.setenv("TPULSAR_BLACKBOX", "0")
    box = health.FlightRecorder("w0", spool=str(tmp_path))
    box.note("claim", ticket="t")
    assert box.dump(reason="x") == ""
    monkeypatch.delenv("TPULSAR_BLACKBOX")
    assert not health.FlightRecorder("w0", spool="").enabled
    box = health.FlightRecorder("w1", spool=str(tmp_path))
    box.arm()
    box.disarm()
    box._atexit()
    assert not os.path.exists(tmp_path / health.BLACKBOX_DIR)


# ------------------------------------------------------ parity: rules

def test_builtin_rules_equal_field_by_field():
    """The same 11 rules, in the same order, every field equal; the
    compile-cache rule's family is in the port's catalog, under the
    JAX catalog's name, so the rule is evaluated, not skipped."""
    jr, tr = jalerts.builtin_rules(), talerts.builtin_rules()
    assert [r.id for r in tr] == [r.id for r in jr]
    for a, b in zip(jr, tr):
        assert dataclasses.asdict(b) == dataclasses.asdict(a), a.id
    assert ttelemetry.compile_cache_misses_total().name == \
        jtelemetry.compile_cache_misses_total().name
    assert talerts.ALLOWED_ALERTS == jalerts.ALLOWED_ALERTS
    assert talerts.EXPECTED_ALERTS == jalerts.EXPECTED_ALERTS
    assert talerts.allowed_rules("action:kill_worker") == \
        jalerts.allowed_rules("action:kill_worker")
    assert "tpulsar_compile_cache_misses_total" in _catalog(ttelemetry)


def _seeded_frames(seed: int, n: int = 6) -> list[dict]:
    """Frames of seeded journal events, queue waits, stream latencies,
    metric histories, snapshots and fsck counts around NOW."""
    rng = np.random.default_rng(seed)
    names = ["takeover", "quarantined", "worker_exit", "claimed",
             "checkpoint_invalid", "checkpoint_disabled",
             "queue_corrupt", "chunk_received", "submitted"]
    frames = []
    for _ in range(n):
        events = []
        for _ in range(int(rng.integers(0, 12))):
            ev = {"event": str(rng.choice(names)),
                  "t": float(NOW - rng.uniform(0, 900)),
                  "ticket": f"t{int(rng.integers(0, 5))}"}
            if ev["event"] == "worker_exit":
                ev.update(rc=int(rng.choice([0, 70, -9])),
                          kind=str(rng.choice(["crash", "drain",
                                               "scale_down"])))
            if ev["event"] == "chunk_received":
                ev["latency_s"] = float(rng.uniform(0, 10))
            events.append(ev)
        events.sort(key=lambda e: e["t"])
        waits = sorted((float(NOW - rng.uniform(0, 700)),
                        float(rng.uniform(0, 60)))
                       for _ in range(int(rng.integers(0, 15))))
        samples = {rid: [(NOW - 200.0, float(rng.integers(0, 3))),
                         (NOW, float(rng.integers(0, 5)))]
                   for rid in ("compile_miss_on_warm",
                               "accel_breaker_pinned")}
        cap = jhealth_cases._cap_snapshot(int(rng.integers(-1, 3)))
        frames.append({
            "now": NOW, "events": events, "snapshot": cap,
            "samples": samples, "queue_wait": waits,
            "stream_latency": jalerts.stream_latency_samples(events),
            "fsck": int(rng.integers(0, 3))})
    return frames


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_rule_and_burn_rate_equal_on_seeded_frames(seed):
    frames = _seeded_frames(seed)
    verdicts = []
    for frame in frames:
        assert talerts.queue_wait_samples(frame["events"]) == \
            jalerts.queue_wait_samples(frame["events"])
        assert talerts.stream_latency_samples(frame["events"]) == \
            jalerts.stream_latency_samples(frame["events"])
        for wj, wt in zip(jalerts.builtin_rules(),
                          talerts.builtin_rules()):
            got = talerts.evaluate_rule(wt, frame)
            assert got == jalerts.evaluate_rule(wj, frame), wj.id
            verdicts.append(got)
        for window in (60.0, 120.0, 600.0):
            for min_count in (1, 3):
                assert talerts.burn_rate(
                    frame["queue_wait"], NOW, window, 30.0, 0.1,
                    min_count) == jalerts.burn_rate(
                    frame["queue_wait"], NOW, window, 30.0, 0.1,
                    min_count)
    # the frames reach both verdicts and the skip
    assert any(v and v["breached"] for v in verdicts)
    assert any(v and not v["breached"] for v in verdicts)
    assert any(v is None for v in verdicts)


def test_render_alerts_equal():
    active = [{"rule": "takeover_rate", "severity": "warn",
               "value": 1.0, "threshold": 1, "window_s": 300.0,
               "doc": "crash-shaped takeovers"},
              {"rule": "worker_flap", "severity": "page", "value": 2.0,
               "threshold": 2, "window_s": 300.0}]
    for act in ([], active):
        assert thealth.render_alerts(act, title="t") == \
            jhealth.render_alerts(act, title="t")


# ---------------------------------------- parity: detector and fleet


@pytest.fixture(scope="module")
def fleet_spool(tmp_path_factory):
    """One stub fleet's spool: the JAX controller's crash-recovery
    case (two of the port's stub workers, w0 crashing on its first
    beam), then the journal's worker metric snapshots and a trace file
    for one beam."""
    tmp = tmp_path_factory.mktemp("fleet")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfleet, "_STUB_ARGV", PORT_STUB)
        jfleet.test_controller_crash_recovery_exactly_once(tmp)
    spool = str(tmp / "spool")
    reg = jmetrics.Registry()
    reg.counter("tpulsar_serve_beams_total", "beams",
                labelnames=("outcome",)).inc(3, outcome="done")
    reg.gauge("tpulsar_serve_queue_depth", "depth").set(2)
    reg.histogram("tpulsar_serve_beam_seconds", "s",
                  buckets=(0.1, 1.0, 10.0)).observe(0.5)
    for wid, t in (("w0", time.time() - 3600.0), ("w1", time.time())):
        os.makedirs(os.path.join(spool, "metrics"), exist_ok=True)
        jprotocol._atomic_write_json(
            jfleetview.snapshot_path(spool, wid),
            {"t": t, "worker": wid, "metrics": reg.snapshot()})
    ev = next(e for e in jjournal.read_events(spool)
              if e.get("event") == "takeover")
    tid = ev["ticket"]
    trace = {"traceEvents": [
        {"name": "search", "ph": "X", "ts": 10.0, "dur": 5.0, "pid": 7,
         "tid": 1, "args": {"trace_id": ev.get("trace_id", "")}},
        {"name": "other", "ph": "X", "ts": 1.0, "dur": 1.0, "pid": 7,
         "tid": 1, "args": {"trace_id": "nope"}}],
        "otherData": {"trace_epoch_unix_s": time.time() - 5.0}}
    outdir = tmp / "out_trace"
    outdir.mkdir()
    (outdir / "beam_trace.json").write_text(json.dumps(trace))
    jjournal.record(spool, "result", ticket=tid, worker="w1",
                    status="done", outdir=str(outdir), attempt=1,
                    trace_id=ev.get("trace_id", ""))
    return spool, tid


def test_fleetview_equal_on_one_spool(fleet_spool):
    """merge_snapshots, slo_snapshot, fleet_snapshot, render_top and
    stitch of both packages on one stub fleet's spool."""
    spool, tid = fleet_spool
    jsn = [r["metrics"] for r in jfleetview.worker_snapshots(spool)
           .values()]
    tsn = [r["metrics"] for r in tfleetview.worker_snapshots(spool)
           .values()]
    assert tsn == jsn and len(tsn) == 2
    assert tfleetview.merge_snapshots(tsn) == \
        jfleetview.merge_snapshots(jsn)
    slo = tfleetview.slo_snapshot(spool)
    assert slo == jfleetview.slo_snapshot(spool)
    assert slo["tpulsar_fleet_slo_source_workers"]["series"][
        "beam_e2e"] == 2
    fleet = tfleetview.fleet_snapshot(spool)
    assert fleet == jfleetview.fleet_snapshot(spool)
    # w0's snapshot is an hour old: its gauges are stripped
    assert fleet["tpulsar_serve_queue_depth"]["series"][""] == 2
    assert fleet["tpulsar_serve_beams_total"]["series"]["done"] == 6

    def strip_clock(text):
        lines = text.splitlines()
        return [lines[0].split("(")[0]] + [
            " ".join(w for w in line.split() if not w.endswith("s")
                     or not w[:-1].replace(".", "").isdigit())
            for line in lines[1:]]
    assert strip_clock(tfleetview.render_top(spool)) == \
        strip_clock(jfleetview.render_top(spool))
    st, sj = tfleetview.stitch(spool, tid), jfleetview.stitch(spool, tid)
    assert st == sj
    assert any(e.get("name") == "search" for e in st["traceEvents"])
    assert not any(e.get("name") == "other" for e in st["traceEvents"])
    with pytest.raises(FileNotFoundError):
        tfleetview.stitch(spool, "no-such-ticket")


def test_write_fleet_prom_equal(fleet_spool, tmp_path):
    spool, _ = fleet_spool
    paths = {}
    for name, fv in (("jax", jfleetview), ("torch", tfleetview)):
        paths[name] = fv.write_fleet_prom(
            spool, path=str(tmp_path / f"{name}.prom"))
    text = open(paths["torch"]).read()
    assert text == open(paths["jax"]).read()
    assert 'tpulsar_fleet_slo_source_workers{series="beam_e2e"} 2' in text


def _alert_set(root: str) -> list[dict]:
    """alerts.json's alerts without their wall-clock fields (the two
    copies' journals differ only in when the events added here were
    recorded)."""
    doc = json.load(open(os.path.join(root, "alerts.json")))
    return [{k: v for k, v in a.items()
             if k not in ("since", "last_event_t")}
            for a in doc["alerts"]]


def test_detector_tick_persists_the_same_alerts(fleet_spool, tmp_path):
    """One HealthDetector tick of each package on its own copy of the
    stub fleet's spool (takeovers, crash exits, a quarantine added
    here, a saturated capacity snapshot): the same alerts.json rule
    set and evidence, the same alert_fired events, the same
    tpulsar_alerts_active export."""
    spool, _ = fleet_spool
    got = {}
    for name, health, journal in (("jax", jhealth, jjournal),
                                  ("torch", thealth, tjournal)):
        root = str(tmp_path / name)
        shutil.copytree(spool, root)
        journal.record(root, "quarantined", ticket="tq", worker="w0")
        journal.record(root, "worker_exit", worker="w0", rc=70,
                       kind="crash")
        det = health.HealthDetector(
            root, notify=False,
            extra_snapshots=lambda: (
                jhealth_cases._cap_snapshot(0),))
        det.tick(now=time.time(), debounce=False)
        fired = [{k: v for k, v in e.items() if k not in ("t",
                                                          "last_event_t")}
                 for e in journal.read_events(root)
                 if e["event"] == "alert_fired"]
        got[name] = (_alert_set(root), fired, det.metrics_snapshot())
    rules = [a["rule"] for a in got["torch"][0]]
    assert {"takeover_rate", "quarantine", "fleet_saturated"} <= \
        set(rules)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2]
    # either package's reader serves the other's alerts.json
    assert thealth.read_active_alerts(str(tmp_path / "jax")) == \
        jhealth.read_active_alerts(str(tmp_path / "jax"))


@pytest.mark.parametrize("name", [
    "tpulsar_fleet_workers", "tpulsar_fleet_restarts_total",
    "tpulsar_fleet_requeued_total", "tpulsar_fleet_quarantined_total",
    "tpulsar_fleet_scale_total", "tpulsar_fleet_autoscale_workers",
    "tpulsar_fleet_capacity", "tpulsar_fleet_slo_seconds",
    "tpulsar_fleet_slo_source_workers", "tpulsar_fleet_tickets",
    "tpulsar_fleet_event_rate", "tpulsar_alerts_active",
])
def test_fleet_and_alert_families_match_the_jax_catalog(name):
    """The fleet's and the doctor's families are in the port's catalog
    with the JAX catalog's type, help, labels and buckets (the four
    journal-derived ones and the alert gauge live in a caller-owned
    registry)."""
    def families(telemetry, metrics):
        reg = metrics.Registry()
        for fn in (telemetry.fleet_slo_seconds,
                   telemetry.fleet_slo_source_workers,
                   telemetry.fleet_tickets, telemetry.fleet_event_rate,
                   telemetry.alerts_active):
            fn(reg)
        return {**_catalog(telemetry), **reg.snapshot()}

    catalog = families(jtelemetry, jmetrics)
    port = families(ttelemetry, tmetrics)
    assert name in port, name
    for key in ("type", "help", "labelnames", "buckets"):
        assert port[name].get(key) == catalog[name].get(key), key


# ------------------------------------------------------------ doctor

def _doctor_cfg(tmp_path) -> str:
    path = tmp_path / "cfg.py"
    root = tmp_path / "run"
    path.write_text(
        f"basic = {{'log_dir': '{root}/logs'}}\n"
        f"background = {{'jobtracker_db': '{root}/jt.db'}}\n"
        f"download = {{'datadir': '{root}/raw'}}\n"
        f"processing = {{'base_working_directory': '{root}/work', "
        f"'base_results_directory': '{root}/res'}}\n"
        f"resultsdb = {{'url': '{root}/results.db'}}\n")
    return str(path)


def test_doctor_fleet_verdict_equal_in_both_clis(fleet_spool, tmp_path,
                                                 capsys):
    """`doctor --spool` of both packages on one fleet's spool: the same
    exit code (1, rules firing), the same rules named; a quiet spool
    exits 0 in both; `doctor --queue sqlite:...` reads through the
    queue backend."""
    spool, _ = fleet_spool
    out = {}
    for name, cli in (("jax", jcli_main), ("torch", tcli_main)):
        assert cli(["doctor", "--spool", spool]) == 1
        out[name] = capsys.readouterr().out
    assert "takeover_rate" in out["torch"]
    assert out["torch"] == out["jax"]
    quiet = str(tmp_path / "quiet")
    os.makedirs(quiet)
    assert tcli_main(["doctor", "--spool", quiet]) == 0
    assert "OK: no alert rules firing" in capsys.readouterr().out
    db = tmp_path / "q.db"
    from tpulsar_torch.frontdoor.queue import get_ticket_queue
    q = get_ticket_queue(f"sqlite:{db}")
    q.record_event("takeover", ticket="t9", worker="w0", attempt=1,
                   from_worker="w0")
    assert tcli_main(["doctor", "--queue", f"sqlite:{db}"]) == 1
    assert "takeover_rate" in capsys.readouterr().out


def test_doctor_node_probe_on_the_cpu(tmp_path):
    """`python -m tpulsar_torch doctor` on a node without a CUDA
    device: every section runs, the device probe fails (the entry
    points default to the card) and says so, the exit code is 1; the
    build state names the native library."""
    res = subprocess.run(
        [sys.executable, "-m", "tpulsar_torch", "--config",
         _doctor_cfg(tmp_path), "doctor", "--device-timeout", "120"],
        env=dict(os.environ, PYTHONPATH=str(ROOT),
                 CUDA_VISIBLE_DEVICES="", TPULSAR_DD_FAMILY="direct"),
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    out = res.stdout
    assert res.returncode == 1, out + res.stderr
    for section in ("dependencies:", "config:", "directories writable:",
                    "job tracker:", "queue manager:", "device:",
                    "build state and pins:"):
        assert section in out, section
    assert "[ok] check_sanity" in out
    assert "[FAIL] device probe — no CUDA device" in out
    assert "native library:" in out and "CUDA kernels:" in out
    assert "[pin] TPULSAR_DD_FAMILY=direct" in out
    last = out.strip().splitlines()[-1]
    assert "check(s) FAILED:" in last and "device probe" in last
