"""The port's operator commands against the JAX package's: `search`
(with `--device`), `trace` and tools/torch_trace_summarize.py, `plan`,
`checkpoint`, and the `obs` console with the blackbox reader.

One traced search of the small Mock subband pair the slice tests use
(`python -m tpulsar_torch search ... --device cpu` in process, plots
turned off as the chip smoke turns them off) is the fixture of the
search and trace cases: its results equal search_beam's on the same
prepared inputs, and its trace file serves `trace` and the summarize
tool.  The other cases run both packages' commands on the same files:
the plan text, either package's checkpoint, and a journal written by
the port's queue on both backends."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import shutil

import pytest

torch = pytest.importorskip("torch")

from test_torch_checkpoint import restore_job_globals  # noqa: E402
from test_torch_search_job import _config_file, _subband_pair  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from tpulsar import checkpoint as jckpt  # noqa: E402
from tpulsar.cli import main as jmain  # noqa: E402
from tpulsar.obs import health as jhealth  # noqa: E402
from tpulsar.resilience import faults as jfaults  # noqa: E402
from tpulsar_torch import checkpoint as tckpt  # noqa: E402
from tpulsar_torch import config as tcfg  # noqa: E402
from tpulsar_torch.cli import main as tmain  # noqa: E402
from tpulsar_torch.cli import search_job as tjob  # noqa: E402
from tpulsar_torch.obs import health as thealth  # noqa: E402
from tpulsar_torch.obs import trace as ttrace  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_plots(params):
    return dataclasses.replace(params, make_plots=False)


# ------------------------------------------------------------ the CLI

def test_cli_has_the_jax_commands_but_aot_with_their_arguments():
    """All 28 of the JAX CLI's subcommands, `aot` included (the name is
    kept from when it was the one left out); the operator commands
    take the JAX CLI's arguments, `aot compile` and `aot verify`
    included, and `search` `--device` besides."""
    def commands(p):
        sub = next(a for a in p._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {name: sp for name, sp in sub.choices.items()}

    def dests(p):
        return sorted(a.dest for a in p._actions)

    jc, tc = commands(jmain.build_parser()), commands(tmain.build_parser())
    assert sorted(tc) == sorted(jc) and len(tc) == 28
    for name in ("plan", "checkpoint", "trace", "lint", "aot"):
        assert dests(tc[name]) == dests(jc[name]), name
    jaot, taot = commands(jc["aot"]), commands(tc["aot"])
    assert sorted(taot) == sorted(jaot) == ["compile", "ls", "verify"]
    for name in jaot:
        assert dests(taot[name]) == dests(jaot[name]), name
    assert dests(tc["search"]) == sorted(dests(jc["search"]) + ["device"])
    jobs, tobs = commands(jc["obs"]), commands(tc["obs"])
    assert sorted(tobs) == sorted(jobs)
    for name in jobs:
        assert dests(tobs[name]) == dests(jobs[name]), name


# ------------------------------------------------------------- search

@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    """`search FILES --outdir OUT --device cpu` with TPULSAR_TRACE=1 on
    the Mock subband pair (DM window 0-8), and search_beam of the same
    prepared inputs (zaplist, configuration) with the trace off."""
    root = tmp_path_factory.mktemp("cli_ops")
    fns = _subband_pair(root / "beam")
    cfg_path = _config_file(root, dm_max=8.0)
    saved = {k: os.environ.get(k) for k in ("TPULSAR_CONFIG",
                                           "TPULSAR_TRACE")}
    from_config = tex.SearchParams.from_config
    tex.SearchParams.from_config = classmethod(
        lambda cls, s: _no_plots(from_config(s)))
    os.environ["TPULSAR_CONFIG"] = cfg_path
    tcfg.set_settings(tcfg.load_config(cfg_path))
    out = root / "out"
    try:
        os.environ["TPULSAR_TRACE"] = "1"
        ttrace.reset()
        with restore_job_globals():
            rc = tmain.main(["search", *fns, "--outdir", str(out),
                             "--device", "cpu"])
        os.environ.pop("TPULSAR_TRACE")
        ttrace.reset()
        cfg = tcfg.settings()
        os.makedirs(root / "ref_work")
        ppfns, zap = tjob.prepare_inputs(fns, str(root / "ref_work"),
                                         cfg=cfg)
        ref = tex.search_beam(
            ppfns, str(root / "ref_work"), str(root / "ref_results"),
            tex.SearchParams.from_config(cfg.searching), zaplist=zap,
            checkpoint_dir=str(root / "ref_ck"), device="cpu")
    finally:
        tex.SearchParams.from_config = from_config
        tcfg.set_settings(None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ttrace.reset()
    return dict(rc=rc, out=str(out), ref=ref, fns=fns, root=root)


def test_search_command_equals_search_beam(searched, tmp_path):
    """Exit 0, the checkpoint cleaned, and every results file equal to
    search_beam's (tools/torch_results_diff.py: timing files by
    presence, .npz by arrays, tarballs by members) with the trace file
    set aside; the pulsar's period among the candidates."""
    assert searched["rc"] == 0
    out, ref = searched["out"], searched["ref"]
    names = sorted(os.listdir(out))
    assert ".checkpoint" not in names
    trace_file = f"{ref.basenm}_trace.json"
    assert trace_file in names
    cmp = tmp_path / "cmp"
    cmp.mkdir()
    for n in names:
        if n != trace_file:
            os.link(os.path.join(out, n), cmp / n)
    assert _tool("torch_results_diff").diff_results(
        str(cmp), ref.resultsdir) == []
    assert any(abs(c.period_s - 0.25) / 0.25 < 2e-3
               for c in ref.candidates)


def test_search_without_gpu_exits_2_naming_the_device(tmp_path,
                                                      monkeypatch,
                                                      capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with restore_job_globals():
        assert tmain.main(["search", str(tmp_path / "x.fits"),
                           "--outdir", str(out)]) == 2
    err = capsys.readouterr().err
    assert "search: cannot run on device 'cuda'" in err
    assert "no CUDA device" in err
    assert not out.exists()


# -------------------------------------------------------------- trace

def test_trace_command_matches_the_jax_command(searched, capsys):
    """The port's `trace` over the traced search's outdir prints the
    span table; the JAX package's `trace` prints the same table from
    the same file."""
    assert tmain.main(["trace", searched["out"]]) == 0
    text = capsys.readouterr().out
    assert "search_block" in text and "dm_chunk" in text
    assert "hi-accelsearch" in text
    assert jmain.main(["trace", searched["out"]]) == 0
    assert capsys.readouterr().out == text


@pytest.mark.parametrize("main", [tmain.main, jmain.main],
                         ids=["torch", "jax"])
def test_trace_command_without_a_trace_exits_1(tmp_path, main, capsys):
    assert main(["trace", str(tmp_path)]) == 1
    capsys.readouterr()


def test_trace_summarize_compares_with_the_report(searched, capsys):
    ts = _tool("torch_trace_summarize")
    out, base = searched["out"], searched["ref"].basenm
    report = os.path.join(out, f"{base}.report")
    assert ts.main([out, "--compare-report", report]) == 0, \
        capsys.readouterr().err
    text = capsys.readouterr().out
    assert "dedispersing" in text and "matches" in text
    assert ts.main([out, "--json"]) == 0
    obj = json.loads(capsys.readouterr().out)
    assert obj["n_events"] > 0 and "hi-accelsearch" in obj["rollup"]


def test_trace_summarize_flags_a_mismatch(searched, tmp_path, capsys):
    """A report stage 10% off the trace is a mismatch (exit 1)."""
    ts = _tool("torch_trace_summarize")
    out, base = searched["out"], searched["ref"].basenm
    stages = ts.parse_report_stages(os.path.join(out, f"{base}.report"))
    stage, secs = max(stages.items(), key=lambda kv: kv[1])
    assert secs > 0.5
    bad = tmp_path / "bad.report"
    bad.write_text(f"{stage}: {1.1 * secs + 0.06:.3f} s  (50.0%)\n")
    assert ts.main([out, "--compare-report", str(bad)]) == 1
    assert f"MISMATCH {stage}" in capsys.readouterr().err


# --------------------------------------------------------------- plan

@pytest.mark.parametrize("args", [
    ["--survey", "pdev"],
    ["--lodm", "0", "--hidm", "300", "--numchan", "64", "--dt", "1e-4",
     "--bw", "100", "--fctr", "1400", "--numsub", "16"],
    "mock-file"], ids=["survey", "geometry", "mock-file"])
def test_plan_text_equals_the_jax_command(searched, args, capsys):
    if args == "mock-file":
        args = list(searched["fns"])
    assert tmain.main(["plan", *args]) == 0
    got = capsys.readouterr().out
    assert jmain.main(["plan", *args]) == 0
    assert got == capsys.readouterr().out
    assert "loDM" in got and "trials" in got


# --------------------------------------------------------- checkpoint

def _age_free(text: str) -> str:
    return re.sub(r" +[\d.]+ s old", "", text)


@pytest.mark.parametrize("writer", [jckpt, tckpt], ids=["jax", "torch"])
def test_checkpoint_command_reads_either_packages_store(tmp_path, writer,
                                                        capsys):
    """Both packages' `checkpoint` and `checkpoint --verify` on a store
    the given package wrote: the same rows but for the age column,
    exit 0; with one byte of an artifact flipped `--verify` exits 1
    and names that artifact, in both."""
    root = str(tmp_path / "ck")
    store = writer.CheckpointStore(root, "fp-cli")
    assert store.save("rfifind", b"mask" * 16, kind="stage", ext=".npz")
    for i in range(3):
        assert store.save(f"pass_{i:04d}", bytes(range(i, i + 64)),
                          kind="pass", pass_idx=i)
    texts = {}
    for name, main in (("torch", tmain.main), ("jax", jmain.main)):
        assert main(["checkpoint", root]) == 0
        texts[name] = capsys.readouterr().out
        assert main(["checkpoint", root, "--verify"]) == 0
        assert "verify: OK" in capsys.readouterr().out
    assert _age_free(texts["torch"]) == _age_free(texts["jax"])
    assert "4 artifact(s)" in texts["torch"]
    for key in ("rfifind", "pass_0000", "pass_0001", "pass_0002"):
        assert f"  {key} " in texts["torch"]
    doc = writer.read_manifest(root)
    path = os.path.join(root, doc["entries"]["pass_0001"]["file"])
    with open(path, "r+b") as fh:
        b = fh.read(1)
        fh.seek(0)
        fh.write(bytes([b[0] ^ 0xFF]))
    for main in (tmain.main, jmain.main):
        assert main(["checkpoint", str(tmp_path / "ck"), "--verify"]) == 1
        text = capsys.readouterr().out
        assert "INVALID pass_0001" in text
        assert "verify: 1 invalid artifact(s)" in text


def test_checkpoint_command_finds_an_outdirs_checkpoint(tmp_path, capsys):
    outdir = tmp_path / "out"
    store = tckpt.CheckpointStore(tckpt.default_root(str(outdir)), "fp")
    assert store.save("pass_0000", b"x" * 8, kind="pass", pass_idx=0)
    assert tmain.main(["checkpoint", str(outdir)]) == 0
    assert ".checkpoint" in capsys.readouterr().out
    assert tmain.main(["checkpoint", str(tmp_path / "nothing")]) == 1
    assert "no readable checkpoint manifest" in capsys.readouterr().out


# ---------------------------------------------------------- blackbox

#: (health, faults) of each package: tests/test_health.py's flight
#: recorder cases run against both
HEALTH = {"jax": (jhealth, jfaults), "torch": (thealth, tfaults)}


@pytest.fixture(params=sorted(HEALTH))
def health_pkg(request):
    return HEALTH[request.param]


def test_blackbox_round_trip_and_render(tmp_path, health_pkg):
    health, _faults = health_pkg
    spool = str(tmp_path)
    box = health.FlightRecorder("w7", spool=spool, ring=16)
    for i in range(20):                      # overflow the ring
        box.note("claim", ticket=f"t{i}")
    path = box.dump(reason="unit test", rc=70)
    assert os.path.exists(path)
    assert box.dump() == ""                  # idempotent
    rec = health.load_blackbox(spool, "w7")
    assert not rec["torn"] and rec["bad_lines"] == 0
    assert len(rec["entries"]) == 16         # ring bound held
    assert rec["entries"][-1]["ticket"] == "t19"
    assert rec["header"]["rc"] == 70
    text = health.render_blackbox(spool, "w7")
    assert "t19" in text and "rc=70" in text
    assert "TORN" not in text


def test_blackbox_disabled_and_clean_exit(tmp_path, monkeypatch,
                                          health_pkg):
    health, _faults = health_pkg
    spool = str(tmp_path)
    monkeypatch.setenv("TPULSAR_BLACKBOX", "0")
    box = health.FlightRecorder("w0", spool=spool)
    box.note("claim", ticket="t")
    assert box.dump(reason="x") == ""
    monkeypatch.delenv("TPULSAR_BLACKBOX")
    # spool-less recorder is inert too
    assert not health.FlightRecorder("w0", spool="").enabled
    # armed then disarmed: the atexit hook becomes a no-op
    box = health.FlightRecorder("w1", spool=spool)
    box.arm()
    box.disarm()
    box._atexit()
    assert health.load_blackbox(spool, "w1") is None


def test_blackbox_torn_dump_salvage(tmp_path, health_pkg):
    health, faults = health_pkg
    spool = str(tmp_path)
    box = health.FlightRecorder("w2", spool=spool, ring=32)
    for i in range(10):
        box.note("journal", event="claimed", ticket=f"t{i}")
    faults.configure("blackbox.dump:unimplemented:errno=EIO")
    try:
        path = box.dump(reason="mid-dump death", rc=70)
    finally:
        faults.reset()
    rec = health.load_blackbox(spool, "w2")
    assert rec["path"] == path
    assert rec["torn"]                       # no end marker landed
    assert len(rec["entries"]) == 5          # first half salvaged
    text = health.render_blackbox(spool, "w2")
    assert "TORN DUMP" in text and "salvaged" in text
    # a garbage line is counted, never fatal
    with open(path, "a") as fh:
        fh.write("{not json\n")
    assert health.load_blackbox(spool, "w2")["bad_lines"] == 1


def test_obs_blackbox_command_renders_either_packages_dump(tmp_path,
                                                           capsys):
    """The port's `obs blackbox` renders a dump of the JAX package's
    recorder as the JAX command does, and exits 1 without a dump."""
    spool = str(tmp_path)
    box = jhealth.FlightRecorder("w3", spool=spool, ring=8)
    box.note("claim", ticket="tk")
    box.dump(reason="crash", rc=70)
    assert tmain.main(["obs", "blackbox", "w3", "--spool", spool]) == 0
    got = capsys.readouterr().out
    assert jmain.main(["obs", "blackbox", "w3", "--spool", spool]) == 0
    assert got == capsys.readouterr().out and "ticket=tk" in got
    assert tmain.main(["obs", "blackbox", "w9", "--spool", spool]) == 1
    assert "no blackbox dump" in capsys.readouterr().out


# -------------------------------------------- obs console, both backends

def _spool_url(tmp_path):
    return str(tmp_path / "spool")


def _sqlite_url(tmp_path):
    return f"sqlite:{tmp_path / 'spool' / 'queue.db'}"


@pytest.mark.parametrize("mk_url,backend", [
    (_spool_url, "spool"), (_sqlite_url, "sqlite")])
def test_obs_console_and_queue_ops_both_backends(tmp_path, mk_url,
                                                 backend, capsys):
    """tests/test_health.py's case on the port's queue, console and
    metrics; and the JAX package's `obs timeline` over the same
    journal prints what the port's does."""
    from tpulsar_torch.frontdoor.queue import get_ticket_queue
    from tpulsar_torch.obs import metrics, telemetry

    os.makedirs(tmp_path / "spool", exist_ok=True)
    url = mk_url(tmp_path)
    q = get_ticket_queue(url)
    spool = q.journal_root
    q.record_event("submitted", ticket="tk1")
    q.submit("tk1", [str(tmp_path / "b.fits")],
             str(tmp_path / "out"))
    q.heartbeat(worker_id="w0", status="idle")
    assert q.claim_next(worker_id="w0") is not None
    q.record_event("claimed", ticket="tk1", worker="w0")
    q.write_result("tk1", "done", rc=0)
    q.record_event("result", ticket="tk1", status="done")

    args = ["--queue", url] if backend == "sqlite" else []
    assert tmain.main(["obs", "timeline", "tk1", "--spool", spool]
                      + args) == 0
    text = capsys.readouterr().out
    assert "tk1" in text
    assert jmain.main(["obs", "timeline", "tk1", "--spool", spool]
                      + args) == 0
    assert capsys.readouterr().out == text
    assert tmain.main(["obs", "top", "--once", "--spool", spool]
                      + args) == 0
    assert "w0" in capsys.readouterr().out
    assert tmain.main(["obs", "tail", "--spool", spool] + args) == 0
    assert "submitted" in capsys.readouterr().out
    assert tmain.main(["obs", "timeline", "nope", "--spool", spool]
                      + args) == 1
    capsys.readouterr()

    # the queue-op histogram observed the SAME op vocabulary on both
    # backends (read_result is deliberately untimed)
    snap = metrics.REGISTRY.snapshot()
    series = snap[telemetry.queue_op_seconds().name]["series"]
    ops = {tuple(k.split("|")) for k in series}
    for op in ("submit", "claim", "result", "heartbeat"):
        assert (backend, op) in ops, (backend, op, sorted(ops))


def test_trace_summarize_spool_mode_over_sqlite(tmp_path, capsys):
    from tpulsar_torch.frontdoor.queue import get_ticket_queue

    ts = _tool("torch_trace_summarize")
    spool = tmp_path / "spool"
    os.makedirs(spool)
    url = f"sqlite:{spool / 'queue.db'}"
    q = get_ticket_queue(url)
    q.record_event("submitted", ticket="tk1")
    assert ts.main([str(spool), "--queue", url]) == 0
    assert "tk1" in capsys.readouterr().out


def test_obs_timeline_shows_a_takeover_in_order(tmp_path, capsys):
    """The chain chip_smoke's phase 12 reads: claimed by w0, takeover
    from w0, claimed by w1, one result."""
    from tpulsar_torch.frontdoor.queue import get_ticket_queue

    spool = tmp_path / "spool"
    os.makedirs(spool)
    url = f"sqlite:{spool / 'queue.db'}"
    q = get_ticket_queue(url)
    q.record_event("submitted", ticket="st")
    q.record_event("claimed", ticket="st", worker="w0")
    q.record_event("takeover", ticket="st", from_worker="w0")
    q.record_event("claimed", ticket="st", worker="w1")
    q.record_event("result", ticket="st", status="done", worker="w1")
    assert tmain.main(["obs", "timeline", "st", "--queue", url,
                       "--spool", str(spool)]) == 0
    rows = [ln.split() for ln in capsys.readouterr().out.splitlines()[3:]]
    assert [(r[2], r[3]) for r in rows] == [
        ("submitted", "-"), ("claimed", "w0"), ("takeover", "-"),
        ("claimed", "w1"), ("result", "w1")]
    assert "from_worker=w0" in rows[2]
    shutil.rmtree(spool)
