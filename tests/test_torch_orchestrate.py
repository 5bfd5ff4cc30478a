"""The port's orchestration layer (tpulsar_torch/orchestrate/ and the
daemon commands of tpulsar_torch/cli/main.py) against the JAX
package's: tests/test_orchestrate.py's cases, each run on both
packages' modules where it fits both; the tracker DB and the local
backend's queue state shared between the packages; the warm backend's
tickets claimed by the port's server; the port's own rules (the
default worker is the port's job, on the GPU or failing; a one-shot
downloader finishes the transfers it starts); and one slice test that
runs the whole pipeline through subprocesses — downloader, jobpool,
kill-jobs --fail, the retry resuming from the checkpoint, uploader —
and holds its results DB to the JAX pipeline's on the same input.

Tolerances: tracker rows, queue states, tickets and error texts
compare exactly.  The two results DBs of the slice test compare row
by row: integers and texts exactly, floats at rtol 1e-5 (the two
packages sum float32 values in other orders, as in
tools/torch_results_diff.py), blobs by what does not carry a time
(.npz by arrays at the same rtol, tarballs by member names, the
timing report and the metrics by presence, other files exactly)."""

from __future__ import annotations

import importlib
import json
import os
import stat
import subprocess
import sys
import tarfile
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_checkpoint import ROOT, _pass_keys  # noqa: E402
from test_torch_search_job import _subband_pair  # noqa: E402
from test_torch_serve import _results_diff  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
from tpulsar.io import synth  # noqa: E402
from tpulsar_torch import checkpoint as tckpt  # noqa: E402

PKGS = {"jax": "tpulsar", "torch": "tpulsar_torch"}
both = pytest.mark.parametrize("pkg", ["jax", "torch"])


def mod(pkg: str, path: str):
    """One package's module: mod("torch", "orchestrate.pool")."""
    return importlib.import_module(f"{PKGS[pkg]}.{path}")


@pytest.fixture(autouse=True)
def _no_leaks():
    yield
    for pkg in PKGS:
        mod(pkg, "resilience.faults").reset()
        mod(pkg, "obs.debugflags").set_allmodes_off()


def _tracker(pkg, tmp_path):
    return mod(pkg, "orchestrate.jobtracker").JobTracker(
        str(tmp_path / "tracker.db"))


def _fake_worker_script(tmp_path, body="touch $OUTDIR/done.marker\n"):
    script = tmp_path / "worker.sh"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def _add_beam_files(tracker, tmp_path, n_beams=1):
    """Write synthetic mock pairs and register them 'downloaded'."""
    fns = []
    for b in range(n_beams):
        spec = synth.BeamSpec(nchan=16, nsamp=512, nsblk=64,
                              beam_id=b % 8, scan=100 + b)
        pair = synth.synth_beam(str(tmp_path / "data"), spec, merged=False)
        for fn in pair:
            tracker.insert("files", filename=fn,
                           remote_filename=os.path.basename(fn),
                           size=os.path.getsize(fn), status="downloaded",
                           details="test fixture")
        fns.extend(pair)
    return fns


def _local(pkg, tmp_path, **kw):
    kw.setdefault("state_dir", str(tmp_path / "localq"))
    return mod(pkg, "orchestrate.queue_managers.local") \
        .LocalProcessManager(**kw)


def _wait_done(qm, qid, polls=100):
    for _ in range(polls):
        if not qm.is_running(qid):
            return
        time.sleep(0.1)
    raise AssertionError(f"{qid} still running")


# ------------------------------------------------- tracker, pool, local

@both
def test_jobtracker_basics(pkg, tmp_path):
    tracker = _tracker(pkg, tmp_path)
    fid = tracker.insert("files", filename="/tmp/x.fits", size=123,
                         status="new", details="")
    assert tracker.count("files") == 1
    tracker.update("files", fid, status="downloaded")
    row = tracker.query("SELECT * FROM files WHERE id=?", [fid],
                        fetchone=True)
    assert row["status"] == "downloaded"
    assert tracker.count("files", "downloaded") == 1
    # atomic multi-statement execute
    tracker.execute(
        ["INSERT INTO jobs (status, created_at, updated_at) "
         "VALUES ('new', '', '')",
         "UPDATE files SET status='added' WHERE id=?"], [[], [fid]])
    assert tracker.count("jobs") == 1


def test_tracker_and_results_schemas_are_the_jax_packages():
    """One schema text each, so either package's daemons open the
    other's databases."""
    for path in ("orchestrate.jobtracker", "orchestrate.results_db"):
        assert mod("torch", path).SCHEMA == mod("jax", path).SCHEMA, path


@both
def test_pool_full_lifecycle(pkg, tmp_path):
    """downloaded files -> job created -> submitted -> processed."""
    tracker = _tracker(pkg, tmp_path)
    _add_beam_files(tracker, tmp_path)
    qm = _local(pkg, tmp_path, max_jobs_running=2,
                script=_fake_worker_script(tmp_path))
    pool = mod(pkg, "orchestrate.pool").JobPool(
        tracker, qm, str(tmp_path / "results"), max_attempts=2)

    pool.rotate()   # creates + submits
    assert tracker.count("jobs", "submitted") == 1
    sub = tracker.query("SELECT * FROM job_submits", fetchone=True)
    assert sub["status"] == "running"
    # output dir scheme {base}/{mjd}/{obs_name}/{beam}/{date}
    parts = os.path.relpath(sub["output_dir"],
                            str(tmp_path / "results")).split(os.sep)
    assert len(parts) == 4
    assert parts[0] == "55555"  # int MJD
    assert parts[3] == time.strftime("%y%m%d")

    _wait_done(qm, sub["queue_id"])
    pool.rotate()   # sync from queue
    assert tracker.count("jobs", "processed") == 1
    assert os.path.exists(os.path.join(sub["output_dir"], "done.marker"))


@both
def test_pool_failure_retry_then_terminal(pkg, tmp_path):
    tracker = _tracker(pkg, tmp_path)
    _add_beam_files(tracker, tmp_path)
    notes = []
    qm = _local(pkg, tmp_path, max_jobs_running=2,
                script=_fake_worker_script(tmp_path,
                                           "echo boom >&2\nexit 3\n"))
    pool = mod(pkg, "orchestrate.pool").JobPool(
        tracker, qm, str(tmp_path / "results"), max_attempts=2,
        notify=lambda s, b: notes.append(s))

    for _ in range(6):
        pool.rotate()
        time.sleep(0.3)
        if tracker.count("jobs", "terminal_failure"):
            break
    assert tracker.count("jobs", "terminal_failure") == 1
    assert tracker.count("job_submits", "processing_failed") == 2
    assert notes and "terminally failed" in notes[0]
    sub = tracker.query("SELECT details FROM job_submits", fetchone=True)
    assert "boom" in sub["details"] or "exit code" in sub["details"]


@both
def test_local_get_errors_attributes_beam(pkg, tmp_path):
    """A dead pid's error text names the beam it was searching (the
    DATAFILES/OUTDIR contract recorded in the qid state file), so a
    restarted daemon can attribute failures without the tracker DB."""
    qm = _local(pkg, tmp_path, max_jobs_running=2,
                script=_fake_worker_script(tmp_path, "exit 7\n"))
    qid = qm.submit([str(tmp_path / "data" / "beamZ.fits")],
                    str(tmp_path / "outZ"), job_id=9)
    _wait_done(qm, qid, polls=50)
    assert qm.had_errors(qid)
    err = qm.get_errors(qid)
    assert "exit code 7" in err
    assert "beamZ.fits" in err and "outZ" in err


@both
def test_pool_shutdown_delegates_to_backend(pkg, tmp_path):
    tracker = _tracker(pkg, tmp_path)
    qm = _local(pkg, tmp_path, max_jobs_running=2,
                script=_fake_worker_script(tmp_path, "sleep 60\n"))
    _add_beam_files(tracker, tmp_path)
    pool = mod(pkg, "orchestrate.pool").JobPool(
        tracker, qm, str(tmp_path / "results"))
    pool.rotate()
    assert qm.status()[1] == 1
    assert pool.shutdown() == 1          # reaped the running child
    assert qm.status()[1] == 0


@both
def test_local_delete_kills_the_process_group(pkg, tmp_path):
    """delete() signals the job's whole process group (the worker the
    wrapper shell started included), the job stops counting as
    running, and a never-written rc file reads as a failure."""
    pidfile = tmp_path / "worker.pid"
    qm = _local(pkg, tmp_path, max_jobs_running=1,
                script=_fake_worker_script(
                    tmp_path, f"sleep 60 &\necho $! > {pidfile}\nwait\n"))
    qid = qm.submit([], str(tmp_path / "out"), job_id=1)
    for _ in range(100):
        if pidfile.exists() and pidfile.read_text().strip():
            break
        time.sleep(0.05)
    child = int(pidfile.read_text())
    assert qm.is_running(qid) and not qm.can_submit()
    assert qm.delete(qid) is True
    for _ in range(100):
        try:
            os.kill(child, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        raise AssertionError("the job's child survived delete()")
    assert not qm.is_running(qid) and qm.can_submit()
    assert qm.had_errors(qid) and "exit code 1" in qm.get_errors(qid)


@both
def test_queue_manager_registry(pkg, tmp_path):
    qms = mod(pkg, "orchestrate.queue_managers")
    qm = qms.get_queue_manager("local", max_jobs_running=1,
                               state_dir=str(tmp_path / "q"))
    assert qm.can_submit()
    with pytest.raises(ValueError):
        qms.get_queue_manager("nonexistent")
    # the same names in both packages, tpu_slice included
    for name, cls in (("slurm", "SlurmManager"), ("pbs", "PBSManager"),
                      ("moab", "MoabManager")):
        got = qms.get_queue_manager(name, script="job.sh")
        assert type(got).__name__ == cls
    got = qms.get_queue_manager("tpu_slice", hosts=["h1"])
    assert type(got).__name__ == "TPUSliceManager"
    got = qms.get_queue_manager("warm", spool=str(tmp_path / "spool"))
    assert type(got).__name__ == "WarmServerManager"


def test_default_workers_are_the_ports_job(tmp_path):
    """The local backend runs `python -m tpulsar_torch.cli.search_job`
    unless a submit script is configured; the accelerator-host backend
    names the same job and stamps its --qid."""
    from tpulsar_torch.orchestrate.queue_managers.local import (
        LocalProcessManager)
    from tpulsar_torch.orchestrate.queue_managers.tpu_slice import (
        TPUSliceManager)

    lp = LocalProcessManager(state_dir=str(tmp_path / "q"))
    assert lp._cmd().endswith(" -m tpulsar_torch.cli.search_job")
    lp = LocalProcessManager(state_dir=str(tmp_path / "q"),
                             script="/srv/my job.sh")
    assert lp._cmd() == "'/srv/my job.sh'"
    ts = TPUSliceManager(hosts=["h1"])
    assert ts.remote_cmd == "python -m tpulsar_torch.cli.search_job"
    assert ts.qid_flag is True
    assert TPUSliceManager(hosts=["h1"], remote_cmd="run.sh").qid_flag \
        is False


def test_default_local_worker_fails_without_a_gpu(tmp_path):
    """With no submit script the local backend's job is the port's,
    on the GPU: on a host without one (here: none visible) the job
    fails, and the pool records the failure with the job's own error
    — it never searches on the CPU instead."""
    from tpulsar_torch.orchestrate.jobtracker import JobTracker
    from tpulsar_torch.orchestrate.pool import JobPool
    from tpulsar_torch.orchestrate.queue_managers.local import (
        LocalProcessManager)

    tracker = JobTracker(str(tmp_path / "tracker.db"))
    _add_beam_files(tracker, tmp_path)
    qm = LocalProcessManager(
        state_dir=str(tmp_path / "localq"),
        env_extra={"PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": "",
                   "OMP_NUM_THREADS": "1",
                   "TPULSAR_WORKDIR_BASE": str(tmp_path / "work")})
    pool = JobPool(tracker, qm, str(tmp_path / "results"),
                   max_attempts=1)
    pool.rotate()
    sub = tracker.query("SELECT * FROM job_submits", fetchone=True)
    _wait_done(qm, sub["queue_id"], polls=600)
    pool.rotate()
    assert tracker.count("jobs", "terminal_failure") == 1
    details = tracker.query("SELECT details FROM job_submits",
                            fetchone=True)["details"]
    assert "exit code 1" in details and "no CUDA device" in details
    assert not [n for n in os.listdir(sub["output_dir"])
                if not n.endswith(".stderr")]


# ------------------------------------------------------- across packages

@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_tracker_and_local_queue_cross_packages(tmp_path, writer,
                                                reader, capsys):
    """One package's pool creates and submits a job into a tracker DB
    and the local backend's state directory; the other package's
    JobTracker and `status` command read it, and its pool syncs the
    finished job from that queue state to 'processed'."""
    tw = _tracker(writer, tmp_path)
    _add_beam_files(tw, tmp_path)
    script = _fake_worker_script(tmp_path)
    qw = _local(writer, tmp_path, max_jobs_running=1, script=script)
    mod(writer, "orchestrate.pool").JobPool(
        tw, qw, str(tmp_path / "results")).rotate()
    tr = _tracker(reader, tmp_path)
    assert tr.count("jobs", "submitted") == 1
    assert tr.count("files", "downloaded") == 2
    sub = tr.query("SELECT * FROM job_submits", fetchone=True)
    qr = _local(reader, tmp_path, max_jobs_running=1, script=script)
    _wait_done(qr, sub["queue_id"])
    mod(reader, "orchestrate.pool").JobPool(
        tr, qr, str(tmp_path / "results")).rotate()
    assert tw.count("jobs", "processed") == 1
    capsys.readouterr()
    assert mod(reader, "cli.main").main(
        ["--db", str(tmp_path / "tracker.db"), "status"]) == 0
    out = capsys.readouterr().out
    assert "jobs: processed=1" in out
    assert "job_submits: processed=1" in out


@pytest.mark.parametrize("client", ["jax", "torch"])
def test_warm_backend_tickets_are_claimed_by_the_ports_server(
        tmp_path, client, monkeypatch):
    """Either package's warm backend, driven by the port's job pool,
    sees the port server's heartbeat as fresh, writes the job as a
    ticket, and the server claims and answers it (device work
    stubbed): the job ends 'processed' with the pool never forking a
    search process."""
    from tpulsar_torch import config as tcfg
    from tpulsar_torch.orchestrate.jobtracker import JobTracker
    from tpulsar_torch.orchestrate.pool import JobPool
    from tpulsar_torch.serve import protocol as tprotocol
    from tpulsar_torch.serve.server import SearchServer

    cfg = tcfg.TpulsarConfig()
    cfg.basic.log_dir = str(tmp_path / "logs")
    cfg.processing.base_working_directory = str(tmp_path / "work")
    cfg.processing.base_results_directory = str(tmp_path / "res")
    cfg.check_sanity(create_dirs=True)
    spool = str(tmp_path / "spool")
    claimed = []

    def stub(prepared):
        claimed.append(prepared.ticket_id)
        return type("Outcome", (), dict(compile_misses=0, compile_hits=1,
                                        candidates=[], num_dm_trials=8))()

    srv = SearchServer(spool=spool, cfg=cfg, warm_boot=False, poll_s=0.05,
                       device="cpu", beam_fn=stub,
                       heartbeat_interval_s=0.2)
    th = threading.Thread(target=srv.serve, daemon=True)
    th.start()
    try:
        tracker = JobTracker(str(tmp_path / "tracker.db"))
        _add_beam_files(tracker, tmp_path)
        qm = mod(client, "orchestrate.queue_managers.warm") \
            .WarmServerManager(spool=spool, max_queue_depth=4,
                               fallback_kwargs={"state_dir": str(
                                   tmp_path / "localq")})
        deadline = time.time() + 30
        while not qm.server_available():
            assert time.time() < deadline, "no fresh heartbeat"
            time.sleep(0.05)
        pool = JobPool(tracker, qm, str(tmp_path / "res"))
        pool.rotate()
        sub = tracker.query("SELECT * FROM job_submits", fetchone=True)
        assert sub["queue_id"].startswith("warm-")
        while qm.is_running(sub["queue_id"]):
            assert time.time() < deadline, "ticket never finished"
            time.sleep(0.05)
        pool.rotate()
    finally:
        srv.request_drain()
        th.join(timeout=30)
    assert not th.is_alive()
    assert claimed == [sub["queue_id"]]
    assert tracker.count("jobs", "processed") == 1
    assert tprotocol.read_result(spool, sub["queue_id"])["status"] \
        == "done"
    assert qm._fallback is None          # no process was forked


# ------------------------------------------------------------ downloader

@both
def test_downloader_end_to_end(pkg, tmp_path):
    dl = mod(pkg, "orchestrate.downloader")
    tracker = _tracker(pkg, tmp_path)
    remote = tmp_path / "remote"
    pool_dir = remote / "pool"
    pool_dir.mkdir(parents=True)
    for i in range(3):
        (pool_dir / f"beam{i}.fits").write_bytes(b"x" * (1000 + i))

    service = dl.LocalRestoreService(str(remote))
    transport = dl.LocalTransport(str(remote))
    d = dl.Downloader(tracker, service, transport,
                      datadir=str(tmp_path / "rawdata"),
                      space_to_use=10 ** 9, min_free_space=0,
                      numdownloads=2, numretries=2)

    d.run()          # makes the first restore request
    assert tracker.count("requests", "waiting") == 1
    d.run()          # request ready -> files listed -> downloads start
    for _ in range(50):
        d.run()
        if tracker.count("files", "downloaded") >= 3:
            break
        time.sleep(0.05)
    assert tracker.count("files", "downloaded") >= 3
    st = d.status()
    assert st["files_downloaded"] >= 3
    assert st["used_space_bytes"] > 0
    row = tracker.query("SELECT * FROM files WHERE status='downloaded'",
                        fetchone=True)
    assert os.path.getsize(row["filename"]) == row["size"]


@both
def test_downloader_retry_and_terminal(pkg, tmp_path):
    dl = mod(pkg, "orchestrate.downloader")
    tracker = _tracker(pkg, tmp_path)
    remote = tmp_path / "remote"
    (remote / "pool").mkdir(parents=True)
    (remote / "pool" / "beam0.fits").write_bytes(b"y" * 500)
    service = dl.LocalRestoreService(str(remote))
    transport = dl.LocalTransport(str(remote), fail_every=1)  # always fail
    d = dl.Downloader(tracker, service, transport,
                      datadir=str(tmp_path / "rawdata"),
                      space_to_use=10 ** 9, min_free_space=0,
                      numretries=2)
    for _ in range(30):
        d.run()
        for th in list(d._threads.values()):
            th.join(timeout=10)
        if tracker.count("files", "terminal_failure"):
            break
    assert tracker.count("files", "terminal_failure") == 1
    attempts = tracker.query(
        "SELECT COUNT(*) c FROM download_attempts", fetchone=True)["c"]
    assert attempts >= 2


@both
def test_exhausted_archive_backs_off_requests(pkg, tmp_path):
    """Once every listed file is tracked, a restore that comes back
    empty starts a cooloff instead of firing a new (and equally
    empty) request every cycle."""
    dl = mod(pkg, "orchestrate.downloader")
    tracker = _tracker(pkg, tmp_path)
    remote = tmp_path / "remote"
    (remote / "pool").mkdir(parents=True)
    (remote / "pool" / "beam0.fits").write_bytes(b"z" * 400)
    d = dl.Downloader(tracker, dl.LocalRestoreService(str(remote)),
                      dl.LocalTransport(str(remote)),
                      datadir=str(tmp_path / "raw"),
                      space_to_use=10 ** 9, min_free_space=0,
                      numretries=1)
    for _ in range(20):
        d.run()
        for th in list(d._threads.values()):
            th.join(timeout=10)
        if tracker.count("files", "downloaded"):
            break
    for _ in range(10):
        d.run()
    nreq = tracker.count("requests")
    assert nreq <= 3, f"{nreq} restore requests fired after exhaustion"


def test_transports_are_one_copy():
    """The downloader and the zaplist refresh use the one copy of the
    transports (orchestrate/transports.py), with the JAX package's
    methods and signatures."""
    import inspect

    from tpulsar.orchestrate import downloader as jdl
    from tpulsar_torch.orchestrate import downloader as tdl
    from tpulsar_torch.orchestrate import transports, zaplists

    assert tdl.LocalTransport is transports.LocalTransport
    assert tdl.HTTPTransport is transports.HTTPTransport
    assert isinstance(zaplists._transport_for("/x"),
                      transports.LocalTransport)
    assert isinstance(zaplists._transport_for("http://h/x"),
                      transports.HTTPTransport)
    for name in ("LocalTransport", "HTTPTransport"):
        jc, tc = getattr(jdl, name), getattr(transports, name)
        for meth in ("__init__", "list_files", "size", "modtime",
                     "fetch"):
            assert inspect.signature(getattr(tc, meth)) == \
                inspect.signature(getattr(jc, meth)), (name, meth)


def test_one_shot_downloader_finishes_its_transfers(tmp_path):
    """`downloader --once` in a fresh process each time: a transfer
    that outlasts the iteration (here slowed by a download.transfer
    delay fault) still arrives, because the iteration joins the
    transfers it started before the process exits — restore request,
    then location and fetch, then the size check, one process each."""
    remote = tmp_path / "remote"
    (remote / "pool").mkdir(parents=True)
    (remote / "pool" / "beam0.fits").write_bytes(os.urandom(20000))
    cfg = _daemon_config(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT, TPULSAR_CONFIG=cfg,
               TPULSAR_FAULTS="download.transfer:delay:seconds=1.0")
    statuses = []
    for _ in range(3):
        res = subprocess.run(
            [sys.executable, "-m", "tpulsar_torch", "downloader", "--once",
             "--remote-root", str(remote)], env=env, capture_output=True,
            text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        statuses.append(res.stdout.strip().splitlines()[-1])
    assert "'files_downloaded': 0" in statuses[1]
    assert "'files_downloaded': 1" in statuses[2], statuses
    got = tmp_path / "raw" / "beam0.fits"
    assert got.read_bytes() == (remote / "pool" / "beam0.fits").read_bytes()


_DAEMON_PROBE = r"""
import runpy, sys
sys.argv = ["tpulsar_torch"] + sys.argv[1:]
try:
    runpy.run_module("tpulsar_torch", run_name="__main__")
except SystemExit as e:
    print("EXIT:%s" % e.code)
print("TORCH:%s" % ("torch" in sys.modules))
"""


@pytest.mark.parametrize("argv", [
    ["init-db"], ["jobpool", "--once"], ["uploader", "--once"],
    ["downloader", "--once", "--remote-root", "{remote}"], ["status"],
    ["show", "processing"], ["kill-jobs"], ["stats"]])
def test_daemons_never_import_torch(tmp_path, argv):
    """The daemons and operator commands are control plane: in a fresh
    process they run without importing torch, so they never touch
    CUDA (the jobs they submit own the device)."""
    (tmp_path / "remote" / "pool").mkdir(parents=True)
    argv = [a.format(remote=tmp_path / "remote") for a in argv]
    env = dict(os.environ, PYTHONPATH=ROOT,
               TPULSAR_CONFIG=_daemon_config(tmp_path))
    res = subprocess.run([sys.executable, "-c", _DAEMON_PROBE, *argv],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path))
    assert "EXIT:0" in res.stdout, (res.stdout, res.stderr)
    assert "TORCH:False" in res.stdout, res.stdout


@both
def test_http_restore_service_and_transport(pkg, tmp_path):
    """HTTPRestoreService + HTTPTransport against a local fixture HTTP
    server (the hermetic stand-in for the reference's web service +
    FTPS stack)."""
    import http.server
    import urllib.parse

    dl = mod(pkg, "orchestrate.downloader")
    pool = tmp_path / "pool"
    pool.mkdir()
    (pool / "beam1.fits").write_bytes(b"x" * 100)
    restored = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _text(self, body, code=200):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_HEAD(self):
            p = pool / os.path.basename(self.path)
            if p.exists():
                self.send_response(200)
                self.send_header("Content-Length",
                                 str(p.stat().st_size))
                self.end_headers()
            else:
                self.send_response(404)
                self.end_headers()

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(url.query)
            if url.path == "/restore":
                restored["g1"] = int(q["num"][0])
                self._text("g1")
            elif url.path == "/location":
                self._text("g1" if q["guid"][0] in restored else "")
            elif url.path.endswith("index.txt"):
                self._text("beam1.fits 100\n")
            else:
                p = pool / os.path.basename(url.path)
                self._text(p.read_text() if p.exists() else "", 200)

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        svc = dl.HTTPRestoreService(base)
        assert svc.location("g1") is None
        guid = svc.request_restore(5, 4, "mock")
        assert guid == "g1" and restored == {"g1": 5}
        assert svc.location("g1") == "g1"
        tr = dl.HTTPTransport(base)
        files = tr.list_files("g1")
        assert files == ["g1/beam1.fits"]
        assert tr.size(files[0]) == 100
        dst = tmp_path / "got.fits"
        tr.fetch(files[0], str(dst))
        assert dst.stat().st_size == 100
    finally:
        srv.shutdown()


@both
def test_zaplist_refresh_modtime_semantics(pkg, tmp_path):
    """Remote-zaplist refresh: fetch when newer, skip when the cached
    copy is current, force overrides; no path-escaping member is ever
    extracted."""
    refresh_zaplists = mod(pkg, "orchestrate.zaplists").refresh_zaplists
    remote = tmp_path / "remote"
    remote.mkdir()
    (remote / "b1.zaplist").write_text("60.0 0.05\n")
    (remote / "evil.txt").write_text("not a zaplist\n")
    tarpath = remote / "zaplists.tar.gz"
    with tarfile.open(tarpath, "w:gz") as tf:
        tf.add(remote / "b1.zaplist", arcname="b1.zaplist")
        tf.add(remote / "evil.txt", arcname="../evil.txt")
    zapdir = str(tmp_path / "zaps")
    assert refresh_zaplists(zapdir, str(remote)) is True
    assert os.path.exists(os.path.join(zapdir, "b1.zaplist"))
    assert not os.path.exists(os.path.join(zapdir, "..", "evil.txt"))
    assert not os.path.exists(os.path.join(zapdir, "evil.txt"))
    assert refresh_zaplists(zapdir, str(remote)) is False
    future = time.time() + 60
    os.utime(tarpath, (future, future))
    assert refresh_zaplists(zapdir, str(remote)) is True
    assert refresh_zaplists(zapdir, str(remote), force=True) is True


# ------------------------------------------------------ config, CLI bits

@both
def test_config_validation(pkg, tmp_path):
    c = mod(pkg, "config")
    cfg = c.TpulsarConfig()
    cfg.basic.log_dir = str(tmp_path / "logs")
    cfg.background.jobtracker_db = str(tmp_path / "jt.db")
    cfg.download.datadir = str(tmp_path / "raw")
    cfg.processing.base_working_directory = str(tmp_path / "work")
    cfg.processing.base_results_directory = str(tmp_path / "res")
    cfg.resultsdb.url = str(tmp_path / "results.db")
    cfg.check_sanity(create_dirs=True)   # no raise

    cfg.jobpooler.queue_manager = "bogus"
    cfg.email.enabled = True
    cfg.email.recipient = ""
    with pytest.raises(c.InsaneConfigsError) as ei:
        cfg.check_sanity(create_dirs=True)
    msg = str(ei.value)
    assert "queue_manager" in msg and "recipient" in msg

    cfgfile = tmp_path / "conf.py"
    cfgfile.write_text(
        f"download = {{'numdownloads': 7}}\n"
        f"basic = {{'log_dir': {str(tmp_path / 'logs')!r}}}\n"
        f"background = {{'jobtracker_db': {str(tmp_path / 'jt.db')!r}}}\n"
        f"processing = {{'base_working_directory': "
        f"{str(tmp_path / 'work')!r}, "
        f"'base_results_directory': {str(tmp_path / 'res')!r}}}\n"
        f"resultsdb = {{'url': {str(tmp_path / 'results.db')!r}}}\n")
    loaded = c.load_config(str(cfgfile))
    assert loaded.download.numdownloads == 7


@both
def test_config_tpu_slice_requires_hosts(pkg):
    c = mod(pkg, "config")
    cfg = c.TpulsarConfig()
    cfg.jobpooler.queue_manager = "tpu_slice"
    with pytest.raises(c.InsaneConfigsError, match="tpu_hosts"):
        cfg.check_sanity(create_dirs=True)
    cfg.jobpooler.tpu_hosts = "a,b"
    cfg.check_sanity(create_dirs=True)


@both
def test_search_params_from_config(pkg):
    sc = mod(pkg, "config.core").SearchingConfig(
        hi_accel_zmax=0, sifting_sigma_threshold=6.5,
        max_cands_to_fold=7, nsub=32)
    p = mod(pkg, "search.executor").SearchParams.from_config(sc)
    assert p.run_hi_accel is False          # zmax=0 disables the stage
    assert p.sifting.sigma_threshold == 6.5
    assert p.max_cands_to_fold == 7
    assert p.nsub == 32


@both
def test_daemon_notify_sink(pkg, monkeypatch, capsys, tmp_path):
    """_notify routes daemon crash reports through the alert notifier
    plane: a command: spec proves the alert JSON reaches the sink; a
    bad spec falls back to log instead of killing the daemon."""
    cli = mod(pkg, "cli.main")
    alerts = mod(pkg, "obs.alerts")
    out = tmp_path / "alert.json"
    monkeypatch.setenv(
        "TPULSAR_ALERT_NOTIFY",
        f"command:{sys.executable} -c "
        f"\"import sys, pathlib; pathlib.Path({str(out)!r})"
        f".write_text(sys.stdin.read())\"")
    send = cli._notify(mod(pkg, "config").TpulsarConfig())
    send("test failure", "it broke")
    rec = json.loads(out.read_text())
    assert rec["subject"] == "test failure"
    assert rec["body"] == "it broke"
    assert rec["rule"] == "daemon_error"

    monkeypatch.setenv("TPULSAR_ALERT_NOTIFY", "smtp:nope")
    cli._notify(mod(pkg, "config").TpulsarConfig())("x", "y")
    assert "falling back to log" in capsys.readouterr().err
    with pytest.raises(ValueError):
        alerts.make_notifier("smtp:nope")
    assert type(alerts.make_notifier("webhook:http://x/y")).__name__ \
        == "WebhookNotifier"
    with pytest.raises(ValueError):
        alerts.make_notifier("webhook:")


@both
def test_debugflags_cli(pkg):
    import argparse

    debugflags = mod(pkg, "obs.debugflags")
    p = argparse.ArgumentParser()
    debugflags.add_cli_flags(p)
    args = p.parse_args(["--debug-jobtracker"])
    debugflags.apply_cli_flags(args)
    assert debugflags.is_on("jobtracker")
    assert not debugflags.is_on("upload")
    debugflags.set_allmodes_off()
    assert mod("torch", "obs.debugflags").MODES == \
        mod("jax", "obs.debugflags").MODES


def test_cli_has_the_jax_daemon_commands_and_flags():
    """The twelve orchestration commands, with the JAX CLI's
    arguments, and the global --db and --debug-* flags."""
    from tpulsar.cli.main import build_parser as jparser
    from tpulsar_torch.cli.main import build_parser as tparser

    def commands(p):
        sub = next(a for a in p._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {name: sorted(a.dest for a in sp._actions)
                for name, sp in sub.choices.items()}

    def flags(p):
        return sorted(a.dest for a in p._actions
                      if a.__class__.__name__ != "_SubParsersAction")

    jc, tc = commands(jparser()), commands(tparser())
    names = ("init-db", "add-files", "downloader", "jobpool", "uploader",
             "status", "show", "kill-jobs", "remove-files", "stats",
             "monitor", "db-shell")
    for name in names:
        assert tc[name] == jc[name], name
    assert flags(tparser()) == flags(jparser())
    # all 28 of the JAX CLI's, `aot` included (test_torch_cli_ops.py
    # holds the operator commands' arguments to the JAX CLI's)
    assert len(tc) == 28


def _daemon_config(root, **extra) -> str:
    """A python configuration file with every path under root."""
    doms = {"processing": {"base_working_directory": str(root / "work"),
                           "base_results_directory": str(root / "res")},
            "basic": {"log_dir": str(root / "logs")},
            "download": {"datadir": str(root / "raw"),
                         "min_free_space": 0},
            "background": {"jobtracker_db": str(root / "jt.db")},
            "resultsdb": {"url": str(root / "results.db")}}
    for dom, kv in extra.items():
        doms.setdefault(dom, {}).update(kv)
    path = root / "cfg.py"
    path.write_text("".join(f"{d} = {kv!r}\n" for d, kv in doms.items()))
    return str(path)


@pytest.fixture()
def restore_settings():
    """`main(["--config", ...])` installs the configuration in the
    process: drop it afterwards."""
    from tpulsar_torch import config as tcfg

    yield
    tcfg.set_settings(None)


def test_operator_commands_on_a_tracker(tmp_path, capsys, monkeypatch,
                                        restore_settings):
    """init-db, add-files (type, beam-7 and duplicate checks), show,
    remove-files, stats and monitor --once on one tracker, through the
    port's CLI in process."""
    from tpulsar_torch.cli.main import main
    from tpulsar_torch.orchestrate.jobtracker import JobTracker

    db = str(tmp_path / "jt.db")
    cfg = _daemon_config(tmp_path)
    # main exports the --config path; the monkeypatch restores the
    # variable when the test ends
    monkeypatch.setenv("TPULSAR_CONFIG", cfg)
    assert main(["--config", cfg, "--db", db, "init-db"]) == 0
    fns = synth.synth_beam(str(tmp_path / "data"),
                           synth.BeamSpec(nchan=16, nsamp=512, nsblk=64),
                           merged=False)
    b7 = synth.synth_beam(str(tmp_path / "data7"),
                          synth.BeamSpec(nchan=16, nsamp=512, nsblk=64,
                                         beam_id=7), merged=False)
    junk = tmp_path / "notes.txt"
    junk.write_text("x")
    capsys.readouterr()
    assert main(["--db", db, "add-files", *fns, b7[0], str(junk),
                 str(tmp_path / "missing.fits")]) == 0
    out = capsys.readouterr().out
    assert "added 2 files" in out and "beam 7" in out
    assert "does not exist" in out
    assert main(["--db", db, "add-files", fns[0]]) == 0
    assert "already tracked" in capsys.readouterr().out
    t = JobTracker(db)
    assert t.count("files", "added") == 2
    assert main(["--db", db, "show", "uploading"]) == 0
    assert "nothing uploading" in capsys.readouterr().out
    fid = t.query("SELECT id FROM files", fetchone=True)["id"]
    assert main(["--db", db, "remove-files", str(fid)]) == 0
    assert t.count("files", "deleted") == 1
    assert not os.path.exists(fns[0])
    capsys.readouterr()
    assert main(["--config", cfg, "--db", db, "stats"]) == 0
    out = capsys.readouterr().out
    assert "files:" in out and "'deleted': 1" in out
    assert main(["--config", cfg, "--db", db, "monitor", "--once"]) == 0
    assert "nothing in flight" in capsys.readouterr().out


# ------------------------------------------------- the CLI queue backends

@both
def test_slurm_registry_survives_restart(pkg, tmp_path):
    """had_errors/get_errors work after the daemon restarts (stderr
    map persisted, not in-memory)."""
    SlurmManager = mod(pkg, "orchestrate.queue_managers.slurm") \
        .SlurmManager
    outdir = tmp_path / "out"
    state = str(tmp_path / "slurm.json")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)

        class R:
            returncode = 0
            stdout = "4242\n"
            stderr = ""
        return R()

    qm = SlurmManager(script="job.sh", state_file=state, runner=fake_run)
    qid = qm.submit(["/does/not/matter"], str(outdir), job_id=7)
    assert qid == "4242" and calls[0][-1] == "job.sh"
    (outdir / "job7.stderr").write_text("Traceback: boom\n")
    qm2 = SlurmManager(script="job.sh", state_file=state, runner=fake_run)
    assert qm2.had_errors(qid)
    assert "boom" in qm2.get_errors(qid)


@both
def test_tpu_slice_restart_and_exit_markers(pkg, tmp_path):
    """Exit-code markers make liveness/error state restart-safe, and
    a restarted pool does not see phantom free-host capacity."""
    TPUSliceManager = mod(pkg, "orchestrate.queue_managers.tpu_slice") \
        .TPUSliceManager
    outdir = str(tmp_path / "out")
    state = str(tmp_path / "tpu.json")
    qm = TPUSliceManager(hosts=["h1"], launcher="sh -c {cmd}",
                         remote_cmd="sleep 5; true", state_file=state)
    qid = qm.submit([], outdir, job_id=1)
    assert qm.is_running(qid)
    assert not qm.can_submit()          # single host is busy
    qm2 = TPUSliceManager(hosts=["h1"], launcher="sh -c {cmd}",
                          state_file=state)
    assert qm2.is_running(qid)          # still running per registry
    assert not qm2.can_submit()         # host still considered busy
    qm.delete(qid)

    qm3 = TPUSliceManager(hosts=["h1"], launcher="sh -c {cmd}",
                          remote_cmd="true", state_file=state)
    qid2 = qm3.submit([], outdir, job_id=2)
    for _ in range(300):
        if not qm3.is_running(qid2):
            break
        time.sleep(0.1)
    assert not qm3.is_running(qid2)
    assert not qm3.had_errors(qid2)

    qm4 = TPUSliceManager(hosts=["h1"], launcher="sh -c {cmd}",
                          remote_cmd="false", state_file=state)
    qid4 = qm4.submit([], outdir, job_id=4)
    for _ in range(300):
        if not qm4.is_running(qid4):
            break
        time.sleep(0.1)
    assert qm4.had_errors(qid4)
    assert "exit code 1" in qm4.get_errors(qid4)


@both
def test_tpu_slice_handleless_delete_kills_remote(pkg, tmp_path):
    """A restart-orphaned delete kills the remote process through the
    launcher; an unreachable host keeps the slot reserved."""
    TPUSliceManager = mod(pkg, "orchestrate.queue_managers.tpu_slice") \
        .TPUSliceManager
    outdir = str(tmp_path / "out")
    state = str(tmp_path / "tpu.json")
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import os, sys, time\n"
        "open(os.path.join(%r, 'worker.pid'), 'w')"
        ".write(str(os.getpid()))\n"
        "time.sleep(60)\n" % outdir)
    qm = TPUSliceManager(hosts=["h1"], launcher="sh -c {cmd}",
                         remote_cmd=f"{sys.executable} {worker}",
                         state_file=state, qid_flag=True)
    qid = qm.submit([], outdir, job_id=1)
    pidfile = os.path.join(outdir, "worker.pid")
    for _ in range(100):
        if os.path.exists(pidfile) and open(pidfile).read():
            break
        time.sleep(0.1)
    pid = int(open(pidfile).read())
    os.kill(pid, 0)
    qm2 = TPUSliceManager(hosts=["h1"], launcher="sh -c {cmd}",
                          state_file=state)
    assert qm2.is_running(qid)
    assert qm2.delete(qid) is True
    assert not qm2.is_running(qid)
    for _ in range(100):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        raise AssertionError("remote worker survived handle-less delete")
    assert qm2.can_submit()
    qid2 = qm.submit([], outdir, job_id=2)
    qm3 = TPUSliceManager(hosts=["h1"],
                          launcher="definitely-not-a-launcher {host} {cmd}",
                          state_file=state)
    assert qm3.delete(qid2) is False
    assert qm3.is_running(qid2)
    assert not qm3.can_submit()
    qm.delete(qid2)


def _moab_showq_xml(jobs):
    buckets: dict[str, list[str]] = {"active": [], "eligible": [],
                                     "blocked": []}
    for option, qid, name, state in jobs:
        buckets[option].append(
            f'<job JobID="{qid}" JobName="{name}" State="{state}"/>')
    queues = "".join(
        f'<queue option="{opt}">{"".join(rows)}</queue>'
        for opt, rows in buckets.items())
    return f"<Data>{queues}</Data>"


class _MoabFake:
    """Scriptable msub/showq/canceljob runner with a call log."""

    def __init__(self):
        self.calls: list[list[str]] = []
        self.msub_replies: list[tuple[str, str]] = [("12345\n", "")]
        self.showq_jobs: list = []
        self.showq_comm_err = False
        self.showq_comm_err_n = 0

    def __call__(self, cmd, **kw):
        self.calls.append(list(cmd))

        class R:
            returncode = 0
            stdout = ""
            stderr = ""

        r = R()
        if cmd[0] == "msub":
            out, err = (self.msub_replies.pop(0)
                        if self.msub_replies else ("", ""))
            r.stdout, r.stderr = out, err
        elif cmd[0] == "showq":
            if self.showq_comm_err_n > 0:
                self.showq_comm_err_n -= 1
                r.stderr = "ERROR: lost communication error with server"
            elif self.showq_comm_err:
                r.stderr = "ERROR: lost communication error with server"
            else:
                r.stdout = _moab_showq_xml(self.showq_jobs)
        return r

    def n(self, prog: str) -> int:
        return sum(1 for c in self.calls if c[0] == prog)


def _moab(pkg, fake, tmp_path, **kw):
    MoabManager = mod(pkg, "orchestrate.queue_managers.moab").MoabManager
    kw.setdefault("state_file", str(tmp_path / "moab.json"))
    kw.setdefault("retry_wait_s", 0.0)
    kw.setdefault("sleeper", lambda s: None)
    return MoabManager(script="job.sh", runner=fake, **kw)


@both
def test_moab_submit_walltime_and_registry(pkg, tmp_path):
    fake = _MoabFake()
    datafile = tmp_path / "beam.fits"
    datafile.write_bytes(b"x" * (2 ** 30 // 10))      # 0.1 GB
    outdir = tmp_path / "out"
    qm = _moab(pkg, fake, tmp_path, walltime_per_gb=50.0)
    qid = qm.submit([str(datafile)], str(outdir), job_id=3)
    assert qid == "12345"
    msub = next(c for c in fake.calls if c[0] == "msub")
    assert any("walltime=5:00:00" in a for a in msub)
    assert any("DATAFILES=" in a for a in msub)
    (outdir / "job3.stderr").write_text("boom\n")
    qm2 = _moab(pkg, _MoabFake(), tmp_path)
    assert qm2.had_errors(qid)
    assert "boom" in qm2.get_errors(qid)


@both
def test_moab_lost_msub_reply_recovered_by_job_name(pkg, tmp_path):
    fake = _MoabFake()
    fake.msub_replies = [("", "moab communication error (timeout)")]
    fake.showq_jobs = [("eligible", "777", "tpulsar9", "Idle")]
    qm = _moab(pkg, fake, tmp_path)
    assert qm.submit([], str(tmp_path / "out"), job_id=9) == "777"
    assert fake.n("msub") == 1            # never resubmitted


@both
def test_moab_comm_error_blocks_submission_and_assumes_alive(pkg,
                                                             tmp_path):
    fake = _MoabFake()
    fake.showq_jobs = [("active", "55", "tpulsar1", "Running")]
    qm = _moab(pkg, fake, tmp_path, showq_ttl_s=0.0)
    assert qm.is_running("55")
    fake.showq_comm_err = True
    assert qm.status() == (9999, 9999)
    assert not qm.can_submit()
    assert qm.is_running("55")
    assert qm.is_running("does-not-exist")


@both
def test_moab_showq_ttl_cache(pkg, tmp_path):
    fake = _MoabFake()
    fake.showq_jobs = [("active", "55", "tpulsar1", "Running"),
                       ("blocked", "56", "tpulsar2", "Hold")]
    now = [0.0]
    qm = _moab(pkg, fake, tmp_path, showq_ttl_s=300.0,
               clock=lambda: now[0])
    assert qm.status() == (1, 1)
    for _ in range(5):
        qm.status()
        qm.is_running("55")
    assert fake.n("showq") == 1
    now[0] = 301.0
    qm.status()
    assert fake.n("showq") == 2


@both
def test_moab_delete_verifies_departure(pkg, tmp_path):
    fake = _MoabFake()
    fake.showq_jobs = [("active", "55", "tpulsar1", "Running")]
    qm = _moab(pkg, fake, tmp_path, showq_ttl_s=300.0)
    qm.status()
    assert not qm.delete("55")
    fake.showq_jobs = []
    assert qm.delete("55")
    assert fake.n("canceljob") == 2


@both
def test_moab_recovery_succeeds_on_last_attempt(pkg, tmp_path):
    fake = _MoabFake()
    fake.msub_replies = [("", "moab communication error (timeout)")]
    fake.showq_comm_err_n = 2
    fake.showq_jobs = [("eligible", "888", "tpulsar4", "Idle")]
    qm = _moab(pkg, fake, tmp_path, comm_retry_limit=3)
    assert qm.submit([], str(tmp_path / "out"), job_id=4) == "888"
    assert fake.n("msub") == 1


@both
def test_moab_lost_reply_definitively_absent_is_nonfatal(pkg, tmp_path):
    qms = mod(pkg, "orchestrate.queue_managers")
    fake = _MoabFake()
    fake.msub_replies = [("", "moab communication error (timeout)")]
    fake.showq_jobs = []
    qm = _moab(pkg, fake, tmp_path)
    with pytest.raises(qms.QueueManagerNonFatalError):
        qm.submit([], str(tmp_path / "out"), job_id=5)
    assert fake.n("msub") == 1


@both
def test_moab_recovery_ignores_dying_previous_attempt(pkg, tmp_path):
    qms = mod(pkg, "orchestrate.queue_managers")
    fake = _MoabFake()
    fake.msub_replies = [("", "moab communication error (timeout)")]
    fake.showq_jobs = [("active", "600", "tpulsar6", "Canceling")]
    qm = _moab(pkg, fake, tmp_path)
    with pytest.raises(qms.QueueManagerNonFatalError):
        qm.submit([], str(tmp_path / "out"), job_id=6)


_PBSNODES_OUT = """node1
     state = free
     np = 8
     properties = search,gpu
     jobs = 0/11.srv, 1/12.srv

node2
     state = free
     np = 16
     properties = search
     jobs = 0/13.srv

node3
     state = down
     np = 64
     properties = search

node4
     state = free
     np = 4
     properties = other
"""


def _pbs_fake_run(nodes_out=_PBSNODES_OUT):
    calls = []

    def fake(cmd, **kw):
        calls.append(cmd)

        class R:
            returncode = 0
            stderr = ""
            stdout = ""
        r = R()
        if cmd[0] == "pbsnodes":
            r.stdout = nodes_out
        elif cmd[0] == "qsub":
            r.stdout = "99.srv\n"
        return r

    fake.calls = calls
    return fake


def _pbs(pkg, **kw):
    return mod(pkg, "orchestrate.queue_managers.pbs").PBSManager(
        script="job.sh", **kw)


@both
def test_pbs_submit_node_picks_most_free_cpus(pkg, tmp_path):
    fake = _pbs_fake_run()
    qm = _pbs(pkg, node_property="search", max_jobs_per_node=4,
              state_file=str(tmp_path / "st.json"), runner=fake)
    assert qm._get_submit_node() == "node2"
    assert qm.submit(["a.fits"], str(tmp_path / "out"), 1) == "99.srv"
    qsub = next(c for c in fake.calls if c[0] == "qsub")
    assert "nodes=node2:ppn=1" in " ".join(qsub)


@both
def test_pbs_per_node_cap_and_no_node(pkg, tmp_path):
    fake = _pbs_fake_run()
    qm = _pbs(pkg, node_property="search", max_jobs_per_node=1,
              state_file=str(tmp_path / "st.json"), runner=fake)
    assert qm._get_submit_node() is None
    assert qm.can_submit() is False
    qm2 = _pbs(pkg, node_property="search", max_jobs_per_node=2,
               state_file=str(tmp_path / "st2.json"), runner=fake)
    assert qm2._get_submit_node() == "node2"
    assert qm2.can_submit() is True


@both
def test_pbs_ranking_counts_slots_but_cap_counts_jobs(pkg, tmp_path):
    nodes = """nodeA
     state = free
     np = 8
     properties = search
     jobs = 0/50.srv, 1/50.srv, 2/50.srv, 3/50.srv, 4/50.srv, 5/50.srv

nodeB
     state = free
     np = 8
     properties = search
     jobs = 0/60.srv, 1/61.srv
"""
    fake = _pbs_fake_run(nodes_out=nodes)
    qm = _pbs(pkg, node_property="search", max_jobs_per_node=3,
              state_file=str(tmp_path / "st.json"), runner=fake)
    assert qm._get_submit_node() == "nodeB"
    qm2 = _pbs(pkg, node_property="search", max_jobs_per_node=2,
               state_file=str(tmp_path / "st2.json"), runner=fake)
    assert qm2._get_submit_node() == "nodeA"


@both
def test_pbs_submit_invalidates_node_cache(pkg, tmp_path):
    fake = _pbs_fake_run()
    qm = _pbs(pkg, node_property="search", max_jobs_per_node=4,
              state_file=str(tmp_path / "st.json"), runner=fake)
    qm.submit(["a.fits"], str(tmp_path / "out"), 1)
    qm.submit(["b.fits"], str(tmp_path / "out"), 2)
    assert sum(1 for c in fake.calls if c[0] == "pbsnodes") == 2


@both
def test_pbs_without_node_selection_keeps_generic_spec(pkg, tmp_path):
    fake = _pbs_fake_run()
    qm = _pbs(pkg, state_file=str(tmp_path / "st.json"), runner=fake)
    qm.submit(["a.fits"], str(tmp_path / "out"), 2)
    qsub = next(c for c in fake.calls if c[0] == "qsub")
    assert "nodes=1:ppn=1" in " ".join(qsub)
    assert not any(c[0] == "pbsnodes" for c in fake.calls)


# ------------------------------------------------------------- telemetry

@both
def test_daemons_record_their_telemetry(pkg, tmp_path):
    """The pool's rotate latency and the downloader's bytes and
    failures land in the process registry under the JAX catalog's
    names."""
    telemetry = mod(pkg, "obs.telemetry")
    metrics = telemetry.metrics
    base = metrics.REGISTRY.snapshot()
    tracker = _tracker(pkg, tmp_path)
    qm = _local(pkg, tmp_path, script=_fake_worker_script(tmp_path))
    mod(pkg, "orchestrate.pool").JobPool(
        tracker, qm, str(tmp_path / "results")).rotate()
    dl = mod(pkg, "orchestrate.downloader")
    remote = tmp_path / "remote"
    (remote / "pool").mkdir(parents=True)
    (remote / "pool" / "a.fits").write_bytes(b"a" * 300)
    d = dl.Downloader(tracker, dl.LocalRestoreService(str(remote)),
                      dl.LocalTransport(str(remote)),
                      datadir=str(tmp_path / "raw"), space_to_use=10 ** 9,
                      min_free_space=0)
    for _ in range(4):
        d.run()
        d._threads and [th.join(10) for th in d._threads.values()]
    delta = metrics.diff_snapshots(metrics.REGISTRY.snapshot(), base)
    assert delta["tpulsar_pool_rotate_seconds"]["series"][""]["count"] \
        == 1
    assert delta["tpulsar_download_bytes_total"]["series"][""] == 300


# ---------------------------------------------------------- the slice

#: the slice test's search: the default one on the Mock subband pair,
#: cut to a DM window of 0-40 (several passes, so that the kill lands
#: between two of them)
SLICE_SEARCHING = {"dm_max": 40.0}
#: checkpoint writes up to pass 0 (the rfifind mask, then pass 0)
WRITES_TO_FIRST_PASS = 2


def _job_script(root, name: str, module: str, *args) -> str:
    path = root / f"{name}.sh"
    path.write_text("#!/bin/sh\nexec " + " ".join(
        [sys.executable, "-m", module, *args]) + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _slice_config(root, script: str) -> str:
    return _daemon_config(
        root, searching=SLICE_SEARCHING,
        jobpooler={"queue_manager": "local", "max_jobs_running": 1,
                   "max_attempts": 2, "submit_script": script})


def _cli(env, *args, timeout=120) -> str:
    res = subprocess.run([sys.executable, "-m", "tpulsar_torch", *args],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, (args, res.stdout[-2000:],
                                 res.stderr[-3000:])
    return res.stdout


def _blob_equal(name: str, a: bytes, b: bytes) -> bool:
    """Two stored files hold the same results: a plot by presence (its
    pixels are rendered from the arrays compared elsewhere), anything
    else by tools/torch_results_diff.py's rules at rtol 1e-5 (timing
    files by presence, .npz by arrays, tarballs by members, decimals
    in text within rtol)."""
    if name.endswith(".png"):
        return bool(a) and bool(b)
    return not _results_diff()._content_diff(name, a, b, name, 1e-5)


def _equal(a, b) -> bool:
    """Floats at rtol 1e-5, blobs by _blob_equal, the rest exactly."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        return a[0] == b[0] and _blob_equal(a[0], a[1], b[1])
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=1e-5, abs=1e-9)
    return a == b


def _results_rows(db_path: str) -> dict:
    """Every table's rows, without ids, timestamps or version_number;
    each blob as (its file name, its bytes)."""
    import sqlite3

    con = sqlite3.connect(db_path)
    con.row_factory = sqlite3.Row
    out = {}
    skip = {"id", "header_id", "cand_id", "uploaded_at", "version_number"}
    for table in ("headers", "pdm_candidates", "pdm_plots",
                  "sp_candidates", "sp_files", "diagnostics"):
        rows = []
        for r in con.execute(f"SELECT * FROM {table} ORDER BY id"):
            d = {k: r[k] for k in r.keys() if k not in skip}
            if d.get("blob") is not None:
                d["blob"] = (d.get("filename") or "", bytes(d["blob"]))
            rows.append(d)
        out[table] = rows
    con.close()
    return out


def _wait(pred, what: str, timeout_s: float = 240.0):
    deadline = time.time() + timeout_s
    while not pred():
        assert time.time() < deadline, what
        time.sleep(0.1)


def test_slice_pipeline_killed_retried_uploaded_matches_jax(tmp_path,
                                                            request):
    """The whole pipeline through subprocesses on a Mock subband pair:
    `downloader --once` from a local archive until both files are
    downloaded; `jobpool --once` makes one job and submits the port's
    job (--device cpu through jobpooler.submit_script), parked after
    pass 0; `kill-jobs --fail` kills its process group (the
    checkpoint survives the TERM); `jobpool --once` retries it into the
    same output directory, where it resumes from the checkpoint and
    computes only the later passes; `jobpool --once` marks it
    processed; `uploader --once` uploads it, a second upload inserts
    nothing.  The results DB's rows equal those of the JAX pipeline
    (its own pool, local backend, job and uploader) on the same files,
    at rtol 1e-5."""
    from tpulsar.orchestrate.jobtracker import JobTracker as JTracker
    from tpulsar.orchestrate.pool import JobPool as JPool
    from tpulsar.orchestrate.queue_managers.local import (
        LocalProcessManager as JLocal)
    from tpulsar.orchestrate.uploader import JobUploader as JUploader
    from tpulsar_torch.orchestrate.jobtracker import JobTracker
    from tpulsar_torch.orchestrate.queue_managers.local import (
        LocalProcessManager)

    archive = tmp_path / "archive"
    fns = _subband_pair(archive / "pool")
    assert len(fns) == 2
    base_env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                    JAX_PLATFORMS="cpu", TPULSAR_DD_FAMILY="direct")
    base_env.pop("TPULSAR_FAULTS", None)

    # ---- the JAX pipeline, in process, on the archive's files
    jroot = tmp_path / "jax"
    jroot.mkdir()
    # The JAX job runs through `-c`, not `-m tpulsar.cli.search_job`:
    # when a pytest-xdist worker's session ends, the session guard in
    # tests/conftest.py kills every process whose command line names
    # that module, a live job of a test still running in another worker
    # included.  This test reaps both pipelines' jobs itself (below).
    jscript = jroot / "job.sh"
    jscript.write_text(
        f"#!/bin/sh\nexec {sys.executable} -c 'import sys; from "
        f"tpulsar.cli import search_job; sys.exit(search_job.main())'\n")
    jscript.chmod(jscript.stat().st_mode | stat.S_IEXEC)
    jcfg = _slice_config(jroot, str(jscript))
    jt = JTracker(str(jroot / "jt.db"))
    for fn in fns:
        jt.insert("files", filename=fn, remote_filename=fn,
                  size=os.path.getsize(fn), status="added", details="")
    jqm = JLocal(max_jobs_running=1, script=str(jroot / "job.sh"),
                 state_dir=str(jroot / "localq"),
                 env_extra={**base_env, "TPULSAR_CONFIG": jcfg})
    jpool = JPool(jt, jqm, str(jroot / "res"), max_attempts=2)
    request.addfinalizer(jqm.shutdown)
    request.addfinalizer(lambda: LocalProcessManager(
        state_dir=str(tmp_path / "torch" / "work" / ".localq")).shutdown())
    jpool.rotate()
    jsub = jt.query("SELECT * FROM job_submits", fetchone=True)

    # ---- the port's pipeline, every step a CLI subprocess
    troot = tmp_path / "torch"
    troot.mkdir()
    tcfg = _slice_config(troot, _job_script(
        troot, "job", "tpulsar_torch.cli.search_job", "--device", "cpu"))
    env = dict(base_env, TPULSAR_CONFIG=tcfg)
    t = JobTracker(str(troot / "jt.db"))
    for _ in range(4):
        _cli(env, "downloader", "--once", "--remote-root", str(archive))
        if t.count("files", "downloaded") == 2:
            break
    assert t.count("files", "downloaded") == 2
    for row in t.query("SELECT * FROM files"):
        assert os.path.dirname(row["filename"]) == str(troot / "raw")
        assert os.path.getsize(row["filename"]) == row["size"]

    parked = dict(env, TPULSAR_FAULTS=(
        f"checkpoint.write:delay:after={WRITES_TO_FIRST_PASS},"
        f"seconds=300"))
    out = _cli(parked, "jobpool", "--once")
    assert t.count("jobs") == 1 and t.count("jobs", "submitted") == 1
    sub = t.query("SELECT * FROM job_submits", fetchone=True)
    outdir = sub["output_dir"]
    rel = os.path.relpath(outdir, str(troot / "res")).split(os.sep)
    assert len(rel) == 4 and rel[3] == time.strftime("%y%m%d")
    ckdir = tckpt.default_root(outdir)
    _wait(lambda: _pass_keys(ckdir), "pass 0 never became durable")
    with open(troot / "work" / ".localq" / f"{sub['queue_id']}.json") as fh:
        pid = json.load(fh)["pid"]
    pgid = os.getpgid(pid)
    out = _cli(env, "kill-jobs", "--fail", str(sub["job_id"]))
    assert f"job {sub['job_id']} -> failed" in out

    def group_gone():
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return True
        return False

    _wait(group_gone, "the killed job's process group lives on", 60)
    assert t.query("SELECT status FROM job_submits WHERE id=?",
                   [sub["id"]], fetchone=True)["status"] == "stopped"
    assert t.query("SELECT status FROM jobs", fetchone=True)["status"] \
        == "failed"
    kept = _pass_keys(ckdir)
    assert kept == ["pass_0000"], kept
    # the TERM unwound the job: its workspace is gone, its checkpoint
    # stayed
    assert not [n for n in os.listdir(troot / "work")
                if n.startswith("tpulsar_")]
    out = _cli(env, "show", "failed")
    assert f"{sub['job_id']} | failed | stopped by operator" in out

    _cli(env, "jobpool", "--once")            # failed -> retrying -> sent
    subs = t.query("SELECT * FROM job_submits ORDER BY id")
    assert [s["status"] for s in subs] == ["stopped", "running"]
    assert subs[1]["output_dir"] == outdir
    qm_state = troot / "work" / ".localq" / f"{subs[1]['queue_id']}.json"
    rc_file = json.loads(qm_state.read_text())["rc_file"]
    _wait(lambda: os.path.exists(rc_file), "the retry never finished", 300)
    _cli(env, "jobpool", "--once")
    assert t.query("SELECT status FROM jobs", fetchone=True)["status"] \
        == "processed"
    assert os.path.getsize(os.path.join(
        outdir, f"{subs[1]['queue_id']}.stderr")) == 0
    assert not os.path.exists(ckdir)
    with open(os.path.join(outdir, "metrics.json")) as fh:
        metrics = json.load(fh)
    npass_retry = metrics["tpulsar_passes_total"]["series"][""]
    assert metrics["tpulsar_checkpoint_events_total"]["series"]
    _cli(env, "uploader", "--once")
    assert t.query("SELECT status FROM jobs", fetchone=True)["status"] \
        == "uploaded"
    assert "uploaded" in _cli(env, "status")

    # ---- the JAX pipeline finishes and uploads
    _wait(lambda: not jqm.is_running(jsub["queue_id"]),
          "the JAX job never finished", 300)
    jpool.rotate()
    assert jt.count("jobs", "processed") == 1, jt.query(
        "SELECT details FROM job_submits", fetchone=True)["details"]
    JUploader(jt, db_url=str(jroot / "results.db")).run()
    assert jt.count("jobs", "uploaded") == 1
    with open(os.path.join(jsub["output_dir"], "metrics.json")) as fh:
        npass = json.load(fh)["tpulsar_passes_total"]["series"][""]
    assert npass >= 2 and npass_retry == npass - 1

    trows = _results_rows(str(troot / "results.db"))
    jrows = _results_rows(str(jroot / "results.db"))
    assert len(trows["headers"]) == 1 and trows["pdm_candidates"]
    assert len(trows["diagnostics"]) >= 5
    for table in jrows:
        assert len(trows[table]) == len(jrows[table]), table
        for i, (a, b) in enumerate(zip(trows[table], jrows[table])):
            assert a.keys() == b.keys(), table
            bad = [k for k in a if not _equal(a[k], b[k])]
            assert not bad, (table, i, {k: (a[k], b[k]) for k in bad})

    # a second upload inserts nothing
    _cli(env, "uploader", "--once")
    assert _results_rows(str(troot / "results.db"))["headers"] == \
        trows["headers"]
    assert t.count("job_submits", "uploaded") == 1
