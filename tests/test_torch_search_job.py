"""The port's per-beam job entry point against the JAX package's:
`tpulsar_torch.cli.search_job.main` and `tpulsar.cli.search_job.main`
on the same synthesized Mock subband pair through the DATAFILES/OUTDIR
contract, with the default configuration (plots on) cut to a DM window
of 0-8; and the job's skip, signal, device and configuration rules
(its batch entry point, run_search_batch: test_torch_beam_batch.py).

Candidates compare at test_torch_default_golden.py's tolerances (the
JAX side runs the direct stage-2 family)."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tarfile
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_checkpoint import (  # noqa: E402
    ROOT, _pass_keys, restore_job_globals)
from test_torch_default_beam import _bestprof_values  # noqa: E402
from test_torch_slice import (  # noqa: E402, F401 (an autouse fixture)
    _assert_cands_match, one_torch_thread)
from tpulsar import config as jcfg  # noqa: E402
from tpulsar.cli import search_job as jjob  # noqa: E402
from tpulsar.io import synth  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import checkpoint as tckpt  # noqa: E402
from tpulsar_torch import config as tcfg  # noqa: E402
from tpulsar_torch.cli import search_job as tjob  # noqa: E402
from tpulsar_torch.io import accelcands  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402


def _config_file(root, **searching) -> str:
    """A configuration file with every path under `root` and the
    searching domain's defaults changed by `searching`."""
    lines = ["searching:"] + [f"  {k}: {v}" for k, v in
                              searching.items()] + [
        "processing:",
        f"  base_working_directory: {root / 'work'}",
        f"  base_results_directory: {root / 'res'}",
        f"basic:\n  log_dir: {root / 'logs'}",
        f"download:\n  datadir: {root / 'raw'}",
        f"background:\n  jobtracker_db: {root / 'jt.db'}",
        f"resultsdb:\n  url: {root / 'results.db'}"]
    path = root / "cfg.yaml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def configured(tmp_path, monkeypatch):
    """Installs a configuration (DM window 0-8, paths under tmp_path)
    in both packages, as TPULSAR_CONFIG would; returns its path."""
    path = _config_file(tmp_path, dm_max=8.0)
    monkeypatch.setenv("TPULSAR_CONFIG", path)
    jcfg.set_settings(jcfg.load_config(path))
    tcfg.set_settings(tcfg.load_config(path))
    with restore_job_globals():
        yield path
    jcfg.set_settings(jcfg.TpulsarConfig())
    tcfg.set_settings(None)


def _subband_pair(root, seed=11):
    spec = synth.BeamSpec(nchan=32, nsamp=1 << 13, nbits=4,
                          tsamp_s=327.68e-6, seed=seed)
    psr = synth.PulsarSpec(period_s=0.25, dm=5.0, snr_per_sample=0.5)
    return synth.synth_beam(str(root), spec, pulsars=[psr], merged=False)


def _tar_names(path):
    with tarfile.open(path) as tf:
        return tf.getnames()


def test_job_matches_the_jax_job(tmp_path, configured, monkeypatch,
                                 capsys):
    """Both jobs on one Mock subband pair through DATAFILES (with the
    whitespace a scheduler's template leaves) and OUTDIR: the same
    results files (PNGs and metrics.json included), the same tarball
    members, and candidates and folds at the default-search
    tolerances."""
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")
    fns = _subband_pair(tmp_path / "beam")
    assert len(fns) == 2
    monkeypatch.setenv("DATAFILES", " " + " ; ".join(fns) + " ;")
    outs = {}
    for name, job, extra in (("jax", jjob, []),
                             ("torch", tjob, ["--device", "cpu"])):
        outs[name] = tmp_path / f"out_{name}"
        monkeypatch.setenv("OUTDIR", str(outs[name]))
        assert job.main(extra) == 0
    assert "search complete" in capsys.readouterr().out
    jr, tr = outs["jax"], outs["torch"]
    names = sorted(os.listdir(tr))
    assert names == sorted(os.listdir(jr))
    assert "metrics.json" in names and ".checkpoint" not in names
    pngs = [n for n in names if n.endswith(".png")]
    assert len([n for n in pngs if "_singlepulse_DMs" in n]) == 3
    base = next(n for n in names if n.endswith(".accelcands"))[:-11]
    assert base.startswith("P2030") and "_s0" not in base
    for n in names:
        if n.endswith(".tgz"):
            assert _tar_names(tr / n) == _tar_names(jr / n), n
    tc = accelcands.parse_candlist(str(tr / f"{base}.accelcands"))
    jc = accelcands.parse_candlist(str(jr / f"{base}.accelcands"))
    assert tc
    _assert_cands_match(tc, jc)
    assert [c.z for c in tc] == [c.z for c in jc]
    nfold = len(_tar_names(tr / f"{base}_bestprof.tgz"))
    assert nfold >= 1
    assert len([n for n in pngs if "_cand" in n]) == nfold
    got = _bestprof_values(tr / f"{base}_bestprof.tgz")
    want = _bestprof_values(jr / f"{base}_bestprof.tgz")
    assert got.keys() == want.keys()
    for m in want:
        for k in want[m]:
            assert got[m][k] == pytest.approx(want[m][k], rel=1e-4,
                                              abs=1e-9), (m, k)
    assert (tr / "search_params.txt").read_bytes() == \
        (jr / "search_params.txt").read_bytes()
    assert (tr / "header.json").read_bytes() == \
        (jr / "header.json").read_bytes()
    # the workspaces are gone
    assert os.listdir(tmp_path / "work") == []


def test_too_short_beam_is_a_clean_skip(tmp_path, monkeypatch, capsys):
    path = _config_file(tmp_path, low_T_to_search=3600.0)
    tcfg.set_settings(tcfg.load_config(path))
    try:
        spec = synth.BeamSpec(nchan=16, nsamp=512, nsblk=64)
        fns = synth.synth_beam(str(tmp_path / "b"), spec, merged=True)
        out = tmp_path / "out"
        with restore_job_globals():
            rc = tjob.main(list(fns) + ["--outdir", str(out),
                                        "--device", "cpu"])
    finally:
        tcfg.set_settings(None)
    assert rc == 0
    assert (out / "skipped.txt").read_text().startswith("observation is")
    assert "skipped" in capsys.readouterr().out
    assert not os.path.exists(tckpt.default_root(str(out)))


def test_job_without_gpu_fails_instead_of_using_the_cpu(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with restore_job_globals(), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        tjob.main(["x.fits", "--outdir", str(out),
                   "--workdir-base", str(tmp_path / "w")])
    assert not out.exists() and not (tmp_path / "w").exists()


#: checkpoint writes the job makes up to its first pass artifact: the
#: rfifind mask, then pass 0
WRITES_TO_FIRST_PASS = 2


def test_sigterm_unwinds_and_removes_the_workspace(tmp_path):
    """A queue manager's plain TERM mid-search exits 128+15 through
    the job's try/finally: the tpulsar_* workspace is removed, the
    checkpoint (durable resume state) is kept.

    The job is parked where the signal must land: every checkpoint
    write after the first pass's sleeps 300 s first, so the TERM
    arrives mid-search however slowly the test process is scheduled
    (it used to race a 0.4 s delay on every write)."""
    fns = _subband_pair(tmp_path / "beam", seed=5)
    cfg = _config_file(tmp_path, dm_max=40.0)
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=ROOT, TPULSAR_CONFIG=cfg,
               DATAFILES=";".join(fns), OUTDIR=str(out),
               OMP_NUM_THREADS="1",
               TPULSAR_FAULTS=f"checkpoint.write:delay:after="
                              f"{WRITES_TO_FIRST_PASS},seconds=300")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpulsar_torch.cli.search_job",
         "--device", "cpu", "--no-accel", "--qid", "q17"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        start_new_session=True)
    ckdir = tckpt.default_root(str(out))
    stderr = ""

    def why() -> str:
        return f"rc {proc.returncode}; the job's stderr:\n{stderr[-3000:]}"

    try:
        deadline = time.time() + 240
        while not _pass_keys(ckdir):
            assert proc.poll() is None, \
                f"the job ended first: rc {proc.returncode}"
            assert time.time() < deadline, "no pass checkpointed in time"
            time.sleep(0.05)
        assert proc.poll() is None, \
            f"the job ended before the signal: rc {proc.returncode}"
        work = os.listdir(tmp_path / "work")
        assert len(work) == 1 and work[0].startswith("tpulsar_"), work
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
        stderr = proc.stderr.read().decode(errors="replace")
        proc.stderr.close()
    assert proc.returncode == 128 + signal.SIGTERM, why()
    assert os.listdir(tmp_path / "work") == [], why()
    # parked at the write after pass 0's: no later pass is durable
    assert len(_pass_keys(ckdir)) == 1, why()


@pytest.mark.parametrize("job", [jjob, tjob], ids=["jax", "torch"])
def test_signal_handlers_raise_systemexit(job):
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                            signal.SIGINT)}
    try:
        job.install_signal_handlers()
        handler = signal.getsignal(signal.SIGTERM)
        with pytest.raises(SystemExit) as ei:
            handler(signal.SIGTERM, None)
        assert ei.value.code == 128 + signal.SIGTERM
        assert signal.getsignal(signal.SIGINT) is handler
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def test_datafiles_entries_are_stripped(monkeypatch):
    import argparse

    monkeypatch.setenv("DATAFILES", " /d/a.fits ; /d/b.fits ;; /d/c.fits ")
    args = argparse.Namespace(files=[])
    assert tjob.get_datafns(args) == ["/d/a.fits", "/d/b.fits",
                                      "/d/c.fits"]
    assert tjob.get_datafns(args) == jjob.get_datafns(args)
    monkeypatch.setenv("DATAFILES", " ; ")
    with pytest.raises(SystemExit, match="no data files"):
        tjob.get_datafns(args)


def test_packaged_zaplist_is_the_jax_packages():
    tz = tjob.choose_zaplist(["nonexistent.fits"], None, None)
    jz = jjob.choose_zaplist(["nonexistent.fits"], None, None)
    assert tz is not None and tz.shape[1] == 2
    assert (tz == jz).all()


def _zaplist_store(root, names=("P2030.20101225.b3.zaplist",
                                "P2030.20101225.all.zaplist")):
    """A local-directory store holding a zaplists.tar.gz of custom
    zaplists (and one member that is not a zaplist)."""
    src = root / "src"
    src.mkdir(parents=True)
    for i, n in enumerate(names):
        (src / n).write_text(f"# custom\n{60.0 + i} 0.5\n")
    store = root / "store"
    store.mkdir()
    with tarfile.open(store / "zaplists.tar.gz", "w:gz") as tf:
        for n in names:
            tf.add(src / n, arcname=f"lists/{n}")
        tf.add(src / names[0], arcname="../escape.txt")
    return str(store)


def test_zaplist_url_refresh_picks_the_jax_jobs_zaplist(tmp_path):
    """prepare_inputs of both jobs with processing.zaplist_url set
    (a local-directory store) refresh the custom-zaplist cache and
    pick the same per-beam zaplist for a Mock subband pair, not the
    packaged default; exact equality."""
    import numpy as np

    fns = _subband_pair(tmp_path / "beam")
    store = _zaplist_store(tmp_path)
    zaps = {}
    for name, job, cfgmod in (("jax", jjob, jcfg), ("torch", tjob, tcfg)):
        cfg = cfgmod.TpulsarConfig()
        cfg.processing.zaplistdir = str(tmp_path / f"zap_{name}")
        cfg.processing.zaplist_url = store
        work = tmp_path / f"work_{name}"
        work.mkdir()
        _pp, zaps[name] = job.prepare_inputs(fns, str(work), cfg=cfg)
        assert sorted(os.listdir(tmp_path / f"zap_{name}")) == [
            ".extracted_zaplists", ".refresh_lock",
            "P2030.20101225.all.zaplist", "P2030.20101225.b3.zaplist",
            "zaplists.tar.gz"]
    assert np.array_equal(zaps["torch"], zaps["jax"])
    assert zaps["torch"].tolist() == [[60.0, 0.5]]


def test_configuration_mirrors_the_jax_package(tmp_path):
    """The same domains, fields and defaults; one file loads the same
    in both; SearchParams.from_config maps it the same way; the same
    problems are reported."""
    assert tcfg.TpulsarConfig().to_dict() == jcfg.TpulsarConfig().to_dict()
    path = _config_file(tmp_path, dm_max=120.0, use_hi_accel=False,
                        nsub=64, sifting_min_num_dms=3)
    t, j = tcfg.load_config(path), jcfg.load_config(path)
    assert t.to_dict() == j.to_dict()
    assert tex.SearchParams.from_config(t.searching).provenance() == \
        jex.SearchParams.from_config(j.searching).provenance()
    assert tex.SearchParams.from_config(
        tcfg.TpulsarConfig().searching).provenance() == \
        jex.SearchParams.from_config(
            jcfg.TpulsarConfig().searching).provenance()
    bad_t, bad_j = tcfg.TpulsarConfig(), jcfg.TpulsarConfig()
    for cfg in (bad_t, bad_j):
        cfg.basic.log_dir = str(tmp_path / "missing")
        cfg.download.numdownloads = 0
        cfg.searching.nsub = 0
        cfg.jobpooler.queue_manager = "bogus"
    problems = []
    for cfg, mod in ((bad_t, tcfg), (bad_j, jcfg)):
        with pytest.raises(mod.InsaneConfigsError) as ei:
            cfg.check_sanity()
        problems.append(ei.value.problems)
    assert problems[0] == problems[1]
    bogus = tmp_path / "bogus.yaml"
    bogus.write_text("searching:\n  no_such_knob: 1\n")
    with pytest.raises(tcfg.ConfigError, match="searching.no_such_knob"):
        tcfg.load_config(str(bogus))


def test_help_runs_without_jax(tmp_path):
    """`python -m tpulsar_torch.cli.search_job --help` exits 0 and
    names the device option."""
    res = subprocess.run(
        [sys.executable, "-m", "tpulsar_torch.cli.search_job", "--help"],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout and "--no-accel" in res.stdout


def test_default_configuration_is_the_default_search():
    """The job's parameters under the default configuration are
    SearchParams(): the default search, plots on."""
    p = tex.SearchParams.from_config(tcfg.TpulsarConfig().searching)
    assert p.provenance() == tex.SearchParams().provenance()
