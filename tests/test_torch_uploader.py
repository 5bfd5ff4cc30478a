"""The port's uploader (tpulsar_torch/orchestrate/uploader.py with its
results DB, verify-after-write uploadables and diagnostics) against
the JAX package's: tests/test_uploader.py's cases, each run with both
packages' uploaders on a results directory the port's search_beam
wrote; the two uploaders on one results directory writing equal rows
in every table; the one results DB schema read by either package; a
results directory without plots (as the card's runs write it); the
upload telemetry; and the version fallback of a tree with no git
history.

Tolerances: rows written from one results directory compare exactly
(ids, upload timestamps and the pinned version_number aside), blobs
byte for byte."""

from __future__ import annotations

import importlib
import os
import shutil
import sqlite3

import pytest

torch = pytest.importorskip("torch")

from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from tpulsar_torch.io import synth  # noqa: E402
from tpulsar_torch.plan import ddplan  # noqa: E402
from tpulsar_torch.search import executor  # noqa: E402

PKGS = {"jax": "tpulsar", "torch": "tpulsar_torch"}
both = pytest.mark.parametrize("pkg", ["jax", "torch"])


def mod(pkg: str, path: str):
    return importlib.import_module(f"{PKGS[pkg]}.{path}")


@pytest.fixture(autouse=True)
def _no_leaks():
    yield
    for pkg in PKGS:
        mod(pkg, "resilience.faults").reset()


def _search(root, make_plots: bool):
    """A real results directory from the port's search_beam on a small
    beam (test_uploader.py's beam, plan and parameters)."""
    spec = synth.BeamSpec(nchan=32, nsamp=1 << 14, nbits=4,
                          tsamp_s=5.24288e-4)
    psr = synth.PulsarSpec(period_s=0.15, dm=60.0, snr_per_sample=0.8)
    fns = synth.synth_beam(str(root / "data"), spec, pulsars=[psr])
    plan = [ddplan.DedispStep(lodm=50.0, dmstep=5.0, dms_per_pass=4,
                              numpasses=1, numsub=8, downsamp=1)]
    params = executor.SearchParams(nsub=8, run_hi_accel=False,
                                   max_cands_to_fold=3, fold_nbin=32,
                                   fold_npart=8, make_plots=make_plots)
    return executor.search_beam(fns, str(root / "work"),
                                str(root / "results"), params=params,
                                plan=plan, device="cpu")


@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    """The port's results directory, plots on (module-scoped: the
    search is the expensive part; each test uploads a copy)."""
    return _search(tmp_path_factory.mktemp("upl"), make_plots=True)


@pytest.fixture()
def results(searched, tmp_path):
    """A fresh copy of the searched results directory."""
    dst = str(tmp_path / "results")
    shutil.copytree(searched.resultsdir, dst)
    return dst


def _tracked_submit(pkg, tmp_path, resultsdir):
    t = mod(pkg, "orchestrate.jobtracker").JobTracker(
        str(tmp_path / "jt.db"))
    job_id = t.insert("jobs", status="processed", details="")
    sid = t.insert("job_submits", job_id=job_id, queue_id="q1",
                   output_dir=resultsdir, status="processed", details="")
    return t, job_id, sid


def _upload(pkg, tmp_path, resultsdir, db_name="results.db"):
    t, job_id, sid = _tracked_submit(pkg, tmp_path, resultsdir)
    db_url = str(tmp_path / db_name)
    mod(pkg, "orchestrate.uploader").JobUploader(t, db_url=db_url).run()
    return t, job_id, sid, db_url


@both
def test_upload_end_to_end(pkg, searched, results, tmp_path):
    t, job_id, _sid, db_url = _upload(pkg, tmp_path, results)
    assert t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                   fetchone=True)["status"] == "uploaded"
    db = mod(pkg, "orchestrate.results_db").ResultsDB(db_url)
    hdr = db.fetchone("SELECT * FROM headers")
    assert hdr is not None
    assert hdr["source_name"] == "G0000+00"
    assert hdr["beam_id"] == 3
    assert hdr["version_number"]
    ncands = db.fetchone("SELECT COUNT(*) c FROM pdm_candidates")["c"]
    assert ncands == len(searched.candidates)
    nsp = db.fetchone("SELECT COUNT(*) c FROM sp_candidates")["c"]
    assert nsp == min(len(searched.sp_events), 10000)
    ndiags = db.fetchone("SELECT COUNT(*) c FROM diagnostics")["c"]
    assert ndiags >= 5
    names = {r["name"] for r in db.execute(
        "SELECT name FROM diagnostics").fetchall()}
    assert {"RFI mask percentage", "Num cands folded",
            "Search parameters"} <= names
    assert any(n.startswith("Single-pulse plot") for n in names)
    db.close()


@both
def test_version_pinning(pkg, results):
    get_version_number = mod(pkg, "orchestrate.uploader").get_version_number
    v1 = get_version_number(results)
    v2 = get_version_number(results)
    assert v1 == v2
    assert os.path.exists(os.path.join(results, "version_number.txt"))


@both
def test_parse_failure_fails_job(pkg, tmp_path):
    os.makedirs(tmp_path / "empty_results", exist_ok=True)
    t, job_id, sid, _db = _upload(pkg, tmp_path,
                                  str(tmp_path / "empty_results"))
    assert t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                   fetchone=True)["status"] == "failed"
    assert t.query("SELECT status FROM job_submits WHERE id=?", [sid],
                   fetchone=True)["status"] == "upload_failed"


@both
def test_upload_is_transactional(pkg, results, tmp_path, monkeypatch):
    """If a diagnostic upload fails, nothing is committed."""
    diag_mod = mod(pkg, "orchestrate.diagnostics")
    UploadError = mod(pkg, "orchestrate.uploadables").UploadError
    real = diag_mod.get_diagnostics

    def broken(resultsdir, basenm):
        diags = real(resultsdir, basenm)

        class Bomb:
            header_id = None

            def upload(self, db):
                raise UploadError("injected diagnostic failure")

        return diags + [Bomb()]

    monkeypatch.setattr(diag_mod, "get_diagnostics", broken)
    t, job_id, _sid, db_url = _upload(pkg, tmp_path, results)
    assert t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                   fetchone=True)["status"] == "failed"
    db = mod(pkg, "orchestrate.results_db").ResultsDB(db_url)
    assert db.fetchone("SELECT COUNT(*) c FROM headers")["c"] == 0
    assert db.fetchone("SELECT COUNT(*) c FROM pdm_candidates")["c"] == 0
    db.close()


@both
def test_connection_error_defers_the_upload(pkg, results, tmp_path):
    """A connection-shaped failure (the upload.write fault point)
    leaves the submit 'processed' for a later iteration, counted as
    deferred; the next iteration uploads it."""
    faults = mod(pkg, "resilience.faults")
    telemetry = mod(pkg, "obs.telemetry")
    base = telemetry.metrics.REGISTRY.snapshot()
    faults.configure("upload.write:unimplemented:count=1")
    t, job_id, sid, db_url = _upload(pkg, tmp_path, results)
    assert t.query("SELECT status FROM job_submits WHERE id=?", [sid],
                   fetchone=True)["status"] == "processed"
    mod(pkg, "orchestrate.uploader").JobUploader(t, db_url=db_url).run()
    assert t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                   fetchone=True)["status"] == "uploaded"
    delta = telemetry.metrics.diff_snapshots(
        telemetry.metrics.REGISTRY.snapshot(), base)
    assert delta["tpulsar_uploads_total"]["series"] == {
        "deferred": 1.0, "uploaded": 1.0}
    cats = delta["tpulsar_upload_seconds"]["series"]
    assert {"Parsing", "Header (incl. candidates + SP)",
            "Diagnostics"} <= set(cats)


@both
def test_skipped_beam_goes_terminal_not_failed(pkg, tmp_path):
    """A worker-side clean skip (skipped.txt, no header.json) moves the
    job to a terminal 'skipped' state, which the pool's failure
    recovery leaves alone."""
    rd = tmp_path / "skip_results"
    os.makedirs(rd, exist_ok=True)
    (rd / "skipped.txt").write_text(
        "observation is 2.0 s < low_T_to_search 3600.0 s\n")
    t, job_id, sid, _db = _upload(pkg, tmp_path, str(rd))
    assert t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                   fetchone=True)["status"] == "skipped"
    srow = t.query("SELECT status, details FROM job_submits WHERE id=?",
                   [sid], fetchone=True)
    assert srow["status"] == "skipped"
    assert "low_T_to_search" in srow["details"]
    pool = mod(pkg, "orchestrate.pool").JobPool(
        t, mod(pkg, "orchestrate.queue_managers.local")
        .LocalProcessManager(state_dir=str(tmp_path / "q")),
        str(tmp_path / "res"))
    pool.recover_failed_jobs()
    assert t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                   fetchone=True)["status"] == "skipped"


def _rows(db_url: str) -> dict:
    con = sqlite3.connect(db_url)
    con.row_factory = sqlite3.Row
    skip = {"uploaded_at", "version_number"}
    out = {t: [{k: r[k] for k in r.keys() if k not in skip}
               for r in con.execute(f"SELECT * FROM {t} ORDER BY id")]
           for t in ("headers", "pdm_candidates", "pdm_plots",
                     "sp_candidates", "sp_files", "diagnostics")}
    con.close()
    return out


def test_both_uploaders_write_equal_rows(results, tmp_path):
    """The JAX JobUploader and the port's, each on the same results
    directory into its own results DB: every table's rows equal (ids
    included; upload timestamps and version_number aside), blobs byte
    for byte."""
    dbs = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        root.mkdir()
        t, job_id, _sid, dbs[pkg] = _upload(pkg, root, results)
        assert t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                       fetchone=True)["status"] == "uploaded"
    jrows, trows = _rows(dbs["jax"]), _rows(dbs["torch"])
    assert trows["headers"] and trows["pdm_candidates"]
    assert trows["sp_candidates"] and trows["diagnostics"]
    for table in jrows:
        assert trows[table] == jrows[table], table


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_results_db_is_shared(results, tmp_path, writer, reader):
    """One package uploads; the other's ResultsDB opens the database,
    reads the rows, and its uploader appends a second beam to it."""
    (tmp_path / "a").mkdir()
    _t, _j, _s, db_url = _upload(writer, tmp_path / "a", results)
    db = mod(reader, "orchestrate.results_db").ResultsDB(db_url)
    n = db.fetchone("SELECT COUNT(*) c FROM pdm_candidates")["c"]
    assert n > 0
    assert db.fetchone("SELECT COUNT(*) c FROM headers")["c"] == 1
    db.close()
    os.makedirs(tmp_path / "b")
    t2, _j, _s = _tracked_submit(reader, tmp_path / "b", results)
    mod(reader, "orchestrate.uploader").JobUploader(
        t2, db_url=db_url).run()
    db = mod(writer, "orchestrate.results_db").ResultsDB(db_url)
    assert db.fetchone("SELECT COUNT(*) c FROM headers")["c"] == 2
    assert db.fetchone("SELECT COUNT(*) c FROM pdm_candidates")["c"] \
        == 2 * n
    db.close()


def test_diagnostics_equal_between_packages(results):
    """get_diagnostics of both packages on one results directory: the
    same diagnostics in the same order, with the same values and
    files."""
    from tpulsar.orchestrate import diagnostics as jdiag
    from tpulsar_torch.orchestrate import diagnostics as tdiag
    from tpulsar_torch.orchestrate.uploader import _basenm_from_dir

    basenm = _basenm_from_dir(results)

    def flat(diags):
        return [(type(d).__name__, d.name, getattr(d, "value", None),
                 getattr(d, "path", None)) for d in diags]

    got = flat(tdiag.get_diagnostics(results, basenm))
    assert got == flat(jdiag.get_diagnostics(results, basenm))
    assert len(got) >= 5


@both
def test_results_without_plots_upload(pkg, tmp_path):
    """A results directory searched with plots off (as every run on
    the card writes it: its machine has no matplotlib) has no .png:
    the plot diagnostics are absent, not failed, and the beam
    uploads with its float and file diagnostics."""
    out = _search(tmp_path / "np", make_plots=False)
    assert not [n for n in os.listdir(out.resultsdir)
                if n.endswith(".png")]
    t, job_id, _sid, db_url = _upload(pkg, tmp_path, out.resultsdir)
    assert t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                   fetchone=True)["status"] == "uploaded"
    con = sqlite3.connect(db_url)
    names = [r[0] for r in con.execute("SELECT name FROM diagnostics")]
    ncands = con.execute("SELECT COUNT(*) FROM pdm_candidates").fetchone()
    con.close()
    assert len(names) >= 5 and ncands[0] == len(out.candidates)
    assert not any(n.startswith("Single-pulse plot") for n in names)
    assert not any("_cand" in n for n in names)


def test_version_falls_back_to_the_package_version(tmp_path,
                                                   monkeypatch):
    """Without git history (an exported tree) the pinned version is
    the port's package version."""
    import tpulsar_torch
    from tpulsar_torch.orchestrate import uploader

    def no_git(*a, **k):
        raise FileNotFoundError("git")

    monkeypatch.setattr(uploader.subprocess, "run", no_git)
    assert uploader.pipeline_version() == f"v{tpulsar_torch.__version__}"
    assert uploader.get_version_number(str(tmp_path)) == \
        f"v{tpulsar_torch.__version__}"
