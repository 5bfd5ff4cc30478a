"""tpulsar_torch as a package: it stands alone (no JAX, nothing of
tpulsar — its job and serve entry points included), its entry points
default to CUDA and refuse to move to the CPU by themselves, it
refuses, by name, what the later slices of the port will add, and it
runs what the earlier slices added."""

import inspect
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import resolve_device, state  # noqa: E402
from tpulsar_torch.plan import ddplan  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "tpulsar_torch"

_PROBE = r"""
import sys
import tpulsar_torch
import tpulsar_torch.state, tpulsar_torch.search.executor
import tpulsar_torch.kernels.cuda_dd, tpulsar_torch.io.synth
import tpulsar_torch.kernels.accel, tpulsar_torch.kernels.fold_batch
import tpulsar_torch.search.refine
import tpulsar_torch.io.datafile, tpulsar_torch.astro.barycenter
import tpulsar_torch.checkpoint, tpulsar_torch.resilience.faults
import tpulsar_torch.obs.telemetry, tpulsar_torch.search.plots
import tpulsar_torch.config, tpulsar_torch.cli.search_job
import tpulsar_torch.cli.main, tpulsar_torch.serve.server
import tpulsar_torch.serve.protocol, tpulsar_torch.serve.stagein
import tpulsar_torch.frontdoor.queue, tpulsar_torch.frontdoor.tenancy
import tpulsar_torch.obs.journal, tpulsar_torch.obs.health
import tpulsar_torch.obs.fleetview, tpulsar_torch.obs.log
import tpulsar_torch.dataplane.index, tpulsar_torch.resilience.policy
import tpulsar_torch.dataplane.blobstore, tpulsar_torch.dataplane.transfer
import tpulsar_torch.frontdoor.sqlite_queue, tpulsar_torch.frontdoor.results
import tpulsar_torch.frontdoor.federation, tpulsar_torch.frontdoor.client
import tpulsar_torch.frontdoor.gateway
import tpulsar_torch.resilience.rescue
import tpulsar_torch.orchestrate.zaplists
import tpulsar_torch.orchestrate.transports
import tpulsar_torch.orchestrate.jobtracker, tpulsar_torch.orchestrate.pool
import tpulsar_torch.orchestrate.downloader
import tpulsar_torch.orchestrate.uploader, tpulsar_torch.orchestrate.results_db
import tpulsar_torch.orchestrate.uploadables
import tpulsar_torch.orchestrate.diagnostics
import tpulsar_torch.orchestrate.queue_managers
import tpulsar_torch.orchestrate.queue_managers.local
import tpulsar_torch.orchestrate.queue_managers.slurm
import tpulsar_torch.orchestrate.queue_managers.pbs
import tpulsar_torch.orchestrate.queue_managers.moab
import tpulsar_torch.orchestrate.queue_managers.tpu_slice
import tpulsar_torch.orchestrate.queue_managers.warm
import tpulsar_torch.obs.alerts, tpulsar_torch.obs.debugflags
import tpulsar_torch.native, tpulsar_torch.kernels.tree_dd
import tpulsar_torch.kernels.beam_batch
import tpulsar_torch.stream, tpulsar_torch.stream.ingest
import tpulsar_torch.stream.dedisp_state, tpulsar_torch.stream.trigger
import tpulsar_torch.stream.worker
import tpulsar_torch.fleet, tpulsar_torch.fleet.controller
import tpulsar_torch.fleet.autoscale
import tpulsar_torch.chaos, tpulsar_torch.chaos.scenario
import tpulsar_torch.chaos.worker, tpulsar_torch.chaos.runner
import tpulsar_torch.chaos.invariants
import tpulsar_torch.aot, tpulsar_torch.aot.cachedir
import tpulsar_torch.aot.registry, tpulsar_torch.aot.warmstart
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tpulsar" or m.startswith("tpulsar."))
print("BAD:" + ",".join(bad))
"""


def test_import_pulls_in_no_jax_and_nothing_of_tpulsar():
    """In a fresh interpreter, importing the port's modules loads no
    jax and no tpulsar.* module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _PROBE],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("BAD:")][-1]
    assert line == "BAD:", line


_HELP_PROBE = r"""
import runpy, sys
sys.argv = ["search_job", "--help"]
try:
    runpy.run_module("tpulsar_torch.cli.search_job", run_name="__main__")
except SystemExit as e:
    print("EXIT:%s" % e.code)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tpulsar" or m.startswith("tpulsar."))
print("BAD:" + ",".join(bad))
"""


def test_job_entry_point_pulls_in_no_jax_and_nothing_of_tpulsar():
    """`python -m tpulsar_torch.cli.search_job --help` runs the job's
    module as __main__ and leaves jax and tpulsar.* out of
    sys.modules."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _HELP_PROBE],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "EXIT:0" in lines and any("--device" in ln for ln in lines)
    assert [ln for ln in lines if ln.startswith("BAD:")][-1] == "BAD:"


_SERVE_HELP_PROBE = r"""
import runpy, sys
sys.argv = ["tpulsar_torch", "serve", "--help"]
try:
    runpy.run_module("tpulsar_torch", run_name="__main__")
except SystemExit as e:
    print("EXIT:%s" % e.code)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tpulsar" or m.startswith("tpulsar."))
print("BAD:" + ",".join(bad))
"""


def test_serve_entry_point_pulls_in_no_jax_and_nothing_of_tpulsar():
    """`python -m tpulsar_torch serve --help` runs the package as
    __main__, names the device option, and leaves jax and tpulsar.*
    out of sys.modules."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _SERVE_HELP_PROBE],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "EXIT:0" in lines and any("--device" in ln for ln in lines)
    assert [ln for ln in lines if ln.startswith("BAD:")][-1] == "BAD:"


def test_chaos_control_plane_imports_no_torch():
    """The chaos harness is control plane: importing its stub worker,
    runner and verifier in a fresh interpreter loads no torch, no jax
    and nothing of tpulsar (a stub boots in milliseconds; only the
    serve workers a storm spawns touch the device)."""
    probe = ("import sys\n"
             "import tpulsar_torch.chaos.worker, "
             "tpulsar_torch.chaos.runner, tpulsar_torch.chaos.invariants\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'jaxlib', 'tpulsar'))\n"
             "print('BAD:' + ','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "BAD:"


_OPERATOR_PROBE = r"""
import contextlib, io, sys
import tpulsar_torch.analysis, tpulsar_torch.analysis.cli
import tpulsar_torch.config.knobs
from tpulsar_torch.cli import main
with contextlib.redirect_stdout(io.StringIO()):
    rcs = [main.main(["lint", "--list"]),
           main.main(["obs", "top", "--once", "--spool", sys.argv[1]]),
           main.main(["obs", "tail", "--spool", sys.argv[1]]),
           main.main(["obs", "blackbox", "w0", "--spool", sys.argv[1]])]
print("RCS:" + ",".join(map(str, rcs)))
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("torch", "numpy", "jax", "jaxlib", "tpulsar"))
print("BAD:" + ",".join(bad))
"""


def test_linter_knobs_and_obs_console_import_no_torch(tmp_path):
    """The contract linter, the knob registry and the obs console are
    stdlib only: importing them and running `lint --list` and `obs
    top|tail|blackbox` over an empty spool in a fresh interpreter
    loads no torch, no numpy, no jax and nothing of tpulsar."""
    res = subprocess.run([sys.executable, "-c", _OPERATOR_PROBE,
                          str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    # tail and blackbox find nothing in an empty spool (exit 1)
    assert "RCS:0,0,1,1" in lines
    assert lines[-1] == "BAD:"


def test_source_never_imports_jax_or_tpulsar():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"from\s+tpulsar(\.|\s+import)|import\s+tpulsar\b)",
                     re.M)
    hits = []
    for path in (list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                 + list((ROOT / "tools").glob("torch_*.py"))):
        for m in pat.finditer(path.read_text()):
            hits.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not hits, hits


def test_default_device_is_cuda_and_never_falls_back(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    params = tex.SearchParams.slice_defaults()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.search_beam([str(tmp_path / "x.fits")], str(tmp_path / "w"),
                        str(tmp_path / "r"), params)
    plan = [ddplan.DedispStep(0.0, 1.0, 2, 1, 2, 1)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.search_block(np.zeros((4, 256), np.float32),
                         np.linspace(1200, 1500, 4), 1e-3, plan, params)


def test_search_block_runs_on_a_cpu_mesh():
    """The mesh is no longer refused: a 2-shard mesh of the CPU
    searches every trial of the plan."""
    from tpulsar_torch.parallel import make_mesh

    mesh = make_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    rng = np.random.default_rng(3)
    out = tex.search_block(rng.standard_normal((4, 1024)).astype(
                               np.float32),
                           np.linspace(1200, 1500, 4), 1e-3,
                           [ddplan.DedispStep(0.0, 1.0, 3, 1, 2, 1)],
                           tex.SearchParams.slice_defaults(nsub=2),
                           mesh=mesh, device="cpu")
    assert out[3] == 3


def test_make_mesh_without_a_gpu_raises(monkeypatch):
    """make_mesh() means every CUDA device; without one it raises, as
    every other entry point does, and never falls back to the CPU."""
    from tpulsar_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_blob_tickets_are_refused_by_name(tmp_path, monkeypatch):
    """A ticket with blobs: refs and no data plane configured fails
    its own stage-in with the reference's error, naming the two knobs
    (tests/test_dataplane.py's no-source case); nothing is left in the
    workspace."""
    from tpulsar_torch.config import TpulsarConfig
    from tpulsar_torch.serve import stagein

    for knob in ("TPULSAR_DATA_URL", "TPULSAR_BLOB_ROOT"):
        monkeypatch.delenv(knob, raising=False)
    cfg = TpulsarConfig()
    cfg.processing.base_working_directory = str(tmp_path / "work")
    out = stagein.prepare_beam(
        {"ticket": "b", "datafiles": [], "blobs": {"a.fits": "0" * 64}},
        cfg=cfg)
    assert out.error.startswith("stage-in failed")
    assert "no data plane is configured" in out.error
    assert "TPULSAR_DATA_URL" in out.error
    assert "TPULSAR_BLOB_ROOT" in out.error
    assert os.listdir(tmp_path / "work") == []


def _tiny_pulsar_block():
    """16 channels x 8192 samples with a strong dispersed pulse train
    (P = 0.1 s, DM 20), seeded."""
    rng = np.random.default_rng(4)
    nchan, T, dt = 16, 1 << 13, 1e-3
    freqs = np.linspace(1214.0, 1536.0, nchan)
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    t = np.arange(T) * dt
    delays = 4148.808 * 20.0 * (freqs ** -2.0 - freqs[-1] ** -2.0)
    for c in range(nchan):
        data[c] += ((((t - delays[c]) / 0.1) % 1.0) < 0.1) * 2.0
    return data, freqs, dt


@pytest.mark.parametrize("change, stage", [
    (dict(run_hi_accel=True, hi_accel_zmax=8), "hi-accel"),
    (dict(refine_cands=True, max_cands_to_fold=3), "refinement"),
    (dict(max_cands_to_fold=3), "folding"),
    (dict(max_cands_to_fold=3, make_plots=True), "plotting"),
    ("checkpoint", "checkpoint"),
    ("tree", "tree"),
])
def test_earlier_refused_options_now_run(change, stage, tmp_path,
                                         monkeypatch):
    """The hi-accel stage, refinement, folding, plots,
    checkpoint/resume and the tree stage-2 family are ported: each is
    accepted and a tiny search runs it on the CPU (search_block;
    search_beam for the plots, which it draws)."""
    from tpulsar_torch import checkpoint as ckpt
    from tpulsar_torch.obs import telemetry
    from tpulsar_torch.search import degraded

    kw = {}
    if change == "checkpoint":
        kw["checkpoint_dir"] = str(tmp_path / "ck")
        change = dict(max_cands_to_fold=3)
    elif change == "tree":
        monkeypatch.setenv("TPULSAR_DD_FAMILY", "tree")
        change = dict(max_cands_to_fold=3)
    base = telemetry.metrics.REGISTRY.snapshot()
    params = tex.SearchParams.slice_defaults(nsub=8, lo_accel_numharm=4,
                                             topk_per_stage=8, **change)
    data, freqs, dt = _tiny_pulsar_block()
    plan = [ddplan.DedispStep(16.0, 2.0, 4, 1, 8, 1)]
    if stage == "plotting":
        out = _tiny_beam_search(tmp_path, params, plan)
        final, folded, timers = out.candidates, out.folded, out.timers
        pngs = sorted(n for n in os.listdir(out.resultsdir)
                      if n.endswith(".png"))
        assert len(pngs) == len(folded) + 3
        assert f"{out.basenm}_cand1.png" in pngs
    else:
        timers = tex.StageTimers()
        final, folded, _sp, ntr = tex.search_block(
            data, freqs, dt, plan, params, timers=timers, device="cpu",
            **kw)
        assert ntr == 4 and final
        assert abs(final[0].freq_hz - 10.0) < 0.05
    assert stage + ("search" if stage == "hi-accel" else "") \
        in timers.times or stage in ("checkpoint", "tree")
    fams = telemetry.metrics.diff_snapshots(
        telemetry.metrics.REGISTRY.snapshot(), base)[
            "tpulsar_dedisp_trials_total"]["series"]
    if stage == "tree":
        assert fams == {"tree": 4.0}
    if stage == "checkpoint":
        entries = ckpt.read_manifest(kw["checkpoint_dir"])["entries"]
        assert {"pass_0000", "sifted", "fold_0000"} <= set(entries)
    if stage == "hi-accel":
        # all four trials went through the hi stage, none skipped
        assert degraded.counts()["accel_hi_chunk_skipped"] == (0, 4, 1)
    if stage in ("hi-accel", "refinement", "folding", "checkpoint",
                 "tree"):
        # refined r leaves the half-bin grid; unrefined r stays on it
        on_grid = 2 * final[0].r == round(2 * final[0].r)
        assert on_grid == (stage != "refinement")
    if stage == "hi-accel":
        assert folded == []
    else:
        assert 1 <= len(folded) <= 3
        assert abs(folded[0].period_s - 0.1) < 1e-3


def _tiny_beam_search(tmp_path, params, plan):
    """search_beam on _tiny_pulsar_block written as a merged Mock file
    (the port's own writer), on the CPU."""
    from tpulsar_torch.io import synth as tsynth

    data, freqs, dt = _tiny_pulsar_block()
    spec = tsynth.BeamSpec(nchan=16, nsamp=data.shape[1], nbits=4,
                           tsamp_s=dt, fctr_mhz=1375.0, bw_mhz=322.0,
                           seed=4)
    psr = tsynth.PulsarSpec(period_s=0.1, dm=20.0, width_frac=0.1,
                            snr_per_sample=2.0)
    fns = tsynth.synth_beam(str(tmp_path / "beam"), spec, pulsars=[psr])
    return tex.search_beam(fns, str(tmp_path / "w"), str(tmp_path / "r"),
                           params, plan=plan, device="cpu")


def test_default_configuration_is_accepted():
    """SearchParams() — the JAX package's default search, plots
    included — is what the port runs now: it validates, and the
    entries' one check looks at the mesh, not at the configuration."""
    params = tex.SearchParams()
    assert params.make_plots and params.run_hi_accel
    assert list(inspect.signature(tex.check_supported).parameters) == [
        "mesh", "dev"]
    tex.check_supported(None, "cpu")


def test_hi_accel_without_templates_is_not_refused():
    """run_hi_accel with zmax 0 runs no hi stage (as in the reference),
    so it is accepted: a tiny search runs, and times no hi stage."""
    params = tex.SearchParams.slice_defaults(
        run_hi_accel=True, hi_accel_zmax=0, nsub=8, lo_accel_numharm=4,
        topk_per_stage=8)
    data, freqs, dt = _tiny_pulsar_block()
    timers = tex.StageTimers()
    final, _f, _sp, ntr = tex.search_block(
        data, freqs, dt, [ddplan.DedispStep(16.0, 2.0, 4, 1, 8, 1)],
        params, timers=timers, device="cpu")
    assert ntr == 4 and final and not timers.times.get("hi-accelsearch")


def test_search_params_mirror_the_reference():
    """Same fields, same defaults, and a provenance dict that
    round-trips through state.search_params_from_jax."""
    assert tex.SearchParams().provenance() == jex.SearchParams().provenance()
    jp = jex.SearchParams(nsub=32, sp_widths=(1, 2, 4), dm_max=300.0,
                          run_hi_accel=False)
    tp = state.search_params_from_jax(jp.provenance())
    assert tp.provenance() == jp.provenance()
    with pytest.raises(TypeError):
        state.search_params_from_jax(dict(jp.provenance(), bogus=1))


def test_plan_from_jax_accepts_tuples_dicts_and_objects():
    import dataclasses

    from tpulsar.plan import ddplan as jddplan

    steps = jddplan.survey_plan("pdev")
    want = ddplan.survey_plan("pdev")
    assert state.plan_from_jax(steps) == want
    assert state.plan_from_jax([dataclasses.astuple(s) for s in steps]) \
        == want
    assert state.plan_from_jax([dataclasses.asdict(s) for s in steps]) \
        == want
    assert sum(s.numpasses for s in want) == 57
    with pytest.raises(ValueError):
        state.plan_from_jax([(0.0, 1.0, 2)])


def test_cuda_tensor_build_needs_nvcc(monkeypatch):
    """Without nvcc the build raises; it never falls back."""
    from tpulsar_torch.kernels import cuda_dd

    monkeypatch.setattr(cuda_dd.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_dd.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_dd._nvcc()
