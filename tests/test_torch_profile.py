"""TPULSAR_PROFILE=<dir> in the port (tpulsar_torch/search/executor.py,
the JAX package's jax.profiler.trace hook at the same place): a torch
profiler trace of the whole block search, written as one gzipped
Chrome trace (``<host>_<pid>.<ts>.pt.trace.json.gz``) whose
``search_block`` range is the root the port's own trace shares.  A
profiled search gives exactly the unprofiled results; unset costs
nothing; a profiler that cannot write its trace fails the search."""

from __future__ import annotations

import contextlib
import gzip
import importlib.util
import json
import os
import re
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from tpulsar_torch.io import synth as tsynth  # noqa: E402
from tpulsar_torch.plan import ddplan  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a small search that runs every stage but the hi stage and plots
PARAMS = tex.SearchParams.slice_defaults(
    nsub=8, lo_accel_numharm=4, topk_per_stage=8, max_cands_to_fold=2)
PLAN = [ddplan.DedispStep(16.0, 2.0, 4, 1, 8, 1)]


def _results_diff():
    path = os.path.join(ROOT, "tools", "torch_results_diff.py")
    spec = importlib.util.spec_from_file_location("torch_results_diff",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    """A 16-channel Mock beam with a dispersed pulsar (P 0.1 s, DM 20),
    written by the port's own synthesizer."""
    spec = tsynth.BeamSpec(nchan=16, nsamp=1 << 13, nbits=4,
                           tsamp_s=1e-3, fctr_mhz=1375.0, bw_mhz=322.0,
                           seed=4)
    psr = tsynth.PulsarSpec(period_s=0.1, dm=20.0, width_frac=0.1,
                            snr_per_sample=2.0)
    return tsynth.synth_beam(str(tmp_path_factory.mktemp("beam") / "b"),
                             spec, pulsars=[psr])


def _search(fns, root):
    return tex.search_beam(fns, str(root / "w"), str(root / "r"), PARAMS,
                           plan=PLAN, device="cpu")


def _trace_events(path: str) -> list[dict]:
    with gzip.open(path, "rt") as fh:
        return json.load(fh)["traceEvents"]


def test_profiled_search_writes_one_trace_and_the_same_results(
        beam, tmp_path, monkeypatch):
    monkeypatch.delenv("TPULSAR_PROFILE", raising=False)
    plain = _search(beam, tmp_path / "plain")
    prof_dir = tmp_path / "profile"
    monkeypatch.setenv("TPULSAR_PROFILE", str(prof_dir))
    profiled = _search(beam, tmp_path / "profiled")

    names = os.listdir(prof_dir)
    # tensorboard_trace_handler's name, so TensorBoard's plugin lists it
    assert len(names) == 1 and re.fullmatch(
        rf"{re.escape(socket.gethostname())}_{os.getpid()}\.\d+"
        rf"\.pt\.trace\.json\.gz", names[0]), names
    events = _trace_events(str(prof_dir / names[0]))
    roots = [e for e in events if e.get("name") == "search_block"]
    assert len(roots) == 1 and roots[0]["dur"] > 0
    # the block's work nests under the root range: the CPU's FFTs
    inside = [e for e in events if e.get("ph") == "X"
              and "fft" in e.get("name", "")
              and roots[0]["ts"] <= e["ts"] <= roots[0]["ts"]
              + roots[0]["dur"]]
    assert inside
    # nothing profiled lands in the results directory
    assert not [n for n in os.listdir(profiled.resultsdir)
                if "pt.trace" in n]
    problems = _results_diff().diff_results(plain.resultsdir,
                                            profiled.resultsdir)
    assert problems == []
    assert [c.r for c in profiled.candidates] == \
        [c.r for c in plain.candidates]
    assert plain.candidates and plain.folded


def test_each_profiled_search_writes_its_own_trace(beam, tmp_path,
                                                   monkeypatch):
    """The knob is read per call: a second profiled search adds a
    second trace; after unsetting it a search adds none."""
    prof_dir = tmp_path / "profile"
    monkeypatch.setenv("TPULSAR_PROFILE", str(prof_dir))
    data = np.random.default_rng(3).integers(0, 16, (16, 4096), np.uint8)
    freqs = np.linspace(1214.0, 1536.0, 16)
    params = tex.SearchParams.slice_defaults(
        nsub=8, lo_accel_numharm=4, topk_per_stage=8, max_cands_to_fold=0)
    for n in (1, 2):
        tex.search_block(data, freqs, 1e-3, PLAN, params, device="cpu")
        assert len(os.listdir(prof_dir)) == n
    monkeypatch.setenv("TPULSAR_PROFILE", "  ")
    tex.search_block(data, freqs, 1e-3, PLAN, params, device="cpu")
    monkeypatch.delenv("TPULSAR_PROFILE")
    tex.search_block(data, freqs, 1e-3, PLAN, params, device="cpu")
    assert len(os.listdir(prof_dir)) == 2


def test_unset_knob_is_a_null_context(monkeypatch):
    monkeypatch.delenv("TPULSAR_PROFILE", raising=False)
    assert isinstance(tex._block_profiler(torch.device("cpu")),
                      contextlib.nullcontext)


def test_unwritable_profile_directory_raises(beam, tmp_path, monkeypatch):
    """A path the profiler cannot write to fails the block search
    before it starts: the beam's RFI mask (written before the block
    search) is all its results directory holds."""
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("TPULSAR_PROFILE", str(blocker / "profile"))
    with pytest.raises(OSError):
        _search(beam, tmp_path / "s")
    assert [n.endswith("_rfifind.npz")
            for n in os.listdir(tmp_path / "s" / "r")] == [True]


@pytest.mark.parametrize("stage", ["export", "gzip"])
def test_a_failing_export_raises(tmp_path, monkeypatch, stage):
    """The trace's export or its compression failing after the block
    ran fails the search: it is never swallowed, and leaves no partial
    file."""
    def refuse(*args, **kwargs):
        raise OSError(f"cannot write ({stage})")

    if stage == "export":
        monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                            refuse)
    else:
        monkeypatch.setattr(tex.gzip, "open", refuse)
    monkeypatch.setenv("TPULSAR_PROFILE", str(tmp_path / "profile"))
    data = np.random.default_rng(5).integers(0, 16, (16, 4096), np.uint8)
    params = tex.SearchParams.slice_defaults(
        nsub=8, lo_accel_numharm=4, topk_per_stage=8, max_cands_to_fold=0)
    with pytest.raises(OSError, match="cannot write"):
        tex.search_block(data, np.linspace(1214.0, 1536.0, 16), 1e-3,
                         PLAN, params, device="cpu")
    assert os.listdir(tmp_path / "profile") == []
