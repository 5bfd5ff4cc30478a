"""tpulsar_torch as a package: it stands alone (no JAX, nothing of
tpulsar), its entry points default to CUDA and refuse to move to the
CPU by themselves, and it refuses, by name, what the later slices of
the port will add."""

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

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "tpulsar_torch"

_PROBE = r"""
import sys
import tpulsar_torch
import tpulsar_torch.state, tpulsar_torch.search.executor
import tpulsar_torch.kernels.cuda_dd, tpulsar_torch.io.synth
import tpulsar_torch.io.datafile, tpulsar_torch.astro.barycenter
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


def test_source_never_imports_jax_or_tpulsar():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"from\s+tpulsar(\.|\s+import)|import\s+tpulsar\b)",
                     re.M)
    hits = []
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
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


@pytest.mark.parametrize("change, word", [
    (dict(run_hi_accel=True, hi_accel_zmax=50), "hi-accel"),
    (dict(refine_cands=True), "refinement"),
    (dict(max_cands_to_fold=3), "folding"),
    (dict(make_plots=True), "plots"),
    ("checkpoint", "checkpoint"),
    ("mesh", "mesh"),
    ("tree", "tree"),
])
def test_later_slices_are_refused_by_name(change, word, monkeypatch):
    params = tex.SearchParams.slice_defaults()
    kw = {}
    if isinstance(change, dict):
        params = tex.SearchParams.slice_defaults(**change)
    elif change == "checkpoint":
        kw["checkpoint_dir"] = "/nonexistent"
    elif change == "mesh":
        kw["mesh"] = object()
    else:
        monkeypatch.setenv("TPULSAR_DD_FAMILY", "tree")
    with pytest.raises(NotImplementedError, match=word):
        tex.search_block(np.zeros((4, 256), np.float32),
                         np.linspace(1200, 1500, 4), 1e-3,
                         [ddplan.DedispStep(0.0, 1.0, 2, 1, 2, 1)],
                         params, device="cpu", **kw)


def test_hi_accel_without_templates_is_not_refused():
    """run_hi_accel with zmax 0 runs no hi stage (as in the reference),
    so it is accepted."""
    tex.check_supported(tex.SearchParams.slice_defaults(
        run_hi_accel=True, hi_accel_zmax=0))


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
