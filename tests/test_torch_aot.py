"""The port's AOT layer (tpulsar_torch/aot/) against the JAX package's
(tpulsar/aot/): the build-directory resolver, the gate's rc contract
across processes (`python -m tpulsar_torch aot compile|verify|ls`),
the manifests, the compile-cache families and trace spans of a build,
the file lock of the CUDA build, the registry's coverage of every
compiler and CDLL site, the compile rollup of
tools/torch_trace_summarize.py and the live compile_miss_on_warm rule.

g++ is here, so the ``native`` library really builds.  nvcc is not: the
``cuda_dd`` build runs against a fake nvcc on PATH (a script that
writes its output file and counts its runs), or fails loudly without
one."""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_health import _doctor_cfg  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from tpulsar.aot import cachedir as jcachedir  # noqa: E402
from tpulsar.aot import warmstart as jwarmstart  # noqa: E402
from tpulsar.cli import main as jmain  # noqa: E402
from tpulsar_torch import native as tnative  # noqa: E402
from tpulsar_torch.aot import cachedir, registry, warmstart  # noqa: E402
from tpulsar_torch.cli import main as tmain  # noqa: E402
from tpulsar_torch.kernels import cuda_dd  # noqa: E402
from tpulsar_torch.obs import alerts as talerts  # noqa: E402
from tpulsar_torch.obs import health as thealth  # noqa: E402
from tpulsar_torch.obs import metrics as tmetrics  # noqa: E402
from tpulsar_torch.obs import trace as ttrace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = """#!/bin/sh
echo run >> "$FAKE_NVCC_RUNS"
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
sleep "${FAKE_NVCC_SLEEP:-0}"
echo "ptxas info    : Used 1 registers" >&2
: > "$out"
"""


def _env(cache: str, **extra) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT, TPULSAR_CACHE_DIR=str(cache),
               OMP_NUM_THREADS="1")
    env.pop("TPULSAR_TRACE", None)
    env.update(extra)
    return env


def _aot(cache, *args, **extra) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "tpulsar_torch", "aot", *args],
        env=_env(cache, **extra), capture_output=True, text=True,
        cwd=ROOT, timeout=300)


def _fake_nvcc(tmp_path) -> tuple[str, str]:
    """A directory holding the fake nvcc, and the file it counts runs
    in."""
    bindir = tmp_path / "fakebin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    return str(bindir), str(tmp_path / "nvcc_runs")


def _series(name: str) -> dict:
    return (tmetrics.REGISTRY.snapshot().get(name) or {}).get("series", {})


def _count(val) -> float:
    return float(val["count"] if isinstance(val, dict) else val)


# ------------------------------------------------------------ resolver

def test_resolver_follows_the_knob_as_the_jax_resolver(monkeypatch,
                                                       tmp_path):
    """With TPULSAR_CACHE_DIR set both packages resolve the same
    directory and the same manifest file name; unset, the port builds
    beside its sources in tpulsar_torch/_build."""
    monkeypatch.setenv("TPULSAR_CACHE_DIR", str(tmp_path / "c"))
    assert cachedir.resolve() == jcachedir.resolve() == str(tmp_path / "c")
    assert cachedir.manifest_path() == jcachedir.manifest_path()
    assert cachedir.MANIFEST_NAME == jcachedir.MANIFEST_NAME
    assert not os.path.exists(tmp_path / "c")
    assert cachedir.ensured() == str(tmp_path / "c")
    assert os.path.isdir(tmp_path / "c")
    # the libraries resolve there at call time, not at import
    assert tnative.library_path().startswith(str(tmp_path / "c") + "/")
    assert cuda_dd.library_path().startswith(str(tmp_path / "c") + "/")
    monkeypatch.delenv("TPULSAR_CACHE_DIR")
    assert cachedir.resolve() == os.path.join(ROOT, "tpulsar_torch",
                                              "_build")
    assert os.path.dirname(tnative.library_path()) == cachedir.resolve()


# ------------------------------------------------- the gate, processes

@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """`aot compile --only native` into a fresh build directory, traced
    (TPULSAR_TRACE=1): (directory, its CompletedProcess)."""
    cache = tmp_path_factory.mktemp("aot") / "build"
    res = _aot(cache, "compile", "--only", "native", TPULSAR_TRACE="1")
    return cache, res


def _copy(cache, dest) -> str:
    shutil.copytree(cache, dest)
    return str(dest)


def test_compile_then_verify_in_a_fresh_process(compiled):
    """The counterpart of tests/test_aot.py's compile-then-verify: rc
    0, a manifest of exactly `native` (its library, fingerprint and
    build seconds), then a second process verifies with 0 misses."""
    cache, res = compiled
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[ok] native" in res.stdout and "built in" in res.stdout
    assert "all programs compiled" in res.stdout
    man = warmstart.load_manifest(str(cache / cachedir.MANIFEST_NAME))
    assert man["schema"] == warmstart.MANIFEST_SCHEMA
    assert sorted(man["programs"]) == ["native"]
    rec = man["programs"]["native"]
    assert os.path.exists(rec["library"])
    assert os.path.dirname(rec["library"]) == str(cache)
    assert rec["build_s"] > 0 and rec["ptxas"] is None
    assert len(rec["fingerprint"]) == 32
    ver = _aot(cache, "verify", "--only", "native")
    assert ver.returncode == 0, ver.stdout + ver.stderr
    assert "[hit] native" in ver.stdout
    assert "manifest verify: 1/1 hits, 0 misses" in ver.stdout


def test_verify_without_a_manifest_is_rc_1(tmp_path):
    res = _aot(tmp_path / "empty", "verify")
    assert res.returncode == 1, res.stdout + res.stderr
    assert "no manifest" in res.stdout


def test_verify_with_the_library_deleted_is_a_miss(compiled, tmp_path):
    """The manifest kept, the library gone: the verify's load builds it,
    which is a miss (rc 1)."""
    cache = _copy(compiled[0], tmp_path / "b")
    lib = json.load(open(os.path.join(cache, cachedir.MANIFEST_NAME))
                    )["programs"]["native"]["library"]
    os.remove(os.path.join(cache, os.path.basename(lib)))
    res = _aot(cache, "verify", "--only", "native")
    assert res.returncode == 1, res.stdout + res.stderr
    assert "[MISS] native: built" in res.stdout
    assert "manifest verify: 0/1 hits, 1 misses" in res.stdout


def test_verify_of_a_fingerprint_that_drifted_is_a_miss(compiled,
                                                        tmp_path):
    cache = _copy(compiled[0], tmp_path / "b")
    path = os.path.join(cache, cachedir.MANIFEST_NAME)
    man = json.load(open(path))
    man["programs"]["native"]["fingerprint"] = "0" * 32
    with open(path, "w") as fh:
        json.dump(man, fh)
    res = _aot(cache, "verify", "--only", "native")
    assert res.returncode == 1, res.stdout + res.stderr
    assert "[MISS] native: fingerprint drifted" in res.stdout


def test_only_matching_nothing_is_loud(tmp_path):
    """A typo'd --only must not green-light an unverified directory
    with a vacuous rc 0, in either mode."""
    for mode in ("compile", "verify"):
        res = _aot(tmp_path / "c", mode, "--only", "nomatch")
        assert res.returncode == 1, res.stdout + res.stderr
        assert "no gate programs matched --only nomatch" in res.stdout


def test_deadline_builds_one_and_defers_the_rest(tmp_path):
    """The deadline is checked between builds: the first library
    (native) builds, cuda_dd is deferred, rc 3; the manifest holds
    what was built."""
    cache = tmp_path / "c"
    res = _aot(cache, "compile", "--deadline", "1e-9")
    assert res.returncode == 3, res.stdout + res.stderr
    assert "[ok] native" in res.stdout
    assert "[defer] cuda_dd: deadline reached" in res.stdout
    assert "1 deferred past deadline: cuda_dd" in res.stdout
    man = warmstart.load_manifest(str(cache / cachedir.MANIFEST_NAME))
    assert sorted(man["programs"]) == ["native"]


def test_compile_without_nvcc_fails_naming_cuda_dd(compiled, tmp_path):
    """No nvcc on the host: the cuda_dd build is a failure, never a
    skip; the native library still gates and lands in the manifest."""
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc at /usr/local/cuda/bin")
    cache = _copy(compiled[0], tmp_path / "b")
    res = _aot(cache, "compile", "--scale", "0.5", PATH="/usr/bin:/bin")
    assert res.returncode == 1, res.stdout + res.stderr
    assert "--scale: XLA program shapes of the JAX package" in res.stdout
    assert "[ok] native" in res.stdout
    assert "[FAIL] cuda_dd: nvcc not found" in res.stdout
    assert "1 FAILED: cuda_dd" in res.stdout
    man = warmstart.load_manifest(os.path.join(cache,
                                               cachedir.MANIFEST_NAME))
    assert sorted(man["programs"]) == ["native"]


def test_gate_trace_has_the_compile_rollup(compiled):
    """TPULSAR_TRACE=1 saves the gate's spans beside the manifest; the
    port's summarize tool rolls the aot_compile span and the build's
    backend_compile up once per program."""
    cache, res = compiled
    path = cache / "aot_gate_trace.json"
    assert f"trace: {path}" in res.stdout
    ts = _tool("torch_trace_summarize")
    roll = ts.compile_rollup(str(path))
    assert sorted(roll) == ["native"]
    assert roll["native"]["count"] == 1 and roll["native"]["seconds"] > 0
    assert roll["native"]["events"] == {"aot_compile": 1,
                                        "backend_compile": 1}


# ------------------------------------------------------------ manifests

def test_each_package_refuses_the_other_packages_manifest(compiled,
                                                          tmp_path):
    port = str(compiled[0] / cachedir.MANIFEST_NAME)
    assert warmstart.load_manifest(port) is not None
    assert jwarmstart.load_manifest(port) is None
    jax_doc = {"schema": jwarmstart.MANIFEST_SCHEMA, "programs": {},
               "cache_dir": str(tmp_path)}
    jpath = tmp_path / "jax_manifest.json"
    jpath.write_text(json.dumps(jax_doc))
    assert jwarmstart.load_manifest(str(jpath)) is not None
    assert warmstart.load_manifest(str(jpath)) is None
    assert warmstart.MANIFEST_SCHEMA != jwarmstart.MANIFEST_SCHEMA


# --------------------------------------------------- counters and trace

def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_HITS_PROBE = """
import json
from tpulsar_torch import native
from tpulsar_torch.aot import warmstart
from tpulsar_torch.obs import metrics
native.load()
snap = metrics.REGISTRY.snapshot()
print(json.dumps({"compiles": warmstart.COMPILES, "hits": snap[
    "tpulsar_compile_cache_hits_total"]["series"]}))
"""


def test_a_native_build_is_an_inline_miss_and_a_load_a_hit(
        tmp_path, monkeypatch):
    """A native build at first use increments the miss family and the
    compile histogram under program="(inline)" and records the
    backend_compile span and the compile_cache_miss instant; the
    summarize tool rolls it up.  A second process loading the library
    counts one hit."""
    cache = tmp_path / "c"
    monkeypatch.setenv("TPULSAR_CACHE_DIR", str(cache))
    monkeypatch.setattr(tnative, "_lib", None)
    misses0 = _series("tpulsar_compile_cache_misses_total").get(
        "(inline)", 0.0)
    seconds0 = _count(_series("tpulsar_backend_compile_seconds").get(
        "(inline)", {"count": 0}))
    compiles0 = dict(cuda_dd.COMPILES)
    ttrace.start(clear=True)
    try:
        tnative.load()
        events = ttrace.events()
    finally:
        ttrace.reset()
    assert _series("tpulsar_compile_cache_misses_total")["(inline)"] == \
        misses0 + 1
    assert _count(_series("tpulsar_backend_compile_seconds")[
        "(inline)"]) == seconds0 + 1
    assert cuda_dd.COMPILES["misses"] == compiles0["misses"] + 1
    assert cuda_dd.COMPILES["hits"] == compiles0["hits"]
    spans = [e for e in events if e["name"] == "backend_compile"]
    assert len(spans) == 1 and spans[0]["ph"] == "X"
    assert spans[0]["args"]["program"] == "(inline)"
    assert spans[0]["dur"] > 0
    assert [e["args"]["program"] for e in events
            if e["name"] == "compile_cache_miss"] == ["(inline)"]
    tracefile = tmp_path / "x_trace.json"
    tracefile.write_text(json.dumps({"traceEvents": events}))
    ts = _tool("torch_trace_summarize")
    roll = ts.compile_rollup(str(tracefile))
    assert roll["(inline)"]["count"] == 1
    assert roll["(inline)"]["events"] == {"backend_compile": 1}
    assert "(inline)" in ts.render_compile_rollup(roll)

    res = subprocess.run([sys.executable, "-c", _HITS_PROBE],
                         env=_env(cache), capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"compiles": {"hits": 1, "misses": 0},
                   "hits": {"(inline)": 1.0}}


def test_summarize_tool_prints_the_compile_rollup(tmp_path, capsys):
    """The tool's table mode prints the compile rollup after the span
    table, its --json mode carries it (the JAX tool's layout)."""
    ts = _tool("torch_trace_summarize")
    tracefile = tmp_path / "x_trace.json"
    tracefile.write_text(json.dumps({"traceEvents": [
        {"name": "aot_compile", "ph": "X", "ts": 0, "dur": 2_000_000,
         "args": {"program": "cuda_dd"}},
        {"name": "backend_compile", "ph": "X", "ts": 1, "dur": 1_900_000,
         "args": {"program": "cuda_dd", "parent": "aot_compile"}},
        {"name": "backend_compile", "ph": "X", "ts": 5, "dur": 500_000,
         "args": {"program": "(inline)"}},
    ]}))
    assert ts.main([str(tracefile)]) == 0
    out = capsys.readouterr().out
    assert "compile rollup (per program):" in out
    assert re.search(r"cuda_dd\s+2\.00\s+1", out)
    assert ts.main([str(tracefile), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["compile_rollup"]["cuda_dd"]["seconds"] == 2.0
    assert doc["compile_rollup"]["(inline)"]["count"] == 1


# ------------------------------------------------------ the cuda_dd lock

_LOCK_PROBE = """
import json, os, sys, time
from tpulsar_torch.kernels import cuda_dd
open(sys.argv[1], "w").close()
while not all(os.path.exists(p) for p in sys.argv[2:]):
    time.sleep(0.01)
path = cuda_dd.build()
print(json.dumps({"compiles": cuda_dd.COMPILES, "path": path}))
"""


def test_two_processes_build_the_cuda_library_once(tmp_path):
    """Two processes on a fresh build directory, released together: the
    file lock lets one run nvcc (a miss) while the other waits and
    finds the library (a hit); nvcc ran once and its ptxas report is
    kept beside the library."""
    bindir, runs = _fake_nvcc(tmp_path)
    cache = tmp_path / "c"
    env = _env(cache, PATH=bindir + os.pathsep + os.environ["PATH"],
               FAKE_NVCC_RUNS=runs, FAKE_NVCC_SLEEP="1")
    ready = [str(tmp_path / f"ready{i}") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOCK_PROBE, ready[i], *ready],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert open(runs).read().split() == ["run"]
    assert sorted((o["compiles"]["misses"], o["compiles"]["hits"])
                  for o in outs) == [(0, 1), (1, 0)]
    path = outs[0]["path"]
    assert outs[1]["path"] == path
    assert os.path.dirname(path) == str(cache)
    with open(path + ".ptxas.txt") as fh:
        assert "Used 1 registers" in fh.read()


# ------------------------------------------------------------ site walk

_SUBPROCESS = {"subprocess.run", "subprocess.Popen", "subprocess.call",
               "subprocess.check_call", "subprocess.check_output"}
_COMPILER = re.compile(r"nvcc|\bCXX\b|g\+\+|\bgcc\b|clang|compiler")


def _compile_sites() -> dict[str, str]:
    """Every function of tpulsar_torch/ that calls ctypes.CDLL or runs
    a compiler through subprocess (an argv naming one, directly or
    through a local assigned in the function):
    {"<path>::<function>": "CDLL" | "compiler"}."""
    found = {}
    pkg = os.path.join(ROOT, "tpulsar_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, ROOT).replace(os.sep, "/")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for fn in ast.walk(tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                local = {t.id: n.value for n in ast.walk(fn)
                         if isinstance(n, ast.Assign)
                         for t in n.targets if isinstance(t, ast.Name)}
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    func = ast.unparse(node.func)
                    if func in ("ctypes.CDLL", "CDLL"):
                        found[f"{rel}::{fn.name}"] = "CDLL"
                    elif func in _SUBPROCESS and node.args:
                        argv = node.args[0]
                        if isinstance(argv, ast.Name):
                            argv = local.get(argv.id, argv)
                        if _COMPILER.search(ast.unparse(argv)):
                            found[f"{rel}::{fn.name}"] = "compiler"
    return found


def test_every_compiler_and_cdll_site_is_registered_or_exempt():
    """The counterpart of tests/test_aot.py's jit-site walk: each
    compiler call and CDLL site of the package is covered by a
    registry entry or listed, with its reason, in EXEMPT_SITES, and
    neither list names a site that is gone."""
    found = _compile_sites()
    covered = registry.registered_sites() | set(registry.EXEMPT_SITES)
    assert set(found) == covered, (sorted(found), sorted(covered))
    assert found["tpulsar_torch/kernels/cuda_dd.py::_compile"] == "compiler"
    assert found["tpulsar_torch/native/__init__.py::_build"] == "compiler"
    assert found["tpulsar_torch/kernels/cuda_dd.py::_load"] == "CDLL"
    assert found["tpulsar_torch/native/__init__.py::load"] == "CDLL"
    assert all(why.strip() for why in registry.EXEMPT_SITES.values())


def test_registry_table_names_the_runtime_callables():
    """native first, then cuda_dd; every attribute an entry names exists
    on its module, and the table itself imports nothing but the
    stdlib."""
    assert [p.name for p in registry.programs()] == ["native", "cuda_dd"]
    assert registry.get("cuda_dd").target == "sm_90a"
    with pytest.raises(KeyError, match="aot ls"):
        registry.get("nope")
    for prog in registry.PROGRAMS:
        mod = registry.module(prog)
        for attr in (prog.flags, prog.compiler, prog.context, prog.load,
                     "build", "library_path"):
            assert hasattr(mod, attr), (prog.name, attr)
        assert mod.SOURCES and all(os.path.exists(s) for s in mod.SOURCES)
    probe = ("import sys\nimport tpulsar_torch.aot.registry, "
             "tpulsar_torch.aot.cachedir\nprint(sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('torch', 'numpy', "
             "'jax', 'tpulsar')))\n")
    res = subprocess.run([sys.executable, "-c", probe], env=_env("/x"),
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res


# ------------------------------------------------------------------ ls

_LS_SHAPE = [re.compile(r"^cache dir: \S+$"),
             re.compile(r"^manifest:  \S+( \(absent\))?$"),
             re.compile(r"^\d+ registered programs:$"),
             re.compile(r"^  [* ] [^\s:]+\s+[^:]+$"),
             re.compile(r"^  \(\* = in the warm-start manifest\)$"),
             re.compile(r"^\d+ exempt \S+ sites \(.+\):$"),
             re.compile(r"^    \S+: .+$")]


def _ls_shape(text: str) -> list[int]:
    """The index of the line pattern each line of an `aot ls` matches,
    repeats collapsed."""
    shape = []
    for line in text.splitlines():
        idx = next(i for i, pat in enumerate(_LS_SHAPE) if pat.match(line))
        if not shape or shape[-1] != idx:
            shape.append(idx)
    return shape


def test_ls_lines_match_the_jax_ls(compiled, monkeypatch, capsys):
    """`aot ls` of both packages on one build directory: the same line
    structure (cache dir, manifest, programs with their marks, the
    exempt sites); the port marks the library in its manifest, and
    the JAX ls (whose manifest schema differs) marks none."""
    monkeypatch.setenv("TPULSAR_CACHE_DIR", str(compiled[0]))
    assert tmain.main(["aot", "ls"]) == 0
    tout = capsys.readouterr().out
    assert jmain.main(["aot", "ls"]) == 0
    jout = capsys.readouterr().out
    assert _ls_shape(tout) == [0, 1, 2, 3, 4, 5, 6]
    assert _ls_shape(jout) == [0, 1, 2, 3, 5, 6]
    assert tout.splitlines()[0] == jout.splitlines()[0]
    marks = {ln[4:].split()[0]: ln[2] for ln in tout.splitlines()
             if _LS_SHAPE[3].match(ln)}
    assert marks == {"native": "*", "cuda_dd": " "}
    assert "(absent)" in jout.splitlines()[1]


# ------------------------------------------------------------ doctor

def test_doctor_build_section_reads_the_resolver_and_manifest(
        compiled, tmp_path):
    """The node doctor's build section names the resolved build
    directory and its manifest, each library with its manifest state,
    and a library left there by other sources as stale."""
    cache = _copy(compiled[0], tmp_path / "b")
    path = os.path.join(cache, cachedir.MANIFEST_NAME)
    man = json.load(open(path))
    rec = man["programs"]["native"]
    rec["library"] = os.path.join(cache, os.path.basename(rec["library"]))
    with open(path, "w") as fh:
        json.dump(man, fh)
    with open(os.path.join(cache, "libtpulsar_native_old_0.so"), "w"):
        pass
    res = subprocess.run(
        [sys.executable, "-m", "tpulsar_torch", "--config",
         _doctor_cfg(tmp_path), "doctor", "--device-timeout", "120"],
        env=_env(cache, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300, cwd=str(tmp_path))
    out = res.stdout.split("build state and pins:")[1]
    assert f"[ok] build dir {cache}: manifest with native" in out
    assert re.search(r"\[ok\] native library: \S+ \(in the manifest\)",
                     out)
    assert re.search(r"\[--\] CUDA kernels: \S+ not built", out)
    assert "[--] 1 stale libraries in the build dir" in out
    assert "libtpulsar_native_old_0.so" in out


# -------------------------------------------------------- the alert rule

def test_compile_miss_on_warm_fires_on_an_inline_miss_only(
        tmp_path, monkeypatch):
    """The rule reads the port's own registry: a library built by the
    boot gate (program="native") leaves it silent, a library built at
    first use after that ((inline)) fires it."""
    bindir, runs = _fake_nvcc(tmp_path)
    monkeypatch.setenv("PATH", bindir + os.pathsep + os.environ["PATH"])
    monkeypatch.setenv("FAKE_NVCC_RUNS", runs)
    monkeypatch.setattr(tnative, "_lib", None)
    spool = tmp_path / "spool"
    spool.mkdir()
    rule = next(r for r in talerts.builtin_rules()
                if r.id == "compile_miss_on_warm")
    det = thealth.HealthDetector(
        str(spool), rules=(rule,), persist=False, journal_events=False,
        notify=False,
        extra_snapshots=lambda: (tmetrics.REGISTRY.snapshot(),))

    def build_cuda(where):
        monkeypatch.setenv("TPULSAR_CACHE_DIR", str(tmp_path / where))
        cuda_dd.build()

    build_cuda("before")               # an (inline) series to sample
    now = time.time()
    assert det.tick(now) == []
    monkeypatch.setenv("TPULSAR_CACHE_DIR", str(tmp_path / "gate"))
    assert warmstart.run_gate(only=("native",), echo=lambda s: None) == 0
    assert _series("tpulsar_compile_cache_misses_total")["native"] >= 1
    assert det.tick(now + 1) == []
    build_cuda("after")
    active = det.tick(now + 2)
    assert [a["rule"] for a in active] == ["compile_miss_on_warm"]
    assert active[0]["value"] == 1.0
    assert open(runs).read().split() == ["run", "run"]
