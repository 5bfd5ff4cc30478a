"""A name-by-name audit of the port against the JAX package.

Every ``.py`` file under ``tpulsar/`` maps to its counterpart under
``tpulsar_torch/`` (the same relative path, unless MOVED or LEFT_OUT
say otherwise).  Every public top-level function or class of the JAX
module, and every public method of a public class, must have a
same-named counterpart in the port's file(s), be RENAMED to a name the
port has there, or stand in EXEMPT with the reason the port has no
use for it.  The tables cannot rot: an entry the port no longer needs
(the name now exists, the JAX name is gone, a left-out file appeared)
is a failure too.

The audit reads both trees with ``ast`` and imports neither package.
Private (``_``-prefixed) names are out of its scope.
"""

from __future__ import annotations

import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "tpulsar")
PORT = os.path.join(ROOT, "tpulsar_torch")

#: JAX module -> the port's files that hold its counterparts
MOVED = {
    "kernels/pallas_dd.py": ("kernels/cuda_dd.py", "csrc/dedisperse.cu"),
    "orchestrate/downloader.py": ("orchestrate/downloader.py",
                                  "orchestrate/transports.py"),
}

#: JAX modules with no counterpart file, and why
LEFT_OUT = {
    "parallel/compat.py": "the spelling of jax.shard_map across jax "
                          "versions; parallel/mesh.py::shard_map is the "
                          "port's one spelling",
}

#: (JAX module, name) -> the port's name for the same function
RENAMED = {
    ("kernels/pallas_dd.py", "form_subbands_pallas"): "form_subbands",
    ("kernels/pallas_dd.py", "dedisperse_subbands_pallas"):
        "dedisperse_subbands",
}

_JAX_PLATFORM = ("a JAX platform workaround; the port resolves its "
                 "device with resolve_device")
_XLA_CACHE = ("the XLA persistent compilation cache; the port's build "
              "directory holds two shared libraries (library_entries)")
_XLA_REGISTRY = ("the XLA program registry of the AOT gate; the port "
                 "gates two shared libraries, not programs")
_PALLAS_GATE = ("the Pallas kernels' TPU gating, smoke tests and XLA "
                "fallback; the port's CUDA kernels have no fallback")
_OLD_NATIVE = ("a probe of older native builds; the port always builds "
               "accel_stage_topk_zsegs from its own source")
_DD_TREE = ("the two-level tree behind TPULSAR_DD_TREE; the port's one "
            "tree family is kernels/tree_dd.py (TPULSAR_DD_FAMILY=tree)")

_TRACE_SYNC = ("the opt-in fence of TPULSAR_TRACE_SYNC; the port times "
               "each stage on the card with CUDA events, read where it "
               "already waits (search/report.py), so nothing fences for "
               "the trace")

#: (JAX module, name) -> why the port has no counterpart
EXEMPT = {
    ("__init__.py", "apply_platform_env"): _JAX_PLATFORM,
    ("__init__.py", "cpu_subprocess_env"): _JAX_PLATFORM,
    ("__init__.py", "probe_device_subprocess"): _JAX_PLATFORM,
    ("analysis/checkers.py", "BenchKeysChecker.finalize"):
        "the bench-keys checker judges the benchmark's gate, which the "
        "port gets with its benchmark (ROADMAP item 26)",
    ("aot/cachedir.py", "activate"): _XLA_CACHE,
    ("aot/cachedir.py", "activate_if_configured"): _XLA_CACHE,
    ("aot/cachedir.py", "cache_entries"): _XLA_CACHE,
    ("aot/cachedir.py", "repo_root"): _XLA_CACHE,
    ("aot/registry.py", "GateContext"): _XLA_REGISTRY,
    ("aot/registry.py", "Instance"): _XLA_REGISTRY,
    ("aot/registry.py", "block_dtype"): _XLA_REGISTRY,
    ("aot/registry.py", "block_dtype_name"): _XLA_REGISTRY,
    ("aot/registry.py", "gate_groups"): _XLA_REGISTRY,
    ("aot/registry.py", "jitted"): _XLA_REGISTRY,
    ("aot/registry.py", "make_context"): _XLA_REGISTRY,
    ("aot/registry.py", "step_geometries"): _XLA_REGISTRY,
    ("aot/warmstart.py", "install_runtime_monitor"):
        "the jax.monitoring listeners; the port counts its builds in "
        "locked_build",
    ("kernels/beam_batch.py", "coalesce_dd_ok"):
        "the probe of the coalesced Pallas program; the port's "
        "stage-2 kernel takes the beam axis itself",
    ("kernels/dedisperse.py", "TreePlan"): _DD_TREE,
    ("kernels/dedisperse.py", "build_tree_plan"): _DD_TREE,
    ("kernels/dedisperse.py", "dedisperse_subbands_tree"): _DD_TREE,
    ("kernels/pallas_dd.py", "disable_signature"): _PALLAS_GATE,
    ("kernels/pallas_dd.py", "forced"): _PALLAS_GATE,
    ("kernels/pallas_dd.py", "is_tpu_backend"): _PALLAS_GATE,
    ("kernels/pallas_dd.py", "kernel_variant"): _PALLAS_GATE,
    ("kernels/pallas_dd.py", "sb_smoke_test_ok"): _PALLAS_GATE,
    ("kernels/pallas_dd.py", "signature_enabled"): _PALLAS_GATE,
    ("kernels/pallas_dd.py", "smoke_test_ok"): _PALLAS_GATE,
    ("kernels/pallas_dd.py", "use_pallas"): _PALLAS_GATE,
    ("kernels/pallas_dd.py", "use_pallas_sb"): _PALLAS_GATE,
    ("native/__init__.py", "accel_stage_topk"): _OLD_NATIVE,
    ("native/__init__.py", "accel_stage_topk_segs"): _OLD_NATIVE,
    ("native/__init__.py", "has_accel_zsegs"): _OLD_NATIVE,
    ("obs/trace.py", "fence"): _TRACE_SYNC,
    ("obs/trace.py", "sync_enabled"): _TRACE_SYNC,
}


def _jax_modules() -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(JAX):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.relpath(os.path.join(dirpath, f), JAX)
                .replace(os.sep, "/")
                for f in filenames if f.endswith(".py")]
    return sorted(out)


def _top_level(tree: ast.Module):
    """The statements that bind module-level names, through top-level
    if/try blocks."""
    stack = list(tree.body)
    while stack:
        node = stack.pop(0)
        if isinstance(node, (ast.If, ast.Try)):
            stack[:0] = node.body + node.orelse + getattr(
                node, "finalbody", []) + [
                s for h in getattr(node, "handlers", []) for s in h.body]
        else:
            yield node


def _bound(node) -> list[str]:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        return [n.id for t in targets for n in ast.walk(t)
                if isinstance(n, ast.Name)]
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in node.names]
    return []


def _parse(path: str) -> ast.Module:
    with open(path) as fh:
        return ast.parse(fh.read(), path)


def _public(path: str) -> list[str]:
    """The audited names of a JAX module: public functions and classes
    at top level, and ``Class.method`` for each public method of a
    public class."""
    names = []
    for node in _top_level(_parse(path)):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) \
                and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not m.name.startswith("_")]
    return names


def _port_names(files: tuple[str, ...]) -> set[str]:
    """Every name the port's files bind at top level, and
    ``Class.attr`` for what each class defines or inherits from a class
    of the same files."""
    names: set[str] = set()
    classes: dict[str, ast.ClassDef] = {}
    for rel in files:
        if not rel.endswith(".py"):
            continue
        for node in _top_level(_parse(os.path.join(PORT, rel))):
            names.update(_bound(node))
            if isinstance(node, ast.ClassDef):
                classes[node.name] = node

    def attrs(cls: ast.ClassDef, seen: frozenset = frozenset()):
        own = {n for s in cls.body for n in _bound(s)}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes \
                    and base.id not in seen:
                own |= attrs(classes[base.id], seen | {cls.name})
        return own

    for cname, cls in classes.items():
        names.update(f"{cname}.{a}" for a in attrs(cls))
    return names


def _port_files(mod: str) -> tuple[str, ...]:
    return MOVED.get(mod, (mod,))


def _missing(mod: str) -> list[str]:
    have = _port_names(_port_files(mod))
    return [n for n in _public(os.path.join(JAX, mod))
            if n not in have and (mod, n) not in EXEMPT
            and (mod, n) not in RENAMED]


JAX_MODULES = _jax_modules()


def test_the_walk_sees_the_whole_jax_package():
    assert len(JAX_MODULES) > 100
    for mod in ("kernels/pallas_dd.py", "search/executor.py",
                "__init__.py", "parallel/compat.py"):
        assert mod in JAX_MODULES


@pytest.mark.parametrize("mod", JAX_MODULES)
def test_every_public_name_has_a_counterpart(mod):
    """The module has its counterpart file(s), and each public name of
    it a counterpart there, a rename, or an exemption."""
    if mod in LEFT_OUT:
        assert not os.path.exists(os.path.join(PORT, mod)), \
            f"{mod} is LEFT_OUT but the port has it"
        return
    for rel in _port_files(mod):
        assert os.path.isfile(os.path.join(PORT, rel)), \
            f"no tpulsar_torch/{rel} for tpulsar/{mod}"
    assert _missing(mod) == [], (
        f"tpulsar/{mod}: no counterpart in tpulsar_torch/"
        f"{', tpulsar_torch/'.join(_port_files(mod))} and no EXEMPT "
        f"entry")


def test_tables_are_not_stale():
    """Every table entry still excuses something: its JAX module and
    name exist, an exempted name is still absent from the port, and a
    rename's target is present."""
    for mod in list(MOVED) + list(LEFT_OUT):
        assert mod in JAX_MODULES, f"{mod} is no longer in tpulsar/"
        assert mod not in MOVED or mod not in LEFT_OUT
    for (mod, name), reason in EXEMPT.items():
        assert reason and mod in JAX_MODULES and mod not in LEFT_OUT
        assert name in _public(os.path.join(JAX, mod)), \
            f"EXEMPT ({mod}, {name}): the JAX module has no such name"
        assert name not in _port_names(_port_files(mod)), \
            f"EXEMPT ({mod}, {name}) is stale: the port has the name"
    for (mod, name), port_name in RENAMED.items():
        have = _port_names(_port_files(mod))
        assert name in _public(os.path.join(JAX, mod))
        assert name not in have and port_name in have, (mod, name)
    for mod, reason in LEFT_OUT.items():
        assert reason


def test_exempt_names_are_only_the_tpu_and_jax_runtime_and_item_26():
    """What the port lacks is written down: the exemptions are the
    JAX/TPU runtime's, the older native probes, the second tree pin,
    the Pallas probe of the batch path, the trace's opt-in fence and
    the benchmark's checker —
    the one the port's benchmark (ROADMAP item 26) will close."""
    open_items = [k for k, why in EXEMPT.items() if "item 26" in why]
    assert open_items == [("analysis/checkers.py",
                           "BenchKeysChecker.finalize")]
    assert len(EXEMPT) == 35


def test_the_audit_catches_a_missing_name(tmp_path, monkeypatch):
    """A JAX module with a public function and a public method the
    port's file lacks yields both names; an exemption silences one."""
    jdir, pdir = tmp_path / "tpulsar", tmp_path / "tpulsar_torch"
    jdir.mkdir()
    pdir.mkdir()
    (jdir / "m.py").write_text(
        "def kept():\n    pass\n\n\ndef gone():\n    pass\n\n\n"
        "class C:\n    def run(self):\n        pass\n\n"
        "    def _private(self):\n        pass\n\n\n"
        "def _helper():\n    pass\n")
    (pdir / "m.py").write_text(
        "from os import path as kept\n\n\nclass B:\n"
        "    def other(self):\n        pass\n\n\nclass C(B):\n"
        "    pass\n")
    this = sys.modules[__name__]
    monkeypatch.setattr(this, "JAX", str(jdir))
    monkeypatch.setattr(this, "PORT", str(pdir))
    assert _missing("m.py") == ["gone", "C.run"]
    monkeypatch.setitem(EXEMPT, ("m.py", "gone"), "a reason")
    assert _missing("m.py") == ["C.run"]
