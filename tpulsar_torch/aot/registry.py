"""Declarative registry of every library the port compiles —
counterpart of tpulsar/aot/registry.py.

The JAX package registers jitted programs, each with shape-builders
that derive its canonical compile shapes.  The port has no XLA
program, no ``torch.compile`` graph and no Triton autotune cache: what
it compiles are two shared libraries, each built once from its
sources at first use and bound with ctypes.  A library has no shapes,
so ``make_context``, ``gate_groups`` and the ``_*_instances`` builders
have no counterpart here; an entry names the module, the callables
the runtime itself calls (``library_path``, the build, the load) and
what its fingerprint reads.

A compiler call (``subprocess`` running nvcc or g++) or a
``ctypes.CDLL`` site in the package is either covered by an entry
(``sites``) or listed in :data:`EXEMPT_SITES` with its reason, and
tests/test_torch_aot.py walks the package's ASTs to enforce exactly
that.

stdlib only: the table is importable without torch and without the
card (``aot ls`` prints it); the modules load when a library is gated.
"""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class Program:
    """One registered library.

    ``module`` holds ``SOURCES``, ``library_path()``, ``build()`` (the
    locked build every lookup goes through) and the attributes named
    here: ``flags`` (the compiler flags), ``compiler`` (the compiler's
    path, or a callable returning it), ``context`` (a callable
    returning what else the build depends on, for the fingerprint) and
    ``load`` (the runtime's load, which builds at first use).
    ``sites`` are the compiler and CDLL sites the entry covers, as
    ``<repo-relative-path>::<function>``.  ``title`` names the library
    in the doctor's build section."""

    name: str
    module: str
    title: str
    flags: str
    compiler: str
    target: str
    context: str
    load: str
    sites: tuple[str, ...]
    doc: str = ""


#: every registered library, in gate order
PROGRAMS: tuple[Program, ...] = (
    Program(
        name="native", module="tpulsar_torch.native",
        title="native library", flags="CXX_FLAGS", compiler="CXX",
        target="host (-march=native)", context="_host_tag", load="load",
        sites=("tpulsar_torch/native/__init__.py::_build",
               "tpulsar_torch/native/__init__.py::load"),
        doc="the 4-bit unpack and the hi stage's CPU consumer "
            "(unpack.cpp, accel_host.cpp), g++"),
    Program(
        name="cuda_dd", module="tpulsar_torch.kernels.cuda_dd",
        title="CUDA kernels", flags="NVCC_FLAGS", compiler="_nvcc",
        target="sm_90a", context="_device_tag", load="_load",
        sites=("tpulsar_torch/kernels/cuda_dd.py::_compile",
               "tpulsar_torch/kernels/cuda_dd.py::_load"),
        doc="stage 1 and stage 2 of the dedispersion and the hi "
            "stage's stage kernel (csrc/dedisperse.cu, "
            "csrc/accel_stage.cu), nvcc"),
)


#: compiler and CDLL sites deliberately not in the registry, with the
#: reason
EXEMPT_SITES: dict[str, str] = {
    "tpulsar_torch/aot/warmstart.py::_compiler_version":
        "runs `<compiler> --version` for the fingerprint; compiles "
        "nothing",
}


def programs() -> tuple[Program, ...]:
    return PROGRAMS


def get(name: str) -> Program:
    for p in PROGRAMS:
        if p.name == name:
            return p
    raise KeyError(f"no registered AOT program {name!r} "
                   f"(python -m tpulsar_torch aot ls prints the registry)")


def registered_sites() -> frozenset[str]:
    return frozenset(s for p in PROGRAMS for s in p.sites)


def module(prog: Program):
    """The registered library's module (imported on first call)."""
    return importlib.import_module(prog.module)


def compiler(prog: Program) -> str:
    """The compiler the library is built with (raises when it cannot
    be found, as the build does)."""
    c = getattr(module(prog), prog.compiler)
    return c() if callable(c) else c


def library_path(prog: Program) -> str:
    return module(prog).library_path()
