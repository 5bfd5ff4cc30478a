"""The one resolver of the port's build directory — counterpart of
tpulsar/aot/cachedir.py.

The port's compiled artifacts are its two shared libraries (the nvcc
build of csrc/*.cu, the g++ build of native/*.cpp), their
ptxas reports and the AOT manifest.  Every layer that reads or writes
them routes through :func:`resolve`:

  1. ``TPULSAR_CACHE_DIR``          (the operator's knob)
  2. ``tpulsar_torch/_build/``      (the default, beside the sources)

There is no ``JAX_COMPILATION_CACHE_DIR`` step and no ``activate()``:
nothing in this package reads either.  The directory is resolved at
call time, so a process (or a test) that sets the knob after import
builds and loads there.

stdlib only.
"""

from __future__ import annotations

import os

#: the AOT manifest's file name inside the build directory (the JAX
#: package's name)
MANIFEST_NAME = "aot_manifest.json"

#: the default build directory (listed in .gitignore)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")


def resolve() -> str:
    """The build directory for this process (not created; see
    :func:`ensured`)."""
    val = os.environ.get("TPULSAR_CACHE_DIR", "").strip()
    if val:
        return os.path.abspath(os.path.expanduser(val))
    return DEFAULT_DIR


def ensured() -> str:
    """:func:`resolve`, with the directory created."""
    d = resolve()
    os.makedirs(d, exist_ok=True)
    return d


def manifest_path() -> str:
    """Where the AOT manifest lives for this build directory."""
    return os.path.join(resolve(), MANIFEST_NAME)


def library_entries() -> frozenset[str]:
    """The shared libraries currently in the build directory (file
    names; temporary files of a build in progress excluded)."""
    try:
        names = os.listdir(resolve())
    except OSError:
        return frozenset()
    return frozenset(n for n in names if n.endswith(".so"))
