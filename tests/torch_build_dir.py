"""A build directory of its own for each port test module that boots a
SearchServer or builds one of the port's libraries.

A server's boot runs the AOT gate (``warmstart.warm_boot``), which
verifies — and on a miss rebuilds, under a file lock — the native
library in ``TPULSAR_CACHE_DIR``, by default the repository's shared
``tpulsar_torch/_build/``.  Under pytest-xdist several processes boot
servers and build libraries at once; on the shared directory they
wait on each other's builds and locks inside tests that hold a
deadline.  Importing ``own_build_dir`` into a test module gives the
module (and every server or job subprocess its tests start with the
environment) a private directory under pytest's temporary root, with
the native library built and in the manifest before the module's first
test, so that a boot inside a test only verifies.  A test that needs
another directory still sets ``TPULSAR_CACHE_DIR`` itself.
"""

from __future__ import annotations

import pytest


@pytest.fixture(autouse=True, scope="module")
def own_build_dir(tmp_path_factory):
    from tpulsar_torch.aot import warmstart

    path = tmp_path_factory.mktemp("torch_build")
    lines: list[str] = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULSAR_CACHE_DIR", str(path))
        rc = warmstart.run_gate(only=("native",), echo=lines.append)
        assert rc == 0, "\n".join(lines)
        yield path
