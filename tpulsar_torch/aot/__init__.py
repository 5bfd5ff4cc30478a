"""The AOT layer of the port: the library registry, the build gate and
its manifest — counterpart of tpulsar/aot/.

In the JAX package this layer gates jitted XLA programs into a
persistent compilation cache.  The port compiles no XLA program; what
it compiles at first use are two shared libraries: the CUDA kernels
(``libtpulsar_dd_<hash>.so``, nvcc, kernels/cuda_dd.py) and the native
host library (``libtpulsar_native_<host>_<hash>.so``, g++,
native/__init__.py).  This layer gates those:

  ``registry``  — the two libraries, each with the module-level
                  callables the runtime itself calls to build and
                  load it (there is no other path to get wrong).
  ``cachedir``  — the one resolver of the build directory
                  (``TPULSAR_CACHE_DIR``, else ``tpulsar_torch/_build``).
  ``warmstart`` — the gate: builds and loads every library, records
                  each one's path, fingerprint, build seconds and
                  ptxas report in ``aot_manifest.json``, verifies a
                  warm process against it (a verify that builds is a
                  miss), and accounts every build and load in the
                  compile-cache families and the trace.

Operator surface: ``python -m tpulsar_torch aot compile|verify|ls``
(rc 0 ok / 1 failures or misses / 3 deadline deferral).  A resident
server boots through ``warmstart.warm_boot`` (verify first, compile
on a miss).

``cachedir`` and ``registry`` are stdlib only: the CLI lists the
libraries and resolves the build directory without torch.
"""

from tpulsar_torch.aot import cachedir  # noqa: F401  (stdlib-only)

__all__ = ["cachedir", "registry", "warmstart"]
