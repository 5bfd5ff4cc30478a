"""Native (C++) host kernels, bound via ctypes — counterpart of
tpulsar/native/__init__.py.

Two sources, copies of the JAX package's:

  * ``unpack.cpp`` holds the host hot loop of every beam read: packed
    bytes -> samples through 256-entry lookup tables, fused with the
    per-channel calibration (float32) or with the calibration and the
    uint8 requantization of ``read_all_uint8``;
  * ``accel_host.cpp`` is the CPU consumer of the hi-accel stage's
    correlation pieces: harmonic-stage sums, z maxima and the
    block-max top-k in one cache-tiled pass, bit-identical to the
    torch consumer of kernels/accel.py on the same f32 pieces (the
    same float32 addition order and tie rules).  kernels/accel.py
    feeds it every batched hi stage on the CPU.

The library is compiled with g++ at first use into the build
directory (aot/cachedir.py: ``TPULSAR_CACHE_DIR``, else
``tpulsar_torch/_build/``; a name keyed by the host's CPU flags, the
sources and the flags: ``-march=native`` makes a CPU-specific binary)
under a thread lock and a file lock, so the server's prefetch thread,
the search and a second process never build or load a half-written
file.  Each lookup is accounted as a compile-cache hit or miss
(aot/warmstart.py::locked_build); ``python -m tpulsar_torch aot
compile`` builds it ahead of use (aot/registry.py's ``native``).
``-ffp-contract=off`` keeps g++ from contracting ``a*b+c`` into an
FMA, which would change the float rounding against the NumPy and
torch paths.

There is no fallback here: when the library cannot be built or
loaded, ``load`` raises with the compiler's output.  The NumPy unpack
of io/psrfits.py (``SpectraInfo(..., unpack="numpy")``) is the plain
version of the unpack, and a caller picks it explicitly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from tpulsar_torch.aot import cachedir, warmstart

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "unpack.cpp"),
           os.path.join(_HERE, "accel_host.cpp")]
CXX = "g++"
#: the JAX package's flags; the second set is its retry for a
#: toolchain without -march=native (still without FMA contraction)
CXX_FLAGS = (["-O3", "-march=native", "-ffp-contract=off"],
             ["-O3", "-ffp-contract=off"])

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _host_tag() -> str:
    """Per-host build tag from the CPU's flag set: a library built
    with -march=native on one micro-architecture must not be loaded
    on an older one that shares the filesystem."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                if ln.startswith(("flags", "Features")):
                    flags = ln
                    break
    except OSError:
        pass
    return hashlib.sha1((platform.machine() + flags).encode()
                        ).hexdigest()[:10]


def library_path() -> str:
    """Build output path, keyed by the host, the sources and the
    flags, so an edited source never loads a stale library."""
    h = hashlib.sha256(repr(CXX_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(
        cachedir.resolve(),
        f"libtpulsar_native_{_host_tag()}_{h.hexdigest()[:12]}.so")


def _build(path: str) -> None:
    """Compile into ``path`` (through a temporary file and a rename);
    raise RuntimeError with the compiler's output when every flag set
    fails."""
    tmp = f"{path}.{os.getpid()}.tmp"
    logs = []
    for flags in CXX_FLAGS:
        cmd = [CXX, *flags, "-shared", "-fPIC", "-std=c++17", *SOURCES,
               "-o", tmp]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=240)
        except (OSError, subprocess.TimeoutExpired) as e:
            logs.append(f"$ {' '.join(cmd)}\n{e}")
            continue
        if r.returncode == 0 and os.path.exists(tmp):
            os.replace(tmp, path)
            return
        logs.append(f"$ {' '.join(cmd)}\n(exit {r.returncode})\n"
                    f"{r.stdout}{r.stderr}")
    raise RuntimeError("the native library did not build:\n"
                       + "\n".join(logs))


def build() -> str:
    """The library's path, compiled first when it is not on disk: the
    locked, accounted lookup of aot/warmstart.py::locked_build.
    Raises RuntimeError when the library cannot be built."""
    return warmstart.locked_build(library_path(), _build)


def load() -> ctypes.CDLL:
    """The native library, built on first call; raises RuntimeError
    when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        lib = ctypes.CDLL(path)
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        for name in ("tpulsar_unpack4", "tpulsar_unpack2",
                     "tpulsar_unpack1"):
            fn = getattr(lib, name)
            fn.argtypes = [u8p, i16p, ctypes.c_size_t]
            fn.restype = None
        lib.tpulsar_unpack4_cal.argtypes = [
            u8p, f32p, ctypes.c_size_t, ctypes.c_size_t, f32p, f32p]
        lib.tpulsar_unpack4_cal.restype = None
        lib.tpulsar_unpack4_q8.argtypes = [
            u8p, u8p, ctypes.c_size_t, ctypes.c_size_t, f32p, f32p]
        lib.tpulsar_unpack4_q8.restype = None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.tpulsar_accel_stage_topk_zsegs.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, f32p, i32p, i32p]
        lib.tpulsar_accel_stage_topk_zsegs.restype = None
        _lib = lib
        return _lib


def unpack_bits(raw: np.ndarray, nbits: int) -> np.ndarray:
    """Unpack (..., nbytes) uint8 -> (..., nsamples) int16, high bits
    first (the PSRFITS order), for nbits 4, 2 or 1."""
    if nbits not in (4, 2, 1):
        raise ValueError(f"native unpack takes 4, 2 or 1 bits, not "
                         f"{nbits}")
    lib = load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    per = 8 // nbits
    out = np.empty(raw.shape[:-1] + (raw.shape[-1] * per,),
                   dtype=np.int16)
    fn = {4: lib.tpulsar_unpack4, 2: lib.tpulsar_unpack2,
          1: lib.tpulsar_unpack1}[nbits]
    fn(raw.reshape(-1), out.reshape(-1), raw.size)
    return out


def _affine(name: str, a, b, nchan: int):
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    if a.shape != (nchan,) or b.shape != (nchan,):
        raise ValueError(f"{name}: per-channel arrays of shape "
                         f"({nchan},) expected, got {a.shape}, {b.shape}")
    return a, b


def unpack4_quantize(raw: np.ndarray, a: np.ndarray,
                     b: np.ndarray) -> np.ndarray:
    """Fused 4-bit unpack + affine requantization: (nspec, nchan/2)
    uint8 packed -> (nspec, nchan) uint8, out = clip(rint(x*a+b))."""
    lib = load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    nspec, nb = raw.shape
    nchan = nb * 2
    a, b = _affine("unpack4_quantize", a, b, nchan)
    out = np.empty((nspec, nchan), dtype=np.uint8)
    lib.tpulsar_unpack4_q8(raw, out, nspec, nchan, a, b)
    return out


def unpack4_calibrate(raw: np.ndarray, scales: np.ndarray,
                      offsets: np.ndarray) -> np.ndarray:
    """Fused 4-bit unpack + per-channel scale/offset: (nspec, nchan/2)
    uint8 -> (nspec, nchan) float32."""
    lib = load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    nspec, nb = raw.shape
    nchan = nb * 2
    scales, offsets = _affine("unpack4_calibrate", scales, offsets, nchan)
    out = np.empty((nspec, nchan), dtype=np.float32)
    lib.tpulsar_unpack4_cal(raw, out, nspec, nchan, scales, offsets)
    return out


def _stages_arg(stages) -> np.ndarray:
    stages = np.ascontiguousarray(stages, dtype=np.int32)
    if stages.size == 0 or stages[0] != 1:
        # the kernel seeds its accumulator at stage 1
        raise ValueError(f"harmonic stages must start at 1, got "
                         f"{stages.tolist()}")
    return stages


def _f32(name: str, a: np.ndarray, ndim: int) -> np.ndarray:
    if a.dtype != np.float32 or a.ndim != ndim:
        raise ValueError(f"{name}: a float32 array of {ndim} axes "
                         f"expected, got {a.dtype} {a.shape}")
    return np.ascontiguousarray(a)


def _topk_out(nd: int, ns: int, topk: int):
    return (np.empty((nd, ns, topk), np.float32),
            np.empty((nd, ns, topk), np.int32),
            np.empty((nd, ns, topk), np.int32))


def accel_stage_topk_zsegs(pieces: list, width: int, nr: int,
                           stages, block_r: int, topk: int):
    """Harmonic-stage sums, z maxima and the per-stage block-max top-k
    of a DM block, read from the correlation's power pieces still split
    by z chunk: one (nd, nsegs, zc, 2*step) float32 buffer per chunk of
    the correlation's
    z loop (kernels/accel._corr_piece_list), addressed through a
    pointer table, so no full plane is ever assembled.  Every chunk but
    the last has zc rows; the last holds the remainder, 1..zc rows (a
    taller one would index past the pointer table).  Raises ValueError
    on an inconsistent layout.  Returns (vals, rbins, zidx), each
    (nd, nstages, topk)."""
    lib = load()
    stages = _stages_arg(stages)
    if not pieces:
        raise ValueError("accel_stage_topk_zsegs: no pieces")
    arrs = [_f32("accel_stage_topk_zsegs", p, 4) for p in pieces]
    nd, nsegs, zchunk, two_step = arrs[0].shape
    nz = 0
    for i, p in enumerate(arrs):
        if (p.shape[0], p.shape[1], p.shape[3]) != (nd, nsegs, two_step) \
                or (i < len(arrs) - 1 and p.shape[2] != zchunk) \
                or not 1 <= p.shape[2] <= zchunk:
            raise ValueError(f"accel_stage_topk_zsegs: piece {i} of shape "
                             f"{p.shape} does not follow "
                             f"{arrs[0].shape}")
        nz += p.shape[2]
    out = _topk_out(nd, int(stages.size), topk)
    table = (ctypes.c_void_p * len(arrs))(*[p.ctypes.data for p in arrs])
    lib.tpulsar_accel_stage_topk_zsegs(
        table, len(arrs), int(zchunk), nd, nsegs, int(nz),
        int(two_step), int(width), int(nr), stages, int(stages.size),
        int(block_r), int(topk), *out)
    return out
