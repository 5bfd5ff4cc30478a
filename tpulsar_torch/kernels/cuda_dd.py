"""The stage-1 and stage-2 dedispersion kernels: build, bind, launch.

Counterpart of tpulsar/kernels/pallas_dd.py.  The CUDA sources are in
tpulsar_torch/csrc/dedisperse.cu (the design notes are there):

  form_subbands        <- pallas_dd._kernel_sb   (via _form_subbands_block)
  dedisperse_subbands  <- pallas_dd._kernel_roll (via _dedisperse_chunk)

The library is compiled for sm_90a with nvcc at first use, from the
sources in this checkout only, into tpulsar_torch/_build/, and bound
with ctypes.  Each wrapper checks its inputs, allocates its output
with torch.empty, launches on torch.cuda.current_stream(), raises if
the launch is refused, and adds one to LAUNCHES[<name>].  A tensor on
the CPU goes to the plain PyTorch version of the same function (the
``*_plain`` functions below, which the tests hold against the JAX
package); a tensor on any other device is refused.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, "csrc", "dedisperse.cu")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: DM rows per stage-2 launch (the kernel's register accumulators)
DM_ROWS = 32
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232_448

#: launches per kernel since the last reset_counts()
LAUNCHES = {"form_subbands": 0, "dedisperse_subbands": 0}

_lib = None
BUILD_LOG = ""


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    """Build output path, keyed by the sources and flags so that an
    edited source never loads a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtpulsar_dd_{h.hexdigest()[:12]}.so")


def build(verbose_ptxas: bool = False) -> str:
    """Compile the kernels (if not built already) and return the
    library path.  verbose_ptxas adds -Xptxas -v, whose register and
    shared-memory report lands in BUILD_LOG."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path) and not verbose_ptxas:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose_ptxas
                                   else []), "-o", tmp, *SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for name in ("dd_form_subbands_u8", "dd_form_subbands_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [P, I, L, P, I, I, P, P]
            fn.restype = I
        lib.dd_dedisperse.argtypes = [P, I, L, P, P, I, I, P, P]
        lib.dd_dedisperse.restype = I
        lib.dd_dedisperse_smem_bytes.argtypes = [I, I]
        lib.dd_dedisperse_smem_bytes.restype = L
        lib.dd_max_rows.restype = I
        if lib.dd_max_rows() != DM_ROWS:
            raise RuntimeError("kernel library disagrees on DM_ROWS")
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def _host_shifts(shifts, ndim: int, what: str) -> np.ndarray:
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.detach().cpu().numpy()
    arr = np.asarray(shifts)
    if arr.ndim != ndim or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"{what}: expected a {ndim}-d integer shift "
                         f"table, got {arr.dtype} {arr.shape}")
    if arr.size and arr.min() < 0:
        raise ValueError(f"{what}: shifts must be >= 0")
    return arr.astype(np.int64)


def _check_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (plain version); anything else is refused."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {x.device}")


# ------------------------------------------------------------ stage 1

def form_subbands(data: torch.Tensor, chan_shifts, nsub: int,
                  downsamp: int) -> torch.Tensor:
    """Stage 1: (nchan, T) uint8/float32 + per-channel shifts ->
    (nsub, T // downsamp) float32 (see form_subbands_plain)."""
    if not isinstance(data, torch.Tensor) or data.dim() != 2:
        raise ValueError("form_subbands: data must be a 2-d tensor")
    if data.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"form_subbands: dtype {data.dtype} not taken "
                         f"(uint8 or float32)")
    nchan, T = data.shape
    if nsub < 1 or nchan % nsub:
        raise ValueError(f"nchan {nchan} not divisible by nsub {nsub}")
    if downsamp < 1:
        raise ValueError("downsamp must be >= 1")
    sh = _host_shifts(chan_shifts, 1, "form_subbands")
    if len(sh) != nchan:
        raise ValueError(f"form_subbands: {len(sh)} shifts for "
                         f"{nchan} channels")
    if not _check_device(data, "form_subbands"):
        return form_subbands_plain(data, sh, nsub, downsamp)
    if not data.is_contiguous():
        raise ValueError("form_subbands: data must be contiguous")
    if sh.size and sh.max() > np.iinfo(np.int32).max - T:
        raise ValueError("form_subbands: shift out of range")
    lib = _load()
    dev = data.device
    shifts_dev = torch.from_numpy(sh.astype(np.int32)).to(dev)
    out = torch.empty((nsub, T // downsamp), dtype=torch.float32,
                      device=dev)
    fn = (lib.dd_form_subbands_u8 if data.dtype == torch.uint8
          else lib.dd_form_subbands_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(fn(data.data_ptr(), nchan, T, shifts_dev.data_ptr(), nsub,
                  downsamp, out.data_ptr(), stream), "form_subbands")
    LAUNCHES["form_subbands"] += 1
    return out


def form_subbands_plain(data: torch.Tensor, chan_shifts, nsub: int,
                        downsamp: int) -> torch.Tensor:
    """Plain PyTorch stage 1, the reference's _form_subbands_jit:

        out[b, j] = sum_{r<ds} sum_{c<cps} data[b*cps + c,
                                               min(j*ds + r + sh, T-1)]

    Channels are summed in c order, then the ds samples of each output
    in r order (the remainder is dropped).  The edge clamp is an edge-padded copy, as in the
    reference."""
    from tpulsar_torch.kernels import dedisperse as dd

    nchan, T = data.shape
    cps = nchan // nsub
    sh = _host_shifts(chan_shifts, 1, "form_subbands").reshape(nsub, cps)
    pad = dd._pad_bucket(int(sh.max(initial=0)))
    padded = dd._edge_pad(data, pad)
    n_ds = (T // downsamp) * downsamp
    out = torch.empty((nsub, T // downsamp), dtype=torch.float32,
                      device=data.device)
    for b in range(nsub):
        acc = torch.zeros(T, dtype=torch.float32, device=data.device)
        for c in range(cps):
            s = min(int(sh[b, c]), pad)
            acc += padded[b * cps + c, s: s + T].to(torch.float32)
        # sum-downsample in r order, as the kernel's epilogue does
        out[b] = acc[0:n_ds:downsamp]
        for r in range(1, downsamp):
            out[b] += acc[r:n_ds:downsamp]
    return out


# ------------------------------------------------------------ stage 2

def dedisperse_subbands(subb: torch.Tensor, sub_shifts) -> torch.Tensor:
    """Stage 2: (nsub, T) float32 + (ndms, nsub) shifts -> (ndms, T)
    float32 DM series, one kernel launch per DM_ROWS rows (see
    dedisperse_subbands_plain)."""
    if not isinstance(subb, torch.Tensor) or subb.dim() != 2:
        raise ValueError("dedisperse_subbands: subb must be a 2-d tensor")
    if subb.dtype != torch.float32:
        raise ValueError(f"dedisperse_subbands: dtype {subb.dtype} not "
                         f"taken (float32)")
    nsub, T = subb.shape
    sh = _host_shifts(sub_shifts, 2, "dedisperse_subbands")
    if sh.shape[1] != nsub:
        raise ValueError(f"dedisperse_subbands: shift table {sh.shape} "
                         f"vs {nsub} subbands")
    if not _check_device(subb, "dedisperse_subbands"):
        return dedisperse_subbands_plain(subb, sh)
    if not subb.is_contiguous():
        raise ValueError("dedisperse_subbands: subb must be contiguous")
    if sh.size and sh.max() > np.iinfo(np.int32).max - T:
        raise ValueError("dedisperse_subbands: shift out of range")
    lib = _load()
    dev = subb.device
    ndms = sh.shape[0]
    out = torch.empty((ndms, T), dtype=torch.float32, device=dev)
    if ndms == 0:
        return out
    groups = range(0, ndms, DM_ROWS)
    # every launch's (rows, nsub) table and (nsub,) smallest shifts,
    # uploaded in one copy
    host = np.zeros((len(groups), DM_ROWS + 1, nsub), np.int32)
    spans = []
    for gi, g0 in enumerate(groups):
        grp = sh[g0: g0 + DM_ROWS]
        smin = grp.min(axis=0)
        host[gi, :len(grp)] = grp
        host[gi, DM_ROWS] = smin
        span = int((grp - smin).max())
        smem = int(lib.dd_dedisperse_smem_bytes(nsub, span))
        if smem > MAX_SMEM:
            raise ValueError(
                f"dedisperse_subbands: rows {g0}..{g0 + len(grp) - 1} "
                f"span {span} shift samples in one subband, which needs "
                f"{smem} B of shared memory (> {MAX_SMEM})")
        spans.append(span)
    tables = torch.from_numpy(host).to(dev)
    row_bytes = (DM_ROWS + 1) * nsub * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for gi, g0 in enumerate(groups):
            nrows = min(DM_ROWS, ndms - g0)
            base = tables.data_ptr() + gi * row_bytes
            _check(lib.dd_dedisperse(
                subb.data_ptr(), nsub, T, base,
                base + DM_ROWS * nsub * 4, nrows, spans[gi],
                out.data_ptr() + g0 * T * 4, stream),
                "dedisperse_subbands")
            LAUNCHES["dedisperse_subbands"] += 1
    return out


def dedisperse_subbands_plain(subb: torch.Tensor,
                              sub_shifts) -> torch.Tensor:
    """Plain PyTorch stage 2, the reference's _dedisperse_subbands_scan:

        out[d, t] = sum_{s<nsub} subb[s, min(t + shift[d, s], T-1)]

    accumulated in s order from zero, so float32 results are
    bit-identical to the reference's scan."""
    from tpulsar_torch.kernels import dedisperse as dd

    nsub, T = subb.shape
    sh = _host_shifts(sub_shifts, 2, "dedisperse_subbands")
    pad = dd._pad_bucket(int(sh.max(initial=0)))
    padded = dd._edge_pad(subb, pad)
    acc = torch.zeros((sh.shape[0], T), dtype=torch.float32,
                      device=subb.device)
    if sh.shape[0] == 0:
        return acc
    for s in range(nsub):
        row = padded[s]
        starts = np.minimum(sh[:, s], pad)
        acc += torch.stack([row[int(x): int(x) + T] for x in starts])
    return acc
