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
from typing import NamedTuple

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, "csrc", "dedisperse.cu")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: stage-2 geometry, as in dedisperse.cu (held against the library
#: when it is loaded): DM rows a block owns at most, time samples per
#: tile, ring stages and subbands per stage
DD_GROUP_ROWS = 20
DD_TILE = 1024
DD_STAGES = 2
DD_SUB_PER_STAGE = 8
#: shared memory one block may use on Hopper (bytes)
MAX_SMEM = 232_448

#: launches per kernel since the last reset_counts()
LAUNCHES = {"form_subbands": 0, "dedisperse_subbands": 0}

_lib = None
_prepared: set[int] = set()
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
        lib.dd_dedisperse.argtypes = [P, I, L, P, I, I, I, I, P, P]
        lib.dd_dedisperse.restype = I
        lib.dd_dedisperse_smem_bytes.argtypes = [I, I]
        lib.dd_dedisperse_smem_bytes.restype = L
        lib.dd_group_rows.argtypes = []
        lib.dd_group_rows.restype = I
        lib.dd_prepare.argtypes = []
        lib.dd_prepare.restype = I
        lib.dd_form_subbands_smem_bytes.argtypes = [I, I, I]
        lib.dd_form_subbands_smem_bytes.restype = L
        lib.dd_blocks_per_sm.argtypes = [I, I, L]
        lib.dd_blocks_per_sm.restype = I
        if lib.dd_group_rows() != DD_GROUP_ROWS or any(
                lib.dd_dedisperse_smem_bytes(nsub, span)
                != stage2_smem_bytes(nsub, span)
                for nsub in (1, 7, 96) for span in (0, 151, 1001)):
            raise RuntimeError("kernel library disagrees with "
                               "stage2_launch's geometry")
        _lib = lib
    return _lib


def _prepare(dev: torch.device) -> None:
    """Raise the kernels' shared-memory limit, once per device."""
    idx = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if idx not in _prepared:
        with torch.cuda.device(idx):
            _check(_load().dd_prepare(), "dd_prepare")
        _prepared.add(idx)


def _blocks_per_sm(kernel: int, rows: int, smem: int) -> int:
    lib = _load()
    _prepare(torch.device("cuda"))
    n = lib.dd_blocks_per_sm(kernel, rows, smem)
    if n < 0:
        raise RuntimeError(f"dd_blocks_per_sm: CUDA error {-n}")
    return n


def stage1_occupancy(nchan: int, nsub: int, downsamp: int,
                     dtype: torch.dtype) -> tuple[int, int]:
    """(stage-1 blocks that fit one SM, shared bytes a block) at a
    shape, as the CUDA runtime of the current device reports them."""
    u8 = dtype == torch.uint8
    smem = int(_load().dd_form_subbands_smem_bytes(nchan // nsub, downsamp,
                                                   int(u8)))
    return _blocks_per_sm(1 if u8 else 2, 0, smem), smem


def stage2_occupancy(sub_shifts) -> tuple[int, int]:
    """(stage-2 blocks that fit one SM, shared bytes a block) for a
    shift table, as the CUDA runtime of the current device reports."""
    plan = stage2_launch(sub_shifts)
    return _blocks_per_sm(0, plan.rows, plan.smem_bytes), plan.smem_bytes


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
    _prepare(dev)
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

def stage2_smem_bytes(nsub: int, span: int) -> int:
    """Shared memory of one stage-2 block (dd_dedisperse_smem_bytes):
    two mbarriers, the group's shift table and smallest shifts, then
    DD_STAGES stages of DD_SUB_PER_STAGE segments of tile + span (+ up
    to 3 samples of misalignment) floats, each a whole number of
    16-byte vectors."""
    table_ints = -(-(nsub * (DD_GROUP_ROWS + 1)) // 4) * 4
    seg_floats = -(-(DD_TILE + span + 3) // 4) * 4
    return (16 + 4 * table_ints
            + 4 * DD_STAGES * DD_SUB_PER_STAGE * seg_floats)


class Stage2Launch(NamedTuple):
    """The one launch that stage 2 makes for a (ndms, nsub) shift
    table: `groups` row groups of `rows` rows (the last may hold
    fewer), the largest span of shifts within one group and subband,
    the shared bytes a block needs, and the (groups, table_ints) int32
    tables the kernel reads: per group, rows' shifts minus the group's
    smallest shift for each subband laid out [s][row] (DD_GROUP_ROWS
    wide), then those smallest shifts, then zeros to a 16-byte
    multiple."""
    groups: int
    rows: int
    span: int
    smem_bytes: int
    tables: np.ndarray


def stage2_launch(sub_shifts) -> Stage2Launch:
    """Launch arithmetic of stage 2, on the host and without the
    library.  Rows are cut into the fewest groups of at most
    DD_GROUP_ROWS, of equal size (38 -> 2 x 19, 64 -> 4 x 16, 76 ->
    4 x 19).  Raises ValueError when the span needs more shared memory
    than a block has: there is no other path."""
    sh = _host_shifts(sub_shifts, 2, "dedisperse_subbands")
    ndms, nsub = sh.shape
    if ndms == 0:
        raise ValueError("dedisperse_subbands: no DM rows")
    groups = -(-ndms // DD_GROUP_ROWS)
    rows = -(-ndms // groups)
    table_ints = -(-(nsub * (DD_GROUP_ROWS + 1)) // 4) * 4
    tables = np.zeros((groups, table_ints), np.int32)
    span = 0
    for g in range(groups):
        grp = sh[g * rows: (g + 1) * rows]
        smin = grp.min(axis=0)
        rel = np.zeros((nsub, DD_GROUP_ROWS), np.int64)
        rel[:, :len(grp)] = (grp - smin).T
        tables[g, :nsub * DD_GROUP_ROWS] = rel.reshape(-1)
        tables[g, nsub * DD_GROUP_ROWS: nsub * (DD_GROUP_ROWS + 1)] = smin
        span = max(span, int(rel.max()))
    smem = stage2_smem_bytes(nsub, span)
    if smem > MAX_SMEM:
        raise ValueError(
            f"dedisperse_subbands: a span of {span} shift samples within "
            f"one row group and subband needs {smem} B of shared memory "
            f"(> {MAX_SMEM})")
    return Stage2Launch(groups, rows, span, smem, tables)


def dedisperse_subbands(subb: torch.Tensor, sub_shifts) -> torch.Tensor:
    """Stage 2: (nsub, T) float32 + (ndms, nsub) shifts -> (ndms, T)
    float32 DM series, in one kernel launch (see stage2_launch and
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
    dev = subb.device
    ndms = sh.shape[0]
    out = torch.empty((ndms, T), dtype=torch.float32, device=dev)
    if ndms == 0:
        return out
    plan = stage2_launch(sh)
    lib = _load()
    _prepare(dev)
    tables = torch.from_numpy(plan.tables).to(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.dd_dedisperse(
            subb.data_ptr(), nsub, T, tables.data_ptr(), ndms, plan.groups,
            plan.rows, plan.span, out.data_ptr(), stream),
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
