"""Distributed FFT: time-axis ("sequence") parallelism for series too
long for one device — counterpart of tpulsar/parallel/dist_fft.py.

The time axis is sharded over the mesh and the FFT is the classic
four-step algorithm, with the transposes as tiled all-to-alls
(parallel/collectives.py):

  x (length N = A*B, viewed as rows[a, b] = x[a*B+b], rows sharded)
    1. all_to_all transpose so each shard holds all a for a b-chunk
    2. local FFT along a              -> F1[k1, b]
    3. twiddle exp(-2*pi*i*k1*b/N)
    4. all_to_all transpose back so each shard holds all b for a
       k1-chunk
    5. local FFT along b              -> out[k1, k2] = X[k1 + A*k2]

The local FFTs are torch.fft (cuFFT on the card).  The output stays in
(k1, k2) "transposed digit" order with an index map; downstream
power-spectrum consumers use it directly (candidate bins are mapped
back to true frequencies on the host — no global re-sort).

A sharded series is a list of per-shard tensors in shard order (the
natural contiguous blocks of the series), each on its shard's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpulsar_torch.kernels.singlepulse import median_lastdim
from tpulsar_torch.parallel import collectives as coll
from tpulsar_torch.parallel.mesh import Mesh, shard_map


def _axis_size(mesh: Mesh, axis_name: str) -> int:
    if axis_name != "dm":
        raise ValueError(f"the mesh shards time over 'dm', not "
                         f"{axis_name!r}")
    return int(mesh.shape[axis_name])


def _shards(x, mesh: Mesh) -> list[torch.Tensor]:
    """A series as its per-shard blocks: a list passes through, a whole
    tensor is split into contiguous blocks."""
    if isinstance(x, list):
        return x
    return shard_map(lambda i, s: s, mesh, (0,), torch.as_tensor(x))


def dist_fft(x, mesh: Mesh, axis_name: str = "dm"
             ) -> list[torch.Tensor]:
    """FFT of a complex series sharded along its (single) axis.

    x: the (N,) series, a whole tensor or its per-shard blocks; N =
    A*B with the axis size dividing A and B.  Returns the spectrum in
    transposed-digit order, (A, B) with out[k1, k2] = X[k1 + A*k2],
    as its per-shard row blocks (A / n, B)."""
    n = _axis_size(mesh, axis_name)
    parts = [p.to(torch.complex64) for p in _shards(x, mesh)]
    N = sum(p.shape[0] for p in parts)
    A = _choose_A(N, n)
    B = N // A
    A_loc, B_loc = A // n, B // n

    # --- transpose 1: (A_loc, B) rows -> (A, B_loc) columns
    t1 = coll.all_to_all(
        [p.reshape(A_loc, n, B_loc).transpose(0, 1) for p in parts],
        split_dim=0, concat_dim=0)

    def columns(i, t):
        cols = t.reshape(A, B_loc)                     # [a, b_loc]
        # the DFT over the slow digit comes first
        f1 = torch.fft.fft(cols, dim=0)                # [k1, b_loc]
        # twiddle exp(-2 pi i k1 b / N) at the reference's precision:
        # the phase in float32, exp in complex64
        b_idx = i * B_loc + torch.arange(B_loc, device=t.device)
        k1 = torch.arange(A, device=t.device)
        prod = (k1[:, None] * b_idx[None, :]).to(torch.float32)
        phase = (np.float32(-2 * math.pi) * prod) / np.float32(N)
        tw = torch.exp(torch.complex(torch.zeros_like(phase), phase))
        return (f1 * tw).reshape(n, A_loc, B_loc)

    g = shard_map(columns, mesh, (0,), t1)
    # --- transpose 2: (A, B_loc) -> (A_loc, B), then the FFT along b
    t2 = coll.all_to_all(g, split_dim=0, concat_dim=0)
    return shard_map(
        lambda i, t: torch.fft.fft(t.transpose(0, 1).reshape(A_loc, B),
                                   dim=1),
        mesh, (0,), t2)


def _choose_A(N: int, n_dev: int) -> int:
    """Pick A ~ sqrt(N) with n_dev | A and n_dev | N//A."""
    A = int(np.sqrt(N))
    while A > n_dev:
        if N % A == 0 and A % n_dev == 0 and (N // A) % n_dev == 0:
            return A
        A -= 1
    return n_dev


def transposed_index_map(N: int, A: int) -> tuple[np.ndarray, int]:
    """Host-side map between transposed-digit order and natural order:
    out[k1, k2] = X[k1 + A*k2].  Returns (to_natural, B) where
    to_natural[k1, k2] = k1 + A*k2."""
    B = N // A
    k1 = np.arange(A)[:, None]
    k2 = np.arange(B)[None, :]
    return k1 + A * k2, B


def dist_fft_natural(x: np.ndarray, mesh: Mesh, axis_name: str = "dm"
                     ) -> np.ndarray:
    """Host in/out, natural order (tests and moderate sizes);
    production consumers keep the transposed order."""
    N = len(x)
    A = _choose_A(N, _axis_size(mesh, axis_name))
    parts = dist_fft(torch.from_numpy(np.ascontiguousarray(x)), mesh,
                     axis_name)
    Xt = torch.cat([p.cpu() for p in parts]).numpy()
    idx, _B = transposed_index_map(N, A)
    out = np.empty(N, dtype=np.complex64)
    out[idx.ravel()] = Xt.ravel()
    return out


# ----------------------------------------------- distributed spectral search
#
# The production consumer (the executor's seq-shard spectral tail,
# gated on the per-trial series size): search ONE ultra-long real
# series whose padded complex spectrum does not fit a device.  The
# spectrum stays sharded in transposed-digit order end to end; only
# the top-k candidate bins are gathered.
#
# Whitening in transposed order: shard d's rows k1 in
# [d*A_loc, (d+1)*A_loc) hold natural bins k = k1 + A*k2 — for every
# k2, a contiguous run of A_loc bins, strided A apart.  Each shard
# therefore sees an A_loc/A uniform sample of every whitening block,
# so per-shard block medians are an unbiased estimate of the global
# block medians — deliberately NOT bit-identical to the single-device
# whitening (a documented statistical tolerance instead of a 2x memory
# blow-up).  Harmonic summing is fundamental-only here.


def dist_spectral_topk(x_sharded, mesh: Mesh, axis_name: str,
                       N: int, topk: int = 64, block: int = 1 << 15):
    """Top-k whitened power bins of a length-N complex series sharded
    over `axis_name` (natural contiguous shards, N = A*B as in
    dist_fft; a whole tensor is split here).

    Returns (powers[topk], bins[topk]) as NumPy, bins in NATURAL
    frequency order, powers whitened to unit-mean noise.  Only each
    shard's top-k is gathered."""
    n = _axis_size(mesh, axis_name)
    xt = dist_fft(x_sharded, mesh, axis_name)        # (A_loc, B) rows
    A = _choose_A(N, n)
    B = N // A
    A_loc = A // n

    def tail(d, xt_shard):
        # xt_shard: (A_loc, B), row k1 -> natural bins k1 + A*k2
        pw = xt_shard.abs() ** 2
        # block medians over the LOCAL comb sample of each natural-
        # frequency block: the natural bin of column k2 is ~ A*k2, the
        # same block for every local row — group columns
        cols_per_block = min(max(1, block // A), B)
        nblk = max(1, B // cols_per_block)
        usable = nblk * cols_per_block
        grp = pw[:, :usable].reshape(A_loc, nblk, cols_per_block)
        med = median_lastdim(grp.transpose(0, 1).reshape(nblk, -1))
        med = torch.clamp(med, min=1e-30) / np.float32(np.log(2.0))
        scale = torch.cat([torch.repeat_interleave(med, cols_per_block),
                           med[-1].expand(B - usable)])
        white = pw / scale[None, :]
        # real input: keep the non-mirrored half (bins k and N-k carry
        # equal power), and never report DC
        k1_col = d * A_loc + torch.arange(A_loc, device=pw.device)[:, None]
        nat_grid = k1_col + A * torch.arange(B, device=pw.device)[None, :]
        white = torch.where((nat_grid >= 1) & (nat_grid <= N // 2),
                            white, torch.zeros((), dtype=white.dtype,
                                               device=white.device))
        vals, idx = torch.topk(white.reshape(-1), topk)
        # natural bin: k1 = d*A_loc + idx // B (row), k2 = idx % B
        nat = (d * A_loc + idx // B) + A * (idx % B)
        return vals, nat

    parts = shard_map(tail, mesh, (0,), xt)
    all_vals = coll.all_gather([v for v, _ in parts], 0)
    all_nat = coll.all_gather([b for _, b in parts], 0)
    gvals, gidx = torch.topk(all_vals, topk)
    return gvals.cpu().numpy(), all_nat[gidx].cpu().numpy()


def spectral_bytes_per_trial(nfft: int) -> int:
    """Peak per-device bytes for ONE trial's single-device spectral
    tail (complex spectrum + powers + whitened copy) — the gate
    quantity for switching to the distributed tail."""
    nbins = nfft // 2 + 1
    return 8 * nbins + 4 * nbins + 4 * nbins + 4 * nfft
