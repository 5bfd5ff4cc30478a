"""Incoherent dedispersion — counterpart of tpulsar/kernels/dedisperse.py.

Replaces PRESTO's `prepsubband` (both the `-sub` subband-forming mode
and the subband->DM-series mode; reference invocation:
lib/python/PALFA2_presto_search.py:506-529):

  * stage 1 `form_subbands`: per-channel integer shift at the pass
    sub-DM, channel-group sum into `nsub` subbands, time downsampling;
  * stage 2 `dedisperse_subbands`: per-subband residual shift for each
    target DM.

Both stages run as the hand-written CUDA kernels of
tpulsar_torch/kernels/cuda_dd.py on a CUDA tensor, and as their plain
PyTorch versions on a CPU tensor.  This is the direct stage-2
family; the shift-tree family is kernels/tree_dd.py.  The streaming
plane's emissions (stream_* below) are stage 2 with the channels as
subbands.  All delays are relative to the *highest* frequency in the
band (delay >= 0), matching the synthesizer and the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulsar_torch import as_device_tensor
from tpulsar_torch.constants import KDM, dispersion_delay_s as delays_s
from tpulsar_torch.kernels import cuda_dd


def shift_samples(dm, freqs_mhz, ref_mhz, dt) -> np.ndarray:
    """Integer sample shifts (host-side)."""
    return np.round(delays_s(dm, freqs_mhz, ref_mhz) / dt).astype(np.int32)


def _pad_bucket(maxshift: int) -> int:
    """Round a maximum shift up to a power-of-two bucket (>=256); a zero
    maximum shift needs no pad at all (the reference's bucket, kept so
    the plain versions pad exactly as the reference does)."""
    if maxshift <= 0:
        return 0
    p = 256
    while p < maxshift:
        p *= 2
    return p


def _edge_pad(data: torch.Tensor, pad: int) -> torch.Tensor:
    """Extend each row of (nrows, T) with `pad` copies of its last
    sample, so that index t reads data[min(t, T-1)].  pad=0 returns the
    input unchanged."""
    if pad <= 0:
        return data
    tail = data[:, -1:].expand(data.shape[0], pad)
    return torch.cat([data, tail], dim=1)


def shift_rows(data: torch.Tensor, shifts) -> torch.Tensor:
    """out[i, t] = data[i, min(t + shifts[i], T-1)]: row i of (nrows, T)
    shifted left by shifts[i] >= 0, clamped at the end (the reference's
    _shift_gather, with its power-of-two pad bucket)."""
    sh = np.asarray(shifts, dtype=np.int64)
    T = data.shape[1]
    pad = _pad_bucket(int(sh.max(initial=0)))
    padded = _edge_pad(data, pad)
    return torch.stack([padded[i, s: s + T] for i, s in
                        enumerate(np.minimum(sh, pad).tolist())])


def downsample(x: torch.Tensor, factor: int, axis: int = -1) -> torch.Tensor:
    """Sum-downsample along an axis; lengths not divisible by the
    factor are truncated."""
    if factor == 1:
        return x
    axis = axis % x.dim()
    n = (x.shape[axis] // factor) * factor
    x = x.narrow(axis, 0, n)
    newshape = x.shape[:axis] + (n // factor, factor) + x.shape[axis + 1:]
    return x.reshape(newshape).sum(dim=axis + 1)


def form_subbands(data: torch.Tensor, chan_shifts, nsub: int,
                  downsamp: int) -> torch.Tensor:
    """Stage 1: (nchan, T) uint8/float32 -> (nsub, T // downsamp)
    float32.

    chan_shifts: per-channel integer shifts at the pass sub-DM,
    *relative to the reference frequency of the channel's own subband*
    (so each subband is internally dedispersed to the sub-DM but keeps
    its inter-subband delay for stage 2)."""
    nchan = data.shape[0]
    if nchan % nsub:
        raise ValueError(f"nchan {nchan} not divisible by nsub {nsub}")
    return cuda_dd.form_subbands(data, chan_shifts, nsub, downsamp)


def dedisperse_subbands(subbands: torch.Tensor, sub_shifts) -> torch.Tensor:
    """Stage 2: (nsub, T') + (ndms, nsub) shifts -> (ndms, T') DM
    series, summed over subbands in order (bit-identical to the
    reference's _dedisperse_subbands_scan)."""
    return cuda_dd.dedisperse_subbands(subbands, sub_shifts)


def subband_reference_freqs(freqs_mhz: np.ndarray, nsub: int) -> np.ndarray:
    """Reference (highest) frequency of each subband; channels must be
    in ascending frequency order."""
    nchan = len(freqs_mhz)
    return np.asarray(freqs_mhz).reshape(nsub, nchan // nsub)[:, -1]


def plan_pass_shifts(freqs_mhz: np.ndarray, nsub: int, subdm: float,
                     dms: np.ndarray, dt: float, downsamp: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Static shift tables for one dedispersion pass.

    Returns (chan_shifts[nchan] at full rate for stage 1,
             sub_shifts[ndms, nsub] at the downsampled rate for stage 2).
    """
    freqs_mhz = np.asarray(freqs_mhz, dtype=np.float64)
    subrefs = subband_reference_freqs(freqs_mhz, nsub)
    nchan = len(freqs_mhz)
    chan_sub = np.repeat(subrefs, nchan // nsub)
    # Delay of each channel relative to its own subband's reference.
    chan_shifts = np.round(
        KDM * subdm * (freqs_mhz ** -2.0 - chan_sub ** -2.0) / dt
    ).astype(np.int64)
    band_ref = freqs_mhz[-1]
    dms = np.atleast_1d(np.asarray(dms, dtype=np.float64))
    dt_down = dt * downsamp
    sub_shifts = np.stack([
        shift_samples(dm, subrefs, band_ref, dt_down) for dm in dms])
    return chan_shifts.astype(np.int32), sub_shifts.astype(np.int32)


def dedisperse_pass(data, freqs_mhz: np.ndarray, nsub: int,
                    subdm: float, dms: np.ndarray, dt: float,
                    downsamp: int, device=None) -> torch.Tensor:
    """Full two-stage pass on `device`: (nchan, T) -> (ndms, T //
    downsamp), through both hand kernels (form_subbands, then
    dedisperse_subbands) on the card and their plain versions on the
    CPU."""
    chan_shifts, sub_shifts = plan_pass_shifts(
        freqs_mhz, nsub, subdm, dms, dt, downsamp)
    data = as_device_tensor(data, device).contiguous()
    subbands = form_subbands(data, chan_shifts, nsub, downsamp)
    return dedisperse_subbands(subbands, sub_shifts)


def dedisperse_exact(data: np.ndarray, freqs_mhz: np.ndarray,
                     dms: np.ndarray, dt: float,
                     downsamp: int = 1) -> np.ndarray:
    """Single-stage exact dedispersion (NumPy oracle, copied from the
    reference): per-channel shift at each target DM, no subband
    approximation, float64 sums."""
    data = np.asarray(data)
    nchan, T = data.shape
    band_ref = float(np.asarray(freqs_mhz)[-1])
    out = []
    for dm in np.atleast_1d(dms):
        shifts = shift_samples(float(dm), freqs_mhz, band_ref, dt)
        ts = np.zeros(T, dtype=np.float64)
        for c in range(nchan):
            s = min(int(shifts[c]), T)
            if s < T:
                ts[: T - s] += data[c, s:]
            if s:
                ts[T - s:] += data[c, -1]  # clamp, matching the kernel
        out.append(ts)
    arr = np.stack(out)
    if downsamp > 1:
        arr = arr[:, : (T // downsamp) * downsamp]
        arr = arr.reshape(arr.shape[0], -1, downsamp).sum(-1)
    return arr


def max_shift_samples(freqs_mhz: np.ndarray, max_dm: float, dt: float) -> int:
    """Worst-case shift — samples at the end of every DM series that
    are contaminated by edge clamping and must be ignored."""
    f = np.asarray(freqs_mhz, dtype=np.float64)
    return int(np.ceil(KDM * max_dm * (f.min() ** -2 - f.max() ** -2) / dt))


# ----------------------------------------------------------- streaming entry
#
# The streaming plane (tpulsar_torch/stream/) dedisperses chunk at a
# time against carried channel state.  An emission computes
#
#     out[d, t] = sum_c window[c, t + shift[d, c]],   t < chunk_len,
#
# summed in channel order from zero: the stage-2 function with the
# channels as "subbands".  On the card it is one launch of the CUDA
# stage-2 kernel (cuda_dd.dedisperse_subbands), whose edge clamp at
# W - 1 is never reached inside the window (chunk_len + maxshift <= W);
# on the CPU it is the plain dedisperse_window_scan.  Both sum in the
# reference's order, so every emitted sample is bit-identical to the
# batch dedispersion of the whole block.

def stream_shift_table(freqs_mhz, dms, dt: float) -> np.ndarray:
    """(ndms, nchan) int32 per-channel shifts for DIRECT streaming
    dedispersion (no subbands), delays relative to the highest
    frequency (the reference's stream_shift_table)."""
    freqs_mhz = np.asarray(freqs_mhz, dtype=np.float64)
    band_ref = float(freqs_mhz[-1])
    return np.stack([
        shift_samples(float(dm), freqs_mhz, band_ref, dt)
        for dm in np.atleast_1d(np.asarray(dms, dtype=np.float64))
    ]).astype(np.int32)


def stream_window_width(chunk_len: int, maxshift: int) -> int:
    """Width of the streaming emission window: chunk_len output
    samples plus the power-of-two shift bucket (columns past
    chunk_len + maxshift are never read)."""
    return chunk_len + _pad_bucket(maxshift)


def dedisperse_window_scan(ext: torch.Tensor, sub_shifts,
                           out_len: int) -> torch.Tensor:
    """Plain PyTorch shift-and-sum over a pre-extended window (no edge
    handling), the reference's dedisperse_window_scan:

        out[d, t] = sum_s ext[s, t + sub_shifts[d, s]],  t < out_len

    accumulated in s order from zero.  Callers guarantee
    max(sub_shifts) + out_len <= ext.shape[1]."""
    sh = np.asarray(sub_shifts, dtype=np.int64)
    if sh.size and int(sh.max()) + out_len > ext.shape[1]:
        raise ValueError(f"dedisperse_window_scan: shift {int(sh.max())} "
                         f"+ {out_len} samples > window {ext.shape[1]}")
    acc = torch.zeros((sh.shape[0], out_len), dtype=torch.float32,
                      device=ext.device)
    for s in range(ext.shape[0]):
        row = ext[s]
        acc += torch.stack([row[int(x): int(x) + out_len]
                            for x in sh[:, s]])
    return acc


def dedisperse_stream_step(window: torch.Tensor, shifts,
                           chunk_len: int) -> torch.Tensor:
    """One streaming emission: (nchan, W) float32 window + (ndms,
    nchan) shifts -> (ndms, chunk_len).  A CUDA window goes through
    one launch of the stage-2 kernel, which computes all W columns;
    the first chunk_len are kept (a view).  A CPU window goes through
    the plain dedisperse_window_scan."""
    sh = cuda_dd._host_shifts(shifts, 2, "dedisperse_stream_step")
    if sh.size and int(sh.max()) + chunk_len > window.shape[1]:
        raise ValueError(f"dedisperse_stream_step: shift {int(sh.max())} "
                         f"+ {chunk_len} samples > window "
                         f"{window.shape[1]}")
    if cuda_dd._check_device(window, "dedisperse_stream_step"):
        return cuda_dd.dedisperse_subbands(window, sh)[:, :chunk_len]
    return dedisperse_window_scan(window, sh, chunk_len)


def dedisperse_stream_batch(data: torch.Tensor, shifts) -> torch.Tensor:
    """Batch reference of the streaming plane: the whole (nchan, T)
    float32 block dedispersed in one call, edge-padded as the chunked
    path's session close pads it, by the same route as an emission
    (the stage-2 kernel on the card, dedisperse_window_scan on the
    CPU).  A chunked run must match this bit for bit."""
    sh = cuda_dd._host_shifts(shifts, 2, "dedisperse_stream_batch")
    T = data.shape[1]
    ext = _edge_pad(data, _pad_bucket(int(sh.max(initial=0))))
    if cuda_dd._check_device(ext, "dedisperse_stream_batch"):
        return cuda_dd.dedisperse_subbands(ext.contiguous(), sh)[:, :T]
    return dedisperse_window_scan(ext, sh, T)
