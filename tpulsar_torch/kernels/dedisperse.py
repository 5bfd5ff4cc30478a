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
PyTorch versions on a CPU tensor.  Only the direct stage-2 family is
here; the shift-tree family (the JAX package's tree_dd.py) is not
ported.  All delays are relative to the *highest* frequency in the
band (delay >= 0), matching the synthesizer and the reference.
"""

from __future__ import annotations

import numpy as np
import torch

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
