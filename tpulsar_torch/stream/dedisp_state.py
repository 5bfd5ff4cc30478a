"""Incremental dedispersion state: the carry buffer between chunks —
counterpart of tpulsar/stream/dedisp_state.py.

The streaming plane's core invariant: a chunked run is BIT-IDENTICAL
to the batch dedispersion of the concatenated series.  The batch path
computes, for every DM d and output sample t,

    out[d, t] = sum_c ext[c, t + shift[d, c]]

where ext is the channel block edge-clamped past its last sample and
the sum folds channels in ascending order from zero.  This module
reproduces exactly those terms in exactly that order, one chunk at a
time:

  * a per-channel CARRY BUFFER (on the host, a numpy array, as in the
    reference) holds the trailing ``maxshift`` samples every
    not-yet-emittable output still needs;
  * when ``chunk_len + maxshift`` samples are buffered, one emission
    window of the static width ``chunk_len + pad_bucket`` is
    assembled, copied to the device and dedispersed by
    kernels/dedisperse.dedisperse_stream_step: one launch of the CUDA
    stage-2 kernel on the card, the plain window scan on the CPU;
  * at session close the remaining samples are flushed with the batch
    edge clamp (the last REAL sample replicated), so the final
    ``maxshift`` output samples match the batch block too.

The numpy backend performs the identical per-element fold on the
host.  The carry checkpoint (state_bytes/restore) is the reference's
npz (``carry``, ``emitted``): a carry either package wrote resumes in
the other.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from tpulsar_torch import resolve_device
from tpulsar_torch.constants import dispersion_delay_s


def pad_bucket(maxshift: int) -> int:
    """Power-of-two pad bucket (>=256, 0 for zero shift) — the same
    values as kernels/dedisperse._pad_bucket, restated so the numpy
    backend sizes its windows without the kernel module (tests pin
    the two equal)."""
    if maxshift <= 0:
        return 0
    p = 256
    while p < maxshift:
        p *= 2
    return p


def geometry_freqs_dms(geom: dict) -> tuple[np.ndarray, np.ndarray]:
    """THE session geometry -> (freqs_mhz ascending, dms) derivation,
    shared by the worker, the trigger and the tests."""
    freqs = np.linspace(float(geom["f_lo_mhz"]), float(geom["f_hi_mhz"]),
                        int(geom["nchan"]))
    dms = np.linspace(0.0, float(geom["dm_max"]), int(geom["ndms"]))
    return freqs, dms


def shift_table(geom: dict) -> np.ndarray:
    """(ndms, nchan) int32 per-channel shifts — the same values
    kernels/dedisperse.stream_shift_table produces (both round
    constants.dispersion_delay_s against the highest frequency)."""
    freqs, dms = geometry_freqs_dms(geom)
    ref = float(freqs[-1])
    dt = float(geom["dt"])
    return np.stack([
        np.round(dispersion_delay_s(dm, freqs, ref) / dt)
        for dm in dms]).astype(np.int32)


def resolve_backend(backend: str = "auto") -> str:
    """``auto`` means ``torch`` (the device path); ``numpy`` is the
    host fold.  The port has no ``jax`` backend."""
    if backend == "auto":
        return "torch"
    if backend not in ("torch", "numpy"):
        raise ValueError(f"unknown stream backend {backend!r} "
                         f"(torch, numpy or auto)")
    return backend


def _window_scan_numpy(window: np.ndarray, shifts: np.ndarray,
                       out_len: int) -> np.ndarray:
    """Fold-left channel accumulation, per-element order identical to
    the torch path: acc starts at zeros, channel c adds its shifted
    slice for every DM before channel c+1 contributes."""
    ndms = shifts.shape[0]
    acc = np.zeros((ndms, out_len), np.float32)
    cols = np.arange(out_len)
    for c in range(window.shape[0]):
        acc += window[c][shifts[:, c][:, None] + cols[None, :]]
    return acc


class StreamDedisp:
    """Carry-state incremental dedispersion for one session.

    ``device`` is where the torch backend dedisperses (default
    ``"cuda"``; without a GPU the caller must pass ``device="cpu"``,
    for either backend: the class never moves to the CPU by itself).
    Emitted blocks are returned as host float32 arrays."""

    def __init__(self, geom: dict, backend: str = "auto", device=None):
        self.geom = dict(geom)
        self.nchan = int(geom["nchan"])
        self.chunk_len = int(geom["chunk_len"])
        self.shifts = shift_table(geom)
        self.maxshift = int(self.shifts.max(initial=0))
        self.pad = pad_bucket(self.maxshift)
        #: static emission window width
        self.window_width = self.chunk_len + self.pad
        self.backend = resolve_backend(backend)
        self.device = resolve_device(device)
        self.buf = np.zeros((self.nchan, 0), np.float32)
        self.emitted = 0          # output samples emitted so far

    # ------------------------------------------------------- emission
    def _scan(self, window: np.ndarray) -> np.ndarray:
        if self.backend == "torch":
            from tpulsar_torch.kernels import dedisperse as dd

            win = torch.from_numpy(window).to(self.device)
            out = dd.dedisperse_stream_step(win, self.shifts,
                                            self.chunk_len)
            return out.cpu().numpy()
        return _window_scan_numpy(window, self.shifts, self.chunk_len)

    def _emit_window(self, cols: np.ndarray) -> np.ndarray:
        """Assemble the static-width window (real columns first, the
        never-read pad tail zeroed) and dedisperse it."""
        window = np.zeros((self.nchan, self.window_width), np.float32)
        window[:, :cols.shape[1]] = cols
        return self._scan(window)

    def append(self, chunk: np.ndarray) -> list[np.ndarray]:
        """Feed one (nchan, chunk_len) chunk; returns the (ndms,
        chunk_len) output blocks that became complete (possibly
        empty — early chunks only fill the carry buffer)."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.shape != (self.nchan, self.chunk_len):
            raise ValueError(f"chunk shape {chunk.shape} != "
                             f"({self.nchan}, {self.chunk_len})")
        self.buf = np.concatenate([self.buf, chunk], axis=1)
        out = []
        need = self.chunk_len + self.maxshift
        while self.buf.shape[1] >= need:
            out.append(self._emit_window(self.buf[:, :need]))
            self.buf = self.buf[:, self.chunk_len:]
            self.emitted += self.chunk_len
        return out

    def flush(self) -> list[np.ndarray]:
        """Session close: emit the remaining buffered samples with the
        batch edge clamp (last REAL sample replicated)."""
        out = []
        r = self.buf.shape[1]
        if r == 0:
            return out
        last = self.buf[:, -1:]
        need = self.chunk_len + self.maxshift
        while r > 0:
            cols = self.buf[:, :min(r, need)]
            if cols.shape[1] < need:
                cols = np.concatenate(
                    [cols, np.broadcast_to(
                        last, (self.nchan, need - cols.shape[1]))],
                    axis=1)
            block = self._emit_window(cols)
            take = min(self.chunk_len, r)
            out.append(np.ascontiguousarray(block[:, :take]))
            self.buf = self.buf[:, take:]
            self.emitted += take
            r -= take
        return out

    # ---------------------------------------------------- carry state
    def state_bytes(self) -> bytes:
        """The resumable carry: buffer + emitted counter, npz-packed.
        Uncompressed (the reference compresses; np.load reads both):
        zlib gains little on float noise and costs seconds a chunk on
        a 960-channel carry."""
        buf = io.BytesIO()
        np.savez(buf, carry=self.buf, emitted=np.int64(self.emitted))
        return buf.getvalue()

    def restore(self, blob: bytes) -> None:
        with np.load(io.BytesIO(blob)) as z:
            self.buf = np.ascontiguousarray(
                z["carry"].astype(np.float32))
            self.emitted = int(z["emitted"])
        if self.buf.shape[0] != self.nchan:
            raise ValueError(
                f"carry state nchan {self.buf.shape[0]} != "
                f"{self.nchan}")
