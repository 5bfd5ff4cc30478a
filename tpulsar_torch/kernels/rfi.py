"""RFI detection and masking — counterpart of tpulsar/kernels/rfi.py.

Replaces PRESTO's rfifind (reference invocation:
lib/python/PALFA2_presto_search.py:482-485): the dynamic spectrum is
cut into (time-block, channel) cells; per-cell statistics (mean,
standard deviation, max Fourier power) are computed on the device,
robust z-scores (host NumPy) flag outlier cells, and rows/columns whose
bad fraction exceeds a threshold are zapped entirely.  The mask is
applied by replacing masked cells with their channel's mean unmasked
level.

The data stay channel-major (nchan, T) in their native dtype; the
float32 cast and the per-cell rfft stream a few channels at a time.
The `_rfifind.npz` artifact is the JAX package's format: a mask saved
by either package loads in both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpulsar_torch import as_device_tensor


@dataclasses.dataclass
class RFIMask:
    """Mask over (nblocks, nchan) cells plus fully-zapped channels and
    time intervals. Serializable to .npz (the reference writes PRESTO's
    binary .mask; ours is an equivalent artifact)."""
    block_len: int
    dt: float
    cell_mask: np.ndarray        # (nblocks, nchan) bool — True = bad
    bad_channels: np.ndarray     # (nchan,) bool
    bad_blocks: np.ndarray       # (nblocks,) bool
    chan_fill: np.ndarray | None = None   # (nchan,) float32 — mean
    #                              unmasked level, the apply-time fill

    @property
    def masked_fraction(self) -> float:
        full = (self.cell_mask | self.bad_channels[None, :]
                | self.bad_blocks[:, None])
        # a degenerate observation can have zero cells; the fraction
        # must stay finite (NaN cannot round-trip the results DB)
        return float(full.mean()) if full.size else 0.0

    def full_mask(self) -> np.ndarray:
        return (self.cell_mask | self.bad_channels[None, :]
                | self.bad_blocks[:, None])

    def save(self, path: str, qscale=None, qoff=None) -> None:
        """qscale/qoff: the per-channel affine dequantization map of
        the uint8 block the mask was derived from (value = q * scale
        + off).  Persisted so a mask saved from a quantized run can be
        re-applied to calibrated float32 data later — chan_fill is in
        QUANTIZED units whenever they are present."""
        np.savez_compressed(
            path, block_len=self.block_len, dt=self.dt,
            cell_mask=self.cell_mask, bad_channels=self.bad_channels,
            bad_blocks=self.bad_blocks,
            chan_fill=(self.chan_fill if self.chan_fill is not None
                       else np.zeros(0, np.float32)),
            qscale=(np.asarray(qscale, np.float32) if qscale is not None
                    else np.zeros(0, np.float32)),
            qoff=(np.asarray(qoff, np.float32) if qoff is not None
                  else np.zeros(0, np.float32)))

    @classmethod
    def load(cls, path: str) -> "RFIMask":
        z = np.load(path)
        fill = z["chan_fill"] if "chan_fill" in z.files else None
        if fill is not None and fill.size == 0:
            fill = None
        return cls(block_len=int(z["block_len"]), dt=float(z["dt"]),
                   cell_mask=z["cell_mask"], bad_channels=z["bad_channels"],
                   bad_blocks=z["bad_blocks"], chan_fill=fill)

    @staticmethod
    def load_quantization(path: str):
        """(qscale, qoff) per-channel dequantization arrays saved with
        the mask, or None if the mask came from a float32 run."""
        z = np.load(path)
        if "qscale" not in z.files or z["qscale"].size == 0:
            return None
        return z["qscale"], z["qoff"]


def _cell_stats_chan(data: torch.Tensor, block_len: int, chunk: int = 16):
    """(nchan, T) -> per-cell (mean, std, max FFT power), each
    (nblocks, nchan) float32 tensors, streaming `chunk` channels at a
    time through the float32 cast and the per-cell rfft.  Variances
    are population variances (ddof 0), as jnp.var computes them."""
    nchan, T = data.shape
    nblocks = T // block_len
    x = data[:, : nblocks * block_len].reshape(nchan, nblocks, block_len)
    means, stds, maxpows = [], [], []
    for c0 in range(0, nchan, chunk):
        c = x[c0: c0 + chunk].to(torch.float32)
        mean = c.mean(dim=-1)
        var = c.var(dim=-1, correction=0)
        spec = torch.fft.rfft(c - mean[..., None], dim=-1)
        maxpow = (spec[..., 1:].abs() ** 2).amax(dim=-1) / torch.clamp(
            block_len * var, min=1e-9)
        means.append(mean)
        stds.append(torch.sqrt(var))
        maxpows.append(maxpow)
    return tuple(torch.cat(s, dim=0).T for s in (means, stds, maxpows))


def cell_stats(data, block_len: int, device=None):
    """(T, nchan) row-major entry point -> (mean, std, maxpow), each
    (nblocks, nchan), on `device`.  Small-array convenience; whole-beam
    callers use the channel-major path (`find_rfi_chan`) to avoid the
    transpose."""
    return _cell_stats_chan(as_device_tensor(data, device).T, block_len)


def _robust_z(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """z-scores from median/MAD along an axis (outlier-resistant)."""
    med = np.median(x, axis=axis, keepdims=True)
    mad = np.median(np.abs(x - med), axis=axis, keepdims=True)
    return (x - med) / np.maximum(1.4826 * mad, 1e-9)


def find_rfi_chan(data: torch.Tensor, dt: float, block_len: int = 2048,
                  threshold: float = 4.0, chan_frac: float = 0.3,
                  block_frac: float = 0.3) -> RFIMask:
    """Compute an RFIMask from a channel-major (nchan, T) dynamic
    spectrum on its device.

    A cell is bad if any of its robust z-scores (mean / std / max
    Fourier power, each standardized per-channel across time and
    across channels) exceeds `threshold`.  Channels (blocks) with more
    than `chan_frac` (`block_frac`) bad cells are zapped entirely — the
    same recommended-channel/interval semantics as rfifind's mask.
    """
    # Observations shorter than one block still get exactly one cell.
    block_len = min(block_len, int(data.shape[1]))
    mean, std, maxpow = (s.cpu().numpy() for s in
                         _cell_stats_chan(data, block_len))

    zs = np.stack([np.abs(_robust_z(s, axis=ax))
                   for s in (mean, std, maxpow) for ax in (0, 1)])
    cell_mask = (zs > threshold).any(axis=0)

    bad_channels = cell_mask.mean(axis=0) > chan_frac
    bad_blocks = cell_mask.mean(axis=1) > block_frac
    mask = RFIMask(block_len=block_len, dt=dt, cell_mask=cell_mask,
                   bad_channels=bad_channels, bad_blocks=bad_blocks)
    full = mask.full_mask()
    good = ~full
    denom = np.maximum(good.sum(axis=0), 1)
    mask.chan_fill = (np.where(good, mean, 0.0).sum(axis=0)
                      / denom).astype(np.float32)
    return mask


def find_rfi(data, dt: float, block_len: int = 2048,
             threshold: float = 4.0, chan_frac: float = 0.3,
             block_frac: float = 0.3, device=None) -> RFIMask:
    """Row-major (T, nchan) entry point (see find_rfi_chan), on
    `device`."""
    return find_rfi_chan(as_device_tensor(data, device).T, dt,
                         block_len=block_len, threshold=threshold,
                         chan_frac=chan_frac, block_frac=block_frac)


def mask_fill_or_default(mask: RFIMask) -> np.ndarray:
    """The mask's per-channel fill level; masks saved before the
    chan_fill field existed fall back to zeros (callers that still
    have the data can recompute it via find_rfi_chan instead)."""
    if mask.chan_fill is not None:
        return mask.chan_fill
    return np.zeros(mask.cell_mask.shape[1], np.float32)


def apply_mask_chan(data: torch.Tensor, cell_mask, fill,
                    block_len: int) -> torch.Tensor:
    """Replace masked cells of channel-major (nchan, T) data with the
    mask's per-channel fill level, in the input's dtype (integer fills
    round half to even, as jnp.round does)."""
    dev = data.device
    cell_mask = torch.as_tensor(np.asarray(cell_mask), device=dev)
    fill = torch.as_tensor(np.asarray(fill, np.float32), device=dev)
    nchan, T = data.shape
    nblocks = cell_mask.shape[0]
    usable = nblocks * block_len
    cells = data[:, :usable].reshape(nchan, nblocks, block_len)
    if not data.dtype.is_floating_point:
        fill = torch.round(fill)
    fillv = fill.to(data.dtype)
    out = torch.where(cell_mask.T[:, :, None], fillv[:, None, None],
                      cells).reshape(nchan, usable)
    if usable < T:
        out = torch.cat([out, data[:, usable:]], dim=1)
    return out


def apply_mask(data, cell_mask, block_len: int, chunk: int = 64,
               device=None) -> torch.Tensor:
    """Row-major (T, nchan) masking, on `device`, that derives the fill
    level from the data itself (the mean of each channel's unmasked
    block means, the block means taken `chunk` blocks at a time in
    float32).  Small-array convenience; whole-beam callers use
    apply_mask_chan with the mask's precomputed fill."""
    data = as_device_tensor(data, device)
    cell_mask = torch.as_tensor(np.asarray(cell_mask), device=data.device)
    T, nchan = data.shape
    nblocks = cell_mask.shape[0]
    usable = nblocks * block_len
    cells = data[:usable].reshape(nblocks, block_len, nchan)
    cmeans = torch.cat([cells[b0: b0 + chunk].to(torch.float32).mean(dim=1)
                        for b0 in range(0, nblocks, chunk)])
    good = ~cell_mask
    denom = torch.clamp(good.sum(dim=0), min=1)
    fill = torch.where(good, cmeans, 0.0).sum(dim=0) / denom   # (nchan,)
    if not data.dtype.is_floating_point:
        fill = torch.round(fill)
    fill = fill.to(data.dtype)
    out = torch.where(cell_mask[:, None, :], fill[None, None, :],
                      cells).reshape(usable, nchan)
    if usable < T:
        out = torch.cat([out, data[usable:]], dim=0)
    return out
