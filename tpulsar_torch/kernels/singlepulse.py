"""Single-pulse (boxcar matched filter) search — counterpart of
tpulsar/kernels/singlepulse.py.

Replaces PRESTO's single_pulse_search.py (reference invocation:
lib/python/PALFA2_presto_search.py:540-543): each DM time series is
detrended, normalized, and convolved with a ladder of boxcar widths;
events above threshold become single-pulse candidates.  Boxcars come
from cumulative-sum differencing — one cumsum per series serves every
width.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DEFAULT_WIDTHS = (1, 2, 3, 4, 6, 9, 14, 20, 30)

#: device-side top-k events kept per (width, DM) before host dedup
DEFAULT_TOPK = 128

#: structured dtype of single-pulse event records
SP_EVENT_DTYPE = np.dtype([("dm", "f8"), ("sigma", "f8"),
                           ("time_s", "f8"), ("sample", "i8"),
                           ("downfact", "i4")])


def median_lastdim(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis with jnp.median's semantics: for an
    even length, the mean of the two middle values, computed as
    (lo + hi) * 0.5 in the input's dtype.  (torch.median returns the
    lower middle value instead, and torch.quantile refuses inputs
    above 16M elements.)"""
    n = x.shape[-1]
    srt = torch.sort(x, dim=-1).values
    lo = srt[..., (n - 1) // 2]
    hi = srt[..., n // 2]
    return (lo + hi) * 0.5


def _baseline_stat(x: torch.Tensor, estimator: str) -> torch.Tensor:
    """Per-block baseline statistic over the last axis — every block
    (including a short tail) is normalized by ITS OWN sample count."""
    if estimator == "median":
        return median_lastdim(x)
    if estimator == "median_sub4":
        return median_lastdim(x[..., ::4])
    if estimator == "clipped_mean":
        mu = x.mean(dim=-1, keepdim=True)
        sd = torch.clamp(x.std(dim=-1, keepdim=True, correction=0),
                         min=1e-9)
        w = (torch.abs(x - mu) <= 3.0 * sd).to(x.dtype)
        return (x * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
    raise ValueError(f"unknown SP detrend estimator {estimator!r}")


def detrend_normalize(series: torch.Tensor, detrend_block: int = 1000,
                      estimator: str = "median") -> torch.Tensor:
    """Remove a piecewise-constant baseline (one statistic per
    `detrend_block` samples) and scale each DM series to unit
    variance (population std, ddof 0, as jnp.std)."""
    ndms, T = series.shape
    detrend_block = min(detrend_block, T)
    nblk = max(1, T // detrend_block)
    usable = nblk * detrend_block
    blocks = series[:, :usable].reshape(ndms, nblk, detrend_block)
    med = _baseline_stat(blocks, estimator)
    baseline = torch.repeat_interleave(med, detrend_block, dim=-1)
    if T > usable:
        # A tail shorter than detrend_block gets a baseline estimated
        # from its own samples (its own length as the denominator).
        tail_med = _baseline_stat(series[:, usable:], estimator)
        baseline = torch.cat(
            [baseline, tail_med[:, None].expand(ndms, T - usable)],
            dim=-1)
    detrended = series - baseline
    std = torch.clamp(detrended.std(dim=-1, keepdim=True, correction=0),
                      min=1e-9)
    return detrended / std


_ESTIMATORS = ("median", "median_sub4", "clipped_mean")


def detrend_estimator(params_value: str | None = None) -> str:
    """Resolve the SP detrend estimator: TPULSAR_SP_DETREND env beats
    the SearchParams value beats the default."""
    env = os.environ.get("TPULSAR_SP_DETREND", "").strip()
    val = env or params_value or "median"
    if val not in _ESTIMATORS:
        raise ValueError(
            f"SP detrend estimator must be one of {_ESTIMATORS}, "
            f"got {val!r}"
            + (" (from TPULSAR_SP_DETREND)" if env else ""))
    return val


def boxcar_search(norm_series: torch.Tensor,
                  widths: tuple[int, ...] = DEFAULT_WIDTHS,
                  topk: int = DEFAULT_TOPK):
    """Matched-filter SNR for each boxcar width via cumsum differencing.

    norm_series: (ndms, T), zero-mean unit-variance.
    Returns (snrs, times) each (nwidths, ndms, topk): top-k peak SNRs
    and their sample indices per width per DM (one candidate per
    32-sample block at most, see fourier.blockmax_topk)."""
    from tpulsar_torch.kernels.fourier import blockmax_topk

    cs = torch.cumsum(norm_series, dim=-1)
    cs = torch.nn.functional.pad(cs, (1, 0))  # cs[:, t] = sum of first t
    all_snrs, all_idx = [], []
    for w in widths:
        sums = cs[:, w:] - cs[:, :-w]
        snr = sums / float(np.sqrt(float(w)))
        vals, idx = blockmax_topk(snr, topk, block_r=32)
        all_snrs.append(vals)
        all_idx.append(idx)
    return torch.stack(all_snrs), torch.stack(all_idx)


def device_search(series: torch.Tensor,
                  widths: tuple[int, ...] = DEFAULT_WIDTHS,
                  topk: int = DEFAULT_TOPK,
                  estimator: str | None = None):
    """The device half of the SP search: normalize + boxcar top-k.
    Returns the (snrs, idx) tensors without moving them to the host."""
    norm = detrend_normalize(series,
                             estimator=detrend_estimator(estimator))
    return boxcar_search(norm, tuple(widths), topk)


def events_from_topk(snrs, idx, dms: np.ndarray, dt: float,
                     threshold: float = 5.0,
                     widths: tuple[int, ...] = DEFAULT_WIDTHS
                     ) -> np.ndarray:
    """Host half of the SP search: threshold + dedup the device top-k
    output (snrs, idx) of shape (nwidths, ndms, k) into event records.
    """
    snrs = np.asarray(snrs)                       # (nw, ndms, k)
    idx = np.asarray(idx).astype(np.int64)
    dms = np.atleast_1d(np.asarray(dms))
    widths_arr = np.asarray(widths)

    # Vectorized dedup: within each DM, cluster events into 32-sample
    # buckets across all widths and keep the best-SNR representative.
    wi, di, _ = np.indices(snrs.shape, sparse=True)
    keep = snrs >= threshold
    snr_f = snrs[keep]
    if snr_f.size == 0:
        return np.empty(0, dtype=SP_EVENT_DTYPE)
    wi_f = np.broadcast_to(wi, snrs.shape)[keep]
    di_f = np.broadcast_to(di, snrs.shape)[keep]
    samp_f = idx[keep]

    cluster = samp_f // 32
    combo = di_f * (cluster.max() + 1) + cluster
    order = np.lexsort((-snr_f, combo))
    combo_sorted = combo[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = combo_sorted[1:] != combo_sorted[:-1]
    sel = order[first]

    out = np.empty(len(sel), dtype=SP_EVENT_DTYPE)
    out["dm"] = dms[di_f[sel]]
    out["sigma"] = snr_f[sel]
    out["time_s"] = samp_f[sel] * dt
    out["sample"] = samp_f[sel]
    out["downfact"] = widths_arr[wi_f[sel]]
    return np.sort(out, order="sigma")[::-1]


def write_singlepulse_file(path: str, events: np.ndarray, dm: float) -> None:
    """Write one .singlepulse file (PRESTO-compatible columns)."""
    with open(path, "w") as fh:
        fh.write("# DM      Sigma      Time (s)     Sample    Downfact\n")
        sel = events[events["dm"] == dm] if len(events) else events
        for ev in sel:
            fh.write(f"{ev['dm']:7.2f} {ev['sigma']:10.2f} "
                     f"{ev['time_s']:13.6f} {ev['sample']:10d} "
                     f"{ev['downfact']:8d}\n")
