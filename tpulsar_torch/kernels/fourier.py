"""Fourier-domain periodicity search — counterpart of
tpulsar/kernels/fourier.py.

Replaces four PRESTO C programs (reference invocations:
lib/python/PALFA2_presto_search.py:549-567):

  realfft   -> batched torch.fft.rfft over the DM-trial axis (cuFFT)
  zapbirds  -> barycentre-corrected zaplist mask multiplication
  rednoise  -> log-spaced block-median spectral whitening
  accelsearch (zmax=0) -> incoherent harmonic summing + top-k

Powers are normalized so that pure-noise summed powers of n harmonics
follow Gamma(n, 1), which makes the host-side sigma conversion
(sigma_from_power) exact.  cuFFT is not XLA's FFT: spectra agree with
the reference within a tolerance, not bit for bit.  The harmonic-sum
order is the reference's exactly.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from scipy import special as sps

from tpulsar_torch import as_device_tensor
from tpulsar_torch.kernels.singlepulse import median_lastdim, rows_blocked


# ----------------------------------------------------------------- rfft

def pad_series(series: torch.Tensor, nfft: int) -> torch.Tensor:
    """Pad (..., T) series to length nfft with each row's mean (mean
    padding avoids the broadband leakage a zero-pad step would
    inject)."""
    T = series.shape[-1]
    if T == nfft:
        return series
    if T > nfft:
        return series[..., :nfft]
    lead = series.shape[:-1]
    mean = rows_blocked(lambda b: b.mean(dim=-1, keepdim=True),
                        series.reshape(-1, T)).reshape(*lead, 1)
    pad = mean.expand(*lead, nfft - T)
    return torch.cat([series, pad], dim=-1)


def complex_spectrum(series: torch.Tensor) -> torch.Tensor:
    """(ndms, T) real time series -> (ndms, T//2+1) complex spectrum
    with the DC bin zeroed (equivalent to mean subtraction)."""
    spec = torch.fft.rfft(series.to(torch.float32), dim=-1)
    spec[..., 0] = 0.0
    return spec


def power_spectrum(series, device=None) -> torch.Tensor:
    """(ndms, T) real time series -> (ndms, T//2+1) raw powers, on
    `device`.  The DC bin is zeroed (PRESTO drops it too: bin 0 holds
    the mean)."""
    return complex_spectrum(as_device_tensor(series, device)).abs() ** 2


# ------------------------------------------------------------- rednoise

MAX_WHITEN_BLOCK = 8192


def _block_edges(nbins: int, first_block: int = 6,
                 growth: float = 1.5) -> np.ndarray:
    """Logarithmically growing block edges for the low-frequency
    section of the local-normalization estimate; stops once blocks
    reach MAX_WHITEN_BLOCK (the rest uses equal blocks)."""
    edges = [1]  # skip DC
    size = first_block
    while edges[-1] < nbins and size < MAX_WHITEN_BLOCK:
        edges.append(min(nbins, edges[-1] + int(size)))
        size = size * growth
    return np.asarray(edges, dtype=np.int64)


def whiten_estimator() -> str:
    """TPULSAR_WHITEN_ESTIMATOR: 'median' (default; median/ln2 = mean
    for exponential noise) or 'clipped_mean' for the equal-width tail
    blocks."""
    val = os.environ.get("TPULSAR_WHITEN_ESTIMATOR", "median").strip()
    if val not in ("median", "clipped_mean"):
        raise ValueError(
            f"TPULSAR_WHITEN_ESTIMATOR must be median|clipped_mean, "
            f"got {val!r}")
    return val


def _block_level(x: torch.Tensor, estimator: str) -> torch.Tensor:
    """Mean-noise-level estimate over the last axis (exponential
    noise), already in MEAN units."""
    if estimator == "median":
        return median_lastdim(x) / float(np.log(2.0))
    lead = x.shape[:-1]
    return rows_blocked(_clipped_level,
                        x.reshape(-1, x.shape[-1])).reshape(lead)


def _clipped_level(x: torch.Tensor) -> torch.Tensor:
    m1 = x.mean(dim=-1, keepdim=True)
    clipped = torch.minimum(x, 4.0 * m1)
    # E[min(X, 4 mu)] = mu (1 - e^-4) for X ~ Exp(mu)
    return clipped.mean(dim=-1) / (1.0 - float(np.exp(-4.0)))


def whiten_powers(powers: torch.Tensor, edges: tuple[int, ...],
                  estimator: str | None = None) -> torch.Tensor:
    """Divide powers by a piecewise local noise level estimated from
    block statistics, linearly interpolated between block centers.
    The log-spaced head blocks and a short remainder always use the
    median; `estimator` governs the equal-width tail blocks."""
    if estimator is None:
        estimator = whiten_estimator()
    elif estimator not in ("median", "clipped_mean"):
        raise ValueError(
            f"estimator must be median|clipped_mean, got {estimator!r}")
    nbins = powers.shape[-1]
    centers: list[float] = []
    med_parts: list[torch.Tensor] = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        centers.append(0.5 * (lo + hi))
        med_parts.append(_block_level(powers[..., lo:hi],
                                      "median")[..., None])

    tail_start = int(edges[-1])
    ntail = nbins - tail_start
    m = ntail // MAX_WHITEN_BLOCK
    if m > 0:
        tail = powers[..., tail_start: tail_start + m * MAX_WHITEN_BLOCK]
        tail = tail.reshape(*powers.shape[:-1], m, MAX_WHITEN_BLOCK)
        med_parts.append(_block_level(tail, estimator))
        centers.extend(tail_start + (j + 0.5) * MAX_WHITEN_BLOCK
                       for j in range(m))
    rem = ntail - m * MAX_WHITEN_BLOCK
    if rem > 16:
        lo = nbins - rem
        centers.append(0.5 * (lo + nbins))
        med_parts.append(_block_level(powers[..., lo:],
                                      "median")[..., None])

    med = torch.clamp(torch.cat(med_parts, dim=-1), min=1e-30)
    dev = powers.device
    cent = torch.tensor(centers, dtype=torch.float32, device=dev)
    bins = torch.arange(nbins, dtype=torch.float32, device=dev)
    ncent = cent.shape[0]
    idx = torch.clamp(torch.searchsorted(cent, bins) - 1, 0, ncent - 2)
    span = torch.clamp(cent[idx + 1] - cent[idx], min=1e-30)
    t = torch.clamp((bins - cent[idx]) / span, 0.0, 1.0)
    level = med[..., idx] * (1.0 - t) + med[..., idx + 1] * t
    return powers / level


def whiten(powers: torch.Tensor,
           estimator: str | None = None) -> torch.Tensor:
    edges = tuple(int(e) for e in _block_edges(powers.shape[-1]))
    return whiten_powers(powers, edges, estimator=estimator)


# ------------------------------------------------------------- zapbirds

def parse_zaplist(path: str) -> np.ndarray:
    """Read a PRESTO-style zaplist: lines of 'freq(Hz) width(Hz)',
    '#' comments.  Returns (n, 2) array."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            rows.append((float(parts[0]), float(parts[1])))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 2)


def zap_mask(nbins: int, T: float, zaplist: np.ndarray,
             baryv: float = 0.0) -> np.ndarray:
    """Boolean keep-mask over rfft bins.  Each (freq, width) birdie is
    barycentre-corrected (f_topo = f_bary / (1 + baryv); reference
    zapbirds is passed -baryv, PALFA2_presto_search.py:551-553) and the
    covered bins are dropped."""
    keep = np.ones(nbins, dtype=bool)
    if zaplist is None or len(zaplist) == 0:
        return keep
    df = 1.0 / T  # Hz per bin
    for freq, width in np.atleast_2d(zaplist):
        f = freq / (1.0 + baryv)
        lo = int(np.floor((f - width / 2) / df))
        hi = int(np.ceil((f + width / 2) / df)) + 1
        lo = max(lo, 0)
        hi = min(hi, nbins)
        if hi > lo:
            keep[lo:hi] = False
    return keep


# ------------------------------------------------- whitening pipeline

def whitened_powers(spec: torch.Tensor, keep_mask=None,
                    estimator: str | None = None) -> tuple:
    """(powers, wpow) from a complex spectrum: zap -> whiten -> re-zap
    (the re-zap because the local level estimate only partially
    excludes zapped bins)."""
    powers = spec.abs() ** 2
    if keep_mask is not None:
        keep = torch.as_tensor(np.asarray(keep_mask),
                               device=powers.device).to(powers.dtype)
        powers = powers * keep
    wpow = whiten(powers, estimator=estimator)
    if keep_mask is not None:
        wpow = wpow * keep
    return powers, wpow


def scale_spectrum(spec: torch.Tensor, powers: torch.Tensor,
                   wpow: torch.Tensor) -> torch.Tensor:
    """Scale the complex spectrum by the whitening level already
    computed from its powers (so noise |X|^2 has unit mean); zapped
    bins (wpow == 0) vanish from the result."""
    return spec * torch.sqrt(wpow / torch.clamp(powers, min=1e-30)
                             ).to(spec.dtype)


def whitened_spectrum(series: torch.Tensor, nfft: int) -> torch.Tensor:
    """pad -> rfft -> whiten -> scale."""
    spec = complex_spectrum(pad_series(series, nfft))
    powers, wpow = whitened_powers(spec)
    return scale_spectrum(spec, powers, wpow)


def whitened_spectrum_masked(series: torch.Tensor, keep,
                             nfft: int) -> torch.Tensor:
    """whitened_spectrum with a zaplist keep-mask."""
    spec = complex_spectrum(pad_series(series, nfft))
    powers, wpow = whitened_powers(spec, keep)
    return scale_spectrum(spec, powers, wpow)


def interbin_powers(wspec: torch.Tensor) -> torch.Tensor:
    """Half-bin detection grid from a whitened complex spectrum
    (PRESTO's interbinning, ACCEL_DR = 0.5):

    out[..., 2k]   = |X_k|^2
    out[..., 2k+1] = (pi^2/16) |X_k - X_{k+1}|^2   (~ |X_{k+1/2}|^2)

    Index r in the output is in HALF-BIN units."""
    p = wspec.abs() ** 2
    half = (np.pi ** 2 / 16.0) * (wspec[..., :-1] - wspec[..., 1:]
                                  ).abs() ** 2
    half = torch.nn.functional.pad(half, (0, 1))
    return torch.stack([p, half], dim=-1).reshape(*p.shape[:-1], -1)


# ------------------------------------------- harmonic summing + candidates

def harmonic_stages(max_numharm: int) -> list[int]:
    """PRESTO searches stages 1,2,4,8,16 up to numharm."""
    stages = []
    h = 1
    while h <= max_numharm:
        stages.append(h)
        h *= 2
    return stages


def harmonic_sum(powers: torch.Tensor, numharm: int) -> torch.Tensor:
    """Incoherent harmonic sum: S_n(r) = sum_{h=1..n} P(h*r), summed in
    h order (the reference's order).  Output length nbins//numharm."""
    nbins = powers.shape[-1]
    L = nbins // numharm
    acc = powers[..., :L]
    for h in range(2, numharm + 1):
        acc = acc + powers[..., ::h][..., :L]
    return acc


# r-block width for the hierarchical top-k (see the JAX package)
BLOCK_R = 64


def block_maxima(summed: torch.Tensor, block_r: int = BLOCK_R):
    """The reduction half of blockmax_topk: the maximum of each block
    of block_r entries of the last axis (the ragged last block padded
    with -inf) and its first argmax within the block.  Returns (bmax,
    barg) of shape (..., ceil(L / block_r))."""
    L = summed.shape[-1]
    nb = -(-L // block_r)
    pad = nb * block_r - L
    if pad:
        summed = torch.nn.functional.pad(summed, (0, pad),
                                         value=float("-inf"))
    resh = summed.reshape(*summed.shape[:-1], nb, block_r)
    return resh.amax(dim=-1), resh.argmax(dim=-1)


def topk_of_blocks(bmax: torch.Tensor, topk: int):
    """The selection half of blockmax_topk: the min(topk, nb) largest
    block maxima of the last axis and their block indices, ranked as
    jax.lax.top_k ranks them (a stable descending sort)."""
    k = min(topk, bmax.shape[-1])
    order = torch.sort(bmax, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def blockmax_topk(summed: torch.Tensor, topk: int, block_r: int = BLOCK_R):
    """Hierarchical top-k over the last axis: max-reduce fixed r
    blocks (keeping the first argmax), then top-k over the block
    maxima.  Ties rank as jax.lax.top_k ranks them: larger value
    first, then lower index (a stable descending sort).  Returns
    (vals, bins) of shape (..., k), zero-padded when fewer than k
    blocks exist."""
    bmax, barg = block_maxima(summed, block_r)
    vals, blk = topk_of_blocks(bmax, topk)
    k = vals.shape[-1]
    bins = blk * block_r + torch.gather(barg, -1, blk)
    if k < topk:
        vals = torch.nn.functional.pad(vals, (0, topk - k))
        bins = torch.nn.functional.pad(bins, (0, topk - k))
    return vals, bins


def stage_candidates(powers: torch.Tensor, numharm: int, topk: int):
    """Top-k summed powers for one harmonic stage: (values, bins),
    each (ndms, topk)."""
    return blockmax_topk(harmonic_sum(powers, numharm), topk)


def all_stage_candidates(powers: torch.Tensor, stages: tuple[int, ...],
                         topk: int) -> dict:
    """Every harmonic stage's top-k."""
    return {h: stage_candidates(powers, h, topk) for h in stages}


def lo_stage_candidates(wspec: torch.Tensor, stages: tuple[int, ...],
                        topk: int) -> dict:
    """interbin + every harmonic stage's top-k."""
    return all_stage_candidates(interbin_powers(wspec), stages, topk)


# ----------------------------------------------------------- significance

def sigma_from_power(summed_power, numharm: int, numindep: int = 1):
    """Equivalent Gaussian significance of a summed power from
    `numharm` harmonics of unit-mean exponential noise, corrected for
    `numindep` independent trials (host NumPy; the reference's
    function, copied)."""
    s = np.asarray(summed_power, dtype=np.float64)
    n = int(numharm)
    with np.errstate(divide="ignore"):
        q = sps.gammaincc(n, s)
        logq = np.where(q > 0, np.log(np.maximum(q, 1e-300)), -np.inf)
        # large-s: Q(n,s) ~ s^(n-1) e^(-s) / Gamma(n)
        tail = (n - 1) * np.log(np.maximum(s, 1e-30)) - s - sps.gammaln(n)
        logq = np.where(np.isfinite(logq) & (q > 1e-290), logq, tail)
    if numindep > 1:
        with np.errstate(invalid="ignore", over="ignore",
                         divide="ignore"):
            small = logq < -30.0
            safe_logq = np.clip(logq, -30.0, -1e-17)
            m_log1mp = numindep * np.log1p(-np.exp(safe_logq))
            exact = np.where(
                m_log1mp > -1e-8,
                np.log(np.maximum(-m_log1mp, 1e-300)),
                np.log1p(-np.exp(np.clip(m_log1mp, -745.0, -1e-17))))
            logq = np.where(small, logq + np.log(numindep), exact)
        logq = np.minimum(logq, 0.0)
    return -sps.ndtri_exp(logq) if hasattr(sps, "ndtri_exp") else \
        sps.ndtri(1.0 - np.exp(logq))


def power_threshold(sigma: float, numharm: int) -> float:
    """Summed-power threshold giving the requested Gaussian sigma."""
    from scipy import optimize
    return float(optimize.brentq(
        lambda s: sigma_from_power(s, numharm) - sigma,
        1e-3, 1e4, xtol=1e-6))


# ------------------------------------------------------------ full search

def periodicity_search(series, T_s: float, keep_mask=None,
                       max_numharm: int = 16, topk: int = 64,
                       device=None):
    """Zero-acceleration periodicity search of (ndms, T) DM series on
    `device`.

    Returns a dict: stage -> (powers[ndms, topk], bins[ndms, topk]) as
    numpy, plus the TRUE (independent) spectrum bin count.  Bins are
    in HALF-BIN units (interbinned detection grid, dr=0.5 — the same
    semantics as the executor's lo stage); fundamental r = 0.5*bin.
    Host code converts to sigmas and merges with sifting
    (bin_scale=0.5).  T_s is the JAX signature's and selects nothing.
    """
    spec = complex_spectrum(as_device_tensor(series, device))
    powers, wpow = whitened_powers(spec, keep_mask)
    p2 = interbin_powers(scale_spectrum(spec, powers, wpow))
    out = {}
    for h in harmonic_stages(max_numharm):
        vals, bins = stage_candidates(p2, h, topk)
        out[h] = (vals.cpu().numpy(), bins.cpu().numpy())
    return out, wpow.shape[-1]
