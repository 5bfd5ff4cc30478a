"""Sub-bin candidate refinement, the harmpolish equivalent —
counterpart of tpulsar/search/refine.py.

PRESTO's accelsearch optimizes each candidate's (r, z) to sub-bin
precision before reporting (the -harmpolish stage; reference:
lib/python/PALFA2_presto_search.py:561 and :579).  Bin-quantized
candidates lose up to half a Fourier bin of frequency accuracy and up
to ~30% of peak power (scalloping).

Method: the power of a drifting tone at continuous Fourier coordinates
(r, z) is the spectrum correlated against a closed-form fractional
z-response, and a Nelder-Mead simplex maximizes it within +-1 bin in r
and +-DZ in z; each harmonic h is evaluated at (h*r, h*z) and the
powers summed.  That core is host NumPy/SciPy, copied from the
reference.  refine_candidates whitens each DM's series on the device,
gathers the harmonic windows with one indexed gather and makes one
host transfer per DM group.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulsar_torch.kernels.accel import DZ, template_width


def _response_at(z: float, offsets: np.ndarray) -> np.ndarray:
    """Complex response values of a unit tone drifting z bins, sampled
    at (possibly fractional) bin offsets from the tone's MEAN
    frequency.

    Closed form via Fresnel integrals (the continuous limit of the
    discrete-chirp DFT that builds the search templates):
      S(u) = e^{-i pi u^2 / z} / sqrt(2 z) * [F(t2) - F(t1)],
      t1 = -u sqrt(2/z), t2 = (1 - u/z) sqrt(2 z),
    with u the offset from the START frequency and F = C + iS the
    Fresnel integral; z < 0 follows from S_{-z}(u) = conj(S_z(-u)),
    and z -> 0 degenerates to the Dirichlet kernel
    e^{-i pi u} sinc(u)."""
    offsets = np.asarray(offsets, np.float64)
    u = offsets + z / 2.0              # offsets from the START freq
    if abs(z) < 1e-4:
        return (np.exp(-1j * np.pi * u) * np.sinc(u)).astype(complex)
    if z < 0:
        return np.conj(_response_at(-z, -offsets))
    s1, c1 = _fresnel(-u * np.sqrt(2.0 / z))
    s2, c2 = _fresnel((1.0 - u / z) * np.sqrt(2.0 * z))
    f21 = (c2 - c1) + 1j * (s2 - s1)
    return np.exp(-1j * np.pi * u * u / z) / np.sqrt(2.0 * z) * f21


def _fresnel(x):
    from scipy import special
    return special.fresnel(x)


def power_at(spec, r: float, z: float, width: int | None = None) -> float:
    """Normalized power of the whitened complex spectrum `spec` at
    continuous coordinates (r, z): |matched filter|^2 with the
    fractional z-response, so a unit-mean-noise spectrum gives
    Gamma(1,1)-distributed values, the scale of the grid search.

    r is the signal's MEAN Fourier frequency in bins (the convention of
    the search plane and of every Candidate's r/freq fields).  width
    defaults to the search templates' sizing rule (template_width)."""
    if width is None:
        width = template_width(abs(z))
    nbins = spec.shape[-1]
    center = r
    k0 = int(round(center)) - width // 2
    k0 = max(1, min(k0, max(1, nbins - width - 1)))
    kend = min(k0 + width, nbins)
    ks = np.arange(k0, kend)
    resp = _response_at(z, ks - center)
    seg = np.asarray(spec[k0: kend])
    norm = float(np.sum(np.abs(resp) ** 2))
    if norm <= 0:
        return 0.0
    return float(np.abs(np.vdot(resp, seg)) ** 2 / norm)


def refine_peak(spec, r0: float, z0: float, numharm: int = 1,
                width: int | None = None, max_dr: float = 1.0,
                max_dz: float = DZ) -> tuple[float, float, float]:
    """Maximize the harmonic-summed power around (r0, z0).

    Returns (r, z, summed_power) with r the refined FUNDAMENTAL bin and
    summed_power = sum_h P(h*r, h*z).  The simplex is bounded to
    +-max_dr / +-max_dz around the grid detection."""
    from scipy import optimize

    def neg_summed(x):
        r, z = x
        if abs(r - r0) > max_dr or abs(z - z0) > max_dz:
            return 0.0        # outside the trust region: no credit
        return -sum(power_at(spec, h * r, h * z, width=width)
                    for h in range(1, numharm + 1))

    res = optimize.minimize(
        neg_summed, x0=[r0, z0], method="Nelder-Mead",
        options={"xatol": 1e-3, "fatol": 1e-4, "maxfev": 120})
    r, z = float(res.x[0]), float(res.x[1])
    best = -float(res.fun)
    grid = sum(power_at(spec, h * r0, h * z0, width=width)
               for h in range(1, numharm + 1))
    if grid > best:           # optimizer wandered; keep the grid point
        return r0, z0, grid
    return r, z, best


#: window widths: the reference's bucket rule, kept so that the
#: windows cover the same bins as the reference's (a window is
#: [lo, lo + width) clipped to the spectrum)
_WIDTH_BUCKETS = (512, 2048, 8192)


def _window_width(span: int) -> int:
    for w in _WIDTH_BUCKETS:
        if span <= w:
            return w
    return 1 << max(0, span - 1).bit_length()


class _WindowedSpectrum:
    """Host view of selected [lo, hi) windows of a device-resident
    spectrum.  Supports exactly the access pattern power_at uses —
    ``spec[k0:kend]`` with the slice inside one fetched window, plus
    ``.shape`` — so refinement transfers a few hundred bins per
    candidate harmonic instead of the whole whitened spectrum."""

    def __init__(self, nbins: int,
                 windows: list[tuple[int, np.ndarray]]) -> None:
        self.shape = (nbins,)
        self._wins = windows

    def __getitem__(self, sl: slice) -> np.ndarray:
        for lo, arr in self._wins:
            if lo <= sl.start and sl.stop <= lo + len(arr):
                return arr[sl.start - lo: sl.stop - lo]
        raise IndexError(
            f"slice [{sl.start}:{sl.stop}) outside prefetched windows")


def _harmonic_windows(r0: float, z0: float, numharm: int,
                      nbins: int) -> list[tuple[int, int]]:
    """[lo, hi) bin ranges covering every slice power_at can request
    while refine_peak explores |r - r0| <= 1, |z - z0| <= DZ at
    harmonics 1..numharm, including power_at's edge clamps."""
    out = []
    for h in range(1, numharm + 1):
        w_max = template_width(abs(h * (abs(z0) + DZ)))
        raw_lo = int(round(h * (r0 - 1))) - w_max // 2 - 2
        # power_at's upper clamp can relocate k0 down to
        # nbins - w - 1 for centres near the top edge
        lo = min(raw_lo, nbins - w_max - 2)
        hi = int(round(h * (r0 + 1))) + w_max // 2 + 2
        if raw_lo < 1:
            # ... and its lower clamp (k0 = max(1, ...)) relocates k0
            # up to 1, stretching the slice to [1, 1 + w)
            hi = max(hi, 1 + w_max + 1)
        out.append((max(0, lo), min(nbins, max(hi, lo + w_max + 2))))
    return out


def _gather_windows(wspec: torch.Tensor, lows: np.ndarray,
                    width: int) -> np.ndarray:
    """(nwin, width) complex64 host array: wspec[lo : lo + width] for
    each lo, indices clamped to the spectrum (one gather, one
    transfer)."""
    idx = (torch.from_numpy(lows.astype(np.int64)).to(wspec.device)[:, None]
           + torch.arange(width, device=wspec.device)[None, :])
    idx = torch.clamp(idx, 0, wspec.shape[0] - 1)
    return wspec[idx].cpu().numpy()


def refine_candidates(cands, series_by_dm, dt: float, nfft: int,
                      keep_mask=None) -> None:
    """Refine a list of sifting.Candidate IN PLACE.

    series_by_dm: {dm: (T,) float32 tensor} at FULL time resolution, on
    the device the search runs on; candidates are grouped by DM so each
    series is FFT'd and whitened once.  A candidate's r is in its
    detection pass's bin units, so the invariant freq_hz maps it onto
    this series' scale: r0 = freq_hz * T_s.  Power, r, z, freq and
    period are updated; sigma is the caller's to recompute (it owns the
    trials correction)."""
    from tpulsar_torch.kernels import fourier as fr

    by_dm: dict[float, list] = {}
    for c in cands:
        by_dm.setdefault(c.dm, []).append(c)
    T_s = nfft * dt
    for dm, group in by_dm.items():
        if dm not in series_by_dm:
            continue
        series = series_by_dm[dm][None, :]
        if keep_mask is not None:
            wspec = fr.whitened_spectrum_masked(series, keep_mask,
                                                nfft=nfft)[0]
        else:
            wspec = fr.whitened_spectrum(series, nfft=nfft)[0]
        nbins = int(wspec.shape[0])
        ranges: list[tuple[int, int]] = []
        cand_spans: list[list[tuple[int, int]]] = []
        for c in group:
            spans = _harmonic_windows(c.freq_hz * T_s, c.z,
                                      c.numharm, nbins)
            cand_spans.append(spans)
            ranges.extend(spans)
        width = _window_width(max(hi - lo for lo, hi in ranges))
        lows = np.fromiter((lo for lo, _ in ranges), np.int64,
                           len(ranges))
        fetched = _gather_windows(wspec, lows, width)
        del wspec
        windows = [(lo, fetched[i][: min(width, nbins - lo)])
                   for i, (lo, _hi) in enumerate(ranges)]
        i = 0
        for c, spans in zip(group, cand_spans):
            view = _WindowedSpectrum(nbins, windows[i: i + len(spans)])
            i += len(spans)
            r0 = c.freq_hz * T_s
            r, z, power = refine_peak(view, r0, c.z,
                                      numharm=c.numharm)
            c.r, c.z, c.power = r, z, power
            c.freq_hz = r / T_s
            c.period_s = T_s / r
