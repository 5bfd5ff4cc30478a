"""Plain reference of one pass of the PALFA search, and of sifting.

Written from the survey's definitions (PRESTO's prepsubband,
single_pulse_search, realfft / zapbirds / rednoise, accelsearch and
sifting, as PALFA2_presto_search.py runs them) in plain PyTorch and
NumPy.  It imports nothing of the program under test and takes
nothing the program made: from the benchmark's block, frequencies,
plan table and zaplist it works out again the shift tables, the
dedispersed series, the detrend, the whitening, the harmonic sums and
the z-template bank.

Every quantity is computed in float64 (the dedispersion sums are
exact integers).  `Prec("bf16")` computes the same steps with every
stored value rounded to bfloat16: the control a comparison has to
fail.

Conventions the program's outputs are read by:
  * a pass's DM row d is dms[d]; series[d, t] sums subband s at
    min(t + shift[d, s], T - 1), subband b sums its channels at
    min(t + shift[c], T - 1) before the sum-downsample;
  * the single-pulse S/N of width w at sample t is the sum of the
    detrended, unit-variance series over [t, t + w) over sqrt(w);
    events are kept per 32-sample block;
  * the lo and hi stages search the half-bin grid: index 2k is bin k,
    and a candidate's r is index / 2;
  * a stage of h harmonics sums indices c, 2c, .., hc (the hi stage at
    z index clip(centre + hh (zi - centre))).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy import special

from port_bench import bounds

KDM = 1.0 / 2.41e-4

SP_BLOCK = 32          # samples per single-pulse event block
SP_DETREND = 1000      # samples per detrend block
CAND_BLOCK = 64        # half-bins per candidate block (lo and hi)
WHITEN_FIRST, WHITEN_GROWTH, WHITEN_MAX = 6, 1.5, 8192


class Prec:
    """Working precision: 'f64', or 'bf16' (every stored value
    rounded to bfloat16, arithmetic in float32)."""

    def __init__(self, name: str = "f64"):
        if name not in ("f64", "bf16"):
            raise ValueError(name)
        self.name = name
        self.real = torch.float64 if name == "f64" else torch.float32
        self.cplx = torch.complex128 if name == "f64" else torch.complex64

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f64":
            return x
        if x.is_complex():
            return torch.complex(x.real.to(torch.bfloat16).float(),
                                 x.imag.to(torch.bfloat16).float())
        return x.to(torch.bfloat16).to(self.real)


F64 = Prec("f64")


# ------------------------------------------------------ dedispersion

def pass_shifts(freqs: np.ndarray, nsub: int, subdm: float, dms,
                dt: float, downsamp: int):
    """(channel shifts at the full rate, each relative to its own
    subband's highest frequency; subband shifts (ndms, nsub) at the
    downsampled rate, relative to the band's highest frequency)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    nchan = len(freqs)
    subref = freqs.reshape(nsub, nchan // nsub)[:, -1]
    chan_ref = np.repeat(subref, nchan // nsub)
    chan = np.round(KDM * subdm * (freqs ** -2.0 - chan_ref ** -2.0)
                    / dt).astype(np.int64)
    ref = float(freqs[-1])
    sub = np.stack([np.round(KDM * np.asarray(dm) * (subref ** -2.0
                                                      - ref ** -2.0)
                             / (dt * downsamp)).astype(np.int64)
                    for dm in np.atleast_1d(np.asarray(dms, np.float64))])
    return chan, sub


def _add_shifted(acc: torch.Tensor, row: torch.Tensor, s: int) -> None:
    """acc[t] += row[min(t + s, T - 1)]."""
    T = row.shape[0]
    s = min(max(int(s), 0), T)
    if s < T:
        acc[: T - s] += row[s:]
    if s > 0:
        acc[T - s:] += row[T - 1]


def dedisperse(block: torch.Tensor, chan_shifts, sub_shifts, nsub: int,
               downsamp: int) -> torch.Tensor:
    """(ndms, T // downsamp) int32 series of one pass, exact."""
    nchan, T = block.shape
    cps = nchan // nsub
    td = T // downsamp
    dev = block.device
    sub = torch.empty((nsub, td), dtype=torch.int32, device=dev)
    acc = torch.empty(T, dtype=torch.int32, device=dev)
    for b in range(nsub):
        acc.zero_()
        for c in range(b * cps, (b + 1) * cps):
            _add_shifted(acc, block[c].to(torch.int32), chan_shifts[c])
        sub[b] = acc[: td * downsamp].view(td, downsamp).sum(1)
    sh = np.asarray(sub_shifts)
    out = torch.zeros((sh.shape[0], td), dtype=torch.int32, device=dev)
    for s in range(nsub):
        for d in range(sh.shape[0]):
            _add_shifted(out[d], sub[s], sh[d, s])
    return out


# ------------------------------------------------------ single pulse

def _median(x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Median over the last axis; an even length takes the mean of the
    two middle values."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    return prec.q((s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5)


def normalize(series: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Each row less a piecewise-constant baseline (the median of each
    SP_DETREND samples; a shorter tail its own median), over its
    population standard deviation."""
    x = prec.q(series.to(prec.real))
    nd, T = x.shape
    blk = min(SP_DETREND, T)
    nb = max(1, T // blk)
    use = nb * blk
    base = _median(x[:, :use].reshape(nd, nb, blk), prec)
    base = torch.repeat_interleave(base, blk, dim=-1)
    if T > use:
        tail = _median(x[:, use:], prec)
        base = torch.cat([base, tail[:, None].expand(nd, T - use)], -1)
    det = prec.q(x - base)
    sd = prec.q(torch.clamp(det.std(dim=-1, keepdim=True, correction=0),
                            min=1e-9))
    return prec.q(det / sd)


def _block_max(x: torch.Tensor, block: int):
    """(max, first argmax) of each `block` run along the last axis (the
    last run padded with -inf)."""
    L = x.shape[-1]
    nb = -(-L // block)
    if nb * block > L:
        x = torch.nn.functional.pad(x, (0, nb * block - L),
                                    value=float("-inf"))
    r = x.reshape(*x.shape[:-1], nb, block)
    return r.amax(-1), r.argmax(-1)


def _kth(bmax: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest block maximum of each row (-inf when a row has
    fewer blocks)."""
    if bmax.shape[-1] < k:
        return torch.full(bmax.shape[:-1], float("-inf"),
                          dtype=bmax.dtype, device=bmax.device)
    return torch.topk(bmax, k, dim=-1).values[..., -1]


@dataclasses.dataclass
class SPRef:
    widths: tuple
    cs: torch.Tensor       # (ndms, T + 1) cumulative sums, cs[:, 0] = 0
    bmax: torch.Tensor     # (nw, ndms, nblocks) block maxima of the S/N
    barg: torch.Tensor     # (nw, ndms, nblocks) their offsets
    kth: torch.Tensor      # (nw, ndms) the topk-th block maximum

    def snr(self, rows, widths, samples) -> np.ndarray:
        """S/N of (row, width, start sample) triples."""
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.cs.device)
        w = torch.as_tensor(np.asarray(widths, np.int64),
                            device=self.cs.device)
        t = torch.as_tensor(np.asarray(samples, np.int64),
                            device=self.cs.device)
        v = (self.cs[r, t + w] - self.cs[r, t]) / torch.sqrt(w.double())
        return v.double().cpu().numpy()


def sp_reference(series: torch.Tensor, widths, topk: int,
                 prec: Prec = F64) -> SPRef:
    norm = normalize(series, prec)
    cs = prec.q(torch.cumsum(norm, dim=-1))
    del norm
    cs = torch.nn.functional.pad(cs, (1, 0))
    bmaxs, bargs, kths = [], [], []
    for w in widths:
        snr = prec.q(prec.q(cs[:, w:] - cs[:, :-w]) / math.sqrt(w))
        bm, ba = _block_max(snr, SP_BLOCK)
        del snr
        bmaxs.append(bm)
        bargs.append(ba)
        kths.append(_kth(bm, topk))
    L0 = bmaxs[0].shape[-1]
    pad = [torch.nn.functional.pad(b, (0, L0 - b.shape[-1]),
                                   value=float("-inf")) for b in bmaxs]
    padi = [torch.nn.functional.pad(b, (0, L0 - b.shape[-1]))
            for b in bargs]
    return SPRef(tuple(widths), cs, torch.stack(pad), torch.stack(padi),
                 torch.stack(kths))


def sp_events(ref: SPRef, threshold: float) -> dict:
    """The reference's events: {(row, block): (sigma, sample, width)},
    each block's best over the widths among each width's top-k block
    maxima at or above the threshold."""
    ok = (ref.bmax >= ref.kth[..., None]) & (ref.bmax >= threshold)
    vals = torch.where(ok, ref.bmax, torch.full_like(ref.bmax,
                                                     float("-inf")))
    best, wi = vals.max(dim=0)                     # (ndms, nblocks)
    rows, blks = torch.nonzero(best >= threshold, as_tuple=True)
    out = {}
    if len(rows) == 0:
        return out
    w_sel = wi[rows, blks]
    off = ref.barg[w_sel, rows, blks]
    sig = best[rows, blks].double().cpu().numpy()
    for r, b, wj, o, s in zip(rows.tolist(), blks.tolist(),
                              w_sel.tolist(), off.tolist(), sig):
        out[(r, b)] = (float(s), b * SP_BLOCK + o, ref.widths[wj])
    return out


# ------------------------------------------------ spectrum and lo stage

def whiten_edges(nbins: int) -> list[int]:
    """Log-growing block edges of the low-frequency section, from bin
    1, until a block reaches WHITEN_MAX bins."""
    edges = [1]
    size = float(WHITEN_FIRST)
    while edges[-1] < nbins and size < WHITEN_MAX:
        edges.append(min(nbins, edges[-1] + int(size)))
        size *= WHITEN_GROWTH
    return edges


def whitened_spectrum(series: torch.Tensor, nfft: int, keep: np.ndarray,
                      prec: Prec = F64) -> torch.Tensor:
    """Mean-padded to nfft, rfft with DC zeroed, zapped bins dropped,
    scaled so noise powers have unit mean: the local level is median /
    ln 2 of each whitening block (log-growing blocks, then blocks of
    WHITEN_MAX, then the remainder when over 16 bins), linearly
    interpolated between block centres."""
    x = prec.q(series.to(prec.real))
    nd, T = x.shape
    if T < nfft:
        m = prec.q(x.mean(dim=-1, keepdim=True))
        x = torch.cat([x, m.expand(nd, nfft - T)], -1)
    spec = prec.q(torch.fft.rfft(x, dim=-1))
    spec[:, 0] = 0
    nbins = spec.shape[-1]
    kp = torch.as_tensor(keep, device=x.device).to(prec.real)
    powers = prec.q(prec.q(spec.real * spec.real + spec.imag * spec.imag)
                    * kp)
    edges = whiten_edges(nbins)
    cents, levels = [], []
    ln2 = math.log(2.0)
    for lo, hi in zip(edges[:-1], edges[1:]):
        cents.append(0.5 * (lo + hi))
        levels.append(_median(powers[:, lo:hi], prec) / ln2)
    start = edges[-1]
    m = (nbins - start) // WHITEN_MAX
    if m:
        tail = powers[:, start: start + m * WHITEN_MAX].reshape(
            nd, m, WHITEN_MAX)
        med = _median(tail, prec) / ln2
        levels.extend(med.unbind(-1))
        cents.extend(start + (j + 0.5) * WHITEN_MAX for j in range(m))
    rem = nbins - start - m * WHITEN_MAX
    if rem > 16:
        cents.append(0.5 * (nbins - rem + nbins))
        levels.append(_median(powers[:, nbins - rem:], prec) / ln2)
    lev = prec.q(torch.clamp(torch.stack(levels, -1), min=1e-30))
    cent = torch.tensor(cents, dtype=torch.float64, device=x.device)
    bins = torch.arange(nbins, dtype=torch.float64, device=x.device)
    idx = torch.clamp(torch.searchsorted(cent, bins) - 1, 0, len(cents) - 2)
    t = torch.clamp((bins - cent[idx]) / torch.clamp(
        cent[idx + 1] - cent[idx], min=1e-30), 0.0, 1.0).to(prec.real)
    level = prec.q(lev[:, idx] * (1 - t) + lev[:, idx + 1] * t)
    wpow = prec.q(prec.q(powers / level) * kp)
    scale = prec.q(torch.sqrt(wpow / torch.clamp(powers, min=1e-30)))
    return prec.q(spec * scale)


def interbin(wspec: torch.Tensor, prec: Prec = F64) -> torch.Tensor:
    """Half-bin powers: |X_k|^2 at 2k, (pi^2/16) |X_k - X_k+1|^2 at
    2k + 1 (0 after the last bin)."""
    p = prec.q(wspec.real ** 2 + wspec.imag ** 2)
    d = wspec[..., :-1] - wspec[..., 1:]
    half = prec.q((math.pi ** 2 / 16.0) * (d.real ** 2 + d.imag ** 2))
    half = torch.nn.functional.pad(half, (0, 1))
    return torch.stack([p, half], -1).reshape(*p.shape[:-1], -1)


def harmonic_stages(numharm: int) -> list[int]:
    out, h = [], 1
    while h <= numharm:
        out.append(h)
        h *= 2
    return out


@dataclasses.dataclass
class StageRef:
    """One harmonic stage of a set of rows: the summed powers (the
    hi stage's already maximized over z), the block maxima and their
    offsets, the topk-th block maximum, and for the hi stage the z
    index of each maximum and the summed plane."""
    sums: torch.Tensor          # (n, L)
    bmax: torch.Tensor          # (n, nblocks)
    barg: torch.Tensor
    kth: torch.Tensor           # (n,)
    zarg: torch.Tensor | None = None     # (n, L) z index of sums
    plane: torch.Tensor | None = None    # (n, nz, L) summed plane
    zero_bmax: torch.Tensor | None = None  # block maxima of the z=0 row


def lo_reference(wspec: torch.Tensor, numharm: int, topk: int,
                 prec: Prec = F64) -> dict:
    """{h: StageRef} of the zero-acceleration search."""
    p2 = interbin(wspec, prec)
    nr = p2.shape[-1]
    out = {}
    for h in harmonic_stages(numharm):
        L = nr // h
        acc = p2[..., :L].clone()
        for hh in range(2, h + 1):
            acc = prec.q(acc + p2[..., ::hh][..., :L])
        bm, ba = _block_max(acc, CAND_BLOCK)
        out[h] = StageRef(acc, bm, ba, _kth(bm, topk))
    return out


# ------------------------------------------------------------- hi stage

def z_grid(zmax: float) -> np.ndarray:
    n = int(round(zmax / 2.0))
    return np.arange(-n, n + 1) * 2.0


def z_response(z: float, width: int) -> np.ndarray:
    """Response of a unit tone whose frequency drifts linearly by z
    bins, at half-bin spacing over `width` bins around its mean
    frequency: the DFT of a long discrete chirp (N = 2^14 samples,
    zero-padded twice), as PRESTO's accelsearch templates with
    NUMBETWEEN = 2."""
    N = 1 << 14
    c = N // 4
    n = np.arange(N, dtype=np.float64)
    chirp = np.exp(2j * np.pi * (c * n / N + 0.5 * z * (n / N) ** 2))
    spec = np.fft.fft(chirp, 2 * N) / N
    centre = int(round(2 * (c + z / 2)))
    lo = centre - width
    return spec[lo: lo + 2 * width]


def hi_reference(wspec_row: torch.Tensor, zmax: float, numharm: int,
                 topk: int, prec: Prec = F64) -> dict:
    """{h: StageRef} of the accelerated search of one whitened
    spectrum: the matched-filter power plane
        P[z, p] = |sum_k conj(R_z[k]) X'[p - width + k]|^2,
    X' the spectrum at the half-bin grid (zeros between bins), P = 0
    for p < width, then the harmonic sums over (h r, h z)."""
    dev = wspec_row.device
    nbins = wspec_row.shape[-1]
    zs = z_grid(zmax)
    nz = len(zs)
    width = bounds.template_width(zmax)
    n = 2 * nbins
    L2 = 1 << math.ceil(math.log2(n + 2 * width))
    xi = torch.zeros(L2, dtype=prec.cplx, device=dev)
    xi[0:n:2] = wspec_row.to(prec.cplx)
    fx = prec.q(torch.fft.fft(xi))
    del xi
    plane = torch.zeros((nz, n), dtype=prec.real, device=dev)
    for i, z in enumerate(zs):
        a = np.conj(z_response(float(z), width))   # taps j = k - width
        g = np.zeros(L2, dtype=np.complex128)
        j = np.arange(2 * width) - width
        g[(-j) % L2] = a
        fg = prec.q(torch.fft.fft(torch.as_tensor(g, device=dev)
                                  .to(prec.cplx)))
        y = prec.q(torch.fft.ifft(prec.q(fx * fg)))
        plane[i, width:] = prec.q(y.real[width:n] ** 2
                                  + y.imag[width:n] ** 2)
        del y, fg
    del fx
    centre = (nz - 1) // 2
    zi = torch.arange(nz, device=dev)
    out = {}
    for h in harmonic_stages(numharm):
        L = n // h
        acc = plane[:, :L].clone()
        for hh in range(2, h + 1):
            rows = torch.clamp(centre + hh * (zi - centre), 0, nz - 1)
            acc = prec.q(acc + plane[:, : hh * L: hh].index_select(0, rows))
        zmaxv, zarg = acc.max(dim=0)
        bm, ba = _block_max(zmaxv[None], CAND_BLOCK)
        zb, _ = _block_max(acc[centre][None], CAND_BLOCK)
        out[h] = StageRef(zmaxv[None], bm, ba, _kth(bm, topk),
                          zarg=zarg[None], plane=acc[None],
                          zero_bmax=zb)
    return out


# ---------------------------------------------------------- candidates

def sigma_from_power(power, numharm: int, numindep: int) -> np.ndarray:
    """Gaussian significance of a summed power of `numharm` harmonics
    of unit-mean exponential noise (Gamma(numharm, 1)), corrected for
    `numindep` independent trials: sigma = -Phi^-1(P), where
    P = 1 - (1 - Q)^numindep and Q = Q(numharm, power)."""
    s = np.asarray(power, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        q = special.gammaincc(numharm, s)
        asym = ((numharm - 1) * np.log(np.maximum(s, 1e-30)) - s
                - special.gammaln(numharm))
        logq = np.where(q > 1e-290, np.log(np.maximum(q, 1e-300)), asym)
        if numindep > 1:
            m_log1mq = numindep * np.log1p(-np.exp(np.minimum(logq,
                                                              -1e-17)))
            logp = np.where(
                logq < -30.0, logq + np.log(numindep),
                np.where(m_log1mq > -1e-8,
                         np.log(np.maximum(-m_log1mq, 1e-300)),
                         np.log1p(-np.exp(np.clip(m_log1mq, -745.0,
                                                  -1e-17)))))
            logq = np.minimum(logp, 0.0)
        return -special.ndtri_exp(logq)


def numindep_lo(nbins: int, h: int) -> int:
    return max(1, nbins // h)


def numindep_hi(nbins: int, nz: int, h: int) -> int:
    return max(1, (nbins * nz) // h)


# ------------------------------------------------------------- sifting

@dataclasses.dataclass
class Cand:
    r: float
    z: float
    sigma: float
    power: float
    numharm: int
    dm: float
    period_s: float
    freq_hz: float
    hits: list = dataclasses.field(default_factory=list)


def sift(cands: list[Cand], p: dict) -> list[Cand]:
    """PRESTO's sifting as the survey configures it, by plain scans:
    the sigma and period cuts; duplicates (|dr| < r_err and |dz| <= 2)
    merged into the strongest earlier kept candidate, which records
    every (dm, sigma) hit; candidates seen at fewer than min_num_dms
    distinct DMs (to 3 decimals) or whose best hit lies below
    low_dm_cutoff dropped; harmonics (f_c / f_k within harm_frac_tol *
    max(1, ratio) of a/b, a, b <= max_harm) of a stronger kept
    candidate dropped; sigma-descending."""
    cs = [c for c in cands if c.sigma >= p["sigma_threshold"]
          and p["short_period_s"] <= c.period_s <= p["long_period_s"]]
    cs = sorted(cs, key=lambda c: -c.sigma)
    kept: list[Cand] = []
    for c in cs:
        for k in kept:
            if abs(c.r - k.r) < p["r_err"] and abs(c.z - k.z) <= 2.0:
                k.hits.append((c.dm, c.sigma))
                break
        else:
            c.hits = [(c.dm, c.sigma)]
            kept.append(c)
    ok = []
    for c in kept:
        if len({round(d, 3) for d, _ in c.hits}) < p["min_num_dms"]:
            continue
        if max(c.hits, key=lambda h: h[1])[0] < p["low_dm_cutoff"]:
            continue
        ok.append(c)
    ok = sorted(ok, key=lambda c: -c.sigma)
    m = p["max_harm"]
    fracs = np.asarray(sorted({a / b for a in range(1, m + 1)
                               for b in range(1, m + 1)
                               if math.gcd(a, b) == 1}))
    tol = p["harm_frac_tol"]
    out: list[Cand] = []
    fk = np.empty(0)
    for c in ok:
        if len(fk):
            ratio = c.freq_hz / fk
            near = np.abs(ratio[:, None] - fracs[None, :]) \
                < tol * np.maximum(1.0, ratio)[:, None]
            if near.any():
                continue
        out.append(c)
        fk = np.append(fk, c.freq_hz)
    return sorted(out, key=lambda c: -c.sigma)
