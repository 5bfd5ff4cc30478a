"""Synthetic PSRFITS beam generator with injected pulsars.

The reference has no offline test fixture at all — its tests hit live
servers (SURVEY.md section 4).  This module closes that gap: it writes
search-mode PSRFITS files (single merged-band beams, or PALFA
Mock-spectrometer s0/s1 subband pairs) containing Gaussian radio
noise, optional injected dispersed pulsars, and optional injected RFI,
so every layer from the FITS reader to the full search executor can be
tested hermetically and candidate recovery can be asserted against
ground truth.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from tpulsar_torch.astro import angles, times
from tpulsar_torch.constants import dispersion_delay_s
from tpulsar_torch.io import fitscore


@dataclasses.dataclass
class PulsarSpec:
    """Ground truth for one injected pulsar."""
    period_s: float
    dm: float
    width_frac: float = 0.05      # FWHM as a fraction of the period
    snr_per_sample: float = 0.1   # peak amplitude in units of noise sigma
    pdot: float = 0.0             # period derivative (s/s)


@dataclasses.dataclass
class RFISpec:
    """Ground truth for injected interference."""
    kind: str = "tone"            # 'tone' (narrowband) or 'burst' (broadband)
    channel: int = 0              # for tones
    t_start_s: float = 0.0        # for bursts
    t_len_s: float = 0.1
    amplitude: float = 5.0


@dataclasses.dataclass
class BeamSpec:
    """Observation geometry for a synthetic beam (PALFA-Mock-like
    defaults, scaled down; real Mock: 960 chan, 65.5 us, ~4 min)."""
    nchan: int = 96
    nsamp: int = 1 << 16
    tsamp_s: float = 655.36e-6
    fctr_mhz: float = 1375.5
    bw_mhz: float = 322.617
    nbits: int = 4
    npol: int = 1
    nsblk: int = 64
    source: str = "G0000+00"
    ra_str: str = "18:53:00.0"
    dec_str: str = "+13:04:00.0"
    projid: str = "P2030"
    beam_id: int = 3
    scan: int = 100
    mjd: float = 55555.5
    backend: str = "pdev"
    descending_band: bool = False  # write channels in descending freq order
    seed: int = 42


def channel_freqs(spec: BeamSpec) -> np.ndarray:
    """Ascending channel center frequencies in MHz."""
    df = spec.bw_mhz / spec.nchan
    lo = spec.fctr_mhz - spec.bw_mhz / 2 + df / 2
    return lo + np.arange(spec.nchan) * df


def dispersion_delays(dm: float, freqs_mhz: np.ndarray,
                      ref_freq_mhz: float) -> np.ndarray:
    """Dispersion delay (s) of each channel relative to ref_freq."""
    return dispersion_delay_s(dm, freqs_mhz, ref_freq_mhz)


def make_dynamic_spectrum(spec: BeamSpec,
                          pulsars: list[PulsarSpec] = (),
                          rfi: list[RFISpec] = ()) -> np.ndarray:
    """Float32 (nsamp, nchan) dynamic spectrum, channels ascending in
    frequency, unit-variance noise plus injected signals."""
    rng = np.random.default_rng(spec.seed)
    data = rng.standard_normal((spec.nsamp, spec.nchan)).astype(np.float32)
    freqs = channel_freqs(spec)
    ref = freqs[-1]
    t = np.arange(spec.nsamp) * spec.tsamp_s

    for psr in pulsars:
        delays = dispersion_delays(psr.dm, freqs, ref)
        # Gaussian pulse profile in phase, per channel with its delay.
        sigma_phase = psr.width_frac / 2.35482
        for c in range(spec.nchan):
            p_inst = psr.period_s + psr.pdot * t
            phase = ((t - delays[c]) / p_inst) % 1.0
            dph = np.minimum(phase, 1.0 - phase)
            data[:, c] += (psr.snr_per_sample
                           * np.exp(-0.5 * (dph / sigma_phase) ** 2)).astype(np.float32)

    for r in rfi:
        if r.kind == "tone":
            data[:, r.channel] += r.amplitude * np.sin(
                2 * np.pi * 60.0 * t).astype(np.float32)
        elif r.kind == "burst":
            i0 = int(r.t_start_s / spec.tsamp_s)
            i1 = min(spec.nsamp, i0 + max(1, int(r.t_len_s / spec.tsamp_s)))
            data[i0:i1, :] += r.amplitude
    return data


def _digitize(data: np.ndarray, nbits: int):
    """Map float data to unsigned nbits ints plus per-channel
    scale/offset so that decode(scale*x+offset) ~= data."""
    lo = np.percentile(data, 0.5, axis=0)
    hi = np.percentile(data, 99.5, axis=0)
    nlev = (1 << nbits) - 1
    scale = np.maximum((hi - lo) / nlev, 1e-6).astype(np.float32)
    offset = lo.astype(np.float32)
    q = np.clip(np.round((data - offset) / scale), 0, nlev).astype(np.uint16)
    return q, scale, offset


def _row_dtype(spec: BeamSpec) -> np.dtype:
    nchan, npol, nsblk = spec.nchan, spec.npol, spec.nsblk
    bytes_per_blk = nsblk * npol * nchan * spec.nbits // 8
    return np.dtype([
        ("TSUBINT", ">f8"), ("OFFS_SUB", ">f8"), ("LST_SUB", ">f8"),
        ("RA_SUB", ">f8"), ("DEC_SUB", ">f8"), ("GLON_SUB", ">f8"),
        ("GLAT_SUB", ">f8"), ("FD_ANG", ">f4"), ("POS_ANG", ">f4"),
        ("PAR_ANG", ">f4"), ("TEL_AZ", ">f4"), ("TEL_ZEN", ">f4"),
        ("DAT_FREQ", ">f8", (nchan,)), ("DAT_WTS", ">f4", (nchan,)),
        ("DAT_OFFS", ">f4", (nchan * npol,)), ("DAT_SCL", ">f4", (nchan * npol,)),
        ("DATA", ">u1", (bytes_per_blk,)),
    ])


def _fill_rows(rows: np.ndarray, spec: BeamSpec, row0: int,
               freqs: np.ndarray, scale: np.ndarray,
               offset: np.ndarray, packed: np.ndarray) -> None:
    """Fill subint rows row0.. of a table (file channel order)."""
    npol = spec.npol
    tsub = spec.nsblk * spec.tsamp_s
    rows["TSUBINT"] = tsub
    rows["OFFS_SUB"] = (row0 + np.arange(len(rows)) + 0.5) * tsub
    rows["RA_SUB"] = angles.hms_str_to_deg(spec.ra_str)
    rows["DEC_SUB"] = angles.dms_str_to_deg(spec.dec_str)
    rows["TEL_AZ"] = 180.0
    rows["TEL_ZEN"] = 10.0
    rows["DAT_FREQ"] = freqs
    rows["DAT_WTS"] = 1.0
    rows["DAT_OFFS"] = np.tile(offset, npol)
    rows["DAT_SCL"] = np.tile(scale, npol)
    rows["DATA"] = packed.reshape(len(rows), -1)


def _headers(spec: BeamSpec, rows: np.ndarray, freqs: np.ndarray):
    """(primary, SUBINT) headers; `rows` only lends its dtype and
    length."""
    mjd_i = int(spec.mjd)
    secs = (spec.mjd - mjd_i) * 86400.0
    stt_smjd = int(secs)
    stt_offs = secs - stt_smjd

    primary = fitscore.primary_header()
    for k, v in [
        ("FITSTYPE", "PSRFITS"), ("HDRVER", "3.4"),
        ("TELESCOP", "Arecibo"), ("OBSERVER", "tpulsar-synth"),
        ("PROJID", spec.projid), ("FRONTEND", "alfa"),
        ("BACKEND", spec.backend), ("IBEAM", spec.beam_id),
        ("NRCVR", 1), ("FD_POLN", "LIN"),
        ("OBS_MODE", "SEARCH"), ("DATE-OBS", times.mjd_to_datestr(spec.mjd)),
        ("OBSFREQ", spec.fctr_mhz), ("OBSBW", spec.bw_mhz),
        ("OBSNCHAN", spec.nchan), ("CHAN_DM", 0.0),
        ("SRC_NAME", spec.source), ("TRK_MODE", "TRACK"),
        ("RA", spec.ra_str), ("DEC", spec.dec_str),
        ("BMIN", 0.05667), ("BMAJ", 0.05667),
        ("STT_IMJD", mjd_i), ("STT_SMJD", stt_smjd), ("STT_OFFS", stt_offs),
        ("STT_LST", times.lmst_seconds(spec.mjd, -66.7528)),
    ]:
        primary.set(k, v)

    nchan, npol, nsblk = spec.nchan, spec.npol, spec.nsblk
    subhdr_cards = dict(
        INT_TYPE="TIME", INT_UNIT="SEC", SCALE="FluxDen",
        NPOL=npol, POL_TYPE="AA+BB" if npol == 1 else "AABB",
        TBIN=spec.tsamp_s, NBIN=1, NBITS=spec.nbits,
        NCH_FILE=nchan, NCHAN=nchan, CHAN_BW=(freqs[1] - freqs[0]),
        NCHNOFFS=0, NSBLK=nsblk, NSUBOFFS=0,
        ZERO_OFF=0.0, SIGNINT=0, NUMIFS=1, BEAM=spec.beam_id,
    )
    # TDIM fastest axis is the packed channel byte count (nchan*nbits/8),
    # valid for 4-, 8- and 16-bit data alike.
    subhdr = fitscore.bintable_header(
        "SUBINT", rows,
        tdims={"DATA": (nsblk, npol, nchan * spec.nbits // 8)},
        **subhdr_cards)
    return primary, subhdr


def write_psrfits(path: str, spec: BeamSpec, data: np.ndarray) -> str:
    """Write (nsamp, nchan) float data as a search-mode PSRFITS file."""
    nsub = spec.nsamp // spec.nsblk
    if nsub * spec.nsblk != spec.nsamp:
        raise ValueError("nsamp must be a multiple of nsblk")
    q, scale, offset = _digitize(data, spec.nbits)

    freqs = channel_freqs(spec)
    if spec.descending_band:
        freqs = freqs[::-1]
        q = q[:, ::-1]
        scale = scale[::-1]
        offset = offset[::-1]

    rows = np.zeros(nsub, dtype=_row_dtype(spec))
    from tpulsar_torch.io.psrfits import pack_samples
    packed = pack_samples(
        q.reshape(nsub, spec.nsblk * spec.npol * spec.nchan), spec.nbits)
    _fill_rows(rows, spec, 0, freqs, scale, offset, packed)
    primary, subhdr = _headers(spec, rows, freqs)
    fitscore.write_fits(path, [
        fitscore.HDU(primary, None), fitscore.HDU(subhdr, rows)])
    return path


def write_psrfits_slabs(path: str, spec: BeamSpec, slabs, scale,
                        offset) -> str:
    """Write a search-mode PSRFITS file from time slabs, so that the
    whole beam is never held at once.

    slabs: iterable of already-packed sample bytes, each (n, nchan *
    nbits / 8) uint8 for n spectra (a multiple of nsblk, channels
    ascending, single polarization), summing to spec.nsamp.
    scale/offset: the per-channel affine the samples were digitized
    with (value = q * scale + offset)."""
    nsub = spec.nsamp // spec.nsblk
    if nsub * spec.nsblk != spec.nsamp or spec.npol != 1 \
            or spec.descending_band:
        raise ValueError("slab writer: nsamp must be a multiple of "
                         "nsblk, one polarization, ascending band")
    freqs = channel_freqs(spec)
    rowdt = _row_dtype(spec)
    primary, subhdr = _headers(
        spec, np.broadcast_to(np.zeros(1, rowdt), (nsub,)), freqs)
    scale = np.asarray(scale, np.float32)
    offset = np.asarray(offset, np.float32)
    row0 = 0
    with open(path, "wb") as fh:
        fitscore._write_header(fh, primary)
        fitscore._write_header(fh, subhdr)
        for packed in slabs:
            packed = np.asarray(packed, np.uint8)
            if len(packed) % spec.nsblk:
                raise ValueError("slab length must be a multiple of nsblk")
            rows = np.zeros(len(packed) // spec.nsblk, dtype=rowdt)
            _fill_rows(rows, spec, row0, freqs, scale, offset, packed)
            fh.write(rows.tobytes())
            row0 += len(rows)
        if row0 != nsub:
            raise ValueError(f"slabs held {row0} subints, expected {nsub}")
        nbytes = nsub * rowdt.itemsize
        fh.write(b"\x00" * ((-nbytes) % fitscore.BLOCK))
    return path


def synth_beam_slabs(outdir: str, spec: BeamSpec,
                     pulsars: list[PulsarSpec] = (),
                     slab_nsamp: int = 1 << 18, device=None) -> list[str]:
    """Write a merged-Mock-named beam of any length in time slabs,
    generating the noise and the injected pulsars with torch on
    `device` (a full 960-channel Mock beam is 15 GB as float32; this
    path never holds more than one slab).  Unit-variance Gaussian
    noise; each channel is digitized to spec.nbits with the step
    `_digitize` would pick for pure noise (its 0.5 to 99.5 percentile
    range over the levels), with zero on a level rather than between
    two: every channel's median is then the same level, as in a
    digitizer whose offset is set to the band's mean.  Deterministic
    for a given spec.seed and device."""
    import torch

    from tpulsar_torch import resolve_device

    dev = resolve_device(device)
    if spec.nbits != 4:
        raise ValueError("synth_beam_slabs writes 4-bit data")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, mock_filename(spec))
    nlev = (1 << spec.nbits) - 1
    z = 2.5758293035489004        # N(0,1) 99.5th percentile
    step = 2 * z / nlev
    scale = np.full(spec.nchan, step, np.float32)
    offset = np.full(spec.nchan, -(nlev + 1) // 2 * step, np.float32)
    freqs = channel_freqs(spec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(spec.seed)
    slab_nsamp = max(spec.nsblk, slab_nsamp // spec.nsblk * spec.nsblk)
    delays = [torch.as_tensor(
        dispersion_delays(p.dm, freqs, freqs[-1]), dtype=torch.float64,
        device=dev) for p in pulsars]

    def slabs():
        for t0 in range(0, spec.nsamp, slab_nsamp):
            n = min(slab_nsamp, spec.nsamp - t0)
            x = torch.randn((n, spec.nchan), generator=gen, device=dev)
            t = (t0 + torch.arange(n, device=dev, dtype=torch.float64)
                 ) * spec.tsamp_s
            for p, dly in zip(pulsars, delays):
                p_inst = p.period_s + p.pdot * t
                phase = torch.remainder(
                    (t[:, None] - dly[None, :]) / p_inst[:, None], 1.0)
                dph = torch.minimum(phase, 1.0 - phase)
                sig = p.width_frac / 2.35482
                x += (p.snr_per_sample
                      * torch.exp(-0.5 * (dph / sig) ** 2)).to(x.dtype)
            q = torch.clamp(torch.round((x - offset[0]) / scale[0]),
                            0, nlev).to(torch.uint8)
            packed = (q[:, 0::2] << 4) | (q[:, 1::2] & 0x0F)
            yield packed.cpu().numpy()

    return [write_psrfits_slabs(path, spec, slabs(), scale, offset)]


def mock_filename(spec: BeamSpec, subband: int | None = None) -> str:
    """PALFA filename conventions (reference: lib/python/datafile.py:398,514).

    subband None -> merged-Mock name '{projid}.{date}.{src}.b{beam}.{scan}.fits';
    else raw Mock '4bit-{projid}.{date}.{src}.b{beam}s{sb}g0.{scan}.fits'.
    """
    y, m, d = times.mjd_to_date(spec.mjd)
    date = f"{y:04d}{m:02d}{int(d):02d}"
    if subband is None:
        return f"{spec.projid}.{date}.{spec.source}.b{spec.beam_id}.{spec.scan:05d}.fits"
    return (f"4bit-{spec.projid}.{date}.{spec.source}."
            f"b{spec.beam_id}s{subband}g0.{spec.scan:05d}.fits")


def synth_beam(outdir: str, spec: BeamSpec | None = None,
               pulsars: list[PulsarSpec] = (), rfi: list[RFISpec] = (),
               merged: bool = True) -> list[str]:
    """Generate a synthetic beam on disk.

    merged=True  -> one merged-band file (MergedMock-style name).
    merged=False -> a Mock s0/s1 subband pair splitting the band, with
                    a small overlap region, to exercise subband merging.
    Returns the list of file paths written.
    """
    spec = spec or BeamSpec()
    os.makedirs(outdir, exist_ok=True)
    data = make_dynamic_spectrum(spec, pulsars, rfi)
    if merged:
        path = os.path.join(outdir, mock_filename(spec))
        return [write_psrfits(path, spec, data)]

    # Split into two overlapping halves like the Mock spectrometer:
    # s1 = low half, s0 = high half (PALFA convention), with overlap.
    overlap = max(2, spec.nchan // 16)
    half = spec.nchan // 2
    df = spec.bw_mhz / spec.nchan
    freqs = channel_freqs(spec)
    out = []
    for sb, sl in (("1", slice(0, half + overlap)),
                   ("0", slice(half - overlap, spec.nchan))):
        sub = data[:, sl]
        fsub = freqs[sl]
        subspec = dataclasses.replace(
            spec, nchan=sub.shape[1],
            fctr_mhz=float(fsub.mean()),
            bw_mhz=float(df * sub.shape[1]))
        path = os.path.join(outdir, mock_filename(spec, subband=int(sb)))
        write_psrfits(path, subspec, sub)
        out.append(path)
    return out
