"""Data-file domain model: type sniffing, observation grouping,
completeness, and preprocessing.

Capability-parity with the reference's lib/python/datafile.py: file
types are recognized by filename convention, multi-file observations
(PALFA Mock s0/s1 subband pairs) are grouped and checked for
completeness, and preprocessing merges Mock subband pairs into a
single merged-band PSRFITS file — natively, in NumPy, replacing the
reference's shell-out to psrfits_utils' combine_mocks + fitsdelrow
(reference: lib/python/datafile.py:474-508).
"""

from __future__ import annotations

import os
import re

import numpy as np

from tpulsar_torch.astro import coords, times
from tpulsar_torch.constants import SECPERDAY
from tpulsar_torch.io import fitscore
from tpulsar_torch.io.psrfits import SpectraInfo


class DatafileError(Exception):
    pass


# Number of leading subint rows dropped when merging Mock subbands (the
# Mock spectrometer's first rows carry setup transients; reference
# behavior: fitsdelrow 1 7 after combine_mocks, datafile.py:502-503).
MOCK_ROWS_TO_DROP = 7


class Data:
    """Base class for recognized data-file types.  Subclasses declare a
    filename regex; autogen_dataobj picks the matching subclass."""

    filename_re = re.compile(r"$x^")  # matches nothing

    def __init__(self, fns: list[str]):
        self.fns = [os.path.abspath(fn) for fn in fns]

    @classmethod
    def fnmatch(cls, fn: str):
        return cls.filename_re.match(os.path.basename(fn))

    @classmethod
    def are_grouped(cls, fn1: str, fn2: str) -> bool:
        return False

    @classmethod
    def group_is_complete(cls, fns: list[str]) -> bool:
        return len(fns) == 1

    posn_corrected = False

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _REGISTRY.append(cls)


_REGISTRY: list[type[Data]] = []


class PsrfitsData(Data):
    """Any search-mode PSRFITS observation.  Reads header metadata into
    the flat attribute set the job/upload layers consume (reference:
    lib/python/datafile.py:268-309)."""

    def __init__(self, fns: list[str]):
        super().__init__(fns)
        self.specinfo = SpectraInfo(self.fns)
        si = self.specinfo
        self.original_file = os.path.basename(sorted(si.filenames)[0])
        self.project_id = si.project_id
        self.observers = si.observer
        self.source_name = si.source
        self.center_freq = si.fctr
        self.num_channels_per_record = si.num_channels
        self.channel_bandwidth = si.df * 1000.0     # kHz
        self.sample_time = si.dt * 1e6              # microseconds
        self.sum_id = int(si.summed_polns)
        self.timestamp_mjd = float(si.start_MJD[0])
        self.start_lst = si.start_lst
        self.orig_start_az = si.azimuth
        self.orig_start_za = si.zenith_ang
        self.orig_ra_deg = si.ra2000
        self.orig_dec_deg = si.dec2000
        self.right_ascension = self.orig_right_ascension = _compact_hms(si.ra2000)
        self.declination = self.orig_declination = _compact_dms(si.dec2000)
        l, b = coords.equatorial_to_galactic(si.ra2000, si.dec2000)
        self.galactic_longitude = self.orig_galactic_longitude = float(l)
        self.galactic_latitude = self.orig_galactic_latitude = float(b)
        self.file_size = int(sum(os.path.getsize(fn) for fn in self.fns))
        self.observation_time = si.T
        self.num_samples = si.N
        self.data_size = si.N * si.bits_per_sample / 8.0 * si.num_channels
        self.num_samples_per_record = si.spectra_per_subint
        self.beam_id = si.beam_id
        # AST start second-of-day; Puerto Rico is UTC-4 year-round
        # (reference: datafile.py:326-329).
        dayfrac = self.timestamp_mjd % 1
        self.start_ast = int((dayfrac * 24 - 4) * 3600) % int(SECPERDAY)

    @property
    def obs_name(self) -> str:
        return ".".join([self.project_id, self.source_name,
                         str(int(self.timestamp_mjd)), str(self.scan_num)])


def _compact_hms(ra_deg: float) -> float:
    from tpulsar_torch.astro.angles import deg_to_compact
    return deg_to_compact(ra_deg, hours=True)


def _compact_dms(dec_deg: float) -> float:
    from tpulsar_torch.astro.angles import deg_to_compact
    return deg_to_compact(dec_deg, hours=False)


class MockPsrfitsData(PsrfitsData):
    """Raw PALFA Mock-spectrometer subband file (s0 or s1).  Filename
    convention from the reference (lib/python/datafile.py:398-400)."""

    filename_re = re.compile(
        r"^4bit-(?P<projid>[Pp]\d{4})\.(?P<date>\d{8})\."
        r"(?P<source>.*)\.b(?P<beam>[0-7])"
        r"s(?P<subband>[01])g0\.(?P<scan>\d{5})\.fits$")

    def __init__(self, fns):
        super().__init__(fns)
        self.obstype = "Mock"
        m = self.fnmatch(self.fns[0])
        self.scan_num = m.group("scan")
        if self.beam_id is None:
            self.beam_id = int(m.group("beam"))

    @classmethod
    def are_grouped(cls, fn1: str, fn2: str) -> bool:
        """s0/s1 files of the same (projid, date, source, beam, scan)
        belong together."""
        m1, m2 = cls.fnmatch(fn1), cls.fnmatch(fn2)
        if not (m1 and m2):
            return False
        keys = ("projid", "date", "source", "beam", "scan")
        return (all(m1.group(k) == m2.group(k) for k in keys)
                and m1.group("subband") != m2.group("subband"))

    @classmethod
    def group_is_complete(cls, fns: list[str]) -> bool:
        """A complete Mock group is exactly one s0 + one s1."""
        if len(fns) != 2:
            return False
        subbands = sorted(cls.fnmatch(fn).group("subband") for fn in fns)
        return subbands == ["0", "1"]

    def preprocess(self) -> list[str]:
        """Merge the s0/s1 pair into a single merged-band PSRFITS file
        (native combine_mocks replacement) and drop the first
        MOCK_ROWS_TO_DROP subint rows."""
        merged = combine_mock_subbands(self.fns)
        return [merged]


class MergedMockPsrfitsData(PsrfitsData):
    """Merged Mock observation (post-combine)."""

    filename_re = re.compile(
        r"^(?P<projid>[Pp]\d{4})\.(?P<date>\d{8})\."
        r"(?P<source>.*)\.b(?P<beam>[0-7])"
        r"\.(?P<scan>\d{5})\.fits$")

    def __init__(self, fns):
        super().__init__(fns)
        self.obstype = "Mock"
        m = self.fnmatch(self.fns[0])
        self.scan_num = m.group("scan")
        if self.beam_id is None:
            self.beam_id = int(m.group("beam"))


class WappPsrfitsData(PsrfitsData):
    """WAPP 4-bit PSRFITS (reference: lib/python/datafile.py:312-317).

    Early WAPP headers carry wrong sky positions; the reference fixes
    them from a survey coordinate table before searching
    (`get_correct_positions`/`update_positions`,
    lib/python/datafile.py:153-197,339-393).  The table here is plain
    whitespace columns: ``mjd scan beam ra_str dec_str``.
    """

    filename_re = re.compile(
        r"^(?P<projid>[Pp]\d{4})_(?P<mjd>\d{5})_"
        r"(?P<sec>\d{5})_(?P<scan>\d{4})_"
        r"(?P<source>.*)_(?P<beam>\d)\.w4bit\.fits$")

    def __init__(self, fns):
        super().__init__(fns)
        self.obstype = "WAPP"
        m = self.fnmatch(self.fns[0])
        self.scan_num = m.group("scan")
        self.mjd_str = m.group("mjd")
        if self.beam_id is None:
            self.beam_id = int(m.group("beam"))

    def get_correct_positions(self, coords_table: str
                              ) -> tuple[str, str] | None:
        """(ra_str, dec_str) from the survey coordinate table, or None
        when this observation has no entry."""
        key = (int(self.mjd_str), int(self.scan_num), int(self.beam_id))
        return load_coords_table(coords_table).get(key)

    def update_positions(self, coords_table: str) -> bool:
        """Patch RA/DEC in every file's primary header in place and
        refresh the in-memory header.  True if a correction applied."""
        pos = self.get_correct_positions(coords_table)
        if pos is None:
            return False
        ra_str, dec_str = pos
        # pre-validate every file so a multi-file group is never left
        # half-patched by a predictable failure
        for fn in self.fns:
            hdr = fitscore.read_fits(fn)[0].header
            missing = [k for k in ("RA", "DEC") if k not in hdr]
            if missing:
                raise DatafileError(
                    f"cannot correct position: {fn} primary header "
                    f"lacks {missing}")
        for fn in self.fns:
            n = fitscore.rewrite_cards(fn, {"RA": ra_str,
                                            "DEC": dec_str})
            if n != 2:
                raise DatafileError(
                    f"position correction failed for {fn}: "
                    f"{n}/2 header cards rewritten")
        self.specinfo = si = SpectraInfo(self.fns)   # re-read headers
        self.orig_ra_deg = si.ra2000
        self.orig_dec_deg = si.dec2000
        self.right_ascension = _compact_hms(si.ra2000)
        self.declination = _compact_dms(si.dec2000)
        l, b = coords.equatorial_to_galactic(si.ra2000, si.dec2000)
        self.galactic_longitude = float(l)
        self.galactic_latitude = float(b)
        return True

    def preprocess(self, coords_table: str | None = None) -> list[str]:
        """Apply the coordinate correction when a survey table is given
        (reference wires this into the search set-up).  The caller
        passes the table path; this package keeps no settings layer."""
        table = coords_table
        if table and os.path.exists(table):
            self.update_positions(table)
        return list(self.fns)


def load_coords_table(path: str) -> dict:
    """Parse a survey coordinate table: ``mjd scan beam ra dec`` per
    line ('#' comments allowed) -> {(mjd, scan, beam): (ra, dec)}."""
    table = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 5:
                continue
            try:
                key = (int(parts[0]), int(parts[1]), int(parts[2]))
            except ValueError:
                continue
            table[key] = (parts[3], parts[4])
    return table


def get_datafile_type(fns: list[str]) -> type[Data]:
    """Find the single Data subclass matching all file names."""
    matches = [cls for cls in _REGISTRY
               if all(cls.fnmatch(fn) is not None for fn in fns)]
    # Prefer the most specific (raw Mock over merged: merged regex can't
    # match raw names because of the '4bit-' prefix, so ties don't occur
    # in practice; guard anyway).
    if not matches:
        raise DatafileError(
            f"no known data-file type matches {[os.path.basename(f) for f in fns]}")
    if len(matches) > 1:
        raise DatafileError(
            f"ambiguous data-file type for {fns}: {[c.__name__ for c in matches]}")
    return matches[0]


def autogen_dataobj(fns: list[str]) -> Data:
    return get_datafile_type(fns)(fns)


def are_grouped(fn1: str, fn2: str) -> bool:
    try:
        cls = get_datafile_type([fn1, fn2])
    except DatafileError:
        return False
    return cls.are_grouped(fn1, fn2)


def group_files(fns: list[str]) -> list[list[str]]:
    """Partition file names into observation groups."""
    remaining = list(fns)
    groups: list[list[str]] = []
    while remaining:
        seed = remaining.pop(0)
        group = [seed]
        others = []
        for fn in remaining:
            if are_grouped(seed, fn):
                group.append(fn)
            else:
                others.append(fn)
        remaining = others
        groups.append(sorted(group))
    return groups


def is_complete(fns: list[str]) -> bool:
    try:
        cls = get_datafile_type(fns)
    except DatafileError:
        return False
    return cls.group_is_complete(fns)


def preprocess(fns: list[str]) -> list[str]:
    """Run the type's preprocessing (e.g. Mock merge).  Returns the
    file list to actually search."""
    obj = autogen_dataobj(fns)
    if hasattr(obj, "preprocess"):
        return obj.preprocess()
    return list(obj.fns)


# ---------------------------------------------------------------- merging

def combine_mock_subbands(fns: list[str], outdir: str | None = None) -> str:
    """Merge a Mock s0/s1 PSRFITS pair into one file spanning the full
    band — the native replacement for psrfits_utils' combine_mocks.

    The two subbands overlap by a few channels; overlap channels are
    taken from the lower subband.  The first MOCK_ROWS_TO_DROP merged
    subint rows are dropped (reference drops them via fitsdelrow,
    datafile.py:502-503).  Data is re-digitized at the input bit width.
    """
    if len(fns) != 2:
        raise DatafileError("combine_mock_subbands needs exactly 2 files")
    gd_m = MockPsrfitsData.fnmatch(fns[0])
    if gd_m is None or MockPsrfitsData.fnmatch(fns[1]) is None:
        raise DatafileError("not Mock subband files")
    gd = gd_m.groupdict()

    # Order the pair by measured band position, low half first.
    infos = sorted((SpectraInfo([fn]) for fn in fns),
                   key=lambda si: si.lo_freq)
    lo_si, hi_si = infos

    lo = lo_si.read_all()
    hi = hi_si.read_all()
    n = min(len(lo), len(hi))
    lo, hi = lo[:n], hi[:n]

    df = abs(lo_si.df)
    # Number of hi channels that duplicate the top of the lo band.
    overlap = int(round((lo_si.hi_freq - hi_si.lo_freq) / df)) + 1
    overlap = max(0, overlap)
    merged = np.concatenate([lo, hi[:, overlap:]], axis=1)

    drop = MOCK_ROWS_TO_DROP * lo_si.spectra_per_subint
    merged = merged[drop:]
    nsblk = lo_si.spectra_per_subint
    nsamp = (len(merged) // nsblk) * nsblk
    merged = merged[:nsamp]

    from tpulsar_torch.io.synth import BeamSpec, write_psrfits
    nchan = merged.shape[1]
    lo_f = lo_si.lo_freq
    fctr = lo_f + (nchan - 1) * df / 2.0
    spec = BeamSpec(
        nchan=nchan, nsamp=nsamp, tsamp_s=lo_si.dt,
        fctr_mhz=fctr, bw_mhz=nchan * df, nbits=lo_si.bits_per_sample,
        npol=1, nsblk=nsblk, source=lo_si.source,
        ra_str=lo_si.ra_str, dec_str=lo_si.dec_str,
        projid=lo_si.project_id,
        beam_id=lo_si.beam_id if lo_si.beam_id is not None else int(gd["beam"]),
        scan=int(gd["scan"]),
        mjd=float(lo_si.start_MJD[0]) + drop * lo_si.dt / 86400.0,
        backend=lo_si.backend)

    outdir = outdir or os.path.dirname(fns[0])
    y, mo, d = times.mjd_to_date(float(lo_si.start_MJD[0]))
    date = f"{y:04d}{mo:02d}{int(d):02d}"
    outname = (f"{lo_si.project_id}.{date}.{lo_si.source}."
               f"b{spec.beam_id}.{int(gd['scan']):05d}.fits")
    outpath = os.path.join(outdir, outname)
    write_psrfits(outpath, spec, merged)
    return outpath
