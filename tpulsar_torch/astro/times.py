"""Time conversions (reference: lib/python/astro_utils/calendar.py, clock.py).

MJD <-> Julian date <-> Gregorian calendar, and local mean sidereal time.
Algorithms are the standard Fliegel-Van Flandern / Meeus forms.
"""

from __future__ import annotations

import math

from tpulsar_torch.constants import SECPERDAY

MJD_EPOCH_JD = 2400000.5


def mjd_to_jd(mjd: float) -> float:
    return mjd + MJD_EPOCH_JD


def jd_to_mjd(jd: float) -> float:
    return jd - MJD_EPOCH_JD


def date_to_jd(year: int, month: int, day: float) -> float:
    """Gregorian calendar date -> Julian date (Meeus ch.7)."""
    if month <= 2:
        year -= 1
        month += 12
    a = year // 100
    b = 2 - a + a // 4
    return (math.floor(365.25 * (year + 4716))
            + math.floor(30.6001 * (month + 1)) + day + b - 1524.5)


def jd_to_date(jd: float) -> tuple[int, int, float]:
    """Julian date -> (year, month, fractional day)."""
    jd = jd + 0.5
    z = math.floor(jd)
    f = jd - z
    if z < 2299161:
        a = z
    else:
        alpha = math.floor((z - 1867216.25) / 36524.25)
        a = z + 1 + alpha - math.floor(alpha / 4)
    b = a + 1524
    c = math.floor((b - 122.1) / 365.25)
    d = math.floor(365.25 * c)
    e = math.floor((b - d) / 30.6001)
    day = b - d - math.floor(30.6001 * e) + f
    month = int(e - 1 if e < 14 else e - 13)
    year = int(c - 4716 if month > 2 else c - 4715)
    return year, month, day


def mjd_to_date(mjd: float) -> tuple[int, int, float]:
    return jd_to_date(mjd_to_jd(mjd))


def date_to_mjd(year: int, month: int, day: float) -> float:
    return jd_to_mjd(date_to_jd(year, month, day))


def mjd_to_datestr(mjd: float) -> str:
    """MJD -> 'YYYY-MM-DDThh:mm:ss' (DATE-OBS format)."""
    year, month, day = mjd_to_date(mjd)
    d = int(day)
    frac = day - d
    secs = frac * SECPERDAY
    hh = int(secs // 3600)
    mm = int((secs % 3600) // 60)
    ss = secs % 60
    return f"{year:04d}-{month:02d}-{d:02d}T{hh:02d}:{mm:02d}:{ss:06.3f}"


def datestr_to_mjd(s: str) -> float:
    """'YYYY-MM-DDThh:mm:ss(.s)' -> MJD (reference psrfits.py:395-407)."""
    datepart, _, timepart = s.partition("T")
    y, mo, d = (int(x) for x in datepart.split("-"))
    frac = 0.0
    if timepart:
        hh, mm, ss = timepart.split(":")
        frac = (int(hh) * 3600 + int(mm) * 60 + float(ss)) / SECPERDAY
    return date_to_mjd(y, mo, d + frac)


def gmst_deg(mjd_ut: float) -> float:
    """Greenwich mean sidereal time in degrees (IAU 1982)."""
    t = (mjd_to_jd(mjd_ut) - 2451545.0) / 36525.0
    gmst = (280.46061837 + 360.98564736629 * (mjd_to_jd(mjd_ut) - 2451545.0)
            + 0.000387933 * t * t - t * t * t / 38710000.0)
    return gmst % 360.0


def lmst_seconds(mjd_ut: float, longitude_deg_east: float) -> float:
    """Local mean sidereal time in seconds-of-sidereal-day [0, 86400)."""
    lst_deg = (gmst_deg(mjd_ut) + longitude_deg_east) % 360.0
    return lst_deg / 360.0 * SECPERDAY
