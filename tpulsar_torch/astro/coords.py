"""Coordinate transforms (reference: lib/python/astro_utils/sextant.py).

Equatorial (J2000) <-> Galactic via the IAU rotation matrix, plus
rigorous IAU-1976 precession between equinoxes.
"""

from __future__ import annotations

import numpy as np

# J2000 equatorial -> galactic rotation matrix (IAU definition:
# NGP at RA 192.85948, Dec 27.12825, position angle 122.93192).
_EQ2GAL = np.array([
    [-0.0548755604, -0.8734370902, -0.4838350155],
    [+0.4941094279, -0.4448296300, +0.7469822445],
    [-0.8676661490, -0.1980763734, +0.4559837762],
])


def _unit(ra_deg, dec_deg):
    ra = np.deg2rad(np.asarray(ra_deg, dtype=float))
    dec = np.deg2rad(np.asarray(dec_deg, dtype=float))
    return np.stack([np.cos(dec) * np.cos(ra),
                     np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=-1)


def _angles(vec):
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    lon = np.rad2deg(np.arctan2(y, x)) % 360.0
    lat = np.rad2deg(np.arcsin(np.clip(z, -1.0, 1.0)))
    return lon, lat


def equatorial_to_galactic(ra_deg, dec_deg):
    """J2000 RA/Dec (deg) -> galactic l, b (deg)."""
    return _angles(_unit(ra_deg, dec_deg) @ _EQ2GAL.T)


def galactic_to_equatorial(l_deg, b_deg):
    """Galactic l, b (deg) -> J2000 RA/Dec (deg)."""
    return _angles(_unit(l_deg, b_deg) @ _EQ2GAL)


def _precession_matrix(jd_from: float, jd_to: float) -> np.ndarray:
    """IAU 1976 precession matrix between two epochs (Meeus ch. 21)."""
    t0 = (jd_from - 2451545.0) / 36525.0
    t = (jd_to - jd_from) / 36525.0
    asec = np.deg2rad(1.0 / 3600.0)
    zeta = ((2306.2181 + 1.39656 * t0 - 0.000139 * t0**2) * t
            + (0.30188 - 0.000344 * t0) * t**2 + 0.017998 * t**3) * asec
    z = ((2306.2181 + 1.39656 * t0 - 0.000139 * t0**2) * t
         + (1.09468 + 0.000066 * t0) * t**2 + 0.018203 * t**3) * asec
    theta = ((2004.3109 - 0.85330 * t0 - 0.000217 * t0**2) * t
             - (0.42665 + 0.000217 * t0) * t**2 - 0.041833 * t**3) * asec

    cz, sz = np.cos(zeta), np.sin(zeta)
    cZ, sZ = np.cos(z), np.sin(z)
    ct, st = np.cos(theta), np.sin(theta)
    return np.array([
        [cz * ct * cZ - sz * sZ, -sz * ct * cZ - cz * sZ, -st * cZ],
        [cz * ct * sZ + sz * cZ, -sz * ct * sZ + cz * cZ, -st * sZ],
        [cz * st, -sz * st, ct],
    ])


def precess(ra_deg, dec_deg, jd_from: float, jd_to: float):
    """Precess equatorial coordinates from one epoch to another."""
    mat = _precession_matrix(jd_from, jd_to)
    return _angles(_unit(ra_deg, dec_deg) @ mat.T)


def angular_separation_deg(ra1, dec1, ra2, dec2):
    """Great-circle separation (deg) via the Vincenty formula."""
    l1, b1 = np.deg2rad(ra1), np.deg2rad(dec1)
    l2, b2 = np.deg2rad(ra2), np.deg2rad(dec2)
    dl = l2 - l1
    num = np.hypot(np.cos(b2) * np.sin(dl),
                   np.cos(b1) * np.sin(b2) - np.sin(b1) * np.cos(b2) * np.cos(dl))
    den = np.sin(b1) * np.sin(b2) + np.cos(b1) * np.cos(b2) * np.cos(dl)
    return np.rad2deg(np.arctan2(num, den))
