"""Barycentric velocity of an observatory toward a sky position.

The reference obtains the average barycentric velocity of the
observation by calling TEMPO through PRESTO
(lib/python/PALFA2_presto_search.py:43-57, used at :269) and feeds it
to zapbirds (-baryv, :551-553) and, implicitly, to every barycentric
candidate frequency.  We replace the TEMPO/DE200 machinery with an
analytic low-precision ephemeris:

  * Earth's heliocentric orbital velocity from two-body motion with
    the solar equation of center (Meeus, Astronomical Algorithms
    ch. 25 element polynomials) — exact elliptical velocity
    v = (2*pi*a / (P*sqrt(1-e^2))) * (-sin(l) - e*sin(w),
                                       cos(l) + e*cos(w))
    in ecliptic coordinates, with l the true longitude and w the
    longitude of perihelion;
  * the observatory's diurnal rotation velocity from the WGS84
    ellipsoid and local sidereal time.

Omitted terms (documented error budget): the Sun's motion about the
solar-system barycenter (~12 m/s, 4e-8 in v/c), the Earth-Moon
barycenter wobble (~12 m/s), planetary perturbations of Earth's
velocity (a few m/s), and the TDB-UTC offset (~69 s of orbital phase,
<1 m/s).  Total error is a few tens of m/s, i.e. ~1e-7 in v/c against
the ~1e-4 signal — an order of magnitude inside the 1e-6 target.

Sign convention matches PRESTO/TEMPO: positive v/c means the
observatory is RECEDING from the source, so an emitted (barycentric)
frequency f_bary relates to the observed (topocentric) one as
f_bary = f_topo * (1 + voverc).
"""

from __future__ import annotations

import math

import numpy as np

from tpulsar_torch.astro.times import gmst_deg, mjd_to_jd

C_KM_S = 299792.458
AU_KM = 1.495978707e8
SIDEREAL_YEAR_S = 365.25636 * 86400.0
EARTH_OMEGA = 7.292115e-5          # rad/s
WGS84_A_KM = 6378.137
WGS84_F = 1.0 / 298.257223563

# Geodetic (lat_deg, east_lon_deg, elev_m).  Keys follow the
# reference's TEMPO-style observatory codes ("AO" for Arecibo,
# PALFA2_presto_search.py:269) plus the telescope names our PSRFITS
# reader normalizes to (io/psrfits.py:93-96).
OBSERVATORIES: dict[str, tuple[float, float, float]] = {
    "AO": (18.34417, -66.75278, 497.0),
    "Arecibo": (18.34417, -66.75278, 497.0),
    "GB": (38.43313, -79.83983, 807.0),
    "GBT": (38.43313, -79.83983, 807.0),
    "PK": (-32.99840, 148.26352, 415.0),
    "Parkes": (-32.99840, 148.26352, 415.0),
    "JB": (53.23667, -2.30750, 86.0),
    "Jodrell": (53.23667, -2.30750, 86.0),
    "EF": (50.52483, 6.88361, 369.0),
    "Effelsberg": (50.52483, 6.88361, 369.0),
}


def earth_orbital_velocity_kms(mjd: float) -> np.ndarray:
    """Earth's heliocentric velocity in equatorial J2000-ish (mean
    equinox of date) cartesian coordinates, km/s."""
    t = (mjd_to_jd(mjd) - 2451545.0) / 36525.0
    # Meeus ch. 25 element polynomials (degrees).
    L = 280.46646 + 36000.76983 * t + 0.0003032 * t * t
    g = 357.52911 + 35999.05029 * t - 0.0001537 * t * t
    e = 0.016708634 - 0.000042037 * t - 0.0000001267 * t * t
    gr = math.radians(g)
    center = ((1.914602 - 0.004817 * t - 0.000014 * t * t) * math.sin(gr)
              + (0.019993 - 0.000101 * t) * math.sin(2 * gr)
              + 0.000289 * math.sin(3 * gr))
    lam_sun = L + center                 # Sun's true longitude
    lam_earth = math.radians(lam_sun + 180.0)
    # Longitude of perihelion: of the Sun's apparent orbit it is
    # L - g; Earth's is that + 180 deg.
    peri_earth = math.radians(L - g + 180.0)

    k = 2.0 * math.pi * AU_KM / (SIDEREAL_YEAR_S * math.sqrt(1 - e * e))
    vx = -k * (math.sin(lam_earth) + e * math.sin(peri_earth))
    vy = k * (math.cos(lam_earth) + e * math.cos(peri_earth))
    # Ecliptic -> equatorial (mean obliquity of date).
    eps = math.radians(23.43929111 - 0.0130041667 * t)
    return np.array([vx, vy * math.cos(eps), vy * math.sin(eps)])


def site_rotation_velocity_kms(mjd_ut: float, lat_deg: float,
                               east_lon_deg: float,
                               elev_m: float = 0.0) -> np.ndarray:
    """Diurnal rotation velocity of a site, equatorial cartesian km/s."""
    lat = math.radians(lat_deg)
    sin2 = math.sin(lat) ** 2
    # Distance from the rotation axis on the WGS84 ellipsoid.
    n = WGS84_A_KM / math.sqrt(1 - (2 * WGS84_F - WGS84_F ** 2) * sin2)
    axis_dist = (n + elev_m / 1000.0) * math.cos(lat)
    speed = EARTH_OMEGA * axis_dist
    # Velocity points East; at local sidereal angle theta the East
    # unit vector in the equatorial frame is (-sin t, cos t, 0).
    theta = math.radians((gmst_deg(mjd_ut) + east_lon_deg) % 360.0)
    return speed * np.array([-math.sin(theta), math.cos(theta), 0.0])


def baryv_at(mjd: float, ra_deg: float, dec_deg: float,
             obs: str = "AO") -> float:
    """Instantaneous v/c of the observatory along the line of sight,
    positive receding (PRESTO sign convention)."""
    try:
        lat, lon, elev = OBSERVATORIES[obs]
    except KeyError:
        raise ValueError(f"unknown observatory {obs!r}; known: "
                         f"{sorted(OBSERVATORIES)}") from None
    v = (earth_orbital_velocity_kms(mjd)
         + site_rotation_velocity_kms(mjd, lat, lon, elev))
    ra = math.radians(ra_deg)
    dec = math.radians(dec_deg)
    n_hat = np.array([math.cos(dec) * math.cos(ra),
                      math.cos(dec) * math.sin(ra),
                      math.sin(dec)])
    return float(-np.dot(v, n_hat) / C_KM_S)


def average_baryv(ra_deg: float, dec_deg: float, mjd: float, T_s: float,
                  obs: str = "AO", nsamples: int = 100) -> float:
    """Average v/c over an observation of duration T_s starting at
    mjd — the quantity the reference computes with 100 TEMPO samples
    (PALFA2_presto_search.py:53-57)."""
    tts = np.linspace(mjd, mjd + T_s / 86400.0, nsamples)
    return float(np.mean([baryv_at(t, ra_deg, dec_deg, obs) for t in tts]))
