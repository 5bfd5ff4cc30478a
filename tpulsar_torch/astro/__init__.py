"""Astronomical utilities: angles, times, coordinates.

TPU-era replacement for the reference's lib/python/astro_utils package
(protractor/calendar/clock/sextant) with the same capabilities: angle
format conversion, MJD/calendar conversion, sidereal time, and
equatorial<->galactic coordinate transforms.
"""

from tpulsar_torch.astro import angles, coords, times  # noqa: F401
