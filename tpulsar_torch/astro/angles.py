"""Angle parsing/formatting (reference: lib/python/astro_utils/protractor.py).

Conversions between sexagesimal strings ("hh:mm:ss.sss" /
"+dd:mm:ss.ss"), decimal degrees, hours, and radians.
"""

from __future__ import annotations

import math
import re

import numpy as np

_SEX_RE = re.compile(
    r"^\s*(?P<sign>[-+]?)(?P<a>\d+)[: ](?P<b>\d+)[: ](?P<c>\d+(?:\.\d*)?)\s*$")


def parse_sexagesimal(s: str) -> float:
    """'hh:mm:ss.s' or 'dd:mm:ss.s' -> signed decimal value in the
    leading unit (hours or degrees)."""
    m = _SEX_RE.match(str(s))
    if not m:
        # Accept a plain number too.
        return float(s)
    val = float(m.group("a")) + float(m.group("b")) / 60.0 + float(m.group("c")) / 3600.0
    return -val if m.group("sign") == "-" else val


def hms_str_to_deg(s: str) -> float:
    """'hh:mm:ss.ss' -> degrees (RA)."""
    return parse_sexagesimal(s) * 15.0


def dms_str_to_deg(s: str) -> float:
    """'+dd:mm:ss.ss' -> degrees (Dec)."""
    return parse_sexagesimal(s)


def deg_to_hms_str(deg: float, ndec: int = 4) -> str:
    hours = (deg / 15.0) % 24.0
    h = int(hours)
    m = int((hours - h) * 60)
    s = (hours - h - m / 60.0) * 3600.0
    if round(s, ndec) >= 60.0:
        s = 0.0
        m += 1
        if m == 60:
            m = 0
            h = (h + 1) % 24
    return f"{h:02d}:{m:02d}:{s:0{3 + ndec}.{ndec}f}"


def deg_to_dms_str(deg: float, ndec: int = 3) -> str:
    sign = "-" if deg < 0 else "+"
    a = abs(deg)
    d = int(a)
    m = int((a - d) * 60)
    s = (a - d - m / 60.0) * 3600.0
    if round(s, ndec) >= 60.0:
        s = 0.0
        m += 1
        if m == 60:
            m = 0
            d += 1
    return f"{sign}{d:02d}:{m:02d}:{s:0{3 + ndec}.{ndec}f}"


def hms_to_float(hms_compact: float) -> float:
    """Compact hhmmss.ss encoding -> decimal hours (the reference
    stores RA as e.g. 123456.78 meaning 12h34m56.78s)."""
    a = abs(hms_compact)
    h = int(a // 10000)
    m = int((a % 10000) // 100)
    s = a % 100
    val = h + m / 60.0 + s / 3600.0
    return math.copysign(val, hms_compact)


def deg_to_compact(deg: float, hours: bool = False) -> float:
    """Degrees -> compact (h)hmmss.ss float encoding used in upload
    records (reference: lib/python/datafile.py:297-300)."""
    v = deg / 15.0 if hours else deg
    sign = math.copysign(1.0, v)
    a = abs(v)
    d = int(a)
    m = int((a - d) * 60)
    s = (a - d - m / 60.0) * 3600.0
    return sign * (d * 10000 + m * 100 + s)


def normalize_deg(deg: float) -> float:
    return deg % 360.0


def deg_to_rad(x):
    return np.deg2rad(x)


def rad_to_deg(x):
    return np.rad2deg(x)
