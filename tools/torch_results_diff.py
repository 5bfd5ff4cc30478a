#!/usr/bin/env python3
"""Compare two beam results directories written by tpulsar_torch (or
the JAX package) for equality of everything but wall-clock times.

    python3 tools/torch_results_diff.py [--rtol R] DIR_A DIR_B

A resumed search must write the results an uninterrupted search
writes.  Some files carry the time they were written or the time the
search took, so they cannot be compared byte for byte:

  * <base>.report, metrics.json and <base>_trace.json hold stage
    timings: only their presence is compared;
  * .npz files are zip archives whose member headers hold the write
    time: their arrays are compared (names, dtypes, shapes, values);
  * .tgz tarballs hold member mtimes and a gzip header time: their
    member names (in order) and member contents are compared, by the
    same rules.

Every other file is compared byte for byte.  By default values must be
equal.  With --rtol (for two packages' results, whose float32 sums
round in another order), a floating-point .npz array may differ by at
most rtol * max|b| over the array, and a decimal number in a text file
by at most rtol * |b| plus one unit of its last printed digit (a value
within tolerance can round either way); a .bestprof's profile block
(the "bin value" lines after its "#" header) is held like an array, at
rtol * max|b| over the profile plus one unit of the last printed
digit, because a mean-subtracted profile crosses zero and its small
bins carry no more precision than the float32 sum of the whole;
its header lines keep the per-token rule;
integers, names and every other token must still be equal.  Prints one
line per difference and exits 1 if there is any.  Imports numpy only.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import tarfile

import numpy as np

#: names whose content is wall-clock timing, compared for presence only
TIMED_SUFFIXES = (".report", "metrics.json", "_trace.json")


def _values_equal(x: np.ndarray, y: np.ndarray, rtol: float) -> bool:
    """Equal arrays of one dtype and shape: exactly, or for floating
    point values (field by field in a record array) within rtol of
    the array's largest magnitude."""
    if x.dtype.names:
        return all(_values_equal(x[f], y[f], rtol) for f in x.dtype.names)
    if rtol and np.issubdtype(x.dtype, np.floating) and x.size:
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            return False
        ok = ~np.isnan(y)
        scale = float(np.abs(y[ok]).max(initial=0.0))
        return bool(np.abs(x[ok] - y[ok]).max(initial=0.0)
                    <= rtol * scale)
    return bool(np.array_equal(x, y))


def _npz_diff(a: bytes, b: bytes, what: str, rtol: float) -> list[str]:
    with np.load(io.BytesIO(a), allow_pickle=False) as za, \
            np.load(io.BytesIO(b), allow_pickle=False) as zb:
        if sorted(za.files) != sorted(zb.files):
            return [f"{what}: arrays {sorted(za.files)} != "
                    f"{sorted(zb.files)}"]
        out = []
        for k in za.files:
            x, y = za[k], zb[k]
            if x.dtype != y.dtype or x.shape != y.shape \
                    or not _values_equal(x, y, rtol):
                out.append(f"{what}: array {k!r} differs")
        return out


def _decimal(token: str):
    """(value, one unit of the last printed digit) of a decimal number
    like 17.31, or None for anything else (integers included)."""
    if "." not in token or "e" in token.lower():
        return None
    try:
        return float(token), 10.0 ** -len(token.split(".")[1])
    except ValueError:
        return None


def _number(token: str):
    """(value, one unit of the last printed digit) of a finite number
    printed like 17.31, -1.746887, 3.2e-05 or 12, or None."""
    mant, _, exp = token.lower().partition("e")
    try:
        value, power = float(token), int(exp or 0)
    except ValueError:
        return None
    if not np.isfinite(value):
        return None
    digits = len(mant.split(".")[1]) if "." in mant else 0
    return value, 10.0 ** (power - digits)


def _lines_equal(la: list[str], lb: list[str], rtol: float) -> bool:
    """Lines equal token by token: decimals within rtol, the rest
    exactly."""
    if len(la) != len(lb):
        return False
    for ra, rb in zip(la, lb):
        ta, tb = ra.split(), rb.split()
        if len(ta) != len(tb):
            return False
        for x, y in zip(ta, tb):
            if x == y:
                continue
            dx, dy = _decimal(x), _decimal(y)
            if dx is None or dy is None or \
                    abs(dx[0] - dy[0]) > (rtol * abs(dy[0])
                                          + max(dx[1], dy[1])):
                return False
    return True


def _decoded_lines(a: bytes, b: bytes):
    try:
        return a.decode().splitlines(), b.decode().splitlines()
    except UnicodeDecodeError:
        return None


def _text_equal(a: bytes, b: bytes, rtol: float) -> bool:
    """Text equal token by token: decimals within rtol, the rest
    exactly."""
    lines = _decoded_lines(a, b)
    return lines is not None and _lines_equal(*lines, rtol)


def _split_header(lines: list[str]):
    n = next((i for i, ln in enumerate(lines) if not ln.startswith("#")),
             len(lines))
    return lines[:n], lines[n:]


def _bestprof_equal(a: bytes, b: bytes, rtol: float) -> bool:
    """A .bestprof: its "#" header lines by _text_equal's rule, its
    profile block ("bin value" lines) bin for bin, each bin within
    rtol * max|b| over the profile plus one unit of the last printed
    digit (_values_equal's rule for an array)."""
    lines = _decoded_lines(a, b)
    if lines is None:
        return False
    (ha, pa), (hb, pb) = map(_split_header, lines)
    if len(pa) != len(pb) or not _lines_equal(ha, hb, rtol):
        return False
    bins = []
    for ra, rb in zip(pa, pb):
        ta, tb = ra.split(), rb.split()
        if len(ta) != 2 or len(tb) != 2 or ta[0] != tb[0]:
            return False
        x, y = _number(ta[1]), _number(tb[1])
        if x is None or y is None:
            if ta[1] != tb[1]:
                return False
            continue
        bins.append((x, y))
    scale = max((abs(y[0]) for _x, y in bins), default=0.0)
    return all(abs(x[0] - y[0]) <= rtol * scale + max(x[1], y[1])
               for x, y in bins)


def _content_diff(name: str, a: bytes, b: bytes, what: str,
                  rtol: float = 0.0) -> list[str]:
    if name.endswith(TIMED_SUFFIXES):
        return []
    if name.endswith(".npz"):
        return _npz_diff(a, b, what, rtol)
    if name.endswith(".tgz"):
        return _tar_diff(a, b, what, rtol)
    same = _bestprof_equal if name.endswith(".bestprof") else _text_equal
    if a == b or (rtol and same(a, b, rtol)):
        return []
    return [f"{what}: bytes differ"]


def _tar_diff(a: bytes, b: bytes, what: str, rtol: float) -> list[str]:
    with tarfile.open(fileobj=io.BytesIO(a)) as ta, \
            tarfile.open(fileobj=io.BytesIO(b)) as tb:
        na, nb = ta.getnames(), tb.getnames()
        if na != nb:
            return [f"{what}: members {na} != {nb}"]
        out = []
        for m in na:
            out += _content_diff(m, ta.extractfile(m).read(),
                                 tb.extractfile(m).read(),
                                 f"{what}:{m}", rtol)
        return out


def diff_results(dir_a: str, dir_b: str, rtol: float = 0.0
                 ) -> list[str]:
    """The differences between two results directories (empty when
    they hold the same results; values exactly equal unless rtol is
    set)."""
    fa, fb = sorted(os.listdir(dir_a)), sorted(os.listdir(dir_b))
    if fa != fb:
        return [f"file sets differ: only in {dir_a}: "
                f"{sorted(set(fa) - set(fb))}; only in {dir_b}: "
                f"{sorted(set(fb) - set(fa))}"]
    out = []
    for name in fa:
        with open(os.path.join(dir_a, name), "rb") as fh:
            a = fh.read()
        with open(os.path.join(dir_b, name), "rb") as fh:
            b = fh.read()
        out += _content_diff(name, a, b, name, rtol)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Compare two beam results directories.")
    p.add_argument("dir_a")
    p.add_argument("dir_b")
    p.add_argument("--rtol", type=float, default=0.0,
                   help="relative tolerance of floating-point values")
    args = p.parse_args(argv)
    problems = diff_results(args.dir_a, args.dir_b, args.rtol)
    for line in problems:
        print(line)
    if not problems:
        print(f"same results: {args.dir_a} and {args.dir_b}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
