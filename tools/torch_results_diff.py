#!/usr/bin/env python3
"""Compare two beam results directories written by tpulsar_torch (or
the JAX package) for equality of everything but wall-clock times.

    python3 tools/torch_results_diff.py DIR_A DIR_B

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

Every other file is compared byte for byte.  Prints one line per
difference and exits 1 if there is any.  Imports numpy only.
"""

from __future__ import annotations

import io
import os
import sys
import tarfile

import numpy as np

#: names whose content is wall-clock timing, compared for presence only
TIMED_SUFFIXES = (".report", "metrics.json", "_trace.json")


def _npz_diff(a: bytes, b: bytes, what: str) -> list[str]:
    with np.load(io.BytesIO(a), allow_pickle=False) as za, \
            np.load(io.BytesIO(b), allow_pickle=False) as zb:
        if sorted(za.files) != sorted(zb.files):
            return [f"{what}: arrays {sorted(za.files)} != "
                    f"{sorted(zb.files)}"]
        out = []
        for k in za.files:
            x, y = za[k], zb[k]
            if x.dtype != y.dtype or x.shape != y.shape \
                    or not np.array_equal(x, y):
                out.append(f"{what}: array {k!r} differs")
        return out


def _content_diff(name: str, a: bytes, b: bytes, what: str) -> list[str]:
    if name.endswith(TIMED_SUFFIXES):
        return []
    if name.endswith(".npz"):
        return _npz_diff(a, b, what)
    if name.endswith(".tgz"):
        return _tar_diff(a, b, what)
    return [] if a == b else [f"{what}: bytes differ"]


def _tar_diff(a: bytes, b: bytes, what: str) -> list[str]:
    with tarfile.open(fileobj=io.BytesIO(a)) as ta, \
            tarfile.open(fileobj=io.BytesIO(b)) as tb:
        na, nb = ta.getnames(), tb.getnames()
        if na != nb:
            return [f"{what}: members {na} != {nb}"]
        out = []
        for m in na:
            out += _content_diff(m, ta.extractfile(m).read(),
                                 tb.extractfile(m).read(),
                                 f"{what}:{m}")
        return out


def diff_results(dir_a: str, dir_b: str) -> list[str]:
    """The differences between two results directories (empty when
    they hold the same results)."""
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
        out += _content_diff(name, a, b, name)
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    problems = diff_results(*args)
    for p in problems:
        print(p)
    if not problems:
        print(f"same results: {args[0]} and {args[1]}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
