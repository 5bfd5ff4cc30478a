"""Minimal, self-contained FITS reader/writer.

tpulsar carries its own FITS layer rather than depending on pyfits
(which the reference uses, e.g. lib/python/formats/psrfits.py:13) or
astropy (not available in this environment).  Scope: primary HDUs and
BINTABLE extensions — everything PSRFITS needs.  Binary-table data is
exposed as a numpy memmap of a big-endian structured dtype, so opening
a multi-GB PSRFITS file costs only the header parse; column access is
lazy through the OS page cache.

FITS essentials implemented here:
  * 2880-byte header blocks of 80-char cards, ``END`` terminated
  * value types: logical T/F, integer, float, quoted string ('' escape)
  * BINTABLE: TFORMn codes L, X, B, I, J, K, A, E, D (with repeat
    counts), TDIMn reshaping, NAXIS1/NAXIS2 row geometry
  * data area padding to 2880-byte boundaries
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
import re
from typing import Any, Iterator

import numpy as np

BLOCK = 2880
CARDLEN = 80

# TFORM letter -> (numpy big-endian dtype, bytes per element)
_TFORM_DTYPES = {
    "L": (">i1", 1),   # logical, stored as 'T'/'F' bytes; exposed as int8
    "B": (">u1", 1),
    "I": (">i2", 2),
    "J": (">i4", 4),
    "K": (">i8", 8),
    "E": (">f4", 4),
    "D": (">f8", 8),
    "A": ("S", 1),     # character; repeat = string length
}

_TFORM_RE = re.compile(r"^(\d*)([LXBIJKAED])")


class FitsError(Exception):
    pass


class Header:
    """Ordered FITS header: keyword -> value with comments preserved.

    Duplicate keywords (COMMENT/HISTORY) are kept in order; ``get`` and
    ``[]`` return the first occurrence.
    """

    def __init__(self) -> None:
        self.cards: list[tuple[str, Any, str]] = []
        self._index: dict[str, int] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __getitem__(self, key: str) -> Any:
        try:
            return self.cards[self._index[key]][1]
        except KeyError:
            raise KeyError(f"no FITS card {key!r}")

    def get(self, key: str, default: Any = None) -> Any:
        return self.cards[self._index[key]][1] if key in self._index else default

    def __setitem__(self, key: str, value: Any) -> None:
        self.set(key, value)

    def set(self, key: str, value: Any, comment: str = "") -> None:
        key = key.upper()
        if key in self._index:
            i = self._index[key]
            old_comment = self.cards[i][2]
            self.cards[i] = (key, value, comment or old_comment)
        else:
            self._index[key] = len(self.cards)
            self.cards.append((key, value, comment))

    def keys(self) -> list[str]:
        return [c[0] for c in self.cards]

    def items(self) -> Iterator[tuple[str, Any]]:
        return ((c[0], c[1]) for c in self.cards)

    def __len__(self) -> int:
        return len(self.cards)

    def __repr__(self) -> str:
        return f"Header({len(self.cards)} cards)"


def _parse_value(raw: str) -> Any:
    s = raw.strip()
    if not s:
        return None
    if s.startswith("'"):
        # Quoted string; '' is an escaped quote.  Find the closing quote.
        out = []
        i = 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        return "".join(out).rstrip()
    if s == "T":
        return True
    if s == "F":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s.replace("D", "E").replace("d", "e"))
    except ValueError:
        return s


def _parse_card(card: bytes) -> tuple[str, Any, str] | None:
    text = card.decode("ascii", errors="replace")
    key = text[:8].strip()
    if key in ("", "COMMENT", "HISTORY"):
        return (key, text[8:].strip(), "") if key else None
    if text[8:10] != "= ":
        return (key, text[8:].strip(), "")
    body = text[10:]
    # Split off the comment: a '/' outside of quotes.
    in_quote = False
    comment = ""
    value_part = body
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "'":
            # Toggle unless it's an escaped '' inside a quote.
            if in_quote and i + 1 < len(body) and body[i + 1] == "'":
                i += 2
                continue
            in_quote = not in_quote
        elif ch == "/" and not in_quote:
            value_part = body[:i]
            comment = body[i + 1:].strip()
            break
        i += 1
    return key, _parse_value(value_part), comment


def _format_value(value: Any) -> str:
    if isinstance(value, bool):
        return ("T" if value else "F").rjust(20)
    if isinstance(value, (int, np.integer)):
        return str(int(value)).rjust(20)
    if isinstance(value, (float, np.floating)):
        v = float(value)
        s = repr(v)
        if "e" not in s and "." not in s and "inf" not in s and "nan" not in s:
            s += ".0"
        return s.rjust(20)
    if value is None:
        return ""
    s = str(value).replace("'", "''")
    return ("'" + s.ljust(8) + "'").ljust(20)


def _format_card(key: str, value: Any, comment: str) -> bytes:
    if key in ("COMMENT", "HISTORY", ""):
        text = f"{key:<8}{value}"
    else:
        text = f"{key:<8}= {_format_value(value)}"
        if len(text) > CARDLEN:
            # A value that doesn't fit in one card would round-trip
            # corrupted (dangling quote); fail loudly instead.
            raise FitsError(
                f"value for {key} too long for a FITS card: {value!r}")
        if comment:
            text += f" / {comment}"  # comments may be clipped silently
    return text[:CARDLEN].ljust(CARDLEN).encode("ascii", errors="replace")


def read_header(fh) -> tuple[Header, int]:
    """Read one header unit from the current file position.

    Returns (header, bytes_consumed).  The file is left positioned at
    the start of the data area.
    """
    hdr = Header()
    consumed = 0
    done = False
    while not done:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            if consumed == 0 and not block:
                raise EOFError("no more HDUs")
            raise FitsError("truncated FITS header")
        consumed += BLOCK
        for i in range(0, BLOCK, CARDLEN):
            card = block[i:i + CARDLEN]
            if card[:3] == b"END" and card[3:8].strip() == b"":
                done = True
                break
            parsed = _parse_card(card)
            if parsed is None:
                continue
            key, value, comment = parsed
            if key in ("COMMENT", "HISTORY"):
                hdr.cards.append((key, value, comment))
                hdr._index.setdefault(key, len(hdr.cards) - 1)
            elif key:
                hdr.set(key, value, comment)
    return hdr, consumed


def rewrite_cards(path: str | os.PathLike, updates: dict[str, Any],
                  hdu_index: int = 0) -> int:
    """Rewrite header cards of an existing file in place.

    Card slots are fixed 80-byte records, so replacing a value never
    moves data (the same property the reference exploits by patching
    RA/DEC through pyfits, lib/python/datafile.py:339-393).  Only keys
    already present are rewritten; returns the number updated.
    """
    updates = {k.upper(): v for k, v in updates.items()}
    n_updated = 0
    with open(path, "r+b") as fh:
        # seek to the target HDU's header
        for _ in range(hdu_index):
            hdr, _consumed = read_header(fh)
            size = _data_size(hdr)
            fh.seek((size + BLOCK - 1) // BLOCK * BLOCK, os.SEEK_CUR)
        hdr_start = fh.tell()
        done = False
        offset = hdr_start
        while not done:
            block = fh.read(BLOCK)
            if len(block) < BLOCK:
                raise FitsError("truncated FITS header")
            for i in range(0, BLOCK, CARDLEN):
                card = block[i:i + CARDLEN]
                if card[:3] == b"END" and card[3:8].strip() == b"":
                    done = True
                    break
                key = card[:8].decode("ascii", "replace").strip()
                if key in updates and card[8:10] == b"= ":
                    parsed = _parse_card(card)
                    comment = parsed[2] if parsed else ""
                    newcard = _format_card(key, updates[key], comment)
                    pos = offset + i
                    cur = fh.tell()
                    fh.seek(pos)
                    fh.write(newcard)
                    fh.seek(cur)
                    n_updated += 1
            offset += BLOCK
    return n_updated


def parse_tform(tform: str) -> tuple[int, str]:
    """'16E' -> (16, 'E');  'D' -> (1, 'D')."""
    m = _TFORM_RE.match(tform.strip())
    if not m:
        raise FitsError(f"unsupported TFORM {tform!r}")
    repeat = int(m.group(1)) if m.group(1) else 1
    return repeat, m.group(2)


def parse_tdim(tdim: str) -> tuple[int, ...]:
    """FITS TDIM '(a,b,c)' -> numpy shape (c,b,a) (row-major)."""
    dims = tuple(int(d) for d in tdim.strip().strip("()").split(","))
    return tuple(reversed(dims))


def table_dtype(hdr: Header) -> np.dtype:
    """Build the big-endian structured row dtype for a BINTABLE header."""
    nfields = hdr["TFIELDS"]
    fields = []
    for n in range(1, nfields + 1):
        name = str(hdr[f"TTYPE{n}"]).strip()
        repeat, code = parse_tform(str(hdr[f"TFORM{n}"]))
        if code == "X":
            # Bit array: repeat bits stored in ceil(repeat/8) bytes.
            nbytes = (repeat + 7) // 8
            fields.append((name, ">u1", (nbytes,)))
            continue
        if code == "A":
            fields.append((name, f"S{repeat}"))
            continue
        base, _ = _TFORM_DTYPES[code]
        shape: tuple[int, ...] = (repeat,)
        tdim = hdr.get(f"TDIM{n}")
        if tdim:
            shape = parse_tdim(str(tdim))
            if int(np.prod(shape)) != repeat:
                raise FitsError(
                    f"TDIM{n} {tdim} inconsistent with TFORM repeat {repeat}")
        if shape == (1,):
            fields.append((name, base))
        else:
            fields.append((name, base, shape))
    dt = np.dtype(fields)
    if dt.itemsize != hdr["NAXIS1"]:
        raise FitsError(
            f"row dtype itemsize {dt.itemsize} != NAXIS1 {hdr['NAXIS1']}")
    return dt


@dataclasses.dataclass
class HDU:
    """One header-data unit.  ``data`` is None (primary with NAXIS=0),
    or a numpy array (memmap for tables read from disk)."""

    header: Header
    data: np.ndarray | None = None

    @property
    def name(self) -> str:
        return str(self.header.get("EXTNAME", "")).strip()


def _data_size(hdr: Header) -> int:
    naxis = hdr.get("NAXIS", 0)
    if naxis == 0:
        return 0
    nelem = 1
    for i in range(1, naxis + 1):
        nelem *= hdr[f"NAXIS{i}"]
    nbytes_per = abs(hdr.get("BITPIX", 8)) // 8
    return nbytes_per * hdr.get("GCOUNT", 1) * (hdr.get("PCOUNT", 0) + nelem)


def read_fits(path: str | os.PathLike, lazy: bool = True) -> list[HDU]:
    """Read all HDUs.  Table data comes back as a read-only memmap when
    ``lazy`` (default) so huge files are cheap to open."""
    path = os.fspath(path)
    hdus: list[HDU] = []
    filesize = os.path.getsize(path)
    with open(path, "rb") as fh:
        offset = 0
        while offset < filesize:
            fh.seek(offset)
            try:
                hdr, consumed = read_header(fh)
            except EOFError:
                break
            data_start = offset + consumed
            datasize = _data_size(hdr)
            data: np.ndarray | None = None
            if datasize:
                if str(hdr.get("XTENSION", "")).strip() == "BINTABLE":
                    dt = table_dtype(hdr)
                    nrows = hdr["NAXIS2"]
                    if lazy:
                        data = np.memmap(path, dtype=dt, mode="r",
                                         offset=data_start, shape=(nrows,))
                    else:
                        fh.seek(data_start)
                        data = np.frombuffer(fh.read(dt.itemsize * nrows),
                                             dtype=dt)
                else:
                    # Image HDU: BITPIX-typed array.
                    bitpix = hdr["BITPIX"]
                    dt_map = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8",
                              -32: ">f4", -64: ">f8"}
                    shape = tuple(hdr[f"NAXIS{i}"]
                                  for i in range(hdr["NAXIS"], 0, -1))
                    if lazy:
                        data = np.memmap(path, dtype=dt_map[bitpix], mode="r",
                                         offset=data_start, shape=shape)
                    else:
                        fh.seek(data_start)
                        data = np.frombuffer(
                            fh.read(datasize), dtype=dt_map[bitpix]
                        ).reshape(shape)
            hdus.append(HDU(hdr, data))
            offset = data_start + ((datasize + BLOCK - 1) // BLOCK) * BLOCK
    if not hdus:
        raise FitsError(f"{path}: not a FITS file (no HDUs)")
    return hdus


def get_hdu(hdus: list[HDU], name: str) -> HDU:
    for h in hdus:
        if h.name == name:
            return h
    raise FitsError(f"no HDU named {name!r}")


def _write_header(fh, hdr: Header) -> None:
    buf = bytearray()
    for key, value, comment in hdr.cards:
        buf += _format_card(key, value, comment)
    buf += b"END" + b" " * (CARDLEN - 3)
    pad = (-len(buf)) % BLOCK
    buf += b" " * pad
    fh.write(bytes(buf))


def primary_header(**cards: Any) -> Header:
    hdr = Header()
    hdr.set("SIMPLE", True, "file conforms to FITS standard")
    hdr.set("BITPIX", 8)
    hdr.set("NAXIS", 0)
    hdr.set("EXTEND", True)
    for k, v in cards.items():
        hdr.set(k.replace("_", "-") if k.startswith("DATE") else k, v)
    return hdr


def bintable_header(name: str, data: np.ndarray,
                    tdims: dict[str, tuple[int, ...]] | None = None,
                    **cards: Any) -> Header:
    """Build a BINTABLE header describing structured array ``data``.

    ``tdims`` maps column name -> numpy-order shape for TDIM cards.
    """
    if data.dtype.names is None:
        raise FitsError("bintable data must be a structured array")
    hdr = Header()
    hdr.set("XTENSION", "BINTABLE", "binary table extension")
    hdr.set("BITPIX", 8)
    hdr.set("NAXIS", 2)
    hdr.set("NAXIS1", data.dtype.itemsize, "row width in bytes")
    hdr.set("NAXIS2", len(data), "number of rows")
    hdr.set("PCOUNT", 0)
    hdr.set("GCOUNT", 1)
    hdr.set("TFIELDS", len(data.dtype.names))
    rev = {(np.dtype(v).kind, np.dtype(v).itemsize): k
           for k, (v, _) in _TFORM_DTYPES.items() if k != "A"}
    for n, colname in enumerate(data.dtype.names, start=1):
        ft = data.dtype.fields[colname]
        base = ft[0].base if ft[0].subdtype else ft[0]
        shape = ft[0].shape if ft[0].subdtype else ()
        repeat = int(np.prod(shape)) if shape else 1
        if base.kind == "S":
            code = "A"
            repeat = base.itemsize
        else:
            code = rev[(base.kind, base.itemsize)]
        hdr.set(f"TTYPE{n}", colname)
        hdr.set(f"TFORM{n}", f"{repeat}{code}" if repeat != 1 else code)
        if tdims and colname in tdims:
            fits_dims = ",".join(str(d) for d in reversed(tdims[colname]))
            hdr.set(f"TDIM{n}", f"({fits_dims})")
    hdr.set("EXTNAME", name)
    for k, v in cards.items():
        hdr.set(k, v)
    return hdr


def write_fits(path: str | os.PathLike, hdus: list[HDU]) -> None:
    with open(path, "wb") as fh:
        for hdu in hdus:
            _write_header(fh, hdu.header)
            if hdu.data is not None:
                raw = np.ascontiguousarray(hdu.data).tobytes()
                fh.write(raw)
                fh.write(b"\x00" * ((-len(raw)) % BLOCK))
