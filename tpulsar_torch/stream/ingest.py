"""Chunked time-domain session ingest: the framing protocol —
counterpart of tpulsar/stream/ingest.py, the same files byte for byte
(a session either package's producer writes is read by either
package's worker).

A stream session is a directory under a stream root:

    <root>/<session>/manifest.json   geometry + fingerprint + lifecycle
    <root>/<session>/chunks/c0000000042.frame
    <root>/<session>/triggers.jsonl  worker-published trigger records

A chunk FRAME is one file: a JSON header line (seq, sha256, t_ingest,
shape, dtype, nbytes) followed by the raw little-endian float32
payload.  Frames land via atomic tmp+rename, so a reader never sees a
torn frame — a half-ingested chunk simply does not exist yet.  Chunk
sequence numbers are monotone from 0; a missing seq is detected by
the worker (journaled as ``chunk_gap`` and zero-filled, never
silently spliced — see stream/worker.py).

The session manifest carries a GEOMETRY FINGERPRINT (sha256 over the
canonical geometry tuple, the same discipline as the batch
checkpoint's configuration fingerprint): carry-state checkpoints are
keyed to it, so state from a different geometry can never be resumed
into a session.

stdlib + numpy only: the worker imports this without a kernel
module.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from tpulsar_torch.checkpoint import hashing
from tpulsar_torch.resilience import faults

SCHEMA = "tpulsar-stream/v1"

#: geometry keys that participate in the fingerprint, in canonical
#: order (extra manifest keys — labels, notes — do not re-key state)
_GEOM_KEYS = ("nchan", "chunk_len", "dt", "f_lo_mhz", "f_hi_mhz",
              "ndms", "dm_max", "span_chunks")


class StreamError(RuntimeError):
    """Protocol violation: bad frame, geometry mismatch, torn header."""


def geometry_fingerprint(geom: dict) -> str:
    """sha256 over the canonical geometry tuple — the identity a
    session's carry-state checkpoints are keyed to."""
    canon = tuple((k, geom.get(k)) for k in _GEOM_KEYS)
    return hashing.sha256_bytes(repr(canon).encode())


def session_dir(root: str, session: str) -> str:
    if not session or "/" in session or session.startswith("."):
        raise StreamError(f"bad session id {session!r}")
    return os.path.join(root, session)


def manifest_path(root: str, session: str) -> str:
    return os.path.join(session_dir(root, session), "manifest.json")


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def open_session(root: str, session: str, geometry: dict) -> dict:
    """Create (or idempotently re-open) a session.  Re-opening with a
    DIFFERENT geometry is a protocol violation, not a merge."""
    sdir = session_dir(root, session)
    os.makedirs(os.path.join(sdir, "chunks"), exist_ok=True)
    fp = geometry_fingerprint(geometry)
    existing = read_manifest(root, session)
    if existing is not None:
        if existing.get("fingerprint") != fp:
            raise StreamError(
                f"session {session} already open with a different "
                f"geometry (fingerprint {existing.get('fingerprint')!r}"
                f" != {fp!r})")
        return existing
    man = {"schema": SCHEMA, "session": session, "fingerprint": fp,
           "geometry": dict(geometry), "opened_at": round(time.time(), 3),
           "closed": False, "n_chunks": None}
    _atomic_write(manifest_path(root, session),
                  json.dumps(man, sort_keys=True).encode())
    return man


def read_manifest(root: str, session: str) -> dict | None:
    try:
        with open(manifest_path(root, session), "rb") as fh:
            doc = json.loads(fh.read().decode())
    except (OSError, ValueError):
        return None
    if doc.get("schema") != SCHEMA:
        return None
    return doc


def close_session(root: str, session: str, n_chunks: int) -> dict:
    """Mark the session closed at ``n_chunks`` submitted frames (the
    producer's count INCLUDING deliberately dropped seqs — the worker
    reconciles the difference as gaps)."""
    man = read_manifest(root, session)
    if man is None:
        raise StreamError(f"close of unknown session {session}")
    man["closed"] = True
    man["n_chunks"] = int(n_chunks)
    man["closed_at"] = round(time.time(), 3)
    _atomic_write(manifest_path(root, session),
                  json.dumps(man, sort_keys=True).encode())
    return man


# ---------------------------------------------------------------- frames

def frame_path(root: str, session: str, seq: int) -> str:
    return os.path.join(session_dir(root, session), "chunks",
                        f"c{int(seq):010d}.frame")


def encode_frame(seq: int, chunk: np.ndarray,
                 t_ingest: float | None = None) -> bytes:
    """Serialize one chunk: header line + raw float32 payload."""
    arr = np.ascontiguousarray(np.asarray(chunk, dtype=np.float32))
    if arr.ndim != 2:
        raise StreamError(f"chunk must be (nchan, chunk_len), "
                          f"got shape {arr.shape}")
    payload = arr.tobytes()
    header = {"seq": int(seq), "sha256": hashing.sha256_bytes(payload),
              "t_ingest": round(time.time() if t_ingest is None
                                else t_ingest, 6),
              "shape": list(arr.shape), "dtype": "float32",
              "nbytes": len(payload)}
    return json.dumps(header, sort_keys=True).encode() + b"\n" + payload


def decode_frame(blob: bytes) -> tuple[dict, np.ndarray]:
    """Parse + VERIFY one frame (sha256 over the payload).  Raises
    StreamError on any mismatch — a corrupt frame must never become a
    silently-wrong chunk."""
    nl = blob.find(b"\n")
    if nl < 0:
        raise StreamError("frame has no header line")
    try:
        header = json.loads(blob[:nl].decode())
    except ValueError as e:
        raise StreamError(f"torn frame header: {e}") from e
    payload = blob[nl + 1:]
    if len(payload) != header.get("nbytes"):
        raise StreamError(f"frame payload {len(payload)} B != header "
                          f"nbytes {header.get('nbytes')}")
    if hashing.sha256_bytes(payload) != header.get("sha256"):
        raise StreamError(f"frame seq {header.get('seq')} sha256 "
                          f"mismatch")
    shape = tuple(header.get("shape", ()))
    arr = np.frombuffer(payload, dtype=np.float32).reshape(shape)
    return header, arr


def append_chunk(root: str, session: str, seq: int, chunk: np.ndarray,
                 t_ingest: float | None = None) -> dict:
    """Producer side: frame + atomically land one chunk."""
    frame = encode_frame(seq, chunk, t_ingest)
    return append_frame(root, session, frame)


def append_frame(root: str, session: str, blob: bytes) -> dict:
    """Land an already-encoded frame (the gateway route's path): the
    frame is re-verified BEFORE the rename, so a bad upload is
    rejected whole and the chunks directory only ever holds frames
    that decode."""
    header, _ = decode_frame(blob)
    faults.fire("stream.ingest", make_exc=faults.io_error,
                detail=f"append seq {header['seq']}")
    path = frame_path(root, session, header["seq"])
    _atomic_write(path, blob)
    return header


def read_chunk(root: str, session: str, seq: int
               ) -> tuple[dict, np.ndarray] | None:
    """Worker side: verified read of one frame, or None when the seq
    has not landed yet.  The ``stream.ingest`` fault point fires here
    — an injected failure is retried by the worker (the frame stays
    on disk; a fault costs latency, never data)."""
    path = frame_path(root, session, seq)
    if not os.path.exists(path):
        return None
    faults.fire("stream.ingest", make_exc=faults.io_error,
                detail=f"read seq {seq}")
    with open(path, "rb") as fh:
        return decode_frame(fh.read())


def landed_seqs(root: str, session: str) -> list[int]:
    """Sorted seqs whose frames have landed (renamed into place)."""
    cdir = os.path.join(session_dir(root, session), "chunks")
    try:
        names = os.listdir(cdir)
    except OSError:
        return []
    out = []
    for n in names:
        if n.startswith("c") and n.endswith(".frame"):
            try:
                out.append(int(n[1:-6]))
            except ValueError:
                continue
    return sorted(out)


# --------------------------------------------------------------- triggers

def triggers_path(root: str, session: str) -> str:
    return os.path.join(session_dir(root, session), "triggers.jsonl")


def append_triggers(root: str, session: str,
                    records: list[dict]) -> None:
    """Publish trigger records (one JSON line each) with a single
    O_APPEND write per call — readers never see a torn batch."""
    if not records:
        return
    blob = "".join(json.dumps(r, sort_keys=True) + "\n"
                   for r in records).encode()
    fd = os.open(triggers_path(root, session),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, blob)
    finally:
        os.close(fd)


def read_triggers(root: str, session: str) -> list[dict]:
    try:
        with open(triggers_path(root, session), "rb") as fh:
            lines = fh.read().decode().splitlines()
    except OSError:
        return []
    out = []
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            out.append(json.loads(ln))
        except ValueError:
            continue        # torn tail from a crashed writer
    return out
