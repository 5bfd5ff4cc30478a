"""The one sha256 helper every integrity check shares — counterpart
of tpulsar/checkpoint/hashing.py, the same algorithm and encoding, so
a manifest written by either package verifies in the other.

Content integrity everywhere is ``sha256`` over the raw bytes,
hex-encoded: the checkpoint manifests (checkpoint/store.py) and the
checkpoint fingerprint (search/executor.py) both use it.

stdlib only.
"""

from __future__ import annotations

import hashlib

#: streaming read granularity for file digests (1 MiB: large enough
#: to amortize syscalls, small enough to keep memory flat on GB-scale
#: artifacts)
CHUNK_BYTES = 1 << 20


def sha256_bytes(data: bytes) -> str:
    """Hex sha256 of an in-memory payload."""
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str, chunk: int = CHUNK_BYTES) -> str:
    """Hex sha256 of a file's contents, streamed (constant memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def short(digest: str, n: int = 12) -> str:
    """Display prefix for log/error messages (never for comparison)."""
    return digest[:n]
