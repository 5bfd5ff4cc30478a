"""sha256-addressed content store (CAS) — the artifact half of the
data plane; counterpart of tpulsar/dataplane/blobstore.py (a copy: the
same on-disk layout, so a store either package wrote verifies and
serves through the other).

The reference pipeline's outer loop is data logistics: a Cornell-FTPS
beam download with checksum verify on one side, a verify-after-write
common-DB candidate uploader on the other.  This store is that
discipline made local-first: every object lives at its own sha256
(``objects/<aa>/<digest>``), every write is tmp + fsync + rename, and
every write is RE-HASHED off disk before the rename — what the store
advertises is what a reader will get, or the put fails loudly.

Layout under ``root``::

    objects/<aa>/<sha256>        the bytes (aa = first 2 hex chars)
    refs/<sha256>/<ref>          one empty marker file per reference
                                 (refcount = directory entry count,
                                 naturally cross-process atomic)

GC deletes unreferenced objects older than a TTL — a blob someone
pinned with ``add_ref`` survives any TTL until every ref is dropped.

Fault injection: every disk touch goes through the ``dataplane.io``
point (errno modes fail the op EIO/ENOSPC-shaped; delay models a
congested volume).  An injected failure mid-put must never leave a
torn object at its final name — the tmp is unlinked on any exit.

stdlib only; digests route through checkpoint/hashing.py (the one
sha256 helper every integrity check shares).
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import tempfile
import time

from tpulsar_torch.checkpoint import hashing
from tpulsar_torch.obs import telemetry
from tpulsar_torch.resilience import faults

#: a well-formed address: 64 lowercase hex chars (uppercase input is
#: normalized, anything else refused before it can touch the disk)
DIGEST_RE = re.compile(r"^[0-9a-f]{64}$")

#: default GC age for unreferenced objects (seconds)
DEFAULT_TTL_S = 24 * 3600.0


class BlobVerifyError(RuntimeError):
    """Bytes re-hashed to a different digest than their address —
    torn write, corrupt object, or a tampered transfer.  The caller
    must treat the blob as absent, never use the bytes."""

    def __init__(self, expected: str, actual: str, where: str):
        super().__init__(
            f"blob digest mismatch at {where}: expected "
            f"{hashing.short(expected)}.., got {hashing.short(actual)}..")
        self.expected = expected
        self.actual = actual


def check_digest(digest: str) -> str:
    """Normalize + validate an address; ValueError on malformed."""
    d = (digest or "").strip().lower()
    if not DIGEST_RE.match(d):
        raise ValueError(f"malformed blob digest {digest!r} "
                         "(want 64 hex chars)")
    return d


def default_blob_root(spool: str = "") -> str:
    """The operative CAS root: TPULSAR_BLOB_ROOT beats the spool
    convention (<spool>/blobs); '' when neither is configured."""
    env = os.environ.get("TPULSAR_BLOB_ROOT", "")
    if env:
        return env
    return os.path.join(spool, "blobs") if spool else ""


def _fire(op: str) -> None:
    faults.fire("dataplane.io", make_exc=faults.io_error, detail=op)


class BlobStore:
    """One CAS root.  Instances are cheap (no open handles); safe to
    construct per call site.  All paths are process-shared — atomicity
    comes from rename and O_CREAT, not locks."""

    def __init__(self, root: str):
        if not root:
            raise ValueError("BlobStore needs a root directory")
        self.root = root
        self.objects = os.path.join(root, "objects")
        self.refs = os.path.join(root, "refs")

    # ------------------------------------------------------------ paths

    def object_path(self, digest: str) -> str:
        d = check_digest(digest)
        return os.path.join(self.objects, d[:2], d)

    def _ref_dir(self, digest: str) -> str:
        return os.path.join(self.refs, check_digest(digest))

    def has(self, digest: str) -> bool:
        return os.path.exists(self.object_path(digest))

    def size(self, digest: str) -> int:
        """Byte size of a stored blob; FileNotFoundError when absent."""
        return os.stat(self.object_path(digest)).st_size

    # ------------------------------------------------------------ write

    def put_stream(self, fh, expect_digest: str | None = None,
                   length: int | None = None) -> str:
        """Ingest a readable byte stream.  Streams to a tmp file while
        hashing, RE-HASHES the tmp off disk (verify-after-write: the
        page cache lies less than an in-flight buffer), then
        fsync+renames into place.  Returns the digest.

        expect_digest: the address the caller claims (a blob PUT, a
        ticket ref) — a mismatch raises BlobVerifyError and leaves
        nothing behind.  length: read at most this many bytes (the
        HTTP route passes Content-Length).
        """
        t0 = time.monotonic()
        _fire("put")
        os.makedirs(self.objects, exist_ok=True)
        h = hashlib.sha256()
        n = 0
        fd, tmp = tempfile.mkstemp(prefix=".ingest.", dir=self.objects)
        try:
            with os.fdopen(fd, "wb") as out:
                remaining = length
                while True:
                    want = hashing.CHUNK_BYTES
                    if remaining is not None:
                        if remaining <= 0:
                            break
                        want = min(want, remaining)
                    block = fh.read(want)
                    if not block:
                        break
                    h.update(block)
                    out.write(block)
                    n += len(block)
                    if remaining is not None:
                        remaining -= len(block)
                out.flush()
                os.fsync(out.fileno())
            digest = h.hexdigest()
            if expect_digest is not None:
                expect = check_digest(expect_digest)
                if digest != expect:
                    telemetry.dataplane_verify_failures_total().inc(
                        where="store")
                    telemetry.dataplane_blobs_total().inc(
                        op="put", outcome="error")
                    raise BlobVerifyError(expect, digest, "put")
            # verify-after-write: what's ON DISK must re-hash to the
            # address before it can be renamed to it
            _fire("verify")
            ondisk = hashing.sha256_file(tmp)
            if ondisk != digest:
                telemetry.dataplane_verify_failures_total().inc(
                    where="store")
                telemetry.dataplane_blobs_total().inc(
                    op="put", outcome="error")
                raise BlobVerifyError(digest, ondisk, "verify-after-write")
            path = self.object_path(digest)
            if os.path.exists(path):
                telemetry.dataplane_blobs_total().inc(
                    op="put", outcome="dedup")
            else:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                os.replace(tmp, path)
                tmp = ""          # consumed by the rename
                telemetry.dataplane_blobs_total().inc(
                    op="put", outcome="stored")
            telemetry.dataplane_bytes_total().inc(n, op="put")
            telemetry.dataplane_transfer_seconds().observe(
                time.monotonic() - t0, op="put")
            return digest
        finally:
            if tmp:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def put_bytes(self, data: bytes,
                  expect_digest: str | None = None) -> str:
        import io
        return self.put_stream(io.BytesIO(data), expect_digest)

    def put_file(self, path: str,
                 expect_digest: str | None = None) -> str:
        with open(path, "rb") as fh:
            return self.put_stream(fh, expect_digest)

    # ------------------------------------------------------------- read

    def open_blob(self, digest: str):
        """(readable fh, size) for a stored blob — the streaming GET
        source.  The BYTES ARE NOT VERIFIED here (that would force a
        double read per stream); readers that need integrity use
        fetch_to / read_bytes, and the HTTP client re-hashes its side.
        FileNotFoundError when absent."""
        _fire("get")
        path = self.object_path(digest)
        try:
            fh = open(path, "rb")
        except FileNotFoundError:
            telemetry.dataplane_blobs_total().inc(
                op="get", outcome="miss")
            raise
        return fh, os.fstat(fh.fileno()).st_size

    def read_bytes(self, digest: str) -> bytes:
        """Whole blob, VERIFIED: re-hashed against its address before
        return — a corrupt object raises BlobVerifyError, the caller
        never sees garbage."""
        t0 = time.monotonic()
        fh, size = self.open_blob(digest)
        with fh:
            data = fh.read()
        actual = hashing.sha256_bytes(data)
        if actual != check_digest(digest):
            telemetry.dataplane_verify_failures_total().inc(
                where="store")
            telemetry.dataplane_blobs_total().inc(
                op="get", outcome="error")
            raise BlobVerifyError(check_digest(digest), actual, "read")
        telemetry.dataplane_bytes_total().inc(size, op="get")
        telemetry.dataplane_blobs_total().inc(op="get", outcome="hit")
        telemetry.dataplane_transfer_seconds().observe(
            time.monotonic() - t0, op="get")
        return data

    def fetch_to(self, digest: str, dest: str) -> int:
        """Copy a blob out to ``dest`` (tmp+rename at the destination),
        verifying the copied bytes against the address.  Returns the
        byte count; BlobVerifyError on corruption."""
        t0 = time.monotonic()
        fh, size = self.open_blob(digest)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        tmp = f"{dest}.{os.getpid()}.tmp"
        h = hashlib.sha256()
        try:
            with fh, open(tmp, "wb") as out:
                while True:
                    block = fh.read(hashing.CHUNK_BYTES)
                    if not block:
                        break
                    h.update(block)
                    out.write(block)
                out.flush()
                os.fsync(out.fileno())
            actual = h.hexdigest()
            if actual != check_digest(digest):
                telemetry.dataplane_verify_failures_total().inc(
                    where="store")
                telemetry.dataplane_blobs_total().inc(
                    op="get", outcome="error")
                raise BlobVerifyError(check_digest(digest), actual,
                                      f"fetch_to({dest})")
            os.replace(tmp, dest)
            tmp = ""
        finally:
            if tmp:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        telemetry.dataplane_bytes_total().inc(size, op="get")
        telemetry.dataplane_blobs_total().inc(op="get", outcome="hit")
        telemetry.dataplane_transfer_seconds().observe(
            time.monotonic() - t0, op="get")
        return size

    def verify(self, digest: str) -> bool:
        """Does the stored object re-hash to its address?  False for
        absent or corrupt (the blob_durable invariant's primitive)."""
        path = self.object_path(digest)
        if not os.path.exists(path):
            return False
        return hashing.sha256_file(path) == check_digest(digest)

    # ------------------------------------------------------------- refs

    def add_ref(self, digest: str, ref: str) -> None:
        """Pin a blob under a named reference (e.g. a ticket id).
        Idempotent; O_CREAT makes it cross-process safe."""
        d = self._ref_dir(digest)
        os.makedirs(d, exist_ok=True)
        _fire("ref")
        with open(os.path.join(d, _safe_ref(ref)), "a"):
            pass

    def drop_ref(self, digest: str, ref: str) -> None:
        try:
            os.unlink(os.path.join(self._ref_dir(digest),
                                   _safe_ref(ref)))
        except FileNotFoundError:
            pass

    def refcount(self, digest: str) -> int:
        try:
            return len(os.listdir(self._ref_dir(digest)))
        except FileNotFoundError:
            return 0

    # --------------------------------------------------------------- gc

    def gc(self, ttl_s: float = DEFAULT_TTL_S,
           now: float | None = None) -> dict:
        """Delete unreferenced objects older than ``ttl_s`` (mtime of
        the object file).  Referenced blobs survive any TTL.  Returns
        {"collected": n, "kept": n, "bytes_freed": n}."""
        _fire("gc")
        now = time.time() if now is None else now
        collected = kept = freed = 0
        for sub in sorted(_listdir(self.objects)):
            subdir = os.path.join(self.objects, sub)
            if sub.startswith("."):
                # an ingest tmp orphaned by a crash mid-put: it lives
                # at the objects/ top level (never renamed), and only
                # age can prove its writer is gone
                try:
                    if now - os.stat(subdir).st_mtime > ttl_s:
                        os.unlink(subdir)
                except OSError:
                    pass
                continue
            for name in sorted(_listdir(subdir)):
                path = os.path.join(subdir, name)
                if name.startswith("."):        # orphaned ingest tmp
                    try:
                        if now - os.stat(path).st_mtime > ttl_s:
                            os.unlink(path)
                    except OSError:
                        pass
                    continue
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                if self.refcount(name) > 0 or now - st.st_mtime <= ttl_s:
                    kept += 1
                    telemetry.dataplane_blobs_total().inc(
                        op="gc", outcome="kept")
                    continue
                try:
                    os.unlink(path)
                except OSError:
                    continue
                shutil.rmtree(self._ref_dir(name), ignore_errors=True)
                collected += 1
                freed += st.st_size
                telemetry.dataplane_blobs_total().inc(
                    op="gc", outcome="collected")
        return {"collected": collected, "kept": kept,
                "bytes_freed": freed}

    def stats(self) -> dict:
        blobs = total = 0
        for sub in _listdir(self.objects):
            subdir = os.path.join(self.objects, sub)
            for name in _listdir(subdir):
                if name.startswith("."):
                    continue
                try:
                    total += os.stat(os.path.join(subdir, name)).st_size
                    blobs += 1
                except OSError:
                    pass
        return {"root": self.root, "blobs": blobs, "bytes": total}


def _listdir(path: str) -> list[str]:
    try:
        return os.listdir(path)
    except (FileNotFoundError, NotADirectoryError):
        return []


def _safe_ref(ref: str) -> str:
    """Ref names become filenames — keep them path-safe."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", ref or "anon")[:128]
