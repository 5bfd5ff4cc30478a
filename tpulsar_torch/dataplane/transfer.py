"""HTTP blob transfer: the client side of ``/v1/blobs/<sha256>`` —
counterpart of tpulsar/dataplane/transfer.py (a copy).

The gateway mounts the CAS on two routes (frontdoor/gateway.py):

    PUT /v1/blobs/<sha256>   ingest bytes at their address; the
                             server streams to the store, verifies
                             after write, and refuses a body whose
                             hash disagrees with the URL (409)
    GET /v1/blobs/<sha256>   stream the bytes back; the CLIENT
                             re-hashes what it received (both ends
                             verify — the paper's download-checksum
                             discipline, in both directions)

This module is those routes' stdlib client: streamed uploads
(file-like body + Content-Length, no buffering a beam in memory),
streamed downloads to a tmp+rename destination, digest verification
on every path, and the bearer-token header when the deployment sets
``TPULSAR_GATEWAY_TOKEN``.

In router deployments a GET against the router proxies to whichever
member actually holds the bytes (federation.FederationRouter
.open_blob), so one URL serves a candidate artifact produced on any
host.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import urllib.error
import urllib.request

from tpulsar_torch.checkpoint import hashing
from tpulsar_torch.dataplane import blobstore
from tpulsar_torch.obs import telemetry

DEFAULT_TIMEOUT_S = 60.0


class TransferError(Exception):
    """A blob transfer failed (HTTP error, transport failure)."""

    def __init__(self, code: int, message: str):
        super().__init__(f"blob transfer HTTP {code}: {message}")
        self.code = code


def gateway_token(token: str | None = None) -> str:
    """The operative shared secret: an explicit token beats the
    TPULSAR_GATEWAY_TOKEN knob; '' = unauthenticated deployment."""
    if token is not None:
        return token
    return os.environ.get("TPULSAR_GATEWAY_TOKEN", "")


def auth_headers(token: str | None = None) -> dict:
    tok = gateway_token(token)
    return {"Authorization": f"Bearer {tok}"} if tok else {}


def blob_url(base_url: str, digest: str) -> str:
    return (base_url.rstrip("/") + "/v1/blobs/"
            + blobstore.check_digest(digest))


def _raise_http(e: urllib.error.HTTPError) -> TransferError:
    try:
        body = json.loads(e.read().decode() or "{}")
        msg = body.get("error", str(e))
    except (ValueError, OSError):
        msg = str(e)
    return TransferError(e.code, msg)


def put_file(base_url: str, path: str, digest: str | None = None,
             token: str | None = None,
             timeout: float = DEFAULT_TIMEOUT_S) -> str:
    """Upload one file to the gateway CAS at its digest.  Hashes the
    file first when the caller didn't (the URL IS the claim the
    server verifies), streams the body, returns the digest."""
    if digest is None:
        digest = hashing.sha256_file(path)
    t0 = time.monotonic()
    size = os.stat(path).st_size
    with open(path, "rb") as fh:
        req = urllib.request.Request(
            blob_url(base_url, digest), data=fh, method="PUT",
            headers={"Content-Type": "application/octet-stream",
                     "Content-Length": str(size),
                     **auth_headers(token)})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            raise _raise_http(e) from None
    telemetry.dataplane_transfer_seconds().observe(
        time.monotonic() - t0, op="put")
    return blobstore.check_digest(digest)


def put_bytes(base_url: str, data: bytes,
              token: str | None = None,
              timeout: float = DEFAULT_TIMEOUT_S) -> str:
    digest = hashing.sha256_bytes(data)
    t0 = time.monotonic()
    req = urllib.request.Request(
        blob_url(base_url, digest), data=data, method="PUT",
        headers={"Content-Type": "application/octet-stream",
                 "Content-Length": str(len(data)),
                 **auth_headers(token)})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        raise _raise_http(e) from None
    telemetry.dataplane_transfer_seconds().observe(
        time.monotonic() - t0, op="put")
    return digest


def get_to_file(base_url: str, digest: str, dest: str,
                token: str | None = None,
                timeout: float = DEFAULT_TIMEOUT_S) -> int:
    """Download one blob to ``dest`` (tmp+rename), RE-HASHING the
    received stream against the address — a body that hashes wrong is
    discarded and raises BlobVerifyError, never left at ``dest``.
    Returns the byte count."""
    digest = blobstore.check_digest(digest)
    t0 = time.monotonic()
    req = urllib.request.Request(blob_url(base_url, digest),
                                 headers=auth_headers(token))
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    tmp = f"{dest}.{os.getpid()}.tmp"
    h = hashlib.sha256()
    n = 0
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp, \
                open(tmp, "wb") as out:
            while True:
                block = resp.read(hashing.CHUNK_BYTES)
                if not block:
                    break
                h.update(block)
                out.write(block)
                n += len(block)
            out.flush()
            os.fsync(out.fileno())
        actual = h.hexdigest()
        if actual != digest:
            telemetry.dataplane_verify_failures_total().inc(
                where="transfer")
            raise blobstore.BlobVerifyError(digest, actual,
                                            f"GET -> {dest}")
        os.replace(tmp, dest)
        tmp = ""
    except urllib.error.HTTPError as e:
        raise _raise_http(e) from None
    finally:
        if tmp:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    telemetry.dataplane_bytes_total().inc(n, op="get")
    telemetry.dataplane_transfer_seconds().observe(
        time.monotonic() - t0, op="get")
    return n


def get_bytes(base_url: str, digest: str,
              token: str | None = None,
              timeout: float = DEFAULT_TIMEOUT_S) -> bytes:
    """Whole blob in memory, verified against its address."""
    digest = blobstore.check_digest(digest)
    req = urllib.request.Request(blob_url(base_url, digest),
                                 headers=auth_headers(token))
    try:
        with urllib.request.urlopen(
                req, timeout=timeout) as resp:
            data = resp.read()
    except urllib.error.HTTPError as e:
        raise _raise_http(e) from None
    actual = hashing.sha256_bytes(data)
    if actual != digest:
        telemetry.dataplane_verify_failures_total().inc(
            where="transfer")
        raise blobstore.BlobVerifyError(digest, actual, "GET")
    telemetry.dataplane_bytes_total().inc(len(data), op="get")
    return data
