"""Remote stores the custom-zaplist refresh fetches from — this
package's copies of ``LocalTransport`` and ``HTTPTransport`` from
tpulsar/orchestrate/downloader.py, with the two operations the refresh
uses (``modtime``, ``fetch``).  The downloader itself, and the
transports' listing, sizes and fault knobs it uses, are not ported
yet."""

from __future__ import annotations

import os
import shutil


class LocalTransport:
    """'Remote' store that is just a directory tree — the hermetic
    fixture backend."""

    def __init__(self, root: str):
        self.root = root

    def modtime(self, path: str) -> float:
        return os.path.getmtime(os.path.join(self.root, path))

    def fetch(self, path: str, dst: str) -> None:
        shutil.copy2(os.path.join(self.root, path), dst)


class HTTPTransport:
    """HTTP(S) remote store: fetch via GET.  Every request carries a
    timeout: these run on per-job worker paths where a half-open
    connection to a sick server must not wedge the search."""

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def modtime(self, path: str) -> float:
        """Last-Modified of the remote file as a unix timestamp
        (0.0 when the server does not report one: callers treat that
        as 'not newer than any local copy')."""
        import urllib.request
        from email.utils import parsedate_to_datetime
        req = urllib.request.Request(f"{self.base_url}/{path}",
                                     method="HEAD")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            lm = resp.headers.get("Last-Modified")
        if not lm:
            return 0.0
        return parsedate_to_datetime(lm).timestamp()

    def fetch(self, path: str, dst: str) -> None:
        import urllib.request
        with urllib.request.urlopen(f"{self.base_url}/{path}",
                                    timeout=self.timeout_s) as resp, \
                open(dst, "wb") as out:
            shutil.copyfileobj(resp, out)
