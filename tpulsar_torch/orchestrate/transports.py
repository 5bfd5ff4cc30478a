"""Remote stores — counterpart of the transports in
tpulsar/orchestrate/downloader.py (a copy): ``LocalTransport``, a
directory tree with a bandwidth throttle and a fault knob, and
``HTTPTransport``.  The one place the port keeps them: the downloader
(orchestrate/downloader.py) lists, sizes and fetches beams through
them, and the custom-zaplist refresh (orchestrate/zaplists.py) reads
a tarball's modification time and fetches it."""

from __future__ import annotations

import os
import shutil
import time


class LocalTransport:
    """'Remote' store that is just a directory tree — the hermetic
    fixture backend."""

    def __init__(self, root: str, bandwidth_bps: float | None = None,
                 fail_every: int = 0):
        self.root = root
        self.bandwidth_bps = bandwidth_bps
        self.fail_every = fail_every          # fault injection
        self._fetches = 0

    def list_files(self, subdir: str) -> list[str]:
        d = os.path.join(self.root, subdir)
        if not os.path.isdir(d):
            return []
        return sorted(os.path.join(subdir, f) for f in os.listdir(d)
                      if os.path.isfile(os.path.join(d, f)))

    def size(self, path: str) -> int:
        return os.path.getsize(os.path.join(self.root, path))

    def modtime(self, path: str) -> float:
        return os.path.getmtime(os.path.join(self.root, path))

    def fetch(self, path: str, dst: str) -> None:
        self._fetches += 1
        if self.fail_every and self._fetches % self.fail_every == 0:
            raise IOError(f"injected transport failure on fetch "
                          f"#{self._fetches}")
        src = os.path.join(self.root, path)
        if self.bandwidth_bps:
            time.sleep(min(2.0, os.path.getsize(src) / self.bandwidth_bps))
        shutil.copy2(src, dst)


class HTTPTransport:
    """HTTP(S) remote store: listing via an index endpoint returning
    one 'name size' per line; fetch via GET.  Every request carries a
    timeout: these run on per-job worker paths where a half-open
    connection to a sick server must not wedge the search."""

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def list_files(self, subdir: str) -> list[str]:
        import urllib.request
        with urllib.request.urlopen(
                f"{self.base_url}/{subdir}/index.txt",
                timeout=self.timeout_s) as resp:
            lines = resp.read().decode().splitlines()
        return [f"{subdir}/{ln.split()[0]}" for ln in lines if ln.strip()]

    def size(self, path: str) -> int:
        import urllib.request
        req = urllib.request.Request(f"{self.base_url}/{path}",
                                     method="HEAD")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return int(resp.headers["Content-Length"])

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
