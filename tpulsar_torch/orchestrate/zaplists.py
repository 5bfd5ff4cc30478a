"""Remote custom-zaplist refresh — counterpart of
tpulsar/orchestrate/zaplists.py (a copy).

The reference keeps per-beam custom zaplists in a tarball on the
Cornell FTP server and refreshes the local copy when the remote
modification time is newer (lib/python/pipeline_utils.py:191-219,
get_zaplist_tarball).  Same semantics here over the framework's own
transports: HTTP(S) for production, a plain directory for hermetic
tests.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tarfile
import tempfile

from tpulsar_torch.obs.log import get_logger

log = get_logger("zaplists")

_MANIFEST = ".extracted_zaplists"
_LOCK = ".refresh_lock"


def _transport_for(url: str):
    from tpulsar_torch.orchestrate.transports import (HTTPTransport,
                                                     LocalTransport)

    if url.startswith(("http://", "https://")):
        return HTTPTransport(url)
    return LocalTransport(url.removeprefix("file://"))


@contextlib.contextmanager
def _refresh_lock(zapdir: str):
    """Serialize concurrent refreshes of a shared zaplistdir (N
    workers may start jobs as the remote tarball updates)."""
    import fcntl

    path = os.path.join(zapdir, _LOCK)
    with open(path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def refresh_zaplists(zapdir: str, url: str,
                     remote_path: str = "zaplists.tar.gz",
                     force: bool = False) -> bool:
    """Fetch the custom-zaplist tarball when the remote copy is newer
    than the cached one (or `force`), and extract its *.zaplist
    members into zapdir.  Returns True when a refresh happened.

    url: base URL (http(s)://...) or a local/file:// directory.

    Robustness properties:
      * staleness compares the remote modification time against the
        cached tarball's mtime, which is SET to the remote time after
        every fetch (clock-skew safe; a transport reporting no
        modtime returns 0.0, i.e. 'never newer' — refresh with
        force=True for such stores);
      * the new tarball is fetched and extracted into a TEMP directory
        first — a corrupt download changes nothing and the old lists
        keep serving;
      * files land via per-file os.replace and stale lists (tracked in
        a manifest) are only removed afterwards, so concurrent readers
        never observe an empty window; operator-placed lists that
        never came from the tarball are left alone;
      * the whole critical section holds an flock, so concurrent
        workers serialize instead of interleaving fetches.
    """
    os.makedirs(zapdir, exist_ok=True)
    local_tar = os.path.join(zapdir, os.path.basename(remote_path))
    transport = _transport_for(url)
    with _refresh_lock(zapdir):
        if not force and os.path.exists(local_tar):
            remote_mtime = transport.modtime(remote_path)
            if remote_mtime <= os.path.getmtime(local_tar):
                return False
        with tempfile.TemporaryDirectory(dir=zapdir) as tmpd:
            tmp_tar = os.path.join(tmpd, "zaplists.tar")
            transport.fetch(remote_path, tmp_tar)
            names = _extract_zaplists(tmp_tar, tmpd)   # validates too
            old = _read_manifest(zapdir)
            for name in names:
                os.replace(os.path.join(tmpd, name),
                           os.path.join(zapdir, name))
            _write_manifest(zapdir, names)
            # lists removed from the remote tarball disappear locally
            for name in set(old) - set(names):
                try:
                    os.remove(os.path.join(zapdir, name))
                except OSError:
                    pass
            # commit the tarball LAST and pin its mtime to the remote
            shutil.move(tmp_tar, local_tar)
        try:
            remote_mtime = transport.modtime(remote_path)
            if remote_mtime > 0:
                os.utime(local_tar, (remote_mtime, remote_mtime))
        except (OSError, NotImplementedError, AttributeError):
            pass
    log.info("refreshed %d custom zaplists from %s", len(names), url)
    return True


def _read_manifest(zapdir: str) -> list[str]:
    try:
        with open(os.path.join(zapdir, _MANIFEST)) as fh:
            return [os.path.basename(ln.strip())
                    for ln in fh.read().splitlines() if ln.strip()]
    except OSError:
        return []


def _write_manifest(zapdir: str, names: list[str]) -> None:
    tmp = os.path.join(zapdir, _MANIFEST + ".tmp")
    with open(tmp, "w") as fh:
        fh.write("\n".join(names) + ("\n" if names else ""))
    os.replace(tmp, os.path.join(zapdir, _MANIFEST))


def _extract_zaplists(tarpath: str, outdir: str) -> list[str]:
    """Extract only flat *.zaplist members (no paths escaping outdir).
    Returns the extracted file names."""
    names: list[str] = []
    with tarfile.open(tarpath) as tf:
        for member in tf.getmembers():
            name = os.path.basename(member.name)
            if not (member.isfile() and name.endswith(".zaplist")):
                continue
            src = tf.extractfile(member)
            if src is None:
                continue
            with open(os.path.join(outdir, name), "wb") as out:
                out.write(src.read())
            names.append(name)
    return names
