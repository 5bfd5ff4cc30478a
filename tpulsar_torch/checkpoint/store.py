"""Durable, checksummed, pass-level search checkpoints — counterpart
of tpulsar/checkpoint/store.py, with the same manifest schema, file
names and discipline, so either package resumes the other's
directory when the fingerprints agree.

A killed or preempted beam job is re-run by its queue; this module
makes the re-run cost proportional to the work LOST, not the work
done: the executor dumps an artifact at every natural boundary (RFI
mask, each DDplan pass's candidate partials + single-pulse events,
the sifted list, each folded candidate), and a resumed attempt
verifies what is on disk and recomputes only what is missing or
corrupt.

Layout (one directory per beam, by convention
``<outdir>/.checkpoint`` — see :func:`default_root`)::

    <root>/manifest.json       schema, config fingerprint, and one
                               entry per artifact: file name, byte
                               count, sha256 — the integrity contract
    <root>/pass_0007.npz       the artifacts themselves
    <root>/rfi_mask.npz
    <root>/fold_0001.npz
    ...

Discipline (verify-after-write, through
:mod:`tpulsar_torch.checkpoint.hashing`):

  * every write is tmp + flush + ``os.fsync`` + ``os.replace`` — a
    reader (including this process after a crash) can never observe a
    torn artifact at its final name, and a kill mid-write leaves only
    a ``*.tmp`` the next open sweeps;
  * the manifest carries a sha256 per artifact; :meth:`load` verifies
    size and digest and DISCARDS a corrupt entry (journal event
    ``checkpoint_invalid``) instead of resuming from garbage — one
    bad pass costs one pass, never the beam;
  * a manifest that is torn, has an unknown schema, or fingerprints a
    different configuration/beam wipes the directory: dumps from
    another world are never resumed;
  * checkpointing must never fail a healthy beam: ENOSPC / EROFS /
    EDQUOT during a write DISABLES the store for the rest of the beam
    (journal ``checkpoint_disabled``) and the search carries on
    un-checkpointed; any other write error skips that one artifact.

Fault points ``checkpoint.write`` / ``checkpoint.load``
(resilience/faults.py) fire inside :meth:`save` / :meth:`load`, so
every behaviour above is deterministically injectable.

Journal events (emitted through the ``journal`` callback the caller
wires to the spool journal; the executor adds ``pass_complete`` and
``resume`` at its level):

    checkpoint_invalid    a verification failure: scope + key + reason
    checkpoint_disabled   ENOSPC/EROFS degradation for this beam

stdlib only: a serving process reads manifests (quarantine fairness)
without importing torch or numpy.
"""

from __future__ import annotations

import errno
import json
import os
import shutil
import time

from tpulsar_torch.checkpoint import hashing
from tpulsar_torch.obs import telemetry
from tpulsar_torch.resilience import faults

#: manifest schema tag — bump on layout changes; a manifest with any
#: other value is STALE and the whole directory is recomputed (an old
#: schema resumed by new code is exactly the garbage-resume this
#: module exists to prevent)
SCHEMA = "tpulsar-checkpoint/1"

MANIFEST = "manifest.json"

#: errnos that mean "this checkpoint volume is sick, stop trying" —
#: the store disables itself for the rest of the beam instead of
#: paying a failing syscall per artifact (or worse, failing the beam)
_DISABLE_ERRNOS = frozenset(
    getattr(errno, name) for name in ("ENOSPC", "EROFS", "EDQUOT")
    if hasattr(errno, name))


def default_root(outdir: str) -> str:
    """The conventional checkpoint directory for a beam's durable
    output dir — shared by the executor (writes), the serve worker
    (resume), and the fleet requeue path (progress reads)."""
    return os.path.join(outdir, ".checkpoint")


def manifest_path(root: str) -> str:
    return os.path.join(root, MANIFEST)


def read_manifest(root: str) -> dict | None:
    """Parse a manifest tolerantly: None for absent/torn/alien files
    (readers decide what that means; the store wipes, the progress
    probe reports no progress)."""
    try:
        with open(manifest_path(root)) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        return None
    return doc


def progress_marker(root: str) -> int:
    """How far this beam's checkpoint has advanced: the number of
    manifest entries whose artifact file exists.  -1 when there is no
    readable same-schema manifest — "no progress information", which
    callers must distinguish from 0 (a manifest with nothing done).
    Used by the fleet requeue path to tell a crash-LOOPING beam (no
    progress between strikes) from a beam that merely keeps getting
    preempted (progress ≠ crash loop)."""
    doc = read_manifest(root)
    if doc is None:
        return -1
    n = 0
    for entry in (doc.get("entries") or {}).values():
        fn = (entry or {}).get("file", "")
        if fn and os.path.exists(os.path.join(root, fn)):
            n += 1
    return n


def clean(root: str) -> None:
    """Remove a beam's resume state (after results are durable, or at
    quarantine — a beam no worker will ever claim again must not leave
    checkpoint litter for the chaos auditor to flag)."""
    shutil.rmtree(root, ignore_errors=True)


def verify_root(root: str) -> dict:
    """Offline integrity audit of a checkpoint directory: re-hash
    every artifact against the manifest.  Returns ``{"ok",
    "fingerprint", "entries": [{"key", "kind", "bytes", "ok",
    "reason"}]}``."""
    doc = read_manifest(root)
    if doc is None:
        return {"ok": False, "fingerprint": "",
                "entries": [], "reason": "no readable manifest "
                f"(schema {SCHEMA})"}
    out = []
    ok = True
    for key, entry in sorted((doc.get("entries") or {}).items()):
        entry = entry or {}
        path = os.path.join(root, entry.get("file", ""))
        rec = {"key": key, "kind": entry.get("kind", "?"),
               "bytes": entry.get("bytes", -1), "ok": True,
               "reason": ""}
        try:
            size = os.path.getsize(path)
            if size != entry.get("bytes"):
                rec.update(ok=False,
                           reason=f"size {size} != {entry.get('bytes')}")
            elif hashing.sha256_file(path) != entry.get("sha256"):
                rec.update(ok=False, reason="sha256 mismatch")
        except OSError as e:
            rec.update(ok=False, reason=f"unreadable: {e}")
        ok = ok and rec["ok"]
        out.append(rec)
    return {"ok": ok, "fingerprint": doc.get("fingerprint", ""),
            "entries": out}


class CheckpointStore:
    """One beam's checkpoint directory, opened for read + write.

    ``fingerprint`` identifies the (configuration, input-beam) world
    the artifacts belong to; a directory carrying any other
    fingerprint is wiped at open.  ``journal`` is an optional
    ``callable(event, **extra)`` the caller wires to the spool
    journal (the serve worker stamps ticket/worker/attempt onto it) —
    a None journal costs only the evidence, never the behaviour.
    """

    def __init__(self, root: str, fingerprint: str, *,
                 journal=None, warn=None):
        self.root = root
        self.fingerprint = fingerprint
        self._journal_cb = journal
        self._warn = warn or (lambda msg: None)
        #: set when the checkpoint volume proved sick (ENOSPC/EROFS):
        #: every later save() is a cheap no-op for the rest of the beam
        self.disabled = False
        self._entries: dict[str, dict] = {}
        self._open()

    # ------------------------------------------------------------ open

    def journal(self, event: str, **extra) -> None:
        if self._journal_cb is not None:
            try:
                self._journal_cb(event, **extra)
            except Exception:
                pass     # evidence only — never the transition

    def _open(self) -> None:
        try:
            os.makedirs(self.root, exist_ok=True)
        except OSError as e:
            self._disable("open", e)
            return
        # sweep tmp litter a killed writer left: artifacts are only
        # ever observed at their final (renamed) names, so every
        # *.tmp here is wreckage by definition
        try:
            for name in os.listdir(self.root):
                if name.endswith(".tmp"):
                    try:
                        os.unlink(os.path.join(self.root, name))
                    except OSError:
                        pass
        except OSError:
            pass
        doc = None
        exists = os.path.exists(manifest_path(self.root))
        if exists:
            doc = read_manifest(self.root)
        if exists and doc is None:
            # torn or stale-schema manifest: the artifacts cannot be
            # trusted (their integrity record is gone) — recompute
            self.journal("checkpoint_invalid", scope="manifest",
                         reason="torn_or_stale_manifest")
            self._wipe()
        elif doc is not None \
                and doc.get("fingerprint") != self.fingerprint:
            # another configuration's (or another beam's) dumps
            self.journal("checkpoint_invalid", scope="manifest",
                         reason="fingerprint_mismatch")
            self._wipe()
        elif doc is not None:
            self._entries = {
                k: v for k, v in (doc.get("entries") or {}).items()
                if isinstance(v, dict) and v.get("file")}
        if not os.path.exists(manifest_path(self.root)):
            try:
                self._write_manifest()
            except OSError as e:
                self._disable("manifest", e)

    def _wipe(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)
        self._entries = {}
        try:
            os.makedirs(self.root, exist_ok=True)
        except OSError as e:
            self._disable("wipe", e)

    # ----------------------------------------------------------- write

    def _atomic_write(self, path: str, data: bytes) -> None:
        """tmp + fsync + rename: the artifact is either durably whole
        at its final name or absent — never torn."""
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _write_manifest(self) -> None:
        doc = {"schema": SCHEMA, "fingerprint": self.fingerprint,
               "written_at": time.time(), "entries": self._entries}
        self._atomic_write(
            manifest_path(self.root),
            json.dumps(doc, indent=1, sort_keys=True).encode())

    def _disable(self, key: str, exc: OSError) -> None:
        self.disabled = True
        telemetry.checkpoint_events_total().inc(outcome="disabled")
        self.journal("checkpoint_disabled", key=key,
                     errno=exc.errno or 0, error=str(exc)[:160])
        self._warn(
            f"checkpoint dir {self.root} is sick ({exc}); "
            f"checkpointing DISABLED for the rest of this beam — "
            f"the search continues un-checkpointed")

    def save(self, key: str, data: bytes, *, kind: str = "artifact",
             ext: str = ".bin", **meta) -> bool:
        """Durably record one artifact and its manifest entry.
        Returns True when the artifact is durable (callers journal
        their ``pass_complete`` only then); False when checkpointing
        is disabled or this write failed (the search continues — a
        checkpoint is an optimization, never a dependency)."""
        if self.disabled:
            return False
        path = os.path.join(self.root, key + ext)
        try:
            # deterministic write-failure injection: shaped as the
            # OSError a failing disk raises (errno= specs pick the
            # degradation class: ENOSPC disables, EIO skips one)
            faults.fire("checkpoint.write", make_exc=faults.io_error,
                        detail=key)
            self._atomic_write(path, data)
            self._entries[key] = {
                "file": key + ext, "kind": kind, "bytes": len(data),
                "sha256": hashing.sha256_bytes(data),
                "written_at": round(time.time(), 3), **meta}
            self._write_manifest()
        except OSError as e:
            self._entries.pop(key, None)
            if e.errno in _DISABLE_ERRNOS:
                self._disable(key, e)
            else:
                # transient failure: this artifact is skipped (it
                # will be recomputed on resume), later ones still try
                self.journal("checkpoint_write_failed", key=key,
                             errno=e.errno or 0, error=str(e)[:160])
                self._warn(f"checkpoint write {key} failed ({e}); "
                           f"continuing un-checkpointed for this "
                           f"artifact")
            return False
        telemetry.checkpoint_events_total().inc(outcome="written")
        return True

    # ------------------------------------------------------------ read

    def has(self, key: str) -> bool:
        return key in self._entries

    def entries(self, kind: str | None = None) -> dict[str, dict]:
        if kind is None:
            return dict(self._entries)
        return {k: v for k, v in self._entries.items()
                if v.get("kind") == kind}

    def load(self, key: str) -> bytes | None:
        """The artifact's bytes, VERIFIED against the manifest (size
        + sha256) — or None, with the corrupt/torn entry discarded
        and journaled (``checkpoint_invalid``) so the caller simply
        recomputes that one piece."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        path = os.path.join(self.root, entry.get("file", ""))
        try:
            # injectable load failure: a refused/failing read is
            # indistinguishable from corruption to the caller —
            # discard and recompute, never crash the beam
            faults.fire("checkpoint.load", make_exc=faults.io_error,
                        detail=key)
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as e:
            self.discard(key, reason=f"unreadable: {e}"[:160])
            return None
        if len(data) != entry.get("bytes"):
            self.discard(key, reason=f"size {len(data)} != "
                                     f"{entry.get('bytes')}")
            return None
        if hashing.sha256_bytes(data) != entry.get("sha256"):
            self.discard(key, reason="sha256 mismatch")
            return None
        telemetry.checkpoint_events_total().inc(outcome="resumed")
        return data

    def discard(self, key: str, reason: str = "") -> None:
        """Drop one entry (corrupt artifact: recompute it).  Journals
        ``checkpoint_invalid`` — the auditable record that a pass was
        legitimately re-executed after resume."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            try:
                os.unlink(os.path.join(self.root,
                                       entry.get("file", "")))
            except OSError:
                pass
            try:
                self._write_manifest()
            except OSError:
                pass
        telemetry.checkpoint_events_total().inc(outcome="invalid")
        self.journal("checkpoint_invalid", scope="entry", key=key,
                     reason=reason[:200])
        self._warn(f"checkpoint entry {key} invalid ({reason}); "
                   f"recomputing that artifact")
