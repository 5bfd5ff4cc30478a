"""The per-worker flight recorder and the alert-snapshot reader —
counterpart of the ``FlightRecorder`` half of tpulsar/obs/health.py
and of its ``read_active_alerts`` (what the gateway's
``GET /v1/alerts`` serves).  The health doctor, its detector loop and
the alert rules of obs/alerts.py are not ported yet, so nothing in
this package writes ``alerts.json``: the gateway reports the doctor
absent unless a JAX-package detector runs on the same root.

The flight recorder is the per-worker black box: a bounded in-memory
ring of recent journal appends / heartbeats / claims that is dumped
to ``<spool>/blackbox/<worker>.<pid>.json`` on crash or abnormal
exit — atexit for unexpected interpreter death, explicit ``dump()``
on the fatal paths that bypass atexit (``os._exit`` crash
injection).  The dump write is itself fault-injectable
(``blackbox.dump`` fires mid-write), because a crashing worker can
die mid-dump too.

Knobs:
  TPULSAR_BLACKBOX          "0" disables the flight recorder
  TPULSAR_BLACKBOX_RING     ring size (entries kept before death)

stdlib only.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time

from tpulsar_torch.resilience import faults
from tpulsar_torch.serve import protocol

ALERTS_FILE = "alerts.json"
BLACKBOX_DIR = "blackbox"


def alerts_path(root: str) -> str:
    return os.path.join(root, ALERTS_FILE)


def read_active_alerts(root: str) -> dict | None:
    """The detector's persisted active set (``{"t", "alerts": []}``),
    or None when no detector has ever run on this root — the
    distinction the alert-fidelity invariants gate on."""
    return protocol._read_json(alerts_path(root))


class FlightRecorder:
    """Bounded ring of a worker's recent moves, dumped on death.

    The ring costs one deque append per noted event while alive; the
    dump happens exactly once (atexit OR an explicit fatal-path
    ``dump()`` — whichever comes first wins) and only while armed:
    a clean shutdown ``disarm()``s first, so healthy exits leave no
    wreckage to triage."""

    def __init__(self, worker_id: str = "", spool: str = "",
                 ring: int | None = None,
                 enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("TPULSAR_BLACKBOX", "") != "0"
        if ring is None:
            try:
                ring = int(os.environ.get("TPULSAR_BLACKBOX_RING",
                                          "") or 256)
            except ValueError:
                ring = 256
        self.worker_id = worker_id
        self.spool = spool
        self.enabled = bool(enabled and spool)
        self.ring: collections.deque = collections.deque(
            maxlen=max(8, ring))
        self._lock = threading.Lock()
        self._armed = False
        self._dumped = False

    def note(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"t": round(time.time(), 3), "kind": kind}
        rec.update(fields)
        with self._lock:
            self.ring.append(rec)

    def arm(self) -> None:
        """Register the atexit dump; call once serving starts."""
        if not self.enabled or self._armed:
            return
        self._armed = True
        atexit.register(self._atexit)

    def disarm(self) -> None:
        """Clean shutdown: the atexit hook becomes a no-op."""
        self._armed = False

    def _atexit(self) -> None:
        if self._armed:
            self.dump(reason="atexit")

    def dump(self, reason: str = "", rc: int | None = None) -> str:
        """Write the ring to ``<spool>/blackbox/<worker>.<pid>.json``
        (JSONL: header, entries, end marker).  Idempotent — first
        caller wins.  The ``blackbox.dump`` fault point fires after
        the first half of the entries has been flushed, so an armed
        spec (or a real mid-dump death) leaves a torn file the
        renderer must salvage.  Returns the path, '' when disabled
        or already dumped."""
        with self._lock:
            if not self.enabled or self._dumped:
                return ""
            self._dumped = True
            entries = list(self.ring)
        path = os.path.join(
            self.spool, BLACKBOX_DIR,
            f"{self.worker_id or 'server'}.{os.getpid()}.json")
        header = {"kind": "blackbox",
                  "worker": self.worker_id, "pid": os.getpid(),
                  "t": round(time.time(), 3), "reason": reason,
                  "rc": rc, "entries": len(entries)}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as fh:
                fh.write(json.dumps(header, sort_keys=True) + "\n")
                half = (len(entries) + 1) // 2
                for rec in entries[:half]:
                    fh.write(json.dumps(rec, sort_keys=True) + "\n")
                fh.flush()
                faults.fire("blackbox.dump", make_exc=faults.io_error,
                            detail=reason or "dump")
                for rec in entries[half:]:
                    fh.write(json.dumps(rec, sort_keys=True) + "\n")
                fh.write(json.dumps({"kind": "end",
                                     "entries": len(entries)})
                         + "\n")
        except OSError:
            pass            # torn dump: the prefix already landed
        return path
