"""Per-worker metric snapshots in the spool — counterpart of
``snapshot_path`` and ``export_worker_snapshot`` of
tpulsar/obs/fleetview.py (the fleet-wide merge, the journal SLOs and
the timeline stitch are not ported yet).

Every serve worker drops its registry snapshot into
``<spool>/metrics/<worker>.json`` on each heartbeat, in the JAX
package's layout, so a fleet aggregator can merge all workers'
metrics without attaching to any process.

stdlib only.
"""

from __future__ import annotations

import os
import time

from tpulsar_torch.obs import metrics
from tpulsar_torch.serve import protocol

METRICS_DIR = "metrics"


def snapshot_path(spool: str, worker_id: str = "") -> str:
    return os.path.join(spool, METRICS_DIR,
                        f"{worker_id or 'server'}.json")


def export_worker_snapshot(spool: str, worker_id: str = "") -> None:
    """Drop this process's registry snapshot into the spool (atomic
    replace; failure never disturbs the worker)."""
    path = snapshot_path(spool, worker_id)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        protocol._atomic_write_json(path, {
            "t": time.time(), "worker": worker_id,
            "metrics": metrics.REGISTRY.snapshot()})
    except OSError:
        pass
