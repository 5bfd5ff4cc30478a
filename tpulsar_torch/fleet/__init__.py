"""A supervised multi-worker serving fleet — counterpart of
tpulsar/fleet/.

One controller process spawns, monitors, and restarts N resident
search workers (serve/server.py's SearchServer) that share a single
spool (serve/protocol.py).  The spool's atomic-rename claims plus
per-worker heartbeats make ticket pulling a safe work-stealing
protocol: any worker claims the oldest beam, a dead worker's orphaned
claims are reclaimed by the controller's janitor (attempts-counted,
quarantined past the cap), and a live worker's in-flight beams are
never touched.  See fleet/controller.py; the elastic policy is
fleet/autoscale.py.
"""

from tpulsar_torch.fleet.controller import (  # noqa: F401
    FleetController, read_control, render_status, write_control)
