"""Observability — counterpart of tpulsar/obs/: span tracing with
Chrome-trace export (trace), the process-wide metrics registry
(metrics), the instrument catalog (telemetry), the ticket lifecycle
journal (journal), named loggers (log), the declarative alert rules
and their notifiers (alerts), the health doctor's detector and the
per-worker flight recorder (health), and the fleet-wide metric merge,
journal SLOs and timeline stitch (fleetview)."""
