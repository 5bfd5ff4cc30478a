"""Observability — counterpart of tpulsar/obs/: span tracing with
Chrome-trace export (trace), the process-wide metrics registry
(metrics), the instrument catalog (telemetry), the ticket lifecycle
journal (journal), named loggers (log), the per-worker flight recorder
(health) and the per-worker metric snapshots in the spool
(fleetview)."""
