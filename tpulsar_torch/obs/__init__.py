"""Observability — counterpart of tpulsar/obs/: span tracing with
Chrome-trace export (trace), the process-wide metrics registry
(metrics), and the search path's instrument catalog (telemetry)."""
