"""Orchestration — counterpart of tpulsar/orchestrate/: so far the
custom-zaplist refresh (zaplists.py) and the transports it fetches
through (transports.py)."""
