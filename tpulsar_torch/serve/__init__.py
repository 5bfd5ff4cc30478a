"""Resident serving — counterpart of tpulsar/serve/: the spool
protocol (protocol.py), the stage-in prefetch (stagein.py) and the
resident search server (server.py), run by
``python -m tpulsar_torch serve``."""
