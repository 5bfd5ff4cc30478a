"""Named per-module loggers writing to per-daemon log files —
counterpart of tpulsar/obs/log.py (a copy of get_logger and
OutStream; loggers are named ``tpulsar_torch.<module>``).

Capability parity with the reference's OutStream (lib/python/
OutStream.py:11-35): each subsystem gets a named logger that writes to
its own file under the configured log directory, with optional console
echo, without duplicate handlers on re-instantiation.
"""

from __future__ import annotations

import logging
import os
import sys


def get_logger(module: str, logfile: str | None = None,
               screen: bool = True, level: int | None = None
               ) -> logging.Logger:
    """Create/fetch a logger writing to `logfile` (if given) and
    optionally the console.

    The level is set only on FIRST configuration (default INFO) or
    when a caller passes one explicitly: re-fetching a logger with
    the default must not reset it — a daemon configured at DEBUG was
    silently flipped back to INFO by any later library call that
    fetched the same logger (the old unconditional setLevel)."""
    logger = logging.getLogger(f"tpulsar_torch.{module}")
    first_config = not getattr(logger, "_tpulsar_configured", False)
    if level is not None:
        logger.setLevel(level)
    elif first_config:
        logger.setLevel(logging.INFO)
    logger._tpulsar_configured = True
    logger.propagate = False

    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")

    have = {getattr(h, "_tpulsar_id", None) for h in logger.handlers}
    if logfile:
        key = f"file:{os.path.abspath(logfile)}"
        if key not in have:
            os.makedirs(os.path.dirname(os.path.abspath(logfile)),
                        exist_ok=True)
            h = logging.FileHandler(logfile)
            h.setFormatter(fmt)
            h._tpulsar_id = key
            logger.addHandler(h)
    if screen and "screen" not in have:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        h._tpulsar_id = "screen"
        logger.addHandler(h)
    return logger


class OutStream:
    """Thin compatibility shim over get_logger with the reference's
    .outs(msg) call shape."""

    def __init__(self, module: str, logfn: str | None = None,
                 screen: bool = True):
        self.logger = get_logger(module, logfn, screen)

    def outs(self, msg: str, level: int = logging.INFO) -> None:
        self.logger.log(level, msg)
