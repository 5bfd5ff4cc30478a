"""The alert notifier plane — counterpart of the notifier half of
tpulsar/obs/alerts.py (a copy of LogNotifier, WebhookNotifier,
CommandNotifier and make_notifier).  The daemons' crash reports go
through it (cli/main.py::_notify).  The rule engine of the JAX module
(rules, the built-in pack, evaluation, the fault-class mapping) is not
ported yet.

Fan-out is a pluggable spec — ``log`` (the default), ``webhook:<url>``
(HTTP POST of the alert JSON), or ``command:<argv>`` (the alert JSON
on stdin) — parsed loudly like a fault spec.

stdlib only.
"""

from __future__ import annotations

import json
import logging
import shlex
import subprocess
import urllib.request


class LogNotifier:
    """The default sink: one structured log line per transition."""

    kind = "log"

    def __init__(self, logger: logging.Logger | None = None):
        self.log = logger or logging.getLogger("tpulsar_torch.alerts")

    def notify(self, alert: dict) -> bool:
        state = alert.get("state", "firing")
        line = (f"ALERT {state}: {alert.get('rule', '?')} "
                f"[{alert.get('severity', '?')}] "
                f"value={alert.get('value')} "
                f"threshold={alert.get('threshold')} "
                f"window={alert.get('window_s')}s")
        (self.log.warning if state == "firing"
         else self.log.info)("%s", line)
        return True


class WebhookNotifier(LogNotifier):
    """HTTP POST of the alert JSON; delivery failure is logged and
    swallowed (an unreachable webhook must never stall the
    detector loop, let alone the fleet controller hosting it)."""

    kind = "webhook"

    def __init__(self, url: str, timeout_s: float = 5.0,
                 logger: logging.Logger | None = None):
        super().__init__(logger)
        if not url:
            raise ValueError("webhook notifier needs a URL "
                             "(webhook:<url>)")
        self.url = url
        self.timeout_s = timeout_s

    def notify(self, alert: dict) -> bool:
        req = urllib.request.Request(
            self.url, data=json.dumps(alert).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                return 200 <= resp.status < 300
        except (OSError, ValueError) as e:
            self.log.warning("alert webhook %s failed: %s",
                             self.url, e)
            return False


class CommandNotifier(LogNotifier):
    """Run a command per transition with the alert JSON on stdin —
    the operator's escape hatch to pagers this module has never
    heard of."""

    kind = "command"

    def __init__(self, argv_spec: str, timeout_s: float = 10.0,
                 logger: logging.Logger | None = None):
        super().__init__(logger)
        self.argv = shlex.split(argv_spec)
        if not self.argv:
            raise ValueError("command notifier needs an argv "
                             "(command:<cmd args...>)")
        self.timeout_s = timeout_s

    def notify(self, alert: dict) -> bool:
        try:
            proc = subprocess.run(
                self.argv, input=json.dumps(alert).encode(),
                timeout=self.timeout_s,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            return proc.returncode == 0
        except (OSError, subprocess.SubprocessError) as e:
            self.log.warning("alert command %s failed: %s",
                             self.argv[0], e)
            return False


def make_notifier(spec: str,
                  logger: logging.Logger | None = None):
    """``log`` | ``webhook:<url>`` | ``command:<argv>`` — unknown
    schemes fail loudly at configure time, like a fault spec."""
    spec = (spec or "log").strip()
    scheme, _, rest = spec.partition(":")
    if scheme == "log" and not rest:
        return LogNotifier(logger)
    if scheme == "webhook":
        return WebhookNotifier(rest, logger=logger)
    if scheme == "command":
        return CommandNotifier(rest, logger=logger)
    raise ValueError(
        f"unknown alert notifier spec {spec!r} (expected log, "
        f"webhook:<url>, or command:<argv>)")
