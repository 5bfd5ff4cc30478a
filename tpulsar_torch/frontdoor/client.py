"""A tiny stdlib client for the gateway API — counterpart of
tpulsar/frontdoor/client.py (a copy).

Used by ``python -m tpulsar_torch submit`` and chip_smoke.py's
served phase — and small enough to vendor into any submitter that
doesn't want a dependency on either package (it's urllib + json).

Errors carry the gateway's JSON payload: a 429 is retryable
(``ClientError.retry_after_s``), a 503 means this host is shedding —
go elsewhere.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request

DEFAULT_TIMEOUT_S = 30.0


class ClientError(Exception):
    def __init__(self, code: int, payload: dict):
        super().__init__(
            f"gateway HTTP {code}: {payload.get('error', payload)}")
        self.code = code
        self.payload = payload

    @property
    def retry_after_s(self) -> float | None:
        v = self.payload.get("retry_after_s")
        return float(v) if v is not None else None


def _request(method: str, url: str, payload: dict | None = None,
             timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    data = json.dumps(payload).encode() if payload is not None \
        else None
    headers = {"Content-Type": "application/json"} if data else {}
    # authenticated deployments set TPULSAR_GATEWAY_TOKEN on both
    # ends; sending it on reads too is harmless (the gateway only
    # checks mutating routes)
    token = os.environ.get("TPULSAR_GATEWAY_TOKEN", "")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        url, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode() or "{}")
        except ValueError:
            body = {"error": str(e)}
        raise ClientError(e.code, body) from None


def submit_beam(base_url: str, datafiles: list[str],
                outdir: str | None = None, tenant: str = "",
                priority=None, job_id: int | None = None,
                blobs: dict | None = None,
                timeout: float = DEFAULT_TIMEOUT_S,
                retries: int = 0, sleep=time.sleep) -> dict:
    """Submit a beam.  ``retries`` > 0 makes a 429 refusal
    (quota/backpressure — the RETRYABLE class) sleep for the
    gateway's jittered ``retry_after_s`` hint and resubmit, up to
    that many extra attempts; honoring the hint is what keeps a
    thousand refused submitters from herding back in lock-step.  503
    (load-shed) and 4xx validation errors never retry — this host
    told us to go elsewhere / the request is wrong."""
    payload: dict = {"datafiles": list(datafiles)}
    if outdir:
        payload["outdir"] = outdir
    if tenant:
        payload["tenant"] = tenant
    if priority not in (None, ""):
        payload["priority"] = priority
    if job_id is not None:
        payload["job_id"] = job_id
    if blobs:
        # spool-less stage-in: {filename: sha256} refs resolved
        # against the gateway CAS by the worker
        payload["blobs"] = dict(blobs)
    attempt = 0
    while True:
        try:
            return _request("POST",
                            base_url.rstrip("/") + "/v1/beams",
                            payload, timeout)
        except ClientError as e:
            if e.code != 429 or attempt >= retries:
                raise
            attempt += 1
            sleep(e.retry_after_s or 1.0)


def ticket_status(base_url: str, ticket: str,
                  timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    return _request(
        "GET", f"{base_url.rstrip('/')}/v1/tickets/"
               f"{urllib.parse.quote(ticket)}", timeout=timeout)


def ticket_events(base_url: str, ticket: str,
                  timeout: float = DEFAULT_TIMEOUT_S) -> list[dict]:
    return _request(
        "GET", f"{base_url.rstrip('/')}/v1/tickets/"
               f"{urllib.parse.quote(ticket)}/events",
        timeout=timeout)["events"]


def stream_events(base_url: str, ticket: str,
                  timeout_s: float = 600.0):
    """Yield journal events as the gateway streams them (NDJSON),
    ending after the terminal event or the server-side timeout."""
    url = (f"{base_url.rstrip('/')}/v1/tickets/"
           f"{urllib.parse.quote(ticket)}/events?follow=1"
           f"&timeout_s={timeout_s:g}")
    with urllib.request.urlopen(url,
                                timeout=timeout_s + 30.0) as resp:
        for line in resp:
            line = line.strip()
            if line:
                yield json.loads(line.decode())


def result(base_url: str, ticket: str,
           timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    return _request(
        "GET", f"{base_url.rstrip('/')}/v1/results/"
               f"{urllib.parse.quote(ticket)}", timeout=timeout)


def wait_for_result(base_url: str, ticket: str,
                    timeout_s: float = 600.0,
                    poll_s: float = 0.5) -> dict:
    """Poll until the ticket has a terminal result record."""
    deadline = time.time() + timeout_s
    while True:
        status = ticket_status(base_url, ticket)
        if status.get("result") is not None:
            return status["result"]
        if time.time() >= deadline:
            raise TimeoutError(
                f"ticket {ticket} not terminal after {timeout_s:g} s "
                f"(state {status.get('state')!r})")
        time.sleep(poll_s)


def query_candidates(base_url: str, ticket: str | None = None,
                     min_sigma: float = 0.0, limit: int = 200,
                     timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    params = {"min_sigma": f"{min_sigma:g}", "limit": str(limit)}
    if ticket is not None:
        params["ticket"] = ticket
    return _request(
        "GET", f"{base_url.rstrip('/')}/v1/candidates?"
               + urllib.parse.urlencode(params), timeout=timeout)


def capacity(base_url: str,
             timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    return _request("GET", base_url.rstrip("/") + "/v1/capacity",
                    timeout=timeout)
