"""The federation router: one front door over many hosts' fleets —
counterpart of tpulsar/frontdoor/federation.py (a copy).

Each host runs its own spool, FleetController, and gateway; the
gateway advertises the host's aggregate admission capacity at
``GET /v1/capacity`` using the spool protocol's signal convention:

    capacity > 0   accepting: this many beams may be admitted now
    capacity = 0   fresh workers, saturated queue -> BACKPRESSURE
                   (the work will drain; wait and retry)
    capacity = -1  zero fresh workers -> LOAD-SHED (nothing will
                   drain this host's queue; route AWAY from it)

The router polls member capacities (short-TTL cache — the poll is a
network round trip per member and sits on every submission), routes
each submission to the member with the most headroom, and converts
the fleet-level distinction into client-visible semantics: every
member at 0 is a retryable 429, every member shedding (or
unreachable, which is indistinguishable from the outside) is a 503.

The transport is injectable (``fetch``/``post``) so routing policy is
testable without sockets; the default is stdlib urllib against the
members' gateway APIs.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.error
import urllib.request

from tpulsar_torch.obs import telemetry

#: member capacity readings older than this are re-polled; between
#: polls the router decrements its cached reading per routed beam, so
#: the TTL bounds staleness, not admission accuracy
CAPACITY_TTL_S = 2.0

#: a member that does not answer its capacity poll within this many
#: seconds is treated as shedding (indistinguishable from down)
POLL_TIMEOUT_S = 5.0


class AllShedding(Exception):
    """Every member is load-shedding or unreachable (HTTP 503)."""


class AllSaturated(Exception):
    """Members are alive but every queue is full — backpressure, the
    client should retry (HTTP 429)."""


class BlobNotFound(Exception):
    """No federation member holds the requested blob (HTTP 404 at
    the router)."""


@dataclasses.dataclass
class MemberState:
    name: str
    url: str
    capacity: int = -1          # -1 = shedding/unreachable
    polled_at: float = 0.0
    error: str = ""


def parse_members(spec: str) -> list[tuple[str, str]]:
    """``name=url,name=url`` (or bare urls, named host1..N) ->
    [(name, url), ...]."""
    out: list[tuple[str, str]] = []
    for i, part in enumerate(p.strip() for p in spec.split(",")):
        if not part:
            continue
        if "=" in part and not part.split("=", 1)[0].startswith(
                ("http://", "https://")):
            name, url = part.split("=", 1)
        else:
            name, url = f"host{i}", part
        out.append((name.strip(), url.strip().rstrip("/")))
    if not out:
        raise ValueError(f"no federation members in {spec!r}")
    return out


def _default_fetch(url: str, timeout: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _default_post(url: str, payload: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _default_fetch_raw(url: str, timeout: float):
    """Open a streaming GET (returns the response object — the
    caller reads and closes it).  Injectable for socket-free tests."""
    return urllib.request.urlopen(url, timeout=timeout)


class FederationRouter:
    def __init__(self, members: list[tuple[str, str]] | str, *,
                 ttl_s: float = CAPACITY_TTL_S,
                 poll_timeout_s: float = POLL_TIMEOUT_S,
                 fetch=None, post=None, fetch_raw=None, logger=None):
        if isinstance(members, str):
            members = parse_members(members)
        if not members:
            raise ValueError("FederationRouter needs >= 1 member")
        self.members = [MemberState(name=n, url=u)
                        for n, u in members]
        self.ttl_s = ttl_s
        self.poll_timeout_s = poll_timeout_s
        self._fetch = fetch or _default_fetch
        self._post = post or _default_post
        self._fetch_raw = fetch_raw or _default_fetch_raw
        if logger is None:
            from tpulsar_torch.obs.log import get_logger
            logger = get_logger("frontdoor.router")
        self.log = logger
        self._rr = 0          # tie-break rotation among equal members

    # ------------------------------------------------------------ polling

    def _poll(self, m: MemberState) -> None:
        try:
            rec = self._fetch(m.url + "/v1/capacity",
                              self.poll_timeout_s)
            m.capacity = int(rec.get("capacity", -1))
            m.error = ""
        except Exception as e:            # noqa: BLE001 — any member
            # failure mode (refused, timeout, bad JSON) means the
            # same thing to routing: shed away from it
            m.capacity = -1
            m.error = str(e)[:200]
        m.polled_at = time.time()
        telemetry.frontdoor_host_capacity().set(m.capacity,
                                                host=m.name)

    def capacities(self, refresh: bool = False
                   ) -> list[MemberState]:
        now = time.time()
        stale = [m for m in self.members
                 if refresh or now - m.polled_at > self.ttl_s]
        if len(stale) == 1:
            self._poll(stale[0])
        elif stale:
            # poll expired members CONCURRENTLY: this runs on the
            # submission path, and a serial sweep would stall every
            # request poll_timeout_s per dead member — one timeout
            # bounds the whole refresh instead
            import threading
            threads = [threading.Thread(target=self._poll, args=(m,),
                                        daemon=True) for m in stale]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=self.poll_timeout_s + 1.0)
        return list(self.members)

    # ------------------------------------------------------------ routing

    def choose(self) -> MemberState:
        """The member to route the next submission to: most headroom
        wins, rotation breaks ties.  Raises AllShedding when no
        member is accepting or saturated (-1 everywhere), and
        AllSaturated when members are alive but full (0 — the
        backpressure case a client should retry)."""
        states = self.capacities()
        accepting = [m for m in states if m.capacity > 0]
        if not accepting:
            if any(m.capacity == 0 for m in states):
                raise AllSaturated(
                    "every federation member is at capacity 0 "
                    "(backpressure — retry)")
            raise AllShedding(
                "every federation member is load-shedding or "
                "unreachable: "
                + "; ".join(f"{m.name}: {m.error or 'capacity -1'}"
                            for m in states))
        best = max(m.capacity for m in accepting)
        tied = [m for m in accepting if m.capacity == best]
        self._rr += 1
        return tied[self._rr % len(tied)]

    def submit(self, payload: dict) -> tuple[str, dict]:
        """Route one beam submission: choose a member, POST it to the
        member's gateway, decrement the cached headroom (so a burst
        between capacity polls spreads instead of dog-piling one
        member).  Returns (member name, the member's response).  A
        member that fails the POST is marked shedding and the
        submission is retried on the remaining members."""
        last_err: Exception | None = None
        for _ in range(len(self.members)):
            m = self.choose()
            try:
                resp = self._post(m.url + "/v1/beams", payload,
                                  self.poll_timeout_s)
            except urllib.error.HTTPError as e:
                # the member ANSWERED with an admission refusal —
                # its capacity reading was stale; re-poll and let the
                # loop pick another member (or surface the condition)
                telemetry.frontdoor_routed_total().inc(
                    host=m.name, outcome="error")
                self.log.warning("member %s refused (%s); re-polling",
                                 m.name, e)
                self._poll(m)
                last_err = e
                continue
            except Exception as e:        # noqa: BLE001
                telemetry.frontdoor_routed_total().inc(
                    host=m.name, outcome="error")
                self.log.warning("member %s failed (%s); shedding "
                                 "away from it", m.name, e)
                m.capacity = -1
                m.error = str(e)[:200]
                telemetry.frontdoor_host_capacity().set(
                    -1, host=m.name)
                last_err = e
                continue
            m.capacity = max(0, m.capacity - 1)
            telemetry.frontdoor_routed_total().inc(host=m.name,
                                                   outcome="ok")
            return m.name, resp
        assert last_err is not None
        raise last_err

    # --------------------------------------------------------- data plane

    def open_blob(self, digest: str) -> tuple[str, object]:
        """Find the member that HAS the bytes and return its open
        streaming response: (member name, response).  Content
        addressing makes this trivially safe — any member's copy of
        a sha256 is THE copy, so the first 200 wins.  Members are
        tried most-capacity-first (a member accepting work is alive
        and worth asking first); a 404 moves on, transport failures
        mark the member shed.  BlobNotFound when nobody has it."""
        last_err: Exception | None = None
        states = sorted(self.capacities(),
                        key=lambda m: -m.capacity)
        for m in states:
            url = f"{m.url}/v1/blobs/{digest}"
            try:
                resp = self._fetch_raw(url, self.poll_timeout_s)
            except urllib.error.HTTPError as e:
                e.close()
                if e.code != 404:
                    last_err = e
                continue
            except Exception as e:        # noqa: BLE001 — transport
                m.capacity = -1
                m.error = str(e)[:200]
                telemetry.frontdoor_host_capacity().set(
                    -1, host=m.name)
                last_err = e
                continue
            telemetry.frontdoor_routed_total().inc(host=m.name,
                                                   outcome="ok")
            return m.name, resp
        if last_err is not None and not isinstance(
                last_err, urllib.error.HTTPError):
            raise last_err
        raise BlobNotFound(
            f"no federation member holds blob {digest[:12]}..")
