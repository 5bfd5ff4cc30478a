"""The HTTP gateway: beam submission and results over the network —
counterpart of tpulsar/frontdoor/gateway.py (a copy; its stream routes
land frames through this package's stream/ingest.py).

stdlib-only (``http.server``): the gateway is pure control plane — it
writes tickets, reads the journal and the result store, and never
touches the device: it starts and serves on a host with no GPU, and
leaves CUDA uninitialized in its process.  One ThreadingHTTPServer
thread per request; every mutation lands in the TicketQueue, so N
gateway processes over one spool are as safe as N workers are.

API (all JSON):

    POST /v1/beams                submit a beam
        {"datafiles": [...], "outdir"?: str, "job_id"?: int,
         "tenant"?: str, "priority"?: "low|normal|high"|int}
        -> 201 {"ticket", "trace_id", "tenant", "priority", "outdir",
                "status_url"}      (trace_id minted HERE, at the edge)
        -> 400 invalid  | 429 tenant quota or fleet backpressure
        (Retry-After set) | 503 load-shed (zero fresh workers)
    GET /v1/tickets/<id>          lifecycle status (state + the
                                  journal chain summary + result)
    GET /v1/tickets/<id>/events   the journal chain; ``?follow=1``
                                  streams NDJSON until the terminal
                                  event (or ``timeout_s``)
    GET /v1/results/<id>          terminal record + parsed candidates
    GET /v1/candidates            result-store query
        ?ticket=&min_sigma=&limit=
        (indexed via <journal root>/candidates.db when the data
        plane has written one; the outdir parse is the fallback.
        limit <= 0 is a 400, and a clipped answer carries
        ``truncated: true`` + the uncut total)
    PUT /v1/blobs/<sha256>        ingest bytes into the gateway CAS
                                  at their address (streamed; the
                                  server re-hashes and refuses a
                                  mismatched body with 409)
    GET /v1/blobs/<sha256>        stream the bytes back (router mode
                                  proxies to the member that has
                                  them); clients re-hash their side
    GET /v1/capacity              admission headroom: >0 accepting,
                                  0 backpressure, -1 load-shed (the
                                  federation router's poll target)
    POST /v1/stream/<s>/open      open a streaming-ingest session and
                                  enqueue its stream ticket
        {"geometry": {...}, "outdir"?: str, "slo_s"?: float}
        -> 201 (200 on idempotent re-open) {"session", "ticket",
                "fingerprint", "triggers_url"}; 409 on a geometry
        fingerprint mismatch
    POST /v1/stream/<s>/chunks    land one encoded frame (raw body =
                                  ingest.encode_frame bytes; sha256
                                  re-verified before the rename —
                                  400 refuses a corrupt upload whole)
    POST /v1/stream/<s>/close     {"n_chunks": N} mark the session
                                  closed at N submitted frames
    GET /v1/stream/<s>/triggers   published trigger records so far
    GET /healthz                  liveness
    GET /metrics                  this gateway's registry (Prometheus
                                  text)

Authn: when a shared secret is configured (``TPULSAR_GATEWAY_TOKEN``
or ``token=``), every MUTATING route (beam POST, blob PUT, the
stream open/chunks/close POSTs) requires
``Authorization: Bearer <token>`` and answers 401 without it; reads
stay open (the journal/results are already the operator's to serve).

Admission at the edge mirrors the warm backend's semantics: capacity
None (zero fresh workers) is a 503 load-shed — nothing will drain the
queue, the client must go elsewhere (a federation router does this
automatically); capacity 0 with fresh workers is a 429 backpressure —
the queue will drain, retry.  Tenant ``max_pending`` quotas are
refused here too (429), before the spool ever sees the ticket.

In ROUTER mode (``router=`` set) the gateway owns no queue:
``POST /v1/beams`` load-balances to member gateways by advertised
capacity and ``/v1/capacity`` aggregates the members' headroom, so
routers stack (a global router over regional routers over hosts).

The trace_id is minted at the network edge: the ``received`` journal
event carries it, ``write_ticket`` reuses it (never re-mints), and
every span/journal event downstream joins on it — so a beam's
timeline starts at HTTP arrival, and queue-wait SLOs include the
gateway hop.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tpulsar_torch.frontdoor import federation, results, tenancy
from tpulsar_torch.obs import journal as journal_mod
from tpulsar_torch.obs import metrics, telemetry
from tpulsar_torch.serve import protocol

#: ``?follow=1`` event streams give up after this long without a
#: terminal event (clients re-attach; a gateway must not accumulate
#: immortal streaming threads)
STREAM_TIMEOUT_S = 600.0
STREAM_POLL_S = 0.25


class GatewayError(Exception):
    def __init__(self, code: int, message: str, **extra):
        super().__init__(message)
        self.code = code
        self.payload = {"error": message, **extra}


class GatewayServer:
    """One gateway: a TicketQueue front (or, with ``router=``, a
    federation front).  ``port=0`` binds an ephemeral port
    (``.port`` after ``start()``)."""

    def __init__(self, queue=None, *, router=None,
                 policy: tenancy.TenantPolicy | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 outdir_base: str | None = None,
                 max_age_s: float | None = None,
                 default_depth: int = 8,
                 query_limit: int = 200,
                 retry_jitter_seed: int = 0, logger=None,
                 blob_root: str | None = None,
                 stream_root: str | None = None,
                 token: str | None = None):
        if (queue is None) == (router is None):
            raise ValueError(
                "exactly one of queue= (gateway mode) or router= "
                "(router mode) is required")
        self.queue = queue
        self.router = router
        #: the shared-secret bearer token; '' = open gateway
        self.token = token if token is not None \
            else os.environ.get("TPULSAR_GATEWAY_TOKEN", "")
        #: the mounted CAS: an explicit blob_root beats the
        #: TPULSAR_BLOB_ROOT/<spool>/blobs convention; None in
        #: router mode (the router proxies, it never stores)
        self.blob_store = None
        if router is None:
            from tpulsar_torch.dataplane import blobstore as blobstore_mod
            root = blob_root if blob_root is not None else \
                blobstore_mod.default_blob_root(
                    getattr(queue, "journal_root", "") or "")
            if root:
                self.blob_store = blobstore_mod.BlobStore(root)
        #: the streaming-ingest landing root: an explicit stream_root
        #: beats the <spool>/stream convention; None in router mode
        #: (chunk frames are host-local — a session sticks to the
        #: member that opened it)
        self.stream_root = None
        if router is None:
            base = getattr(queue, "journal_root", "") or ""
            self.stream_root = stream_root if stream_root is not None \
                else (os.path.join(base, "stream") if base else None)
        self.policy = policy or tenancy.TenantPolicy()
        self.outdir_base = outdir_base
        self.max_age_s = max_age_s
        self.default_depth = default_depth
        self.query_limit = query_limit
        if logger is None:
            from tpulsar_torch.obs.log import get_logger
            logger = get_logger("frontdoor.gateway")
        self.log = logger
        self._seq = 0
        self._seq_lock = threading.Lock()
        #: deterministic-seeded Retry-After jitter: N clients refused
        #: in one backpressure burst get ±25%-spread retry hints, so
        #: their resubmits don't land as one synchronized herd on the
        #: admission lock — seeded, so a chaos reproduction sees the
        #: same spread every run
        self._retry_rng = random.Random(retry_jitter_seed)
        #: serializes admission-check + ticket write: handler threads
        #: racing the same pending_by_tenant()/capacity() snapshot
        #: would otherwise all pass a quota with one slot left (the
        #: claim side budgets its headroom in one pass for the same
        #: reason).  The guarded section is the capacity probe
        #: (cached, short-TTL), one spool write, and — only for
        #: tenants with a max_pending quota — the pending-backlog
        #: parse that quota is defined over
        self._admit_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_handler(self))
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "GatewayServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gateway-http",
            daemon=True)
        self._thread.start()
        self.log.info("gateway listening on %s (%s)", self.url,
                      "router" if self.router else
                      f"queue {self.queue!r}")
        return self

    def serve_forever(self) -> None:
        self.log.info("gateway listening on %s", self.url)
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # ------------------------------------------------------------- helpers

    def _next_ticket_id(self) -> str:
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        return (f"gw-{os.getpid()}-{seq}-"
                f"{int(time.time() * 1000) % 100000}")

    def _retry_after(self, base: float = 5.0) -> float:
        """The 429 retry hint with ±25% seeded jitter (see
        ``_retry_rng``)."""
        with self._seq_lock:
            u = self._retry_rng.random()
        return round(base * (1.0 + (u - 0.5) * 0.5), 2)

    def check_auth(self, auth_header: str) -> None:
        """The mutating-route gate: no configured token = open
        gateway (the pre-authn contract); a configured token makes
        a missing/wrong ``Authorization: Bearer`` a 401 before any
        handler state is touched."""
        if not self.token:
            return
        if auth_header.strip() == f"Bearer {self.token}":
            return
        raise GatewayError(
            401, "missing or invalid bearer token (the deployment "
                 "sets TPULSAR_GATEWAY_TOKEN; send Authorization: "
                 "Bearer <token>)")

    # -------------------------------------------------------------- routes

    def handle_submit(self, payload: dict) -> tuple[int, dict]:
        if self.router is not None:
            return self._route_submit(payload)
        datafiles = payload.get("datafiles")
        if (not isinstance(datafiles, list) or not datafiles
                or not all(isinstance(f, str) and f
                           for f in datafiles)):
            self._count_submission(payload, "invalid")
            raise GatewayError(
                400, "datafiles must be a non-empty list of paths")
        blobs = payload.get("blobs")
        if blobs is not None and not (
                isinstance(blobs, dict) and blobs
                and all(isinstance(k, str) and isinstance(v, str)
                        for k, v in blobs.items())):
            self._count_submission(payload, "invalid")
            raise GatewayError(
                400, "blobs must be a non-empty {filename: sha256} "
                     "object when present")
        tenant = str(payload.get("tenant", "")
                     or tenancy.DEFAULT_TENANT)
        ticket_id = self._next_ticket_id()
        outdir = payload.get("outdir") or (
            os.path.join(self.outdir_base, ticket_id)
            if self.outdir_base else "")
        if not outdir:
            self._count_submission(payload, "invalid")
            raise GatewayError(
                400, "no outdir in the request and the gateway has "
                     "no --outdir-base to derive one")
        priority = self.policy.priority_of(
            {"tenant": tenant, "priority": payload.get("priority")})
        with self._admit_lock:
            # pending_by_tenant is an O(backlog) parse on the spool
            # backend: only pay it when a max_pending quota actually
            # applies to THIS tenant (the claim side short-circuits
            # trivial policies for the same reason)
            if self.policy.spec(tenant).max_pending > 0:
                ok, reason = self.policy.admit(
                    tenant, self.queue.pending_by_tenant())
                if not ok:
                    self._count_submission(payload, "quota")
                    raise GatewayError(
                        429, reason,
                        retry_after_s=self._retry_after())
            cap = self.queue.capacity(self.max_age_s,
                                      self.default_depth)
            if cap is None:
                self._count_submission(payload, "load_shed")
                raise GatewayError(
                    503, "load-shed: zero fresh workers on this "
                         "host — nothing will drain the queue; "
                         "submit elsewhere",
                    capacity=-1)
            if cap <= 0:
                self._count_submission(payload, "backpressure")
                raise GatewayError(
                    429, "backpressure: the fleet queue is full; "
                         "retry",
                    capacity=0, retry_after_s=self._retry_after())
            # the trace id is minted HERE — the network edge is the
            # start of the beam's observable life, and the
            # 'received' event is journaled before the ticket exists
            # so queue-wait measures from HTTP arrival (a crash
            # between the two leaves an in-flight chain with no
            # ticket: honest, and harmless)
            trace_id = uuid.uuid4().hex[:16]
            self.queue.record_event("received", ticket=ticket_id,
                                    trace_id=trace_id, tenant=tenant,
                                    priority=priority)
            self.queue.submit(
                ticket_id, datafiles, outdir,
                job_id=payload.get("job_id"), trace_id=trace_id,
                tenant=tenant, priority=priority,
                submitted_via="gateway",
                # by-digest stage-in refs ride the ticket record so
                # a spool-less worker pulls its beam from the CAS
                **({"blobs": blobs} if blobs else {}))
        self._count_submission({"tenant": tenant}, "accepted")
        return 201, {"ticket": ticket_id, "trace_id": trace_id,
                     "tenant": tenant, "priority": priority,
                     "outdir": outdir,
                     "status_url": f"/v1/tickets/{ticket_id}"}

    def _route_submit(self, payload: dict) -> tuple[int, dict]:
        import urllib.error

        tenant = str(payload.get("tenant", "")
                     or tenancy.DEFAULT_TENANT)
        try:
            host, resp = self.router.submit(payload)
        except federation.AllSaturated as e:
            self._count_submission({"tenant": tenant},
                                   "backpressure")
            raise GatewayError(429, str(e),
                               retry_after_s=self._retry_after())
        except federation.AllShedding as e:
            self._count_submission({"tenant": tenant}, "load_shed")
            raise GatewayError(503, str(e))
        except urllib.error.HTTPError as e:
            # a member ANSWERED with an admission refusal and no
            # other member took the beam: mirror the member's class
            # so the client's retry contract survives the hop (a 429
            # quota/backpressure refusal must stay retryable, never
            # become a hard 502)
            try:
                body = json.loads(e.read().decode() or "{}")
            except (ValueError, OSError):
                body = {"error": str(e)}
            outcome = {429: "backpressure" if "capacity" in body
                       else "quota",
                       503: "load_shed"}.get(e.code, "error")
            self._count_submission({"tenant": tenant}, outcome)
            if e.code == 429:
                body.setdefault("retry_after_s", self._retry_after())
            raise GatewayError(e.code,
                               body.get("error", str(e)), **{
                                   k: v for k, v in body.items()
                                   if k != "error"})
        except Exception as e:            # noqa: BLE001 — transport
            # failures on every member (the router already shed away
            # from each as it failed)
            self._count_submission({"tenant": tenant}, "error")
            raise GatewayError(502, f"every member failed: {e}")
        self._count_submission({"tenant": tenant}, "routed")
        return 201, {**resp, "host": host}

    def _count_submission(self, payload: dict, outcome: str) -> None:
        # the label set must be BOUNDED: the tenant string is
        # client-supplied (and counted even on refused/invalid
        # requests), so anything outside the configured tenant table
        # collapses to one 'other' series instead of minting a new
        # metric series per request
        tenant = str(payload.get("tenant", "")
                     or tenancy.DEFAULT_TENANT)
        if tenant != tenancy.DEFAULT_TENANT \
                and tenant not in self.policy.tenants:
            tenant = "other"
        telemetry.gateway_submissions_total().inc(
            tenant=tenant, outcome=outcome)

    def handle_ticket_status(self, ticket: str) -> tuple[int, dict]:
        self._require_queue()
        state = self.queue.ticket_state(ticket)
        events = self.queue.read_events(ticket=ticket)
        if state == "unknown" and not events:
            raise GatewayError(404, f"unknown ticket {ticket!r}")
        out = {"ticket": ticket, "state": state,
               "result": self.queue.read_result(ticket)}
        if events:
            out["chain"] = journal_mod.chain_summary(events)
        return 200, out

    def handle_events(self, ticket: str) -> tuple[int, dict]:
        self._require_queue()
        events = self.queue.read_events(ticket=ticket)
        if not events:
            raise GatewayError(
                404, f"no journal events for ticket {ticket!r}")
        return 200, {"ticket": ticket, "events": events}

    def iter_events_follow(self, ticket: str, timeout_s: float):
        """Yield journal events for one ticket as they land, ending
        after the terminal event (or the timeout).  Tails by saved
        offset: the attach read (offset 0) replays history once, then
        each poll costs O(new journal bytes) — N live streams no
        longer multiply into N full-journal re-reads every quarter
        second as the journal grows."""
        self._require_queue()
        offset = 0
        done = False
        deadline = time.time() + timeout_s
        while True:
            events, offset = self.queue.read_events_after(
                offset, ticket=ticket)
            for ev in events:
                yield ev
                if ev.get("event") == journal_mod.TERMINAL_EVENT:
                    done = True
            if done or time.time() >= deadline:
                return
            time.sleep(STREAM_POLL_S)

    def handle_result(self, ticket: str) -> tuple[int, dict]:
        self._require_queue()
        rec = results.result_with_candidates(self.queue, ticket)
        if rec is None:
            state = self.queue.ticket_state(ticket)
            if state == "unknown" and not self.queue.read_events(
                    ticket=ticket):
                raise GatewayError(404, f"unknown ticket {ticket!r}")
            raise GatewayError(404, f"no result yet for {ticket!r}",
                               state=state)
        return 200, rec

    def handle_candidates(self, params: dict) -> tuple[int, dict]:
        self._require_queue()
        try:
            min_sigma = float(params.get("min_sigma", ["0"])[0])
            limit = int(params.get(
                "limit", [str(self.query_limit)])[0])
        except ValueError:
            raise GatewayError(400, "min_sigma/limit must be numeric")
        if limit <= 0:
            # explicit refusal, never a silent clamp: a client that
            # asked for 0 (or -5) rows has a bug, and an empty 200
            # would hide it
            raise GatewayError(
                400, f"limit must be a positive integer (got {limit})")
        limit = min(limit, self.query_limit)
        ticket = params.get("ticket", [None])[0]
        source = params.get("source", ["auto"])[0]
        idx = self._candidate_index() if source != "parse" else None
        if idx is not None:
            try:
                return 200, idx.query(ticket=ticket,
                                      min_sigma=min_sigma, limit=limit)
            except OSError as e:
                # a sick index must degrade to the parse, not 500 a
                # read-only query the outdirs can still answer
                self.log.warning("candidate index failed (%s); "
                                 "falling back to outdir parse", e)
        return 200, results.query_candidates(
            self.queue, ticket=ticket, min_sigma=min_sigma,
            limit=limit)

    def _candidate_index(self):
        """The data plane's candidates.db next to the journal root,
        when a worker has written one (None = legacy parse)."""
        root = getattr(self.queue, "journal_root", "") or ""
        if not root:
            return None
        from tpulsar_torch.dataplane import index as index_mod
        path = index_mod.index_path(root)
        if not os.path.exists(path):
            return None
        return index_mod.CandidateIndex(path)

    # ---------------------------------------------------------- blob routes

    def handle_blob_put(self, digest: str, body,
                        length: int) -> tuple[int, dict]:
        """Ingest one streamed blob at its claimed address."""
        from tpulsar_torch.dataplane import blobstore as blobstore_mod
        if self.router is not None:
            raise GatewayError(
                404, "this is a federation router: it stores no "
                     "blobs — PUT to a member gateway")
        if self.blob_store is None:
            raise GatewayError(
                404, "no blob store mounted (set TPULSAR_BLOB_ROOT "
                     "or start the gateway with --blob-root)")
        try:
            d = blobstore_mod.check_digest(digest)
        except ValueError as e:
            raise GatewayError(400, str(e))
        try:
            stored = self.blob_store.put_stream(
                body, expect_digest=d, length=length)
        except blobstore_mod.BlobVerifyError as e:
            # the body hashed to something other than its URL: the
            # transfer is corrupt (or lying); nothing was stored
            raise GatewayError(409, str(e))
        except OSError as e:
            raise GatewayError(500, f"blob store write failed: {e}")
        return 201, {"digest": stored,
                     "bytes": self.blob_store.size(stored)}

    def open_blob(self, digest: str):
        """(readable fh, size or None) for a blob GET — the local
        store in gateway mode, a proxied member stream in router
        mode.  GatewayError 400/404/500/502 otherwise."""
        from tpulsar_torch.dataplane import blobstore as blobstore_mod
        try:
            d = blobstore_mod.check_digest(digest)
        except ValueError as e:
            raise GatewayError(400, str(e))
        if self.router is not None:
            try:
                _name, resp = self.router.open_blob(d)
            except federation.BlobNotFound as e:
                raise GatewayError(404, str(e))
            except Exception as e:        # noqa: BLE001 — transport
                raise GatewayError(
                    502, f"every member failed the blob fetch: {e}")
            size = resp.headers.get("Content-Length")
            return resp, (int(size) if size else None)
        if self.blob_store is None:
            raise GatewayError(404, "no blob store mounted")
        try:
            fh, size = self.blob_store.open_blob(d)
        except FileNotFoundError:
            raise GatewayError(
                404, f"no blob {d[:12]}.. in the store")
        except OSError as e:
            raise GatewayError(500, f"blob store read failed: {e}")
        return fh, size

    # --------------------------------------------------------- stream routes

    def _require_stream(self):
        from tpulsar_torch.stream import ingest
        if self.router is not None:
            raise GatewayError(
                404, "this is a federation router: stream sessions "
                     "are host-local — open the session on a member "
                     "gateway and keep its chunks there")
        if not self.stream_root:
            raise GatewayError(
                404, "this gateway mounts no stream root")
        return ingest

    def handle_stream_open(self, session: str,
                           payload: dict) -> tuple[int, dict]:
        """Open (or idempotently re-open) an ingest session AND
        enqueue its stream ticket — one claimable unit of session
        work riding the ordinary exactly-once ticket machinery."""
        ingest = self._require_stream()
        geometry = payload.get("geometry")
        if not isinstance(geometry, dict) or not geometry:
            raise GatewayError(
                400, "geometry must be a non-empty JSON object")
        with self._admit_lock:
            known = ingest.read_manifest(self.stream_root, session)
            try:
                man = ingest.open_session(self.stream_root, session,
                                          geometry)
            except ingest.StreamError as e:
                raise GatewayError(409, str(e))
            except (ValueError, KeyError) as e:
                raise GatewayError(400, f"bad geometry: {e}")
            ticket_id = f"stream-{session}"
            if known is None:
                outdir = payload.get("outdir") or (
                    os.path.join(self.outdir_base, ticket_id)
                    if self.outdir_base else "")
                if not outdir:
                    raise GatewayError(
                        400, "no outdir in the request and the "
                             "gateway has no --outdir-base to "
                             "derive one")
                trace_id = uuid.uuid4().hex[:16]
                self.queue.record_event("received", ticket=ticket_id,
                                        trace_id=trace_id)
                self.queue.submit(
                    ticket_id, [], outdir, trace_id=trace_id,
                    kind="stream", session=session,
                    stream_root=self.stream_root,
                    submitted_via="gateway",
                    **({"slo_s": float(payload["slo_s"])}
                       if payload.get("slo_s") else {}))
        return 201 if known is None else 200, {
            "session": session, "ticket": ticket_id,
            "fingerprint": man["fingerprint"],
            "triggers_url": f"/v1/stream/{session}/triggers"}

    def handle_stream_chunk(self, session: str, body,
                            length: int) -> tuple[int, dict]:
        """Land one encoded frame; the payload sha256 is re-verified
        before the rename, so a corrupt upload is refused whole."""
        ingest = self._require_stream()
        if length <= 0:
            raise GatewayError(400, "empty frame body")
        man = ingest.read_manifest(self.stream_root, session)
        if man is None:
            raise GatewayError(
                404, f"unknown stream session {session!r} — POST "
                     f"/v1/stream/{session}/open first")
        if man.get("closed"):
            raise GatewayError(
                409, f"session {session!r} is closed")
        try:
            header = ingest.append_frame(self.stream_root, session,
                                         body.read(length))
        except ingest.StreamError as e:
            raise GatewayError(400, f"bad frame: {e}")
        return 201, {"session": session, "seq": header["seq"],
                     "sha256": header["sha256"]}

    def handle_stream_close(self, session: str,
                            payload: dict) -> tuple[int, dict]:
        ingest = self._require_stream()
        try:
            n_chunks = int(payload["n_chunks"])
        except (KeyError, TypeError, ValueError):
            raise GatewayError(
                400, "n_chunks (total frames submitted, dropped "
                     "seqs included) is required")
        try:
            man = ingest.close_session(self.stream_root, session,
                                       n_chunks)
        except ingest.StreamError as e:
            raise GatewayError(404, str(e))
        return 200, {"session": session, "closed": True,
                     "n_chunks": man["n_chunks"]}

    def handle_stream_triggers(self, session: str) -> tuple[int, dict]:
        ingest = self._require_stream()
        man = ingest.read_manifest(self.stream_root, session)
        if man is None:
            raise GatewayError(
                404, f"unknown stream session {session!r}")
        recs = ingest.read_triggers(self.stream_root, session)
        return 200, {"session": session,
                     "closed": bool(man.get("closed")),
                     "n": len(recs), "triggers": recs}

    def handle_capacity(self) -> tuple[int, dict]:
        if self.router is not None:
            states = self.router.capacities()
            accepting = sum(m.capacity for m in states
                            if m.capacity > 0)
            if accepting > 0:
                cap = accepting
            elif any(m.capacity == 0 for m in states):
                cap = 0
            else:
                cap = -1
            return 200, {
                "capacity": cap, "role": "router",
                "members": {m.name: m.capacity for m in states}}
        cap = self.queue.capacity(self.max_age_s, self.default_depth)
        fresh = self.queue.fresh_workers(self.max_age_s)
        return 200, {
            "capacity": -1 if cap is None else cap,
            "fresh_workers": len(fresh),
            "pending": self.queue.pending_count(),
            "backend": self.queue.backend, "role": "gateway"}

    def handle_alerts(self) -> tuple[int, dict]:
        """The health doctor's currently-firing alerts, read from the
        ``alerts.json`` snapshot the detector persists at the journal
        root every tick — the gateway never evaluates rules itself
        (one detector, one verdict; the HTTP plane only serves it)."""
        self._require_queue()
        from tpulsar_torch.obs import health
        root = self.queue.journal_root
        if not root:
            return 200, {"alerts": [], "doctor": "unavailable",
                         "detail": "queue backend has no journal "
                                   "root to read alerts.json from"}
        rec = health.read_active_alerts(root)
        if rec is None:
            return 200, {"alerts": [], "doctor": "absent",
                         "detail": f"no {health.ALERTS_FILE} at "
                                   f"{root} — no detector has run"}
        return 200, {"alerts": rec.get("alerts", []),
                     "doctor": "ok", "t": rec.get("t")}

    def _require_queue(self) -> None:
        if self.queue is None:
            raise GatewayError(
                404, "this is a federation router: it holds no "
                     "tickets — query the member host that accepted "
                     "the submission (the 'host' field)")


def _make_handler(gw: GatewayServer):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.0: connection close delimits streamed bodies, so
        # ?follow=1 needs no chunked-encoding bookkeeping
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):
            gw.log.debug("%s " + fmt, self.client_address[0], *args)

        # ------------------------------------------------- plumbing

        def _send_json(self, code: int, obj: dict,
                       extra_headers: dict | None = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _observe(self, route: str, code: int,
                     t0: float) -> None:
            telemetry.gateway_requests_total().inc(
                route=route, code=str(code))
            telemetry.gateway_request_seconds().observe(
                time.time() - t0, route=route)

        def _dispatch(self, route: str, fn) -> None:
            t0 = time.time()
            headers: dict = {}
            try:
                code, payload = fn()
            except GatewayError as e:
                code, payload = e.code, e.payload
                if "retry_after_s" in e.payload:
                    # the header is integer-valued by spec; keep the
                    # jittered float in the JSON payload (what the
                    # client library sleeps on) and round here
                    headers["Retry-After"] = str(max(1, round(
                        float(e.payload["retry_after_s"]))))
                if code == 401:
                    headers["WWW-Authenticate"] = "Bearer"
            except Exception as e:        # noqa: BLE001 — one bad
                # request must never take the gateway down
                gw.log.exception("gateway %s failed", route)
                code, payload = 500, {"error": str(e)[:500]}
            # the send is guarded SEPARATELY so a client that hung
            # up mid-response (even mid-error-response) still gets
            # counted — refusal rates must not under-report exactly
            # when clients time out
            try:
                self._send_json(code, payload, headers)
            except (BrokenPipeError, ConnectionResetError, OSError):
                code = 499        # client went away mid-response
            self._observe(route, code, t0)

        # --------------------------------------------------- routes

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            parts = [p for p in path.split("/") if p]
            if len(parts) == 4 and parts[:2] == ["v1", "stream"]:
                self._stream_post(parts[2], parts[3])
                return
            if path != "/v1/beams":
                self._dispatch("other", lambda: (_ for _ in ()).throw(
                    GatewayError(404, f"no POST route {path!r}")))
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(
                    self.rfile.read(length).decode() or "{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                self._dispatch("submit", lambda: (_ for _ in ()).throw(
                    GatewayError(400, f"bad JSON body: {e}")))
                return

            def run():
                gw.check_auth(self.headers.get("Authorization", ""))
                return gw.handle_submit(payload)

            self._dispatch("submit", run)

        def _stream_post(self, session: str, action: str) -> None:
            """POST /v1/stream/<session>/{open,chunks,close} — every
            one a mutating route behind the bearer gate.  ``chunks``
            bodies are raw frame bytes; open/close are JSON."""
            if action == "chunks":
                try:
                    length = int(self.headers.get("Content-Length",
                                                  ""))
                except ValueError:
                    self._dispatch(
                        "stream_chunk",
                        lambda: (_ for _ in ()).throw(GatewayError(
                            411, "Content-Length required for "
                                 "frame POST")))
                    return

                def run():
                    gw.check_auth(self.headers.get("Authorization",
                                                   ""))
                    return gw.handle_stream_chunk(session, self.rfile,
                                                  length)

                self._dispatch("stream_chunk", run)
                return
            if action not in ("open", "close"):
                self._dispatch("other", lambda: (_ for _ in ()).throw(
                    GatewayError(
                        404, f"no stream action {action!r}")))
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(
                    self.rfile.read(length).decode() or "{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                self._dispatch(
                    f"stream_{action}",
                    lambda: (_ for _ in ()).throw(
                        GatewayError(400, f"bad JSON body: {e}")))
                return

            def run():
                gw.check_auth(self.headers.get("Authorization", ""))
                if action == "open":
                    return gw.handle_stream_open(session, payload)
                return gw.handle_stream_close(session, payload)

            self._dispatch(f"stream_{action}", run)

        def do_PUT(self):
            path = urllib.parse.urlparse(self.path).path
            parts = [p for p in path.split("/") if p]
            if len(parts) != 3 or parts[:2] != ["v1", "blobs"]:
                self._dispatch("other", lambda: (_ for _ in ()).throw(
                    GatewayError(404, f"no PUT route {path!r}")))
                return
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                self._dispatch(
                    "blob_put", lambda: (_ for _ in ()).throw(
                        GatewayError(411, "Content-Length required "
                                          "for blob PUT")))
                return

            def run():
                gw.check_auth(self.headers.get("Authorization", ""))
                return gw.handle_blob_put(parts[2], self.rfile,
                                          length)

            self._dispatch("blob_put", run)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path.rstrip("/")
            params = urllib.parse.parse_qs(parsed.query)
            parts = [p for p in path.split("/") if p]
            if path == "/healthz":
                self._dispatch("healthz", lambda: (200, {
                    "ok": True,
                    "role": "router" if gw.router else "gateway"}))
            elif path == "/metrics":
                self._metrics()
            elif path == "/v1/capacity":
                self._dispatch("capacity", gw.handle_capacity)
            elif path == "/v1/alerts":
                self._dispatch("alerts", gw.handle_alerts)
            elif path == "/v1/candidates":
                self._dispatch("candidates",
                               lambda: gw.handle_candidates(params))
            elif len(parts) == 3 and parts[:2] == ["v1", "tickets"]:
                self._dispatch(
                    "ticket",
                    lambda: gw.handle_ticket_status(parts[2]))
            elif len(parts) == 4 and parts[:2] == ["v1", "tickets"] \
                    and parts[3] == "events":
                if params.get("follow", ["0"])[0] in ("1", "true"):
                    self._stream_events(parts[2], params)
                else:
                    self._dispatch(
                        "events",
                        lambda: gw.handle_events(parts[2]))
            elif len(parts) == 3 and parts[:2] == ["v1", "results"]:
                self._dispatch("result",
                               lambda: gw.handle_result(parts[2]))
            elif len(parts) == 3 and parts[:2] == ["v1", "blobs"]:
                self._blob_get(parts[2])
            elif len(parts) == 4 and parts[:2] == ["v1", "stream"] \
                    and parts[3] == "triggers":
                self._dispatch(
                    "stream_triggers",
                    lambda: gw.handle_stream_triggers(parts[2]))
            else:
                self._dispatch("other", lambda: (_ for _ in ()).throw(
                    GatewayError(404, f"no route {path!r}")))

        def _blob_get(self, digest: str) -> None:
            """Streamed (non-JSON) blob read: bytes straight from
            the store — or a proxied member stream in router mode —
            with the address echoed in X-Tpulsar-Sha256 so the
            client verifies its side of the wire."""
            t0 = time.time()
            try:
                fh, size = gw.open_blob(digest)
            except GatewayError as e:
                try:
                    self._send_json(e.code, e.payload)
                except OSError:
                    pass
                self._observe("blob_get", e.code, t0)
                return
            code = 200
            n = 0
            try:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                if size is not None:
                    self.send_header("Content-Length", str(size))
                self.send_header("X-Tpulsar-Sha256",
                                 digest.strip().lower())
                self.end_headers()
                while True:
                    block = fh.read(1 << 20)
                    if not block:
                        break
                    self.wfile.write(block)
                    n += len(block)
            except (BrokenPipeError, ConnectionResetError, OSError):
                code = 499
            finally:
                try:
                    fh.close()
                except OSError:
                    pass
            if n:
                telemetry.dataplane_bytes_total().inc(n, op="get")
            telemetry.dataplane_transfer_seconds().observe(
                time.time() - t0, op="get")
            self._observe("blob_get", code, t0)

        def _metrics(self) -> None:
            t0 = time.time()
            text = metrics.REGISTRY.prometheus_text()
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            self._observe("metrics", 200, t0)

        def _stream_events(self, ticket: str, params: dict) -> None:
            t0 = time.time()
            try:
                timeout_s = float(params.get(
                    "timeout_s", [str(STREAM_TIMEOUT_S)])[0])
            except ValueError:
                timeout_s = STREAM_TIMEOUT_S
            # an unknown ticket must 404 like the non-follow route —
            # never hold a 200 stream (and a gateway thread, and a
            # 4-Hz full-journal re-read) open for the whole timeout
            # waiting for events that will never come
            if gw.queue is None \
                    or (not gw.queue.read_events(ticket=ticket)
                        and gw.queue.ticket_state(ticket)
                        == "unknown"):
                try:
                    self._send_json(404, {
                        "error": f"unknown ticket {ticket!r}"})
                except OSError:
                    pass
                self._observe("events_stream", 404, t0)
                return
            code = 200
            try:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.end_headers()
                for ev in gw.iter_events_follow(ticket, timeout_s):
                    self.wfile.write(
                        (json.dumps(ev, sort_keys=True) + "\n")
                        .encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                code = 499
            self._observe("events_stream", code, t0)

    return Handler
