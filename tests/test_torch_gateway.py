"""The port's network front door against the JAX package's: the HTTP
gateway (frontdoor/gateway.py), its client (client.py), the
federation router (federation.py) and the `submit` and `gateway`
commands, then the slice as a whole — a beam uploaded by digest to a
token'd gateway on a SQLite queue, served by the port's SearchServer
from the CAS and answered over HTTP.

Three kinds of test:

  * the JAX package's tests/test_gateway.py, run on the port's modules
    (their module globals pointed at the port's, with the same fake
    worker); the cases that import a module inside their bodies are
    written out against the port's;
  * request scripts run against a JAX gateway and a port gateway built
    the same way: every answer's status code, Retry-After and JSON
    body compare exactly, with ticket and trace ids, times, ports and
    temporary paths masked; the metric series the script moved compare
    exactly too;
  * the slice: a Mock subband pair through `blob put` → submit_beam
    with ``blobs=`` → `SearchServer(queue_url="sqlite:…")` with
    TPULSAR_DATA_URL → /v1/candidates and `blob get`, on the CPU.  Its
    results directory equals the port's direct search_beam of the
    same beam exactly, and the JAX package's run of the same flow at
    tools/torch_results_diff.py's rtol 1e-5 (the two packages sum
    float32 values in other orders; ROADMAP's limits of parity).

The gateway is control plane: a fresh process that imports it and
serves a request leaves CUDA uninitialized."""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_gateway as jax_gateway  # noqa: E402
from test_gateway import _Worker, _write_candlist  # noqa: E402
from test_torch_checkpoint import ROOT, restore_job_globals  # noqa: E402
from test_torch_search_job import _config_file, _subband_pair  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
from tpulsar import config as jcfg  # noqa: E402
from tpulsar.cli.main import main as jmain  # noqa: E402
from tpulsar.dataplane import index as jindex  # noqa: E402
from tpulsar.frontdoor import client as jclient  # noqa: E402
from tpulsar.frontdoor import federation as jfederation  # noqa: E402
from tpulsar.frontdoor import queue as jfq  # noqa: E402
from tpulsar.frontdoor import tenancy as jtenancy  # noqa: E402
from tpulsar.frontdoor.gateway import GatewayServer as JGateway  # noqa: E402
from tpulsar.obs import telemetry as jtelemetry  # noqa: E402
from tpulsar.serve.server import SearchServer as JSearchServer  # noqa: E402
from tpulsar.stream import STREAM_PROFILE as JSTREAM_PROFILE  # noqa: E402
from tpulsar.stream import ingest as jingest  # noqa: E402
from tpulsar_torch import config as tcfg  # noqa: E402
from tpulsar_torch.cli import search_job as tjob  # noqa: E402
from tpulsar_torch.cli.main import main as tmain  # noqa: E402
from tpulsar_torch.dataplane import index as tindex  # noqa: E402
from tpulsar_torch.frontdoor import client as tclient  # noqa: E402
from tpulsar_torch.frontdoor import federation as tfederation  # noqa: E402
from tpulsar_torch.frontdoor import queue as tfq  # noqa: E402
from tpulsar_torch.frontdoor import tenancy as ttenancy  # noqa: E402
from tpulsar_torch.frontdoor.gateway import GatewayServer  # noqa: E402
from tpulsar_torch.obs import journal as tjournal  # noqa: E402
from tpulsar_torch.obs import telemetry as ttelemetry  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402
from tpulsar_torch.serve.server import SearchServer  # noqa: E402
from tpulsar_torch.stream import STREAM_PROFILE  # noqa: E402
from tpulsar_torch.stream import ingest as tingest  # noqa: E402

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", fq=jfq, GatewayServer=JGateway, tenancy=jtenancy,
        federation=jfederation, client=jclient, ingest=jingest,
        index=jindex, telemetry=jtelemetry, profile=JSTREAM_PROFILE,
        main=jmain),
    "torch": types.SimpleNamespace(
        name="torch", fq=tfq, GatewayServer=GatewayServer,
        tenancy=ttenancy, federation=tfederation, client=tclient,
        ingest=tingest, index=tindex, telemetry=ttelemetry,
        profile=STREAM_PROFILE, main=tmain),
}


def _stream_geom():
    g = dict(STREAM_PROFILE)
    g.update(nchan=8, chunk_len=64, ndms=4)
    return g


def _port(name: str):
    """tests/test_gateway.py's test `name`, its module globals pointed
    at the port's modules."""
    fn = getattr(jax_gateway, name)
    glb = dict(fn.__globals__, client=tclient, federation=tfederation,
               tenancy=ttenancy, fq=tfq, GatewayServer=GatewayServer,
               journal=tjournal, _stream_geom=_stream_geom)
    return types.FunctionType(fn.__code__, glb, fn.__name__,
                              fn.__defaults__, fn.__closure__)


@pytest.fixture(autouse=True)
def _no_token(monkeypatch):
    for var in ("TPULSAR_GATEWAY_TOKEN", "TPULSAR_DATA_URL",
                "TPULSAR_BLOB_ROOT", "TPULSAR_QUEUE_URL"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture()
def q():
    return tfq.MemoryTicketQueue("gw-test")


@pytest.fixture()
def gw(q, tmp_path):
    server = GatewayServer(
        queue=q, outdir_base=str(tmp_path / "results"),
        policy=ttenancy.TenantPolicy(
            {"capped": {"max_pending": 1}})).start()
    yield server
    server.stop()


@pytest.fixture()
def worker(q):
    w = _Worker(q).start()
    yield w
    w.stop()


@pytest.fixture()
def stream_gw(tmp_path):
    q = tfq.get_ticket_queue(f"spool:{tmp_path / 'spool'}")
    server = GatewayServer(
        queue=q, outdir_base=str(tmp_path / "results"),
        stream_root=str(tmp_path / "stream")).start()
    yield server, q
    server.stop()


# ------------------------------------ test_gateway.py on the port

@pytest.mark.parametrize("name", [
    "test_submit_validates_request",
    "test_unknown_ticket_404",
    "test_load_shed_503_with_zero_fresh_workers",
    "test_events_follow_unknown_ticket_404s_immediately",
    "test_healthz",
])
def test_gateway_alone(name, gw):
    _port(name)(gw)


@pytest.mark.parametrize("name", [
    "test_backpressure_429_when_queue_full",
    "test_retry_after_jitter_is_seeded_and_spread",
    "test_client_retries_honor_the_jittered_hint",
    "test_tenant_max_pending_quota_429",
])
def test_gateway_admission(name, gw, q):
    _port(name)(gw, q)


@pytest.mark.parametrize("name", [
    "test_submit_roundtrip_received_chain_and_result",
    "test_events_stream_follows_to_terminal",
    "test_result_store_candidate_query_roundtrip",
    "test_metrics_endpoint_exports_gateway_series",
    "test_candidate_query_refuses_nonpositive_limit",
])
def test_gateway_with_a_worker(name, gw, q, worker):
    _port(name)(gw, q, worker)


@pytest.mark.parametrize("name", [
    "test_fs_spool_gateway_received_lands_in_journal",
    "test_router_mode_routes_submissions_to_live_member",
    "test_router_mirrors_member_refusal_class",
    "test_router_mode_all_members_shedding_is_503",
    "test_stream_mutations_need_bearer_token",
    "test_stream_routes_404_in_router_mode",
])
def test_gateway_own_servers(name, tmp_path):
    _port(name)(tmp_path)


def test_stream_geometry_conflict_409(stream_gw):
    _port("test_stream_geometry_conflict_409")(stream_gw)


def test_submission_metric_clamps_unknown_tenants(gw, q, worker):
    counter = ttelemetry.gateway_submissions_total()
    before = counter.value(tenant="other", outcome="accepted")
    for i in range(3):
        tclient.submit_beam(gw.url, [f"/data/{i}.fits"],
                            tenant=f"rando-{i}")
    assert counter.value(tenant="other",
                         outcome="accepted") == before + 3
    with urllib.request.urlopen(gw.url + "/metrics",
                                timeout=10) as resp:
        text = resp.read().decode()
    assert "rando-" not in text


def test_stream_session_over_http(stream_gw):
    """The stream routes land frames through the port's
    stream/ingest.append_frame; a frame the JAX package encoded lands
    the same way."""
    gw, q = stream_gw
    geom = _stream_geom()
    code, rec = jax_gateway._http(gw.url + "/v1/stream/sA/open",
                                  {"geometry": geom})
    assert code == 201 and rec["ticket"] == "stream-sA"
    code2, rec2 = jax_gateway._http(gw.url + "/v1/stream/sA/open",
                                    {"geometry": geom})
    assert code2 == 200 and rec2["fingerprint"] == rec["fingerprint"]
    assert q.pending_count() == 1
    chunk = np.ones((8, 64), np.float32)
    blob = tingest.encode_frame(0, chunk, t_ingest=1.0)
    assert blob == jingest.encode_frame(0, chunk, t_ingest=1.0)
    code, got = jax_gateway._http(gw.url + "/v1/stream/sA/chunks", blob,
                                  method="POST", raw=True)
    assert code == 201 and got["seq"] == 0
    with pytest.raises(urllib.error.HTTPError) as ei:
        jax_gateway._http(gw.url + "/v1/stream/sA/chunks",
                          blob[:-3] + b"xyz", method="POST", raw=True)
    assert ei.value.code == 400
    code, got = jax_gateway._http(
        gw.url + "/v1/stream/sA/chunks",
        jingest.encode_frame(1, 2 * chunk), method="POST", raw=True)
    assert code == 201 and got["seq"] == 1
    assert tingest.landed_seqs(gw.stream_root, "sA") == [0, 1]
    assert np.array_equal(
        tingest.read_chunk(gw.stream_root, "sA", 1)[1], 2 * chunk)
    code, got = jax_gateway._http(gw.url + "/v1/stream/sA/close",
                                  {"n_chunks": 2})
    assert code == 200 and got["closed"] is True
    with pytest.raises(urllib.error.HTTPError) as ei:
        jax_gateway._http(gw.url + "/v1/stream/sA/chunks",
                          tingest.encode_frame(2, chunk),
                          method="POST", raw=True)
    assert ei.value.code == 409
    tingest.append_triggers(gw.stream_root, "sA",
                            [{"session": "sA", "span": 0, "dm": 1.0,
                              "sigma": 7.5, "sample": 5,
                              "time_s": 5e-4, "width": 1}])
    code, got = jax_gateway._http(gw.url + "/v1/stream/sA/triggers")
    assert code == 200 and got["closed"] and got["n"] == 1
    assert got["triggers"][0]["sigma"] == 7.5


def test_cli_submit_wait_roundtrip(gw, q, worker, tmp_path, capsys):
    rc = tmain(["submit", str(tmp_path / "beam.fits"),
                "--gateway", gw.url, "--wait", "--timeout", "30"])
    assert rc == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["ticket"].startswith("gw-")
    assert lines[1]["status"] == "done"


def test_cli_submit_load_shed_rc3(tmp_path, capsys):
    q = tfq.MemoryTicketQueue("shed")          # zero fresh workers
    gw = GatewayServer(queue=q,
                       outdir_base=str(tmp_path / "res")).start()
    try:
        rc = tmain(["submit", str(tmp_path / "beam.fits"),
                    "--gateway", gw.url])
        assert rc == 3
        err = json.loads(capsys.readouterr().err.strip())
        assert err["code"] == 503
    finally:
        gw.stop()


def test_cli_submit_refused_rc2_and_invalid_rc1(gw, q, tmp_path,
                                                capsys):
    """The other two exit codes of `submit`: a 429 refusal is 2
    (retryable), any other refusal 1."""
    q.heartbeat("w0", status="running", max_queue_depth=1)
    assert tmain(["submit", "/data/a.fits", "--gateway", gw.url]) == 0
    assert tmain(["submit", "/data/b.fits", "--gateway", gw.url]) == 2
    assert json.loads(capsys.readouterr().err.strip().splitlines()[-1]
                      )["code"] == 429
    gw.outdir_base = None           # no outdir can be derived: a 400
    assert tmain(["submit", "/data/c.fits", "--gateway", gw.url]) == 1
    assert json.loads(capsys.readouterr().err.strip().splitlines()[-1]
                      )["code"] == 400


# ---------------------------- the same script, JAX gateway vs port's

_GW_ID = re.compile(r"gw-\d+-(\d+)-\d+")
_URL = re.compile(r"http://127\.0\.0\.1:\d+")
#: keys whose values are times, durations, process ids or random ids
_MASKED = {"t", "trace_id", "finished_at", "claimed_at",
           "submitted_at", "received_at", "requeued_at", "beam_seconds",
           "queue_wait_s", "claim_to_start_s", "beam_e2e_s", "e2e_s",
           "span_s", "claimed_by", "pid", "from_pid", "t_ingest",
           "ingested_at", "opened_at", "closed_at", "fingerprint"}


def _mask(obj, roots: tuple[str, ...]):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in _MASKED else _mask(v, roots))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v, roots) for v in obj]
    if isinstance(obj, str):
        for r in roots:
            obj = obj.replace(r, "<tmp>")
        return _GW_ID.sub(r"gw-\1", _URL.sub("<url>", obj))
    return obj


def _send_raw(method: str, url: str, data: bytes, headers: dict):
    """(status, headers, body) of one request with a raw body, sent as
    urllib sends it, except that the body stops going out once the
    server has answered: a gateway refuses a PUT without a token or
    with a malformed digest before it reads the body and closes the
    connection, and a client still writing a 1 MB body then meets a
    broken pipe instead of the answer (as urllib's client sometimes
    did)."""
    import http.client
    import select

    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    conn.putrequest(method, u.path + (f"?{u.query}" if u.query else ""))
    headers = {"Content-Type": "application/x-www-form-urlencoded",
               **headers, "Content-Length": str(len(data)),
               "Connection": "close"}
    for k, v in headers.items():
        conn.putheader(k, v)
    conn.endheaders()
    view = memoryview(data)
    try:
        while view:
            readable, _w, _x = select.select([conn.sock], [conn.sock],
                                             [], 30)
            if readable:
                break                 # answered before the whole body
            view = view[conn.sock.send(view[:1 << 16]):]
    except (BrokenPipeError, ConnectionResetError):
        pass                          # the answer is read below
    try:
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


class _Script:
    """Records each request's answer: status, the Retry-After and
    WWW-Authenticate headers, and the body (JSON, NDJSON lines, or the
    sha256 and length of raw bytes), masked."""

    def __init__(self, root: str):
        self.roots = (root,)
        self.seen: list = []

    def __call__(self, label, method, url, body=None, token=None,
                 raw=False):
        headers = {}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        data = None
        if body is not None:
            if raw:
                data = body
            else:
                data = json.dumps(body).encode()
                headers["Content-Type"] = "application/json"
        if raw:
            code, hdrs, payload = _send_raw(method, url, data, headers)
        else:
            req = urllib.request.Request(url, data=data, method=method,
                                         headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=30) as resp:
                    code, hdrs, payload = resp.status, resp.headers, \
                        resp.read()
            except urllib.error.HTTPError as e:
                code, hdrs, payload = e.code, e.headers, e.read()
        ctype = hdrs.get("Content-Type", "")
        if ctype == "application/json":
            out = json.loads(payload)
        elif ctype == "application/x-ndjson":
            out = [json.loads(ln) for ln in payload.splitlines()
                   if ln.strip()]
        else:
            out = {"sha256": hashlib.sha256(payload).hexdigest(),
                   "bytes": len(payload)}
        self.seen.append((_mask(label, self.roots), code,
                          hdrs.get("Retry-After"),
                          hdrs.get("WWW-Authenticate"),
                          _mask(out, self.roots)))
        return code, out


def _script_submit_and_query(P, root, rec):
    q = P.fq.MemoryTicketQueue(f"parity-{P.name}")
    gw = P.GatewayServer(queue=q, outdir_base=f"{root}/results",
                         policy=P.tenancy.TenantPolicy(
                             {"capped": {"max_pending": 1}})).start()
    w = _Worker(q).start()
    try:
        u = gw.url
        rec("bad json", "POST", u + "/v1/beams", b"not json", raw=True)
        rec("no datafiles", "POST", u + "/v1/beams", {"datafiles": []})
        rec("empty blobs", "POST", u + "/v1/beams",
            {"datafiles": ["/a"], "blobs": {}})
        for path in ("/v1/tickets/nope", "/v1/tickets/nope/events",
                     "/v1/tickets/nope/events?follow=1&timeout_s=5",
                     "/v1/results/nope", "/v1/nothing"):
            rec(path, "GET", u + path)
        rec("post nowhere", "POST", u + "/v1/nothing", {})
        rec("put nowhere", "PUT", u + "/v1/nothing", b"x", raw=True)
        rec("no blob store", "PUT", u + "/v1/blobs/" + "a" * 64, b"x",
            raw=True)
        tids = []
        for i, tenant in enumerate(("ops", "")):
            _c, r = rec(f"submit {i}", "POST", u + "/v1/beams",
                        {"datafiles": [f"/data/{i}.fits"],
                         "tenant": tenant, "job_id": i})
            tids.append(r["ticket"])
            P.client.wait_for_result(u, r["ticket"], timeout_s=30,
                                     poll_s=0.05)
        t0 = tids[0]
        for path in (f"/v1/tickets/{t0}", f"/v1/tickets/{t0}/events",
                     f"/v1/tickets/{t0}/events?follow=1&timeout_s=5",
                     f"/v1/results/{t0}",
                     "/v1/candidates?min_sigma=6",
                     "/v1/candidates?min_sigma=6&limit=3",
                     f"/v1/candidates?ticket={tids[1]}",
                     "/v1/candidates?limit=0",
                     "/v1/candidates?limit=-5",
                     "/v1/candidates?limit=x",
                     "/v1/candidates?limit=1",
                     "/healthz", "/v1/capacity", "/v1/alerts"):
            rec(path, "GET", u + path)
    finally:
        w.stop()
        gw.stop()


def _script_admission(P, root, rec):
    q = P.fq.MemoryTicketQueue(f"parity-adm-{P.name}")
    gw = P.GatewayServer(queue=q, outdir_base=f"{root}/results",
                         policy=P.tenancy.TenantPolicy(
                             {"capped": {"max_pending": 1}})).start()
    try:
        u = gw.url
        beam = {"datafiles": ["/data/a.fits"]}
        rec("shed", "POST", u + "/v1/beams", beam)
        rec("shed capacity", "GET", u + "/v1/capacity")
        q.heartbeat("w0", status="running", max_queue_depth=1)
        rec("fills depth 1", "POST", u + "/v1/beams", beam)
        for i in range(4):
            rec(f"backpressure {i}", "POST", u + "/v1/beams", beam)
        rec("full capacity", "GET", u + "/v1/capacity")
        q.heartbeat("w0", status="running", max_queue_depth=8)
        for tenant in ("capped", "capped", "other"):
            rec(f"tenant {tenant}", "POST", u + "/v1/beams",
                dict(beam, tenant=tenant))
        for prio in ("high", 1, "bogus"):
            rec(f"priority {prio}", "POST", u + "/v1/beams",
                dict(beam, priority=prio))
    finally:
        gw.stop()


def _script_router(P, root, rec):
    qa = P.fq.MemoryTicketQueue(f"parity-a-{P.name}")
    member = P.GatewayServer(queue=qa,
                             outdir_base=f"{root}/res_a").start()
    wa = _Worker(qa).start()
    router = P.GatewayServer(router=P.federation.FederationRouter(
        [("a", member.url), ("dead", "http://127.0.0.1:1")],
        poll_timeout_s=1.0)).start()
    qc = P.fq.MemoryTicketQueue(f"parity-c-{P.name}")
    qc.heartbeat("w0", status="running", max_queue_depth=8)
    capped = P.GatewayServer(
        queue=qc, outdir_base=f"{root}/res_c",
        policy=P.tenancy.TenantPolicy(
            {"capped": {"max_pending": 1}})).start()
    router_c = P.GatewayServer(router=P.federation.FederationRouter(
        [("c", capped.url)], poll_timeout_s=2.0)).start()
    shed = P.GatewayServer(queue=P.fq.MemoryTicketQueue(
        f"parity-s-{P.name}"), outdir_base=f"{root}/res_s").start()
    router_s = P.GatewayServer(router=P.federation.FederationRouter(
        [("s", shed.url)], poll_timeout_s=1.0)).start()
    try:
        u = router.url
        rec("router capacity", "GET", u + "/v1/capacity")
        _c, r = rec("routed", "POST", u + "/v1/beams",
                    {"datafiles": ["/data/a.fits"]})
        for path in (f"/v1/tickets/{r['ticket']}", "/v1/candidates",
                     f"/v1/results/{r['ticket']}", "/v1/alerts",
                     "/healthz", "/v1/blobs/" + "b" * 64):
            rec("router " + path, "GET", u + path)
        rec("router stream", "POST", u + "/v1/stream/s/open",
            {"geometry": _stream_geom()})
        rec("router blob put", "PUT", u + "/v1/blobs/" + "b" * 64,
            b"x", raw=True)
        P.client.wait_for_result(member.url, r["ticket"],
                                 timeout_s=30, poll_s=0.05)
        rec("member result", "GET", member.url
            + f"/v1/results/{r['ticket']}")
        rec("fill quota", "POST", capped.url + "/v1/beams",
            {"datafiles": ["/a"], "tenant": "capped"})
        rec("mirrored 429", "POST", router_c.url + "/v1/beams",
            {"datafiles": ["/b"], "tenant": "capped"})
        rec("all shedding capacity", "GET", router_s.url + "/v1/capacity")
        rec("all shedding", "POST", router_s.url + "/v1/beams",
            {"datafiles": ["/a"]})
    finally:
        for s in (router, router_c, router_s, capped, shed):
            s.stop()
        wa.stop()
        member.stop()


def _script_stream_and_token(P, root, rec):
    q = P.fq.get_ticket_queue(f"spool:{root}/spool")
    gw = P.GatewayServer(queue=q, outdir_base=f"{root}/results",
                         stream_root=f"{root}/stream",
                         token="sesame").start()
    geom = dict(P.profile, nchan=8, chunk_len=64, ndms=4)
    chunk = np.arange(8 * 64, dtype=np.float32).reshape(8, 64)
    tok = "sesame"
    try:
        u = gw.url + "/v1/stream/sA"
        rec("open no token", "POST", u + "/open", {"geometry": geom})
        rec("open wrong token", "POST", u + "/open",
            {"geometry": geom}, token="nope")
        rec("open", "POST", u + "/open", {"geometry": geom}, token=tok)
        rec("reopen", "POST", u + "/open", {"geometry": geom},
            token=tok)
        rec("conflict", "POST", u + "/open",
            {"geometry": dict(geom, nchan=16)}, token=tok)
        rec("no geometry", "POST", gw.url + "/v1/stream/sB/open", {},
            token=tok)
        frame = P.ingest.encode_frame(0, chunk, t_ingest=1.0)
        rec("chunk no token", "POST", u + "/chunks", frame, raw=True)
        rec("chunk", "POST", u + "/chunks", frame, token=tok, raw=True)
        rec("corrupt chunk", "POST", u + "/chunks", frame[:-3] + b"xyz",
            token=tok, raw=True)
        rec("unknown session chunk", "POST",
            gw.url + "/v1/stream/sZ/chunks", frame, token=tok, raw=True)
        rec("triggers open", "GET", u + "/triggers")
        rec("close no n_chunks", "POST", u + "/close", {}, token=tok)
        rec("close", "POST", u + "/close", {"n_chunks": 1}, token=tok)
        rec("chunk after close", "POST", u + "/chunks",
            P.ingest.encode_frame(1, chunk), token=tok, raw=True)
        P.ingest.append_triggers(gw.stream_root, "sA", [
            {"session": "sA", "span": 0, "dm": 1.0, "sigma": 7.5,
             "sample": 5, "time_s": 5e-4, "width": 1}])
        rec("triggers", "GET", u + "/triggers")
        rec("unknown triggers", "GET",
            gw.url + "/v1/stream/sZ/triggers")
        rec("bad action", "POST", u + "/bogus", {}, token=tok)
        rec("submit no token", "POST", gw.url + "/v1/beams",
            {"datafiles": ["/a"]})
        rec("ticket", "GET", gw.url + "/v1/tickets/stream-sA")
    finally:
        gw.stop()


def _script_blobs(P, root, rec):
    q = P.fq.get_ticket_queue(f"spool:{root}/spool")
    gw = P.GatewayServer(queue=q, outdir_base=f"{root}/results",
                         blob_root=f"{root}/cas", token="s3cret").start()
    router = P.GatewayServer(router=P.federation.FederationRouter(
        [("m", gw.url)], poll_timeout_s=2.0)).start()
    data = bytes(range(256)) * 4096 + b"tail"
    d = hashlib.sha256(data).hexdigest()
    try:
        u = gw.url + "/v1/blobs/"
        rec("put no token", "PUT", u + d, data, raw=True)
        rec("put", "PUT", u + d, data, token="s3cret", raw=True)
        rec("put again", "PUT", u + d, data, token="s3cret", raw=True)
        rec("put lying", "PUT", u + "0" * 64, data, token="s3cret",
            raw=True)
        rec("put bad digest", "PUT", u + "xyz", data, token="s3cret",
            raw=True)
        rec("get", "GET", u + d)
        rec("get upper-case", "GET", u + d.upper())
        rec("get missing", "GET", u + "0" * 64)
        rec("get bad digest", "GET", u + "not-a-digest")
        rec("router get", "GET", router.url + "/v1/blobs/" + d)
        rec("router get missing", "GET",
            router.url + "/v1/blobs/" + "0" * 64)
        outdir = f"{root}/out"
        os.makedirs(outdir)
        _write_candlist(outdir, sigmas=(11.0, 7.0, 5.0))
        q.submit("t1", ["beam.dat"], outdir)
        q.claim_next("w0")
        q.write_result("t1", "done", rc=0, outdir=outdir, worker="w0")
        rec("parse", "GET", gw.url + "/v1/candidates?min_sigma=6")
        idx = P.index.CandidateIndex(P.index.index_path(q.journal_root))
        try:
            idx.index_outdir("t1", outdir, {"beam.accelcands": d})
        finally:
            idx.close()
        rec("index", "GET", gw.url + "/v1/candidates?min_sigma=6")
        rec("index limit", "GET", gw.url + "/v1/candidates?limit=1")
        rec("forced parse", "GET",
            gw.url + "/v1/candidates?source=parse&ticket=t1")
        rec("result", "GET", gw.url + "/v1/results/t1")
        rec("alerts", "GET", gw.url + "/v1/alerts")
    finally:
        router.stop()
        gw.stop()


def _series(telemetry) -> dict:
    """The front door's and the data plane's counter series, without
    the requests whose count depends on timing: the client's polls of
    a ticket's status while it waits, and the router's capacity polls
    (one a member per 2 s TTL)."""
    snap = telemetry.metrics.REGISTRY.snapshot()
    return {(n, k): v for n, r in snap.items()
            if n.startswith(("tpulsar_gateway_", "tpulsar_frontdoor_",
                             "tpulsar_dataplane_"))
            and r["type"] == "counter"
            for k, v in r.get("series", {}).items()
            if not k.startswith(("ticket|", "capacity|"))}


@pytest.mark.parametrize("script", [
    _script_submit_and_query, _script_admission, _script_router,
    _script_stream_and_token, _script_blobs],
    ids=["submit_and_query", "admission", "router", "stream_and_token",
         "blobs"])
def test_gateway_answers_match_the_jax_gateway(script, tmp_path):
    """One request script against a JAX gateway and against the
    port's: the same status codes, Retry-After values (the seeded
    jitter), authentication challenges and masked JSON, and the same
    increments of every gateway, router and data-plane counter."""
    answers, moved = {}, {}
    for name, P in PKGS.items():
        root = str(tmp_path / name)
        os.makedirs(root)
        rec = _Script(root)
        before = _series(P.telemetry)
        script(P, root, rec)
        after = _series(P.telemetry)
        answers[name] = rec.seen
        moved[name] = {k: v - before.get(k, 0.0)
                       for k, v in after.items()
                       if v != before.get(k, 0.0)}
    for j, t in zip(answers["jax"], answers["torch"]):
        assert t == j
    assert len(answers["torch"]) == len(answers["jax"])
    assert moved["torch"] == moved["jax"]
    assert moved["torch"]


# -------------------------------------- the gateway as its own process

_IMPORT_PROBE = r"""
import json, sys, urllib.request
from tpulsar_torch.frontdoor.gateway import GatewayServer
from tpulsar_torch.frontdoor.queue import get_ticket_queue
q = get_ticket_queue("sqlite:" + sys.argv[1])
gw = GatewayServer(queue=q, outdir_base=sys.argv[2], token="t").start()
try:
    with urllib.request.urlopen(gw.url + "/v1/capacity") as resp:
        cap = json.load(resp)
    with urllib.request.urlopen(gw.url + "/metrics") as resp:
        resp.read()
finally:
    gw.stop()
import torch
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tpulsar" or m.startswith("tpulsar."))
print(json.dumps({"cap": cap, "cuda_initialized":
                  torch.cuda.is_initialized(), "bad": bad}))
"""


def test_gateway_leaves_cuda_uninitialized(tmp_path):
    """A fresh process that imports the gateway, serves requests over
    a sqlite queue and stops it has not initialized CUDA (the gateway
    runs beside the server that holds the card, or on a host with no
    GPU) and loaded nothing of jax or tpulsar."""
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE, str(tmp_path / "q.db"),
         str(tmp_path / "res")],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"cap": {"capacity": -1, "fresh_workers": 0,
                           "pending": 0, "backend": "sqlite",
                           "role": "gateway"},
                   "cuda_initialized": False, "bad": []}


def test_gateway_command_serves_and_stops(tmp_path):
    """`python -m tpulsar_torch gateway --queue sqlite:… --blob-root …
    --port 0` prints its URL, serves with the token it was given,
    stops on SIGTERM with exit 0 and exports its metrics."""
    cfg = _config_file(tmp_path, dm_max=8.0)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpulsar_torch", "--config", cfg,
         "gateway", "--queue", f"sqlite:{tmp_path / 'q.db'}",
         "--blob-root", str(tmp_path / "cas"), "--port", "0"],
        env=dict(os.environ, PYTHONPATH=ROOT,
                 TPULSAR_GATEWAY_TOKEN="tok"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(tmp_path))
    try:
        m = None
        for line in proc.stdout:
            m = re.match(r"gateway: (http://\S+) \(front of ", line)
            if m:
                break
        assert m, proc.stderr.read() if proc.poll() else ""
        url = m.group(1)
        with pytest.raises(urllib.error.HTTPError) as ei:
            jax_gateway._http(url + "/v1/blobs/" + hashlib.sha256(
                b"x").hexdigest(), b"x", method="PUT", raw=True)
        assert ei.value.code == 401
        code, got = jax_gateway._http(
            url + "/v1/blobs/" + hashlib.sha256(b"x").hexdigest(), b"x",
            method="PUT", raw=True, token="tok")
        assert code == 201 and got["bytes"] == 1
        assert (tmp_path / "cas" / "objects").is_dir()
        code, got = jax_gateway._http(url + "/v1/capacity")
        assert got["backend"] == "sqlite"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "gateway: stopped" in out
    assert (tmp_path / "logs" / "metrics" / "gateway.prom").exists()


# --------------------------------------------------- the slice as a whole

TOKEN = "slice-token"


def _results_diff():
    path = os.path.join(ROOT, "tools", "torch_results_diff.py")
    spec = importlib.util.spec_from_file_location("torch_results_diff",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve_by_digest(P, Server, cfgmod, root, fns, mp) -> dict:
    """One package's whole flow: a token'd gateway on a sqlite queue
    with a CAS, `blob put` of the beam's files through the package's
    CLI, submit_beam with blobs=, the package's SearchServer on the
    same queue with TPULSAR_DATA_URL set (a daemon thread, drained
    once the result is in), then the answers the gateway gives."""
    db = os.path.join(root, "q.db")
    mp.setenv("TPULSAR_GATEWAY_TOKEN", TOKEN)
    gw = P.GatewayServer(queue=P.fq.get_ticket_queue(f"sqlite:{db}"),
                         outdir_base=os.path.join(root, "results"),
                         blob_root=os.path.join(root, "cas")).start()
    out = {"gw": gw, "db": db, "root": root}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert P.main(["blob", "put", *fns, "--url", gw.url,
                       "--token", TOKEN]) == 0
    blobs = {}
    for line in buf.getvalue().splitlines():
        digest, path = line.split("  ", 1)
        blobs[os.path.basename(path)] = digest
    assert sorted(blobs) == sorted(os.path.basename(f) for f in fns)
    out["blobs"] = blobs
    mp.setenv("TPULSAR_DATA_URL", gw.url)
    kw = dict(device="cpu") if P.name == "torch" else {}
    srv = Server(spool=os.path.join(root, "spool"), cfg=cfgmod.settings(),
                 queue_url=f"sqlite:{db}", warm_boot=False, poll_s=0.05,
                 heartbeat_interval_s=0.5, **kw)
    th = threading.Thread(target=srv.serve, daemon=True)
    th.start()
    try:
        deadline = time.time() + 60
        while P.client.capacity(gw.url)["capacity"] <= 0:
            assert time.time() < deadline, "the server never heartbeat"
            time.sleep(0.05)
        rec = P.client.submit_beam(gw.url, sorted(blobs),
                                   outdir=os.path.join(root, "out"),
                                   blobs=blobs, job_id=1)
        out["ticket"] = rec["ticket"]
        out["result"] = P.client.wait_for_result(
            gw.url, rec["ticket"], timeout_s=300, poll_s=0.1)
    finally:
        srv.request_drain()
        th.join(timeout=60)
    assert not th.is_alive()
    out["beams"] = srv.beams
    mp.delenv("TPULSAR_DATA_URL")
    return out


@contextlib.contextmanager
def _slice_env(root):
    """The slice's configuration (the DM window 0-8, paths under root)
    installed in both packages, as TPULSAR_CONFIG would, with the
    data-plane knobs cleared; undone on exit."""
    with pytest.MonkeyPatch.context() as mp, restore_job_globals():
        for var in ("TPULSAR_GATEWAY_TOKEN", "TPULSAR_DATA_URL",
                    "TPULSAR_BLOB_ROOT", "TPULSAR_QUEUE_URL"):
            mp.delenv(var, raising=False)
        mp.setenv("TPULSAR_DD_FAMILY", "direct")
        cfg = _config_file(root, dm_max=8.0)
        mp.setenv("TPULSAR_CONFIG", cfg)
        jcfg.set_settings(jcfg.load_config(cfg))
        tcfg.set_settings(tcfg.load_config(cfg))
        try:
            yield mp, cfg
        finally:
            jcfg.set_settings(jcfg.TpulsarConfig())
            tcfg.set_settings(None)


@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    """The slice's beam: a Mock subband pair (two PSRFITS files, the
    real P2030 basenames) with an injected pulsar."""
    root = tmp_path_factory.mktemp("slice")
    return root, _subband_pair(root / "beam")


def _flow(beam, name, Server, cfgmod):
    root, fns = beam
    sub = root / name
    os.makedirs(sub)
    with _slice_env(sub) as (mp, cfg):
        f = _serve_by_digest(PKGS[name], Server, cfgmod, str(sub), fns,
                             mp)
    f.update(fns=fns, cfg=cfg)
    return f


@pytest.fixture(scope="module")
def sliced(beam):
    """The port's flow on the beam; its gateway stays up for this
    module's slice tests."""
    f = _flow(beam, "torch", SearchServer, tcfg)
    yield f
    f["gw"].stop()


@pytest.fixture(scope="module")
def sliced_jax(beam):
    """The JAX package's flow on the same beam."""
    f = _flow(beam, "jax", JSearchServer, jcfg)
    yield f
    f["gw"].stop()


def test_slice_served_by_digest_and_answered_over_http(sliced, tmp_path,
                                                       capsys):
    """Uploaded by digest, queued in SQLite, served by the port: the
    result is done and carries its artifacts' digests, the journal
    shows the stage-in and the artifact push, /v1/candidates answers
    from the index with the pulsar in it, `blob get` of each artifact
    gives the outdir's bytes, and `index fsck` and `queue fsck` are
    clean."""
    f = sliced
    url, tid, res = f["gw"].url, f["ticket"], f["result"]
    assert res["status"] == "done", res
    assert f["beams"] == {"done": 1, "failed": 0, "skipped": 0}
    assert res["candidates"] >= 1
    outdir = res["outdir"]
    names = sorted(n for n in os.listdir(outdir)
                   if n.endswith(".accelcands"))
    assert sorted(res["artifacts"]) == names
    evs = [e["event"] for e in tjournal.read_events(f["root"],
                                                   ticket=tid)]
    assert evs[:2] == ["received", "submitted"]
    assert "stagein_done" in evs and "artifact_push" in evs
    assert evs[-1] == "result"
    cands = tclient.query_candidates(url, ticket=tid)
    assert cands["source"] == "index"
    assert cands["total"] == res["candidates"]
    assert any(abs(c["period_s"] - 0.25) < 1e-3
               for c in cands["candidates"]), cands["candidates"][:5]
    assert tclient.result(url, tid)["candidates"] == \
        tindex.candidate_rows(outdir)
    for name, digest in res["artifacts"].items():
        dest = tmp_path / name
        assert tmain(["blob", "get", digest, "--url", url,
                      "--out", str(dest)]) == 0
        with open(os.path.join(outdir, name), "rb") as fh:
            assert dest.read_bytes() == fh.read()
    capsys.readouterr()
    assert tmain(["index", "fsck", "--queue", f"sqlite:{f['db']}"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] is True and rep["results"] == 1
    assert tmain(["queue", "fsck", f"sqlite:{f['db']}"]) == 0
    assert "fsck: clean" in capsys.readouterr().out


def test_slice_equals_the_direct_search_beam(sliced, tmp_path):
    """The served results directory equals the port's search_beam of
    the same beam, prepared as the job prepares it: exactly."""
    fns = sliced["fns"]
    os.makedirs(tmp_path / "work")
    cfg = tcfg.load_config(sliced["cfg"])
    ppfns, zap = tjob.prepare_inputs(fns, str(tmp_path / "work"),
                                     cfg=cfg)
    params = tex.SearchParams.from_config(cfg.searching)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPULSAR_DD_FAMILY", "direct")
        out = tex.search_beam(ppfns, str(tmp_path / "work"),
                              str(tmp_path / "results"), params,
                              zaplist=zap, device="cpu")
    served = sliced["result"]["outdir"]
    assert _results_diff().diff_results(served, out.resultsdir) == []


def test_slice_agrees_with_the_jax_flow(sliced, sliced_jax):
    """The JAX package's gateway, CAS and server ran the same flow on
    the same files: the same blob digests, the same result record
    apart from timing, identity and compile accounting, results
    directories equal at rtol 1e-5, and the same candidate rows
    answered from each index at that tolerance."""
    j, t = sliced_jax, sliced
    assert t["blobs"] == j["blobs"]
    differ = {"ticket", "beam_seconds", "finished_at", "trace_id",
              "outdir", "compile_hits", "compile_misses", "warm",
              "artifacts"}
    rj, rt = j["result"], t["result"]
    assert rt.keys() == rj.keys()
    assert {k: v for k, v in rt.items() if k not in differ} == \
        {k: v for k, v in rj.items() if k not in differ}
    assert sorted(rt["artifacts"]) == sorted(rj["artifacts"])
    assert _results_diff().diff_results(rt["outdir"], rj["outdir"],
                                        rtol=1e-5) == []
    cj = jclient.query_candidates(j["gw"].url, ticket=j["ticket"])
    ct = tclient.query_candidates(t["gw"].url, ticket=t["ticket"])
    assert ct["source"] == cj["source"] == "index"
    assert ct["total"] == cj["total"]
    for a, b in zip(ct["candidates"], cj["candidates"]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], float):
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6), k
            elif k != "ticket":
                assert a[k] == b[k], k
