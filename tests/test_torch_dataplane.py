"""The port's blob data plane against the JAX package's: the
content-addressed store (dataplane/blobstore.py), its HTTP client
(dataplane/transfer.py), the gateway's blob and candidate routes, the
router's cross-host blob fetch and the server's by-digest stage-in.

The JAX package's own tests of tests/test_dataplane.py run here on the
port's modules (their module globals pointed at the port's, as
test_torch_serve.py does for the queue contract); the stage-in cases,
which import the stage-in module inside their bodies, are written out
against the port's; the chaos cases (the spool-less storm, the
packaged dataplane_smoke scenario, the scenario's data-plane rules)
run on the port's chaos harness, whose modules they import inside
their bodies.  A store one package writes is verified and served by
the other package's store and gateway, in both directions.

Everything compares exactly: bytes, digests, refcounts, index rows.
No device work; each test takes well under a second."""

from __future__ import annotations

import inspect
import os
import types

import pytest

torch = pytest.importorskip("torch")

import test_dataplane as jax_dataplane  # noqa: E402
import tpulsar.chaos.runner  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401
from tpulsar.dataplane import blobstore as jblobstore  # noqa: E402
from tpulsar.dataplane import transfer as jtransfer  # noqa: E402
from tpulsar.frontdoor import queue as jfq  # noqa: E402
from tpulsar.frontdoor.gateway import GatewayServer as JGateway  # noqa: E402
from tpulsar.resilience import faults as jfaults  # noqa: E402
from tpulsar_torch.chaos import invariants as tinvariants  # noqa: E402
from tpulsar_torch.chaos import runner as trunner  # noqa: E402
from tpulsar_torch.chaos import scenario as tscenario  # noqa: E402
from tpulsar_torch.dataplane import blobstore as tblobstore  # noqa: E402
from tpulsar_torch.dataplane import index as tindex  # noqa: E402
from tpulsar_torch.dataplane import transfer as ttransfer  # noqa: E402
from tpulsar_torch.frontdoor import client as tclient  # noqa: E402
from tpulsar_torch.frontdoor import federation as tfederation  # noqa: E402
from tpulsar_torch.frontdoor import queue as tfq  # noqa: E402
from tpulsar_torch.frontdoor import results as tresults  # noqa: E402
from tpulsar_torch.frontdoor.gateway import GatewayServer  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402
from tpulsar_torch.serve import stagein as tstagein  # noqa: E402

#: the JAX tests reach the outdir parse as results._candidate_rows; the
#: port keeps that parse once, as dataplane/index.py::candidate_rows
_RESULTS = types.SimpleNamespace(
    _candidate_rows=tindex.candidate_rows,
    query_candidates=tresults.query_candidates,
    result_with_candidates=tresults.result_with_candidates)


def _port(name: str):
    """tests/test_dataplane.py's test `name`, its module globals
    pointed at the port's modules."""
    fn = getattr(jax_dataplane, name)
    glb = dict(fn.__globals__, blobstore=tblobstore, dp_index=tindex,
               transfer=ttransfer, client=tclient,
               federation=tfederation, fq=tfq, results=_RESULTS,
               GatewayServer=GatewayServer, faults=tfaults)
    return types.FunctionType(fn.__code__, glb, fn.__name__,
                              fn.__defaults__, fn.__closure__)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    tfaults.reset()
    jfaults.reset()
    for var in ("TPULSAR_BLOB_ROOT", "TPULSAR_DATA_URL",
                "TPULSAR_GATEWAY_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    yield
    tfaults.reset()
    jfaults.reset()


@pytest.fixture()
def blob_gw(tmp_path):
    """The port's gateway over a spool queue with a CAS mounted."""
    q = tfq.get_ticket_queue(str(tmp_path / "spool"))
    server = GatewayServer(
        queue=q, outdir_base=str(tmp_path / "results"),
        blob_root=str(tmp_path / "cas")).start()
    yield server
    server.stop()


# ------------------------------------------------ the CAS contract

@pytest.mark.parametrize("name", [
    "test_put_get_roundtrip_and_dedup",
    "test_put_file_and_fetch_to_are_verified",
    "test_claimed_digest_mismatch_stores_nothing",
    "test_verify_and_read_detect_corruption",
    "test_gc_respects_refs_and_ttl",
    "test_gc_collects_orphaned_ingest_tmp",
    "test_blobstore_io_fault_point_fires",
    "test_index_rows_match_legacy_parse_exactly",
    "test_index_reindex_is_idempotent",
    "test_index_query_shape_and_limit_refusal",
    "test_index_rebuild_from_queue_outdirs",
    "test_index_fsck_reports_counts",
    "test_results_query_truncation_is_explicit",
])
def test_store_and_index_contract(name, tmp_path):
    _port(name)(tmp_path)


@pytest.mark.parametrize("name", [
    "test_http_blob_roundtrip_digest_verified",
    "test_http_blob_put_rejects_lying_address",
    "test_candidates_answered_from_index_with_parse_fallback",
])
def test_gateway_blob_routes(name, blob_gw, tmp_path):
    _port(name)(blob_gw, tmp_path)


def test_http_blob_bad_digest_is_400(blob_gw):
    _port("test_http_blob_bad_digest_is_400")(blob_gw)


def test_gateway_token_gates_mutating_routes(tmp_path, monkeypatch):
    _port("test_gateway_token_gates_mutating_routes")(tmp_path,
                                                      monkeypatch)


@pytest.mark.parametrize("name", [
    "test_router_open_blob_falls_through_to_the_holder",
    "test_router_open_blob_raises_when_nobody_has_it",
])
def test_router_blob_fetch(name):
    _port(name)()


# --------------------------------------------- by-digest stage-in

def test_stage_blobs_fetches_by_digest_from_local_cas(tmp_path,
                                                      monkeypatch):
    store = tblobstore.BlobStore(str(tmp_path / "cas"))
    d1 = store.put_bytes(b"beam one")
    d2 = store.put_bytes(b"beam two")
    monkeypatch.setenv("TPULSAR_BLOB_ROOT", str(tmp_path / "cas"))
    workdir = str(tmp_path / "work")
    os.makedirs(workdir)
    staged = tstagein._stage_blobs(
        {"ticket": "t1", "blobs": {"b.dat": d2, "a.dat": d1}}, workdir)
    assert [os.path.basename(p) for p in staged] == ["a.dat", "b.dat"]
    with open(staged[0], "rb") as fh:
        assert fh.read() == b"beam one"


def test_stage_blobs_over_http(blob_gw, tmp_path):
    digest = ttransfer.put_bytes(blob_gw.url, b"remote beam")
    workdir = str(tmp_path / "work")
    os.makedirs(workdir)
    staged = tstagein._stage_blobs(
        {"ticket": "t1", "data_url": blob_gw.url,
         "blobs": {"beam.dat": digest}}, workdir)
    with open(staged[0], "rb") as fh:
        assert fh.read() == b"remote beam"


def test_stagein_fetch_fault_is_contained_per_ticket(tmp_path,
                                                     monkeypatch):
    """An injected stagein.fetch failure is this beam's
    PreparedBeam.error, never an escape from the stage-in pipeline."""
    store = tblobstore.BlobStore(str(tmp_path / "cas"))
    digest = store.put_bytes(b"beam")
    monkeypatch.setenv("TPULSAR_BLOB_ROOT", str(tmp_path / "cas"))
    tfaults.configure("stagein.fetch:unimplemented:count=1,errno=EIO")
    ticket = {"ticket": "t1", "datafiles": ["beam.dat"],
              "blobs": {"beam.dat": digest}}
    prep = tstagein.prepare_beam(ticket, str(tmp_path / "work"))
    assert prep.error and "stagein.fetch" in prep.error
    staged = tstagein._stage_blobs(ticket, str(tmp_path / "work2"))
    assert os.path.exists(staged[0])


def test_ticket_with_no_blob_source_fails_contained(tmp_path):
    prep = tstagein.prepare_beam(
        {"ticket": "t1", "datafiles": ["beam.dat"],
         "blobs": {"beam.dat": "a" * 64}}, str(tmp_path / "work"))
    assert "no data plane is configured" in prep.error


def test_stage_blobs_refuses_a_lying_store(tmp_path, monkeypatch):
    """A stored object rotted behind the store's back: the digest is
    re-verified on the way out, so stage-in fails instead of staging
    wrong bytes (and leaves no file at the destination)."""
    store = tblobstore.BlobStore(str(tmp_path / "cas"))
    digest = store.put_bytes(b"good beam")
    with open(store.object_path(digest), "r+b") as fh:
        fh.write(b"BAD")
    monkeypatch.setenv("TPULSAR_BLOB_ROOT", str(tmp_path / "cas"))
    prep = tstagein.prepare_beam(
        {"ticket": "t1", "datafiles": ["beam.dat"],
         "blobs": {"beam.dat": digest}}, str(tmp_path / "work"))
    assert "BlobVerifyError" in prep.error
    assert os.listdir(tmp_path / "work") == []


# ------------------------------------------ the spool-less chaos storm

@pytest.mark.parametrize("name", [
    "test_spoolless_storm_stages_by_digest_and_indexes",
    "test_packaged_dataplane_scenario_loads",
    "test_scenario_dataplane_validation",
])
def test_chaos_dataplane_case(name, tmp_path, monkeypatch):
    """tests/test_dataplane.py's chaos cases on the port's harness: the
    spool-less storm (two of the port's stub workers staging in by
    digest from the port's gateway CAS, one SIGKILLed; every artifact
    re-hashes clean, the index rows equal the outdir parse, the port's
    verifier clean), the packaged scenario and its validation."""
    monkeypatch.setattr(tpulsar.chaos, "invariants", tinvariants)
    monkeypatch.setattr(tpulsar.chaos, "runner", trunner)
    monkeypatch.setattr(tpulsar.chaos, "scenario", tscenario)
    fn = _port(name)
    if inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()


# --------------------------------------- a CAS across the packages

PKGS = {
    "jax": types.SimpleNamespace(blobstore=jblobstore,
                                 transfer=jtransfer, fq=jfq,
                                 GatewayServer=JGateway),
    "torch": types.SimpleNamespace(blobstore=tblobstore,
                                   transfer=ttransfer, fq=tfq,
                                   GatewayServer=GatewayServer),
}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_cas_across_packages(tmp_path, writer, reader):
    """A store one package wrote (objects, refs) verifies, reads,
    counts and keeps its pinned objects through the other package's
    BlobStore, and the other package's gateway serves it to the
    writer's transfer client; bytes the writer's client PUTs into the
    other's gateway verify in the writer's store."""
    w, r = PKGS[writer], PKGS[reader]
    root = str(tmp_path / "cas")
    src = tmp_path / "P2030_beam.fits"
    src.write_bytes(os.urandom(3 << 20) + b"tail")
    ws = w.blobstore.BlobStore(root)
    d_file = ws.put_file(str(src))
    d_loose = ws.put_bytes(b"an unreferenced artifact")
    ws.add_ref(d_file, "ticket-1")
    assert d_file == w.blobstore.BlobStore(root).put_file(str(src))

    rs = r.blobstore.BlobStore(root)
    assert rs.verify(d_file) and rs.verify(d_loose)
    assert rs.refcount(d_file) == 1 and rs.refcount(d_loose) == 0
    assert rs.stats() == ws.stats()
    assert rs.read_bytes(d_loose) == b"an unreferenced artifact"
    dest = tmp_path / "fetched.fits"
    assert rs.fetch_to(d_file, str(dest)) == src.stat().st_size
    assert dest.read_bytes() == src.read_bytes()

    gw = r.GatewayServer(
        queue=r.fq.get_ticket_queue(str(tmp_path / "spool")),
        outdir_base=str(tmp_path / "res"), blob_root=root).start()
    try:
        got = tmp_path / "over_http.fits"
        assert w.transfer.get_to_file(gw.url, d_file, str(got)) \
            == src.stat().st_size
        assert got.read_bytes() == src.read_bytes()
        d_put = w.transfer.put_bytes(gw.url, b"pushed by the writer")
        assert d_put == w.blobstore.BlobStore(root).put_bytes(
            b"pushed by the writer")
        assert w.blobstore.BlobStore(root).verify(d_put)
    finally:
        gw.stop()
    # the reader's gc keeps the writer's pinned object, drops the rest
    rep = rs.gc(ttl_s=0.0, now=os.path.getmtime(
        rs.object_path(d_file)) + 10)
    assert rep["kept"] == 1 and rs.has(d_file)
    assert not ws.has(d_loose)
