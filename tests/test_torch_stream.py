"""The port's streaming plane (tpulsar_torch/stream/) against the JAX
package's (tpulsar/stream/): the same seeded numpy chunks through both.

Held bit-exact (np.array_equal, no tolerance): the pad bucket and the
shift table; the chunked series against the batch dedispersion for
the torch and numpy backends at several chunk lengths; the port's
torch-backend series against the JAX package's
StreamDedisp(backend="jax"); a carry checkpointed by either package
and continued by the other; frames, manifests and triggers.jsonl
written by either package and read by the other.  Held at the SP
tolerance of test_torch_default_golden.py (test_torch_slice's
_assert_events_match: sigma at rtol SP_SIGMA_RTOL, 1% of events may
move within their 32-sample cluster, since the two packages' float32
cumsums differ in order): the single-pulse search of one span.  The
stream telemetry families are held to the JAX catalog by
test_torch_obs.py's family check.

The worker and the server run as subprocesses on the CPU
(``--device cpu``); every wait has its own time limit, and a worker
is parked for its SIGKILL by a fault point (``stream.ingest:hang``),
not raced by a sleep."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_checkpoint import ROOT  # noqa: E402
from test_torch_slice import (  # noqa: E402, F401 (an autouse fixture)
    _assert_events_match, one_torch_thread)
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
from tpulsar.constants import dispersion_delay_s  # noqa: E402
from tpulsar.frontdoor.queue import get_ticket_queue  # noqa: E402
from tpulsar.kernels import dedisperse as jdd  # noqa: E402
from tpulsar.kernels import singlepulse as jsp  # noqa: E402
from tpulsar.obs import journal as jjournal  # noqa: E402
from tpulsar.stream import STREAM_PROFILE as JPROFILE  # noqa: E402
from tpulsar.stream import dedisp_state as jds  # noqa: E402
from tpulsar.stream import ingest as jingest  # noqa: E402
from tpulsar.stream import trigger as jtrg  # noqa: E402
from tpulsar_torch import checkpoint as tckpt  # noqa: E402
from tpulsar_torch.kernels import dedisperse as tdd  # noqa: E402
from tpulsar_torch.kernels import singlepulse as tsp  # noqa: E402
from tpulsar_torch.stream import STREAM_PROFILE  # noqa: E402
from tpulsar_torch.stream import dedisp_state as tds  # noqa: E402
from tpulsar_torch.stream import ingest as tingest  # noqa: E402
from tpulsar_torch.stream import trigger as ttrg  # noqa: E402

#: the CPU geometries: the stream profile and two Mock-like widths
GEOMS = {"profile": {},
         "nchan96": {"nchan": 96},
         "ndms76": {"ndms": 76}}
#: small sessions for the chunked/batch and worker tests
SMALL = {"nchan": 32, "ndms": 16}
#: every subprocess wait's limit (seconds)
PROC_TIMEOUT = 120


def _geom(**over):
    g = dict(STREAM_PROFILE)
    g.update(over)
    return g


def _series(geom, n_chunks, seed=0, pulse_dm=12.0, pulse_t=2000,
            amp=8.0):
    """Noise + one dispersed pulse at pulse_dm (seeded numpy)."""
    rng = np.random.default_rng(seed)
    T = n_chunks * geom["chunk_len"]
    data = rng.normal(0, 1, (geom["nchan"], T)).astype(np.float32)
    freqs, _ = jds.geometry_freqs_dms(geom)
    sh = np.round(dispersion_delay_s(pulse_dm, freqs, float(freqs[-1]))
                  / geom["dt"]).astype(int)
    for c in range(geom["nchan"]):
        s = pulse_t + sh[c]
        if s + 3 <= T:
            data[c, s:s + 3] += amp
    return data


def _stream_all(cls, geom, data, **kw):
    sd = cls(geom, **kw)
    cl = geom["chunk_len"]
    blocks = []
    for k in range(data.shape[1] // cl):
        blocks += sd.append(data[:, k * cl:(k + 1) * cl])
    blocks += sd.flush()
    return np.concatenate(blocks, axis=1), sd


def _control(geom, chunks, session, backend):
    """The in-process control of a session: the frames (None = a gap,
    zero-filled as the worker fills it) through the port's
    StreamDedisp and SpanTrigger on the CPU -> (digest, records)."""
    sd = tds.StreamDedisp(geom, backend=backend, device="cpu")
    tg = ttrg.SpanTrigger(geom, session=session, backend=backend,
                          device="cpu")
    recs = []
    for ch in chunks:
        if ch is None:
            ch = np.zeros((sd.nchan, sd.chunk_len), np.float32)
        for blk in sd.append(ch):
            for _, r in tg.feed(blk):
                recs += r
    for blk in sd.flush():
        for _, r in tg.feed(blk):
            recs += r
    for _, r in tg.flush():
        recs += r
    return ttrg.trigger_digest(recs), recs


# ------------------------------------------------------------ geometry

def test_profile_and_pad_bucket_match_jax():
    assert STREAM_PROFILE == JPROFILE
    for m in (0, 1, 100, 255, 256, 257, 1000, 5000, 16136):
        assert tds.pad_bucket(m) == jds.pad_bucket(m) \
            == tdd._pad_bucket(m) == jdd._pad_bucket(m)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_shift_table_and_window_match_jax(name):
    geom = _geom(**GEOMS[name])
    freqs, dms = tds.geometry_freqs_dms(geom)
    jfreqs, jdms = jds.geometry_freqs_dms(geom)
    assert np.array_equal(freqs, jfreqs) and np.array_equal(dms, jdms)
    sh = tds.shift_table(geom)
    assert sh.dtype == np.int32
    assert np.array_equal(sh, jds.shift_table(geom))
    assert np.array_equal(sh, tdd.stream_shift_table(freqs, dms,
                                                     geom["dt"]))
    assert np.array_equal(sh, jdd.stream_shift_table(freqs, dms,
                                                     geom["dt"]))
    m = int(sh.max())
    assert tdd.stream_window_width(geom["chunk_len"], m) \
        == jdd.stream_window_width(geom["chunk_len"], m) \
        == tds.StreamDedisp(geom, device="cpu").window_width


# --------------------------------------------------------- dedispersion

@pytest.mark.parametrize("chunk_len", [997, 1024, 128])
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_chunked_bit_identical_to_batch(chunk_len, backend):
    """The chunked run equals the batch dedispersion of the whole
    block bit for bit (the port's dedisperse_stream_batch and the JAX
    package's), for chunk lengths on every side of the carry size
    (maxshift ~183 samples here)."""
    geom = _geom(chunk_len=chunk_len, **SMALL)
    n_chunks = max(3, 4096 // chunk_len + 2)
    data = _series(geom, n_chunks, seed=chunk_len)
    stream, sd = _stream_all(tds.StreamDedisp, geom, data,
                             backend=backend, device="cpu")
    batch = tdd.dedisperse_stream_batch(torch.from_numpy(data),
                                        sd.shifts).numpy()
    assert stream.shape == batch.shape == (geom["ndms"], data.shape[1])
    assert np.array_equal(stream, batch)
    assert np.array_equal(batch, np.asarray(
        jdd.dedisperse_stream_batch(data, sd.shifts)))
    assert sd.emitted == data.shape[1]


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_torch_backend_matches_the_jax_class(name):
    """The port's torch-backend series equals the JAX package's
    StreamDedisp(backend="jax") series, emission by emission."""
    geom = _geom(**GEOMS[name])
    data = _series(geom, 4, seed=5, pulse_dm=20.0, pulse_t=700)
    sd = tds.StreamDedisp(geom, backend="torch", device="cpu")
    jsd = jds.StreamDedisp(geom, backend="jax")
    cl = geom["chunk_len"]
    for k in range(4):
        got = sd.append(data[:, k * cl:(k + 1) * cl])
        want = jsd.append(data[:, k * cl:(k + 1) * cl])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    got, want = sd.flush(), jsd.flush()
    assert len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_stream_step_keeps_the_first_chunk_len_columns():
    """dedisperse_stream_step on a CPU window is the plain window scan
    of the first chunk_len columns, equal to the stage-2 plain version
    over the whole window cut to them (the kernel's route on the card)
    and to the reference's step; a window too narrow is refused."""
    from tpulsar_torch.kernels import cuda_dd

    geom = _geom(nchan=16, ndms=8)
    sd = tds.StreamDedisp(geom, device="cpu")
    rng = np.random.default_rng(3)
    win = rng.normal(size=(16, sd.window_width)).astype(np.float32)
    got = tdd.dedisperse_stream_step(torch.from_numpy(win), sd.shifts,
                                     sd.chunk_len)
    assert got.shape == (8, sd.chunk_len)
    full = cuda_dd.dedisperse_subbands_plain(torch.from_numpy(win),
                                             sd.shifts)
    assert torch.equal(got, full[:, :sd.chunk_len])
    assert np.array_equal(got.numpy(), np.asarray(
        jdd.dedisperse_stream_step(win, sd.shifts, sd.chunk_len)))
    with pytest.raises(ValueError, match="window"):
        tdd.dedisperse_stream_step(torch.from_numpy(win[:, :sd.chunk_len]),
                                   sd.shifts, sd.chunk_len)


def test_stage2_shared_memory_at_stream_widths():
    """The stage-2 launch of the 960-channel, 1024-DM Mock session fits
    a block's shared memory (a span of 300 samples: 165,648 B of
    232,448); a geometry whose shifts spread further within a row group
    is refused with ValueError before any launch (there is no other
    path on the card)."""
    from tpulsar_torch.kernels import cuda_dd

    mock = dict(nchan=960, chunk_len=16384, ndms=1024, dt=65.476e-6,
                f_lo_mhz=1214.36, f_hi_mhz=1536.64, dm_max=1000.0,
                span_chunks=4)
    sh = tds.shift_table(mock)
    assert int(sh.max()) == 16136 and tds.pad_bucket(16136) == 16384
    plan = cuda_dd.stage2_launch(sh)
    assert (plan.groups, plan.rows, plan.span, plan.smem_bytes) == \
        (52, 20, 300, 165_648)
    wide = tds.shift_table(dict(mock, ndms=64, dm_max=10000.0))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_dd.stage2_launch(wide)


# -------------------------------------------------------------- carries

@pytest.mark.parametrize("first, then", [("jax", "torch"),
                                         ("torch", "jax")],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_carry_resumes_across_packages(first, then):
    """A carry checkpointed mid-session by one package's class
    (state_bytes) and restored into the other's continues to the
    series of an uninterrupted run, bit for bit."""
    geom = _geom(**SMALL)
    data = _series(geom, 6, seed=21)
    cl = geom["chunk_len"]
    make = {"jax": lambda: jds.StreamDedisp(geom, backend="jax"),
            "torch": lambda: tds.StreamDedisp(geom, backend="torch",
                                              device="cpu")}
    ref, _ = _stream_all(tds.StreamDedisp, geom, data, device="cpu")
    a = make[first]()
    blocks = []
    for k in range(3):
        blocks += a.append(data[:, k * cl:(k + 1) * cl])
    b = make[then]()
    b.restore(a.state_bytes())
    assert b.emitted == a.emitted and np.array_equal(b.buf, a.buf)
    for k in range(3, 6):
        blocks += b.append(data[:, k * cl:(k + 1) * cl])
    blocks += b.flush()
    assert np.array_equal(np.concatenate(blocks, axis=1), ref)


def test_restore_refuses_another_geometry():
    a = tds.StreamDedisp(_geom(**SMALL), device="cpu")
    a.append(np.ones((32, 1024), np.float32))
    b = tds.StreamDedisp(_geom(nchan=16, ndms=16), device="cpu")
    with pytest.raises(ValueError, match="nchan"):
        b.restore(a.state_bytes())


# --------------------------------------------------------------- ingest

@pytest.mark.parametrize("writer, reader", [(jingest, tingest),
                                            (tingest, jingest)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_frames_and_sessions_cross_packages(writer, reader, tmp_path):
    """A session opened, fed and closed by one package's ingest is
    read by the other's: the same manifest fingerprint, frames that
    decode to the same chunk, corruption refused, triggers.jsonl read
    back."""
    root = str(tmp_path)
    geom = _geom()
    man = writer.open_session(root, "s1", geom)
    assert man["fingerprint"] == reader.geometry_fingerprint(geom)
    assert reader.open_session(root, "s1", dict(geom)) == man
    with pytest.raises(reader.StreamError):
        reader.open_session(root, "s1", _geom(nchan=128))
    chunk = np.arange(geom["nchan"] * geom["chunk_len"],
                      dtype=np.float32).reshape(geom["nchan"], -1)
    blob = writer.encode_frame(0, chunk, t_ingest=1.5)
    assert blob == reader.encode_frame(0, chunk, t_ingest=1.5)
    writer.append_chunk(root, "s1", 0, chunk, t_ingest=1.5)
    header, arr = reader.read_chunk(root, "s1", 0)
    assert header["seq"] == 0 and header["t_ingest"] == 1.5
    np.testing.assert_array_equal(arr, chunk)
    assert reader.landed_seqs(root, "s1") == [0]
    assert reader.read_chunk(root, "s1", 1) is None
    writer.close_session(root, "s1", 1)
    assert reader.read_manifest(root, "s1")["closed"] is True
    recs = [{"session": "s1", "span": 0, "dm": 1.0, "sigma": 7.0,
             "sample": 10, "time_s": 0.001, "width": 3}]
    writer.append_triggers(root, "s1", recs)
    assert reader.read_triggers(root, "s1") == recs
    bad = bytearray(open(reader.frame_path(root, "s1", 0), "rb").read())
    bad[-1] ^= 0xFF
    with pytest.raises(reader.StreamError, match="sha256"):
        reader.decode_frame(bytes(bad))
    with pytest.raises(reader.StreamError, match="header"):
        reader.decode_frame(b"no header line")


def test_ingest_fault_point_fires_on_append_and_read(tmp_path,
                                                     monkeypatch):
    """stream.ingest is instrumented at both sites: an injected append
    failure lands nothing; an injected read failure leaves the frame
    on disk for the worker's retry."""
    from tpulsar_torch.resilience import faults

    root = str(tmp_path)
    tingest.open_session(root, "s", _geom())
    chunk = np.zeros((64, 1024), np.float32)
    faults.configure("stream.ingest:unimplemented:count=1,errno=EIO")
    try:
        with pytest.raises(OSError):
            tingest.append_chunk(root, "s", 0, chunk)
        assert tingest.landed_seqs(root, "s") == []
        tingest.append_chunk(root, "s", 0, chunk)
        faults.configure("stream.ingest:unimplemented:count=1,errno=EIO")
        with pytest.raises(OSError):
            tingest.read_chunk(root, "s", 0)
        assert tingest.read_chunk(root, "s", 0)[0]["seq"] == 0
    finally:
        faults.configure("")


# --------------------------------------------------------- single pulse

def _span(geom, seed=11):
    data = _series(geom, 4, seed=seed, pulse_dm=12.0, pulse_t=1500,
                   amp=6.0)
    return _stream_all(tds.StreamDedisp, geom, data, device="cpu")[0]


def test_single_pulse_search_matches_jax():
    """The port's single_pulse_search and normalize_series against the
    JAX package's on one span (5-sigma events)."""
    import jax.numpy as jnp

    geom = _geom(nchan=96)
    span = _span(geom)
    _, dms = tds.geometry_freqs_dms(geom)
    np.testing.assert_allclose(
        tsp.normalize_series(torch.from_numpy(span)).numpy(),
        np.asarray(jsp.normalize_series(jnp.asarray(span))),
        rtol=1e-4, atol=1e-4)
    got = tsp.single_pulse_search(torch.from_numpy(span), dms,
                                  geom["dt"])
    want = jsp.single_pulse_search(jnp.asarray(span), dms, geom["dt"])
    assert len(want) > 0
    _assert_events_match(got, want, near_ties=0.01)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_search_span_matches_jax(backend):
    """search_span: the torch backend against the JAX package's jax
    backend at the SP tolerance; the numpy backends exactly."""
    geom = _geom(**SMALL)
    span = _span(geom)
    _, dms = tds.geometry_freqs_dms(geom)
    got = ttrg.search_span(span, dms, geom["dt"], backend=backend,
                           device="cpu")
    want = jtrg.search_span(span, dms, geom["dt"],
                            backend="jax" if backend == "torch"
                            else "numpy")
    assert got.dtype == jtrg.TRIGGER_DTYPE and len(want) > 0
    if backend == "numpy":
        assert np.array_equal(got, want)
    else:
        _assert_events_match(got, want, near_ties=0.01)
    recs = ttrg.events_to_records(got, "s", 2, 4096, geom["dt"])
    assert recs == jtrg.events_to_records(got, "s", 2, 4096, geom["dt"])
    assert ttrg.trigger_digest(recs) == jtrg.trigger_digest(recs)


@pytest.mark.parametrize("chunk_len", [997, 1024])
def test_streamed_triggers_equal_the_batch_spans(chunk_len):
    """The streamed trigger set (torch backend) equals the SP stage
    over the same spans of the batch-dedispersed series, and holds the
    injected pulse."""
    geom = _geom(chunk_len=chunk_len, span_chunks=max(1, 4096 // chunk_len),
                 **SMALL)
    n_chunks = max(6, 8192 // chunk_len)
    data = _series(geom, n_chunks, seed=11, pulse_dm=12.0, pulse_t=1500)
    cl = geom["chunk_len"]
    digest, recs = _control(
        geom, [data[:, k * cl:(k + 1) * cl] for k in range(n_chunks)],
        "p", "torch")
    batch = tdd.dedisperse_stream_batch(
        torch.from_numpy(data), tds.shift_table(geom)).numpy()
    span_len = geom["span_chunks"] * cl
    _, dms = tds.geometry_freqs_dms(geom)
    brecs = []
    for i, s0 in enumerate(range(0, batch.shape[1], span_len)):
        ev = ttrg.search_span(batch[:, s0:s0 + span_len], dms,
                              geom["dt"], backend="torch", device="cpu")
        brecs += ttrg.events_to_records(ev, "p", i, s0, geom["dt"])
    assert digest == ttrg.trigger_digest(brecs)
    assert any(abs(r["dm"] - 12.0) < 2.5 and abs(r["sample"] - 1500) < 64
               for r in recs), f"pulse not triggered ({len(recs)})"


# ------------------------------------------------------ device rules

def test_stream_entry_points_need_a_gpu_unless_told_cpu(monkeypatch,
                                                        tmp_path):
    from tpulsar_torch.config import TpulsarConfig
    from tpulsar_torch.serve.server import SearchServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tds.StreamDedisp(_geom()),
                 lambda: tds.StreamDedisp(_geom(), backend="numpy"),
                 lambda: ttrg.SpanTrigger(_geom()),
                 lambda: SearchServer(spool=str(tmp_path / "sp"),
                                      cfg=TpulsarConfig(), stream=True,
                                      warm_boot=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(ValueError, match="backend"):
        tds.StreamDedisp(_geom(), backend="jax", device="cpu")
    assert tds.resolve_backend("auto") == "torch"


# --------------------------------------------------------------- worker

def _worker_cmd(spool, wid, backend="torch", package="tpulsar_torch"):
    cmd = [sys.executable, "-m", f"{package}.stream.worker", "--spool",
           spool, "--worker-id", wid, "--once", "--backend", backend]
    return cmd + (["--device", "cpu"] if package == "tpulsar_torch"
                  else [])


def _env(**extra):
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", **extra)


def _run(cmd, **extra):
    return subprocess.run(cmd, env=_env(**extra), capture_output=True,
                          text=True, timeout=PROC_TIMEOUT)


def _feed(sroot, session, geom, data, seqs, close_at=None):
    cl = geom["chunk_len"]
    for k in seqs:
        tingest.append_chunk(sroot, session, k,
                             data[:, k * cl:(k + 1) * cl],
                             t_ingest=time.time())
    if close_at is not None:
        tingest.close_session(sroot, session, close_at)


def _events(q, tid):
    return jjournal.read_events(q.journal_root, ticket=tid)


def test_worker_session_end_to_end_with_a_gap(tmp_path):
    """`python -m tpulsar_torch.stream.worker --device cpu` answers a
    session ticket with seq 2 left out: done, one gap, every other seq
    acknowledged once within its SLO, triggers.jsonl's digest equal to
    the in-process control's, the checkpoint cleaned."""
    spool, sroot = str(tmp_path / "spool"), str(tmp_path / "stream")
    outdir = str(tmp_path / "out")
    os.makedirs(outdir)
    geom = _geom(**SMALL)
    data = _series(geom, 5, seed=31)
    tingest.open_session(sroot, "sA", geom)
    _feed(sroot, "sA", geom, data, [0, 1, 3, 4], close_at=5)
    q = get_ticket_queue(f"spool:{spool}")
    q.submit("st-0", [], outdir, kind="stream", session="sA",
             stream_root=sroot, slo_s=30.0)
    r = _run(_worker_cmd(spool, "w0"))
    assert r.returncode == 0, r.stderr[-2000:]
    res = q.read_result("st-0")
    assert res["status"] == "done", res
    assert (res["n_chunks"], res["chunks"], res["gaps"]) == (5, 4, 1)
    assert res["emitted_samples"] == data.shape[1]
    names = [e["event"] for e in _events(q, "st-0")]
    assert [n for n in names if n in ("stream_open", "chunk_received",
                                      "chunk_gap", "stream_closed")] \
        == ["stream_open"] + ["chunk_received"] * 2 + ["chunk_gap"] \
        + ["chunk_received"] * 2 + ["stream_closed"]
    for e in _events(q, "st-0"):
        if e["event"] == "chunk_received":
            assert e["latency_s"] <= e["slo_s"]
        if e["event"] == "stream_open":
            assert e["backend"] == "torch" and e["resumed"] == 0
    cl = geom["chunk_len"]
    digest, recs = _control(
        geom, [None if k == 2 else data[:, k * cl:(k + 1) * cl]
               for k in range(5)], "sA", "torch")
    assert recs and res["trigger_digest"] == digest
    assert ttrg.trigger_digest(tingest.read_triggers(sroot, "sA")) \
        == digest
    assert not os.path.isdir(tckpt.default_root(outdir))


@pytest.mark.parametrize("resumer, backend", [
    ("tpulsar_torch", "torch"), ("tpulsar", "numpy")],
    ids=["torch-resumes", "jax-resumes"])
def test_worker_sigkill_resume_equals_the_control(resumer, backend,
                                                  tmp_path):
    """The port's worker is parked by a fault point (the stream.ingest
    read of seq 4 hangs) once seqs 0-3 are acknowledged and
    checkpointed, and SIGKILLed there; a second worker — the port's,
    or the JAX package's on its numpy backend, from the port's
    checkpoint — resumes from the carry, reprocesses no acknowledged
    chunk, and ends with the control's trigger digest."""
    spool, sroot = str(tmp_path / "spool"), str(tmp_path / "stream")
    outdir = str(tmp_path / "out")
    os.makedirs(outdir)
    geom = _geom(span_chunks=2, **SMALL)
    data = _series(geom, 8, seed=41, pulse_dm=10.0, pulse_t=1200,
                   amp=9.0)
    tingest.open_session(sroot, "sK", geom)
    _feed(sroot, "sK", geom, data, range(8), close_at=8)
    q = get_ticket_queue(f"spool:{spool}")
    q.submit("st-k", [], outdir, kind="stream", session="sK",
             stream_root=sroot, slo_s=60.0)
    ckroot = tckpt.default_root(outdir)

    def acked() -> int:
        ent = ((tckpt.read_manifest(ckroot) or {}).get("entries") or {}
               ).get("stream_carry") or {}
        return int(ent.get("ack_next", 0))

    proc = subprocess.Popen(
        _worker_cmd(spool, "wk", backend), env=_env(
            TPULSAR_FAULTS="stream.ingest:hang:after=4,seconds=600"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + PROC_TIMEOUT
        while acked() < 4:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.time() < deadline, "seqs 0-3 not checkpointed"
            time.sleep(0.05)
    finally:
        proc.kill()
        proc.wait(timeout=PROC_TIMEOUT)
        proc.stderr.close()
    assert acked() == 4 and q.read_result("st-k") is None
    q.requeue_stale_claims(5)
    r = _run(_worker_cmd(spool, "wk2", backend, package=resumer))
    assert r.returncode == 0, r.stderr[-2000:]
    res = q.read_result("st-k")
    assert res and res["status"] == "done", res
    cl = geom["chunk_len"]
    digest, _ = _control(geom, [data[:, k * cl:(k + 1) * cl]
                                for k in range(8)], "sK", backend)
    assert res["trigger_digest"] == digest
    assert (res["chunks"], res["gaps"], res["replayed"]) == (8, 0, 0)
    evs = _events(q, "st-k")
    assert sorted(e["seq"] for e in evs
                  if e["event"] == "chunk_received") == list(range(8))
    opens = [e for e in evs if e["event"] == "stream_open"]
    assert [e["resumed"] for e in opens] == [0, 1]
    assert opens[1]["ack"] == 4
    assert not os.path.isdir(ckroot)


class _Killed(BaseException):
    """A SIGKILL stand-in raised inside the checkpoint store."""


def test_kill_between_carry_and_manifest_replays_one_chunk(tmp_path,
                                                           monkeypatch):
    """A kill after the carry artifact of seq 3 is renamed into place
    but before the manifest names it (the manifest's rewrite raises)
    leaves seq 2's carry whole: the resumed session starts at seq 3,
    replays that one chunk, and ends with the control's digest."""
    from tpulsar_torch.stream import worker as tworker

    sroot, outdir = str(tmp_path / "stream"), str(tmp_path / "out")
    jroot = str(tmp_path / "spool")
    os.makedirs(outdir)
    os.makedirs(jroot)
    geom = _geom(span_chunks=2, **SMALL)
    data = _series(geom, 6, seed=43, pulse_dm=10.0, pulse_t=1200,
                   amp=9.0)
    tingest.open_session(sroot, "sM", geom)
    _feed(sroot, "sM", geom, data, range(6), close_at=6)
    rec = {"ticket": "st-m", "session": "sM", "stream_root": sroot,
           "outdir": outdir}
    real = tckpt.CheckpointStore._write_manifest
    calls = []

    def dying(store):
        calls.append(1)
        if len(calls) == 5:      # open, then the saves after seqs 0-3
            raise _Killed
        real(store)

    monkeypatch.setattr(tckpt.CheckpointStore, "_write_manifest", dying)
    sess = tworker.StreamSession(rec, jroot=jroot, worker_id="w1",
                                 device="cpu")
    with pytest.raises(_Killed):
        while not sess.done:
            sess.step()
    monkeypatch.setattr(tckpt.CheckpointStore, "_write_manifest", real)
    again = tworker.StreamSession(dict(rec, attempts=1), jroot=jroot,
                                  worker_id="w2", device="cpu")
    while not again.done:
        again.step()
    assert again.next_seq == 6 and again.replayed == 1
    cl = geom["chunk_len"]
    digest, _ = _control(geom, [data[:, k * cl:(k + 1) * cl]
                                for k in range(6)], "sM", "torch")
    assert again.result_extras["trigger_digest"] == digest
    opens = [e for e in jjournal.read_events(jroot, ticket="st-m")
             if e["event"] == "stream_open"]
    assert [(e["resumed"], e["ack"]) for e in opens] == [(0, 0), (1, 3)]


def test_worker_fails_a_non_stream_ticket(tmp_path):
    spool = str(tmp_path / "spool")
    q = get_ticket_queue(f"spool:{spool}")
    q.submit("plain-0", [], str(tmp_path / "o"))
    r = _run(_worker_cmd(spool, "w0"))
    assert r.returncode == 0, r.stderr[-2000:]
    res = q.read_result("plain-0")
    assert res["status"] == "failed"
    assert res["error"] == "not a stream ticket"


def test_worker_without_a_gpu_fails_and_claims_nothing(tmp_path):
    spool = str(tmp_path / "spool")
    q = get_ticket_queue(f"spool:{spool}")
    q.submit("st-0", [], str(tmp_path / "o"), kind="stream",
             session="s", stream_root=str(tmp_path / "stream"))
    cmd = _worker_cmd(spool, "w0")[:-2]           # the default device
    r = _run(cmd, CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr and "device='cpu'" in r.stderr
    assert q.pending_count() == 1 and q.read_result("st-0") is None


# --------------------------------------------------------------- server

def _cli_stream(tmp_path, *args):
    cfgfile = tmp_path / "cfg.yaml"
    cfgfile.write_text(
        f"processing:\n  base_working_directory: {tmp_path / 'work'}\n"
        f"  base_results_directory: {tmp_path / 'res'}\n"
        f"basic:\n  log_dir: {tmp_path / 'logs'}\n"
        f"download:\n  datadir: {tmp_path / 'raw'}\n"
        f"background:\n  jobtracker_db: {tmp_path / 'jt.db'}\n"
        f"resultsdb:\n  url: {tmp_path / 'results.db'}\n")
    return _run([sys.executable, "-m", "tpulsar_torch", "--config",
                 str(cfgfile), "serve", "--stream", "--once", "--spool",
                 str(tmp_path / "spool"), *args])


def test_serve_stream_cli_answers_a_stream_ticket(tmp_path):
    """`python -m tpulsar_torch serve --stream --once --device cpu
    --no-warmstart` answers a stream ticket the JAX package's queue
    wrote (done, the control's digest, the journal chain) and exits 0
    with the heartbeat stopped."""
    from tpulsar.serve import protocol as jprotocol

    sroot, outdir = str(tmp_path / "stream"), str(tmp_path / "out")
    os.makedirs(outdir)
    geom = _geom(**SMALL)
    data = _series(geom, 4, seed=7, pulse_dm=15.0, pulse_t=900,
                   amp=9.0)
    jingest.open_session(sroot, "sS", geom)
    _feed(sroot, "sS", geom, data, range(4), close_at=4)
    q = get_ticket_queue(f"spool:{tmp_path / 'spool'}")
    q.submit("st-s", [], outdir, kind="stream", session="sS",
             stream_root=sroot, slo_s=30.0)
    r = _cli_stream(tmp_path, "--device", "cpu", "--no-warmstart")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mode stream" in r.stdout and "device cpu" in r.stdout
    res = q.read_result("st-s")
    assert res["status"] == "done" and res["chunks"] == 4, res
    cl = geom["chunk_len"]
    digest, recs = _control(geom, [data[:, k * cl:(k + 1) * cl]
                                   for k in range(4)], "sS", "torch")
    assert recs and res["trigger_digest"] == digest
    names = [e["event"] for e in _events(q, "st-s")]
    assert names[:2] == ["submitted", "claimed"]
    assert names[-2:] == ["stream_closed", "result"]
    assert names.count("chunk_received") == 4
    assert jprotocol.read_heartbeat(str(tmp_path / "spool"))["status"] \
        == "stopped"


def test_stream_server_fails_a_beam_ticket_and_warms_one_emission(
        tmp_path, monkeypatch):
    """A stream server (in process, on the CPU, warm boot on) boots by
    one stream emission at STREAM_PROFILE, not the beam search, and
    fails a beam ticket with the reason, serving nothing else."""
    from tpulsar_torch.config import TpulsarConfig
    from tpulsar_torch.serve import server as tserver

    spool = str(tmp_path / "spool")
    cfg = TpulsarConfig()
    cfg.processing.base_working_directory = str(tmp_path / "work")
    q = get_ticket_queue(f"spool:{spool}")
    q.submit("beam-0", ["/x.fits"], str(tmp_path / "o"))
    srv = tserver.SearchServer(spool=spool, cfg=cfg, stream=True,
                               device="cpu", poll_s=0.05)
    calls = []
    monkeypatch.setattr(srv, "_warm_search", lambda: calls.append("beam"))
    step = tdd.dedisperse_stream_step

    def counted(window, *a, **kw):
        calls.append(("emission", tuple(window.shape)))
        return step(window, *a, **kw)

    monkeypatch.setattr(tdd, "dedisperse_stream_step", counted)
    assert srv.serve(once=True) == 0
    assert calls == [("emission", (STREAM_PROFILE["nchan"],
                                   STREAM_PROFILE["chunk_len"] + 256))]
    res = q.read_result("beam-0")
    assert res["status"] == "failed"
    assert "only stream tickets" in res["error"]
    assert srv.beams == {"done": 0, "failed": 0, "skipped": 1}


def test_stream_server_drain_checkpoints_and_requeues(tmp_path):
    """A drain mid-session (the session still open) checkpoints the
    carry, writes no result and requeues the claim; a second stream
    server resumes from that carry once the session closes."""
    import threading

    from tpulsar_torch.config import TpulsarConfig
    from tpulsar_torch.serve import server as tserver

    spool, sroot = str(tmp_path / "spool"), str(tmp_path / "stream")
    outdir = str(tmp_path / "out")
    os.makedirs(outdir)
    geom = _geom(**SMALL)
    data = _series(geom, 4, seed=51)
    tingest.open_session(sroot, "sD", geom)
    _feed(sroot, "sD", geom, data, range(2))
    q = get_ticket_queue(f"spool:{spool}")
    q.submit("st-d", [], outdir, kind="stream", session="sD",
             stream_root=sroot)
    cfg = TpulsarConfig()
    cfg.processing.base_working_directory = str(tmp_path / "work")

    def server():
        return tserver.SearchServer(spool=spool, cfg=cfg, stream=True,
                                    device="cpu", warm_boot=False,
                                    poll_s=0.05)

    srv = server()
    th = threading.Thread(target=srv.serve)
    th.start()
    try:
        deadline = time.time() + PROC_TIMEOUT
        while sum(e["event"] == "chunk_received"
                  for e in _events(q, "st-d")) < 2:
            assert th.is_alive() and time.time() < deadline
            time.sleep(0.05)
    finally:
        srv.request_drain()
        th.join(timeout=PROC_TIMEOUT)
    assert not th.is_alive()
    assert q.read_result("st-d") is None and q.pending_count() == 1
    entry = tckpt.read_manifest(tckpt.default_root(outdir))["entries"][
        "stream_carry"]
    assert entry["ack_next"] == 2
    _feed(sroot, "sD", geom, data, range(2, 4), close_at=4)
    again = server()
    assert again.serve(once=True) == 0
    res = q.read_result("st-d")
    assert res["status"] == "done" and res["replayed"] == 0, res
    opens = [e for e in _events(q, "st-d") if e["event"] == "stream_open"]
    assert [(e["resumed"], e["ack"]) for e in opens] == [(0, 0), (1, 2)]
