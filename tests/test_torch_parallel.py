"""tpulsar_torch.parallel against the JAX package's parallel layer.

Each case of tests/test_parallel.py, on the same seeded inputs, through
both packages: the JAX side on the conftest's 8 virtual CPU devices,
the port on a mesh of 8 (or, where the JAX test takes 4, 4) logical
shards of the CPU.  Dedispersion is held bit for bit (stage 2 sums in
the reference's order on both routes); candidates by the reference's
own rule for its mesh: the sifted key set (r and z to 2 decimals,
numharm, DM to 3) equal, each sigma within 1e-3, the single-pulse
event sets equal (between the packages, but for events at the
threshold: SP_EDGE_RTOL); FFT values by the JAX test's tolerances."""

import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_slice import one_torch_thread  # noqa: E402,F401
from tpulsar.constants import dispersion_delay_s  # noqa: E402
from tpulsar.kernels import dedisperse as jdd  # noqa: E402
from tpulsar.kernels import fourier as jfr  # noqa: E402
from tpulsar.parallel import dist_fft as jdist  # noqa: E402
from tpulsar.parallel import mesh as jmesh  # noqa: E402
from tpulsar.parallel.seq_dedisperse import seq_dedisperse as jseq  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch.kernels import accel as tak  # noqa: E402
from tpulsar_torch.parallel import dist_fft as tdist  # noqa: E402
from tpulsar_torch.parallel import mesh as tmesh  # noqa: E402
from tpulsar_torch.parallel.seq_dedisperse import (  # noqa: E402
    seq_dedisperse as tseq)
from tpulsar_torch.plan import ddplan as tddplan  # noqa: E402
from tpulsar_torch.search import degraded as tdegraded  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _direct_family(monkeypatch):
    """The port's single-device path on the direct stage-2 kernel (the
    mesh shards that one; the tree sums in another order)."""
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")
    monkeypatch.delenv("TPULSAR_SP_DETREND", raising=False)


def _tmesh(n_dm: int, n_beam: int = 1):
    return tmesh.make_mesh(n_beam=n_beam, n_dm=n_dm,
                           devices=[CPU] * (n_beam * n_dm))


def _jmesh(n_dm: int):
    return jmesh.make_mesh(n_beam=1, n_dm=n_dm,
                           devices=jax.devices()[:n_dm])


def _key(c):
    return (round(c.r, 2), round(c.z, 2), c.numharm, round(c.dm, 3))


def _evset(ev):
    return {(round(float(e["dm"]), 3), int(e["sample"]),
             int(e["downfact"])) for e in ev}


#: SP events at most this far above the 5-sigma threshold may be
#: missing on one side of a port-vs-JAX comparison: the boxcar's
#: float32 cumsum accumulates in another order in XLA and in torch (up
#: to ~1e-3 apart over 32k samples), so an event at the threshold can
#: fall either side of it
SP_EDGE_RTOL = 1e-3


def _assert_same_search(got, want, threshold: float | None = None):
    """The reference's rule for its mesh (tests/test_parallel.py):
    key set, sigma within 1e-3, SP event set, trial count.  Between
    the two packages (threshold given) an SP event within SP_EDGE_RTOL
    of the threshold may be on one side only."""
    g_cands, _gf, g_ev, g_trials = got
    w_cands, _wf, w_ev, w_trials = want
    assert g_trials == w_trials
    assert {_key(c) for c in g_cands} == {_key(c) for c in w_cands}
    by_key = {_key(c): c for c in w_cands}
    for c in g_cands:
        assert c.sigma == pytest.approx(by_key[_key(c)].sigma, rel=1e-3)
    if threshold is None:
        assert _evset(g_ev) == _evset(w_ev)
        return
    g, w = _evset(g_ev), _evset(w_ev)
    edge = {ident for ev in (g_ev, w_ev) for ident, sigma in zip(
        _evlist(ev), ev["sigma"])
        if sigma < threshold * (1.0 + SP_EDGE_RTOL)}
    assert (g ^ w) <= edge, sorted(g ^ w)


def _evlist(ev):
    return [(round(float(e["dm"]), 3), int(e["sample"]),
             int(e["downfact"])) for e in ev]


# ------------------------------------------------------------ the mesh

def test_make_mesh_shapes():
    m = _tmesh(4, n_beam=2)
    assert m.shape == {"beam": 2, "dm": 4} == dict(
        jmesh.make_mesh(n_beam=2, n_dm=4).shape)
    m1 = tmesh.make_mesh(n_beam=1, devices=[CPU] * 8)
    assert m1.shape == {"beam": 1, "dm": 8} == dict(
        jmesh.make_mesh(n_beam=1).shape)
    assert m1.axis_names == ("beam", "dm")
    assert m1.devices.shape == (1, 8)
    for kw in (dict(n_beam=3), dict(n_beam=2, n_dm=3)):
        with pytest.raises(ValueError):
            jmesh.make_mesh(**kw)
        with pytest.raises(ValueError):
            tmesh.make_mesh(devices=[CPU] * 8, **kw)


def test_shard_dm_table_padding():
    t = np.arange(10 * 4).reshape(10, 4).astype(np.int32)
    p = tmesh.shard_dm_table(t, 8)
    assert p.shape == (16, 4)
    np.testing.assert_array_equal(p[10], t[-1])
    np.testing.assert_array_equal(p, jmesh.shard_dm_table(t, 8))
    assert tmesh.shard_dm_table(t, 5) is t


def test_replicated_shards_share_one_tensor():
    """On a mesh of one device, a replicated argument is the caller's
    tensor in every shard (Tensor.to copies nothing) and a split one a
    view of it."""
    x = torch.arange(32.0).reshape(4, 8)
    seen = tmesh.shard_map(lambda i, a, b: (a, b), _tmesh(4), (None, 1),
                           x, x)
    for i, (a, b) in enumerate(seen):
        assert a is x
        assert b.data_ptr() == x[:, 2 * i:].data_ptr()
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_map(lambda i, a: a, _tmesh(3), (1,), x)


# ------------------------------------------------- the demo search step

def _step_both(subb, sub_shifts, spec_kw, nfft):
    edges = tuple(int(e) for e in jfr._block_edges(nfft // 2 + 1))
    jspec = jmesh.SearchStepSpec(whiten_edges=edges, **spec_kw)
    tspec = tmesh.SearchStepSpec(whiten_edges=edges, **spec_kw)
    keep = np.ones(nfft // 2 + 1, np.float32)
    jres = jmesh.sharded_search_step(jmesh.make_mesh(n_beam=1, n_dm=8),
                                     jspec)(
        jnp.asarray(subb)[None], jnp.asarray(sub_shifts)[None],
        jnp.asarray(keep))
    tres = tmesh.sharded_search_step(_tmesh(8), tspec)(
        torch.from_numpy(subb)[None], sub_shifts[None], keep)
    assert sorted(jres) == sorted(tres)
    for h in jres:
        jv, jb = (np.asarray(x) for x in jres[h])
        tv, tb = (x.numpy() for x in tres[h])
        assert tv.shape == jv.shape
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
    return tres


def test_sharded_search_matches_single_device():
    """The 8-way step finds the 40 Hz tone in every trial at the
    nearest half bin, as the JAX step does."""
    rng = np.random.default_rng(7)
    nsub, T, dt = 8, 1 << 13, 1e-3
    t = np.arange(T) * dt
    subb = rng.standard_normal((nsub, T)).astype(np.float32)
    subb += 0.4 * np.sin(2 * np.pi * 40.0 * t)[None, :]
    sub_shifts = np.zeros((16, nsub), np.int32)
    res = _step_both(subb, sub_shifts, dict(nsub=nsub, nfft=T,
                                            max_numharm=2, topk=8), T)
    vals, bins = (x.numpy() for x in res[1])
    assert vals.shape == (1, 16, 8)
    assert np.all(bins[0, :, 0] == round(2 * 40.0 * T * dt))


def test_sharded_search_dm_chunks_differ():
    """Each shard applies its own rows of the shift table (an
    all_gather out of order would show)."""
    rng = np.random.default_rng(8)
    nsub, T, ndms = 4, 1 << 12, 8
    subb = rng.standard_normal((nsub, T)).astype(np.float32)
    sub_shifts = (np.arange(ndms)[:, None]
                  * np.ones((1, nsub), np.int32) * 7).astype(np.int32)
    _step_both(subb, sub_shifts, dict(nsub=nsub, nfft=T, max_numharm=1,
                                      topk=4), T)


# --------------------------------------------------- stage 2 in a shard

def test_dd_local_is_the_reference_scan_bit_for_bit():
    """_dd_local (the stage-2 kernel's wrapper; its plain version on
    the CPU) equals the reference's _dedisperse_subbands_scan exactly,
    and the Pallas _pallas_dd_local (interpret mode) within the JAX
    test's own tolerance."""
    rng = np.random.default_rng(23)
    subb = rng.standard_normal((8, 4096)).astype(np.float32)
    shifts = (np.arange(40).reshape(5, 8) * 13).astype(np.int32)
    got = tmesh._dd_local(torch.from_numpy(subb), shifts).numpy()
    want = np.asarray(jdd._dedisperse_subbands_xla(jnp.asarray(subb),
                                                   jnp.asarray(shifts)))
    assert np.array_equal(got, want)
    pallas = np.asarray(jmesh._pallas_dd_local(
        jnp.asarray(subb), jnp.asarray(shifts), stage_s=1024,
        interpret=True, dm_chunk=2))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)


def test_seq_dedisperse_matches_single_device():
    """Time-sharded stage 2 with the ring halo equals the JAX
    seq_dedisperse and the single-device scan bit for bit."""
    rng = np.random.default_rng(17)
    nsub, T, ndms = 8, 4096, 6
    subb = rng.standard_normal((nsub, T)).astype(np.float32)
    shifts = rng.integers(0, 300, size=(ndms, nsub)).astype(np.int32)
    shifts[0] = 0
    parts = tseq(torch.from_numpy(subb), shifts, _tmesh(8))
    assert [p.shape for p in parts] == [(ndms, T // 8)] * 8
    got = torch.cat(parts, dim=1).numpy()
    assert np.array_equal(got, np.asarray(
        jseq(jnp.asarray(subb), shifts, jmesh.make_mesh(n_beam=1,
                                                        n_dm=8))))
    assert np.array_equal(got, np.asarray(jdd._dedisperse_subbands_xla(
        jnp.asarray(subb), jnp.asarray(shifts))))


@pytest.mark.parametrize("T, fill, max_shift, match", [
    (1024, 200, None, "halo"),           # chunk 128 < 200
    (1020, 10, None, "not divisible"),
    (1024, 100, 50, "exceeds max_shift"),
])
def test_seq_dedisperse_rejects(T, fill, max_shift, match):
    shifts = np.full((2, 4), fill, np.int32)
    for fn, subb, mesh in (
            (jseq, jnp.zeros((4, T), jnp.float32),
             jmesh.make_mesh(n_beam=1, n_dm=8)),
            (tseq, torch.zeros((4, T)), _tmesh(8))):
        with pytest.raises(ValueError, match=match):
            fn(subb, shifts, mesh, max_shift=max_shift)


# ------------------------------------------------- the distributed FFT

def test_dist_fft_matches_numpy():
    rng = np.random.default_rng(9)
    N = 1 << 12
    x = (rng.standard_normal(N)
         + 1j * rng.standard_normal(N)).astype(np.complex64)
    got = tdist.dist_fft_natural(x, _tmesh(8))
    want = np.fft.fft(x)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4
    jgot = jdist.dist_fft_natural(x, jmesh.make_mesh(n_beam=1, n_dm=8))
    assert np.max(np.abs(got - jgot)) / np.max(np.abs(want)) < 1e-5
    # the transposed-digit layout: (A / n, B) row blocks, A*B = N
    A = tdist._choose_A(N, 8)
    parts = tdist.dist_fft(torch.from_numpy(x), _tmesh(8))
    assert [p.shape for p in parts] == [(A // 8, N // A)] * 8


def test_dist_fft_tone_bin():
    N = 1 << 14
    x = np.exp(2j * np.pi * 333 * np.arange(N) / N).astype(np.complex64)
    assert np.argmax(np.abs(tdist.dist_fft_natural(x, _tmesh(8)))) == 333


def test_dist_fft_multimillion_bins():
    rng = np.random.default_rng(77)
    N = 1 << 22
    x = (rng.standard_normal(N)
         + 1j * rng.standard_normal(N)).astype(np.complex64)
    t = np.arange(N)
    for f in (12345, 1 << 20, N - 777):
        x += 5.0 * np.exp(2j * np.pi * f * t / N).astype(np.complex64)
    got = tdist.dist_fft_natural(x, _tmesh(8))
    want = np.fft.fft(x)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 5e-4
    for f in (12345, 1 << 20, N - 777):
        assert np.abs(got[f]) > 0.5 * N


def test_dist_fft_large_n_error_bound():
    """2^22 points: the complex64 four-step keeps the relative
    max-norm error below 1e-4, the JAX test's bound."""
    rng = np.random.default_rng(22)
    N = 1 << 22
    x = (rng.standard_normal(N)
         + 1j * rng.standard_normal(N)).astype(np.complex64)
    got = tdist.dist_fft_natural(x, _tmesh(8))
    want = np.fft.fft(x).astype(np.complex64)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4


def test_dist_spectral_topk_finds_tones():
    rng = np.random.default_rng(5)
    N = 1 << 21
    t = np.arange(N, dtype=np.float64)
    x = rng.standard_normal(N).astype(np.float32)
    tones = [12345, 333333, 700007]
    amp = 0.05
    for b in tones:
        x += (amp * np.cos(2 * np.pi * b * t / N)).astype(np.float32)
    xc = x.astype(np.complex64)
    vals, bins = tdist.dist_spectral_topk(torch.from_numpy(xc),
                                          _tmesh(8), "dm", N, topk=16)
    jvals, jbins = jdist.dist_spectral_topk(
        jnp.asarray(xc), jmesh.make_mesh(n_beam=1, n_dm=8), "dm", N,
        topk=16)
    for b in tones:
        assert b in bins.tolist(), (b, bins)
    p_expect = N * amp ** 2 / 4.0
    for p in vals[np.isin(bins, tones)]:
        assert abs(p / p_expect - 1.0) < 0.25, (p, p_expect)
    assert (bins >= 1).all() and (bins <= N // 2).all()
    # the tones' whitened powers agree with the JAX tail's
    jp = dict(zip(jbins.tolist(), jvals.tolist()))
    for b, p in zip(bins.tolist(), vals.tolist()):
        if b in tones:
            assert p == pytest.approx(jp[b], rel=1e-4)


@pytest.mark.parametrize("nfft", [1 << 12, 1 << 22, 1 << 28])
def test_dist_spectral_gate_arithmetic(nfft):
    assert tdist.spectral_bytes_per_trial(nfft) == \
        jdist.spectral_bytes_per_trial(nfft)
    assert (tdist.spectral_bytes_per_trial(nfft) > (1 << 30)) == \
        (nfft >= 1 << 28)


# ------------------------------------------- the executor's mesh path

def _pulsar_block(seed: int, nchan: int, T: int, dm: float, period: float,
                  amp: float = 3.0, duty: float = 0.08):
    rng = np.random.default_rng(seed)
    dt = 1e-3
    freqs = np.linspace(1200.0, 1500.0, nchan)
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    t = np.arange(T) * dt
    delays = dispersion_delay_s(dm, freqs, freqs[-1])
    for c in range(nchan):
        data[c] += (((t - delays[c]) / period) % 1.0 < duty) * amp
    return data, freqs, dt


TWO_STEP_PLAN = [(20.0, 4.0, 11, 1, 8, 1), (64.0, 8.0, 5, 1, 8, 2)]
TWO_STEP_PARAMS = dict(nsub=8, lo_accel_numharm=4, hi_accel_zmax=8,
                       hi_accel_numharm=2, topk_per_stage=8,
                       max_cands_to_fold=0, make_plots=False)


def _plans(rows):
    return ([jddplan.DedispStep(*r) for r in rows],
            [tddplan.DedispStep(*r) for r in rows])


def test_sharded_search_block_matches_single_device():
    """search_block(mesh=...) on 8 shards: the JAX package's mesh
    result and the port's own single-device result, by the reference's
    rule."""
    data, freqs, dt = _pulsar_block(5, 32, 1 << 13, 40.0, 0.08)
    jplan, tplan = _plans(TWO_STEP_PLAN)
    got = tex.search_block(data, freqs, dt, tplan,
                           tex.SearchParams(**TWO_STEP_PARAMS),
                           mesh=_tmesh(8), device="cpu")
    assert got[3] == 16
    assert "sharded_hi_fallback" not in tdegraded.snapshot()
    solo = tex.search_block(data, freqs, dt, tplan,
                            tex.SearchParams(**TWO_STEP_PARAMS),
                            device="cpu")
    _assert_same_search(got, solo)
    want = jex.search_block(jnp.asarray(data), freqs, dt, jplan,
                            jex.SearchParams(**TWO_STEP_PARAMS),
                            mesh=_jmesh(8))
    _assert_same_search(got, want, threshold=5.0)


def test_seq_sharded_search_block_matches_dm_sharded(monkeypatch):
    """The sequence-parallel front end (time shards, ring halo,
    all_to_all) on 4 shards: the DM-sharded result, the JAX package's
    seq-sharded one.  Every chunk of the 'on' run takes the seq route
    (seq_dedisperse, no per-shard _dd_local, no fallback warning), and
    the 'off' run's chunks are as many, 4 _dd_local launches each."""
    data, freqs, dt = _pulsar_block(31, 32, 1 << 13, 40.0, 0.08)
    jplan, tplan = _plans(TWO_STEP_PLAN)
    calls = {"seq_dedisperse": 0, "_dd_local": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(sys.modules["tpulsar_torch.parallel.seq_dedisperse"],
            "seq_dedisperse")
    counted(tmesh, "_dd_local")
    runs, seen = {}, {}
    for seq in ("off", "on"):
        calls.update(seq_dedisperse=0, _dd_local=0)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*cannot be honoured")
            runs[seq] = tex.search_block(
                data, freqs, dt, tplan,
                tex.SearchParams(seq_shard=seq, **TWO_STEP_PARAMS),
                mesh=_tmesh(4), device="cpu")
        seen[seq] = dict(calls)
    assert seen["on"]["_dd_local"] == 0 and seen["off"]["seq_dedisperse"] == 0
    assert seen["on"]["seq_dedisperse"] >= sum(st.numpasses for st in tplan)
    assert seen["off"]["_dd_local"] == 4 * seen["on"]["seq_dedisperse"]
    assert runs["on"][3] == 16
    _assert_same_search(runs["on"], runs["off"])
    want = jex.search_block(jnp.asarray(data), freqs, dt, jplan,
                            jex.SearchParams(seq_shard="on",
                                             **TWO_STEP_PARAMS),
                            mesh=_jmesh(4))
    _assert_same_search(runs["on"], want, threshold=5.0)


def test_seq_shard_on_warns_when_the_halo_does_not_fit():
    """seq_shard='on' with a halo deeper than a shard's chunk warns and
    replicates, and the result is the DM-sharded one."""
    data, freqs, dt = _pulsar_block(31, 32, 1 << 13, 40.0, 0.08)
    _jplan, tplan = _plans([(20.0, 4.0, 8, 1, 8, 1)])
    # 64 shards of 128 samples: pass 0's halo bucket (256) is deeper
    mesh = tmesh.make_mesh(1, 64, devices=[CPU] * 64)
    with pytest.warns(UserWarning, match="cannot be honoured"):
        on = tex.search_block(data, freqs, dt, tplan,
                              tex.SearchParams(seq_shard="on",
                                               **TWO_STEP_PARAMS),
                              mesh=mesh, device="cpu")
    off = tex.search_block(data, freqs, dt, tplan,
                           tex.SearchParams(seq_shard="off",
                                            **TWO_STEP_PARAMS),
                           mesh=mesh, device="cpu")
    _assert_same_search(on, off)


def test_sharded_hi_fallback_when_batch_gate_fails(monkeypatch):
    """With the batched hi path pinned off, the mesh path runs the hi
    stage through the single-device route and finds the same
    candidates, as the JAX package's does."""
    rng = np.random.default_rng(17)
    nchan, T, dt = 16, 1 << 12, 1e-3
    freqs = np.linspace(1200.0, 1500.0, nchan)
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    t = np.arange(T) * dt
    data += ((t / 0.05) % 1.0 < 0.1)[None, :] * 2.0
    jplan, tplan = _plans([(5.0, 5.0, 8, 1, 8, 1)])
    kw = dict(nsub=8, lo_accel_numharm=2, hi_accel_zmax=8,
              hi_accel_numharm=2, topk_per_stage=8, max_cands_to_fold=0,
              make_plots=False)
    monkeypatch.setattr(tak, "_BATCH_OK", True)
    good = tex.search_block(data, freqs, dt, tplan, tex.SearchParams(**kw),
                            mesh=_tmesh(4), device="cpu")
    assert "sharded_hi_fallback" not in tdegraded.snapshot()
    monkeypatch.setattr(tak, "_BATCH_OK", False)
    fallback = tex.search_block(data, freqs, dt, tplan,
                                tex.SearchParams(**kw), mesh=_tmesh(4),
                                device="cpu")
    assert "sharded_hi_fallback" in tdegraded.snapshot()
    monkeypatch.setattr(tak, "_BATCH_OK", None)
    assert any(abs(c.z) > 0 for c in good[0])
    _assert_same_search(fallback, good)
    from tpulsar.kernels import accel as jak
    monkeypatch.setattr(jak, "_BATCH_OK", False)
    want = jex.search_block(jnp.asarray(data), freqs, dt, jplan,
                            jex.SearchParams(**kw), mesh=_jmesh(4))
    assert {_key(c) for c in fallback[0]} == {_key(c) for c in want[0]}


def test_accel_fault_pins_the_single_device_hi_route(monkeypatch):
    """A fault spec naming an accel point runs the hi stage through
    the single-device route (the sharded pass would never fire it)."""
    from tpulsar_torch.resilience import faults

    data, freqs, dt = _pulsar_block(5, 16, 1 << 12, 20.0, 0.05)
    _jplan, tplan = _plans([(5.0, 5.0, 8, 1, 8, 1)])
    monkeypatch.setattr(tak, "_BATCH_OK", True)
    faults.configure("accel.chunk:unimplemented:rate=0.0")
    try:
        tex.search_block(data, freqs, dt, tplan,
                         tex.SearchParams(**TWO_STEP_PARAMS),
                         mesh=_tmesh(2), device="cpu")
    finally:
        faults.reset()
    assert "sharded_hi_fallback" in tdegraded.snapshot()


def test_seq_dist_search_pass_finds_pulsar():
    """A spectral budget below one trial's tail sends the pass to the
    distributed-FFT search: the pulsar is found, the mode noted, SP
    events reported — as by the JAX package's."""
    rng = np.random.default_rng(77)
    nchan, T, dt = 16, 1 << 14, 1e-3
    freqs = np.linspace(1200.0, 1500.0, nchan)
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    tgrid = np.arange(T) * dt
    data += ((tgrid / 0.08) % 1.0 < 0.1)[None, :] * 2.0
    jplan, tplan = _plans([(0.0, 10.0, 8, 1, 8, 1)])
    kw = dict(nsub=8, lo_accel_numharm=4, run_hi_accel=False,
              topk_per_stage=16, max_cands_to_fold=0, make_plots=False,
              seq_shard="on", spectral_hbm_budget=1 << 16)
    cands, _folded, sp, ntrials = tex.search_block(
        data, freqs, dt, tplan, tex.SearchParams(**kw), mesh=_tmesh(8),
        device="cpu")
    assert ntrials == 8
    assert any(abs(c.freq_hz - 1.0 / 0.08) < 0.05
               or abs(c.freq_hz - 2.0 / 0.08) < 0.05 for c in cands), \
        [c.freq_hz for c in cands]
    assert "seq_dist_spectral" in tdegraded.snapshot()
    assert len(sp) > 0
    jc, _jf, jsp, jn = jex.search_block(
        jnp.asarray(data), freqs, dt, jplan, jex.SearchParams(**kw),
        mesh=jmesh.make_mesh(n_beam=1, n_dm=8))
    assert jn == ntrials
    # the same strongest fundamental, one Fourier bin at most apart
    best, jbest = (max(c, key=lambda x: x.sigma) for c in (cands, jc))
    assert abs(best.freq_hz - jbest.freq_hz) <= 1.0 / (T * dt) + 1e-9
    assert best.dm == jbest.dm


def test_sharded_sp_detrend_estimator_consistency():
    """A non-default SP detrend estimator gives the single-device
    events on the mesh path, and the JAX mesh path's."""
    rng = np.random.default_rng(11)
    nchan, T, dt = 16, 1 << 13, 1e-3
    freqs = np.linspace(1200.0, 1500.0, nchan)
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    data[:, 3000:3004] += 5.0
    jplan, tplan = _plans([(0.0, 10.0, 8, 1, 8, 1)])
    kw = dict(nsub=8, lo_accel_numharm=4, run_hi_accel=False,
              topk_per_stage=8, max_cands_to_fold=0, make_plots=False,
              sp_detrend="clipped_mean")
    single = tex.search_block(data, freqs, dt, tplan,
                              tex.SearchParams(**kw), device="cpu")
    sharded = tex.search_block(data, freqs, dt, tplan,
                               tex.SearchParams(**kw), mesh=_tmesh(8),
                               device="cpu")
    assert len(single[2]) > 0
    assert _evset(single[2]) == _evset(sharded[2])
    want = jex.search_block(jnp.asarray(data), freqs, dt, jplan,
                            jex.SearchParams(**kw), mesh=_jmesh(8))
    assert _evset(sharded[2]) == _evset(want[2])


def test_search_block_refuses_a_mesh_of_another_device_type():
    data, freqs, dt = _pulsar_block(5, 16, 1 << 10, 20.0, 0.05)
    _jplan, tplan = _plans([(5.0, 5.0, 4, 1, 8, 1)])
    mesh = tmesh.Mesh(np.array([[torch.device("meta")]], dtype=object))
    with pytest.raises(ValueError, match="device type"):
        tex.search_block(data, freqs, dt, tplan,
                         tex.SearchParams.slice_defaults(nsub=8),
                         mesh=mesh, device="cpu")
