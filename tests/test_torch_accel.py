"""tpulsar_torch.kernels.accel (the hi-accel FDAS stage) against the
JAX package's tpulsar.kernels.accel, on the same NumPy-seeded inputs.

Tolerances: the correlation runs through pocketfft (torch) and XLA's
FFT (JAX), which differ in float order: planes at rtol 1e-4, top-k
powers at rtol 2e-4 (tests/test_accel.py's batched-vs-per-DM
tolerance), r bins and z exactly at a rank whose power stands clear of
its neighbours and as a set within a tie (assert_topk_match).  The
harmonic stage sums add float32 terms in the same order, so on the
same f32 plane they are bit-identical."""

from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpulsar.kernels import accel as ja  # noqa: E402
from tpulsar.kernels import accel_batch as jab  # noqa: E402
from tpulsar.kernels.fourier import harmonic_stages  # noqa: E402
from tpulsar_torch.kernels import accel as ta  # noqa: E402
from tpulsar_torch.kernels import accel_batch as tab  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)

PLANE_RTOL = 1e-4
POWER_RTOL = 2e-4


def _tied(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b))


def assert_topk_match(got, want, rtol: float = PLANE_RTOL) -> None:
    """Two packages' top-k lists, (powers, r bins, z) each of shape
    (..., k) sorted by power (descending), computed through different
    FFTs: each rank's power within rtol; a rank whose power stands
    clear of both neighbours by more than rtol keeps its exact r and
    z; within a run of ranks whose powers lie within rtol of one
    another the (r, z) cells agree as a set, each cell's power within
    rtol; and in the k-th rank's run a cell may leave the list only if
    its power is within rtol of the k-th power (its rival may be the
    unseen (k+1)-th)."""
    gp, gr, gz = (np.asarray(a) for a in got)
    wp, wr, wz = (np.asarray(a) for a in want)
    assert gp.shape == gr.shape == gz.shape == wp.shape == wr.shape \
        == wz.shape
    np.testing.assert_allclose(gp, wp, rtol=rtol)
    k = wp.shape[-1]
    for row in np.ndindex(wp.shape[:-1]):
        p, q = wp[row].tolist(), gp[row].tolist()
        wcell = list(zip(wr[row].tolist(), wz[row].tolist()))
        gcell = list(zip(gr[row].tolist(), gz[row].tolist()))
        start = 0
        for i in range(k):
            if i + 1 < k and (_tied(p[i], p[i + 1], rtol)
                              or _tied(q[i], q[i + 1], rtol)):
                continue            # rank i + 1 is in the same run
            w = dict(zip(wcell[start:i + 1], p[start:i + 1]))
            g = dict(zip(gcell[start:i + 1], q[start:i + 1]))
            where = f"row {row} ranks {start}..{i}"
            if i + 1 < k:
                gband, wband = gcell[start:i + 1], wcell[start:i + 1]
                assert sorted(gband) == sorted(wband), \
                    f"{where}: {gband} != {wband}"
            else:
                for c in set(w) ^ set(g):
                    assert _tied(w.get(c, g.get(c)), p[k - 1], rtol), \
                        f"{where}: {c} left the list clear of the k-th"
            for c in set(w) & set(g):
                assert _tied(g[c], w[c], rtol), f"{where}: {c}'s power"
            start = i + 1


def _specs(nd=3, nbins=6000, seed=7, tones=((1500.0, 6.0),)):
    """Seeded complex noise spectra with drifting tones (bin, z) added
    through the reference's own z-response."""
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(nd, nbins))
         + 1j * rng.normal(size=(nd, nbins))).astype(np.complex64)
    for i in range(nd):
        for r0, z in tones:
            resp = ja.gen_z_response(z, 64)
            lo = int(r0) + 40 * i - 32
            s[i, lo: lo + 64] += 12.0 * resp
    return s


def _bank(zmax=8.0, seg=1 << 11):
    return ja.build_template_bank(zmax, seg=seg), \
        ta.build_template_bank(zmax, seg=seg)


@pytest.mark.parametrize("zmax, seg", [(8.0, 1 << 11), (16.0, 1 << 11),
                                       (50.0, 1 << 13), (200.0, 1 << 13)])
def test_template_bank_is_equal(zmax, seg):
    jb, tb = _bank(zmax, seg)
    assert tb.zs == jb.zs and tb.width == jb.width
    assert (tb.seg, tb.step) == (jb.seg, jb.step)
    np.testing.assert_array_equal(tb.bank_fft, jb.bank_fft)
    np.testing.assert_array_equal(ta.z_grid(zmax), ja.z_grid(zmax))


def test_correlate_block_and_segments_match():
    specs = _specs()
    jb, tb = _bank()
    nz = len(jb.zs)
    want = np.asarray(ja._correlate_block(
        jnp.asarray(specs), jnp.asarray(jb.bank_fft), jb.seg, jb.step,
        jb.width, nz))
    got = ta._correlate_block(torch.from_numpy(specs),
                              torch.from_numpy(tb.bank_fft), tb.seg,
                              tb.step, tb.width, nz)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=PLANE_RTOL,
                               atol=PLANE_RTOL)
    one = np.asarray(ja._correlate_segments(
        jnp.asarray(specs[1]), jnp.asarray(jb.bank_fft), jb.seg, jb.step,
        jb.width))
    got1 = ta._correlate_segments(torch.from_numpy(specs[1]),
                                  torch.from_numpy(tb.bank_fft), tb.seg,
                                  tb.step, tb.width)
    np.testing.assert_allclose(got1.numpy(), one, rtol=PLANE_RTOL,
                               atol=PLANE_RTOL)
    # the segment-at-a-time path is the batched path, row for row
    np.testing.assert_array_equal(got1.numpy(), got[1].numpy())


@pytest.mark.parametrize("nz, nr, mh", [(51, 4096, 16), (9, 1000, 8),
                                        (201, 2048, 16), (51, 777, 4)])
def test_harmonic_stage_maxes_bit_identical_to_jax(nz, nr, mh):
    """The same f32 plane gives the same stage maxima and argmaxes, bit
    for bit, and both equal the from-scratch per-stage sums."""
    rng = np.random.default_rng(5)
    plane = rng.normal(size=(nz, nr)).astype(np.float32) ** 2
    stages = tuple(harmonic_stages(mh))
    want = ja._harmonic_stage_maxes(jnp.asarray(plane), stages, nz)
    got = ta._harmonic_stage_maxes(torch.from_numpy(plane), stages, nz)
    assert set(got) == set(want)
    for h in stages:
        np.testing.assert_array_equal(got[h][0].numpy(),
                                      np.asarray(want[h][0]))
        np.testing.assert_array_equal(got[h][1].numpy(),
                                      np.asarray(want[h][1]))
        old = ta._harmonic_sum_plane(torch.from_numpy(plane), h,
                                     nz).numpy()
        np.testing.assert_array_equal(got[h][0].numpy(), old.max(axis=0))
        np.testing.assert_array_equal(got[h][1].numpy(),
                                      old.argmax(axis=0))


def test_accel_search_batch_matches_jax():
    specs = _specs(nd=5, seed=11, tones=((900.0, 4.0), (2300.0, -6.0)))
    jb, tb = _bank()
    want = ja.accel_search_batch(jnp.asarray(specs), jb, max_numharm=4,
                                 topk=8)
    got = ta.accel_search_batch(torch.from_numpy(specs), tb,
                                max_numharm=4, topk=8)
    assert set(got) == set(want) == {1, 2, 4}
    for h in want:
        assert_topk_match(got[h], want[h], rtol=POWER_RTOL)


@pytest.mark.parametrize("case, agrees", [
    ("swap inside a tie band", True),
    ("the k-th rank's cell replaced by its tie", True),
    ("swap of two cells 10 PLANE_RTOL apart", False),
    ("wrong z at a clear rank", False),
    ("a cell missing outside the k-th tie band", False),
])
def test_assert_topk_match_holds_ties_as_sets(case, agrees):
    """The comparator itself: row 0 of two equal, row 1 changed."""
    p = np.array([40.0, 30.0, 20.0, 0.0, 10.0, 5.0], np.float32)
    p[3] = p[2] * (1 - (10 if "10 PLANE_RTOL" in case else 0.3)
                   * PLANE_RTOL)
    r = np.arange(6, dtype=np.int32) * 120 + 100
    z = np.array([0, 2, -4, 6, -8, 10], np.int32)
    gr, gz = r.copy(), z.copy()
    if case.startswith("swap"):
        gr[[2, 3]], gz[[2, 3]] = r[[3, 2]], z[[3, 2]]
    elif case.startswith("the k-th"):
        gr[5], gz[5] = 9999, 12
    elif case.startswith("wrong z"):
        gz[1] += 2
    else:
        gr[4] = 9999
    got = (np.stack([p, p]), np.stack([r, gr]), np.stack([z, gz]))
    want = (np.stack([p, p]), np.stack([r, r]), np.stack([z, z]))
    if agrees:
        assert_topk_match(got, want)
    else:
        with pytest.raises(AssertionError):
            assert_topk_match(got, want)


def test_batched_equals_per_dm_and_any_batch_size():
    specs = _specs(nd=3, seed=3)
    _jb, tb = _bank()
    nz = len(tb.zs)
    bf = torch.from_numpy(tb.bank_fft)
    bv, br, bz = ta._accel_block_topk(torch.from_numpy(specs), bf, tb.seg,
                                      tb.step, tb.width, nz, 2, 8)
    for i in range(3):
        sv, sr, sz = ta._accel_plane_topk(torch.from_numpy(specs[i]), bf,
                                          tb.seg, tb.step, tb.width, nz,
                                          2, 8)
        np.testing.assert_allclose(bv[i].numpy(), sv.numpy(),
                                   rtol=POWER_RTOL)
        np.testing.assert_array_equal(br[i].numpy(), sr.numpy())
        np.testing.assert_array_equal(bz[i].numpy(), sz.numpy())
    full = ta.accel_search_batch(torch.from_numpy(specs), tb,
                                 max_numharm=2, topk=8)
    for b in (1, 2):
        part = ta.accel_search_batch(torch.from_numpy(specs), tb,
                                     max_numharm=2, topk=8, dm_chunk=b)
        for h in full:
            for k in range(3):
                np.testing.assert_array_equal(part[h][k], full[h][k])


@pytest.mark.parametrize("nbins", [1_966_081, 983_041, 196_609, 5000])
def test_plane_dm_chunk_and_plans_match_jax(nbins, monkeypatch):
    """The batch sizing and schedule: on the CPU (f32 plane, z chunk
    16) as the JAX package on its CPU backend, and on CUDA (bf16, z
    chunk 4) as the JAX package on an accelerator."""
    nz = 51
    assert ta.plane_dm_chunk(nbins, nz) == ja.plane_dm_chunk(nbins, nz)
    for ndms in (1, 38, 76):
        assert astuple(tab.plan_batches(
            ndms, ta.plane_dm_chunk(nbins, nz))) == astuple(
            jab.plan_batches(ndms, ja.plane_dm_chunk(nbins, nz)))
        assert tab.batch_rows(ndms, nbins, nz) == \
            jab.batch_rows(ndms, nbins, nz)
    for b in (1, 3, 7):
        assert astuple(tab.plan_batches_explicit(38, b)) == \
            astuple(jab.plan_batches_explicit(38, b))
    monkeypatch.setattr(ja, "_PLANE_DTYPE_RESOLVED", jnp.bfloat16)
    monkeypatch.setattr(ja, "_Z_CHUNK_RESOLVED", 4)
    assert ta.plane_dm_chunk(nbins, nz, device="cuda") == \
        ja.plane_dm_chunk(nbins, nz)
    assert tab.BATCH_QUANTA == jab.BATCH_QUANTA


def test_plane_dtype_is_bf16_on_cuda_and_f32_on_the_cpu(monkeypatch):
    """The plane-dtype rule: 'auto' is bf16 on CUDA, f32 on the CPU;
    f32/bf16 pin either; an unknown value raises."""
    monkeypatch.delenv("TPULSAR_ACCEL_PLANE_DTYPE", raising=False)
    assert ta.plane_dtype("cuda") == torch.bfloat16
    assert ta.plane_dtype("cpu") == torch.float32
    assert ta.z_chunk("cuda") == 4 and ta.z_chunk("cpu") == 16
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", "f32")
    assert ta.plane_dtype("cuda") == torch.float32
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", "bf16")
    assert ta.plane_dtype("cpu") == torch.bfloat16


@pytest.mark.parametrize("value", ["fp16", "float32", "bfloat16"])
def test_bad_setting_raises(value, monkeypatch):
    """An unknown TPULSAR_ACCEL_PLANE_DTYPE raises (the JAX package
    raises at import; the port when the plane dtype is read)."""
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", value)
    _jb, tb = _bank()
    with pytest.raises(ValueError, match="TPULSAR_ACCEL_PLANE_DTYPE"):
        ta.accel_search_batch(torch.from_numpy(_specs(nd=1)), tb,
                              max_numharm=1, topk=4)


def _chirp_spectrum(z_true=12.0, T=1 << 15, dt=1e-3, f0=40.0, amp=0.8):
    """A drifting tone in noise (tests/test_accel.py's construction),
    normalized by each package's normalize_spectrum."""
    rng = np.random.default_rng(3)
    T_s = T * dt
    t = np.arange(T) * dt
    fdot = z_true / T_s ** 2
    x = rng.standard_normal(T).astype(np.float32) + amp * np.sin(
        2 * np.pi * (f0 * t + 0.5 * fdot * t * t))
    x = (x - x.mean()).astype(np.float32)
    return x, T_s


def test_drifting_tone_found_at_its_z_like_jax():
    x, T_s = _chirp_spectrum()
    jspec = ja.normalize_spectrum(jnp.fft.rfft(jnp.asarray(x)))
    tspec = ta.normalize_spectrum(torch.fft.rfft(torch.from_numpy(x)))
    np.testing.assert_allclose(tspec.numpy(), np.asarray(jspec),
                               rtol=1e-3, atol=1e-4)
    jb, tb = _bank(24.0)
    want = ja.accel_search_one(jspec, jb, max_numharm=1, topk=8)[1]
    got = ta.accel_search_one(tspec, tb, max_numharm=1, topk=8)[1]
    assert_topk_match(got, want, rtol=POWER_RTOL)
    best = int(np.argmax(got[0]))
    assert abs(got[2][best] - 12.0) <= ta.DZ
    assert abs(0.5 * got[1][best] - (40.0 * T_s + 6.0)) <= 2


def test_bf16_plane_picks_the_same_cell_within_one_percent(monkeypatch):
    """The bf16 plane (CUDA's default) against the f32 plane on a
    drifting tone: the same winning (r, z) cell, power within 1%."""
    x, _T_s = _chirp_spectrum()
    spec = ta.normalize_spectrum(torch.fft.rfft(torch.from_numpy(x)))
    _jb, tb = _bank(24.0)
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", "f32")
    f32 = ta.accel_search_one(spec, tb, max_numharm=2, topk=8)
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", "bf16")
    plane = ta._correlate_segments(spec.to(torch.complex64),
                                   torch.from_numpy(tb.bank_fft), tb.seg,
                                   tb.step, tb.width)
    assert plane.dtype == torch.bfloat16
    bf16 = ta.accel_search_one(spec, tb, max_numharm=2, topk=8)
    for h in (1, 2):
        i, j = int(np.argmax(f32[h][0])), int(np.argmax(bf16[h][0]))
        assert (f32[h][1][i], f32[h][2][i]) == (bf16[h][1][j],
                                                bf16[h][2][j])
        assert bf16[h][0][j] == pytest.approx(f32[h][0][i], rel=0.01)


# ------------------------------------------- the card's stage kernel

#: template banks of the stage-kernel cases, by zmax (seg 2^11)
_STAGE_BANKS: dict = {}

#: (zmax, max_numharm, nbins, plane dtype, z chunk): nz 51 and 201 at
#: each of their stage sets, a ragged spectrum (777 bins), a plane of
#: fewer blocks than k (300 bins), the card's z chunk of 4, and bf16
#: pieces; every case's last z chunk is ragged (51 and 201 rows)
STAGE_CASES = ([(50.0, mh, 3000, "f32", 16) for mh in (1, 2, 4, 8)]
               + [(200.0, mh, 2500, "f32", 16) for mh in (1, 2, 4, 8, 16)]
               + [(50.0, 8, 777, "f32", 4), (50.0, 4, 300, "f32", 16),
                  (50.0, 8, 3000, "bf16", 4),
                  (200.0, 16, 2500, "bf16", 16)])


def _stage_bank(zmax: float):
    if zmax not in _STAGE_BANKS:
        _STAGE_BANKS[zmax] = ta.build_template_bank(zmax, seg=1 << 11)
    return _STAGE_BANKS[zmax]


def _assert_same(got, want) -> None:
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("zmax, mh, nbins, dtype, zchunk", STAGE_CASES)
def test_stage_kernel_plain_version_equals_both_consumers(
        zmax, mh, nbins, dtype, zchunk, monkeypatch):
    """The stage kernel's plain version accel._stage_blocks_plain (to
    which the card's kernel is held exactly), through
    accel._blocks_topk, equals the torch consumer _accel_block_topk
    on the same spectra and, on f32 pieces, the native consumer on the
    same pieces, bit for bit; a stage's blocks past its count hold
    -inf, 0, 0, and the width pad's blocks of stage 1 read 0 at their
    first column and z 0."""
    from tpulsar_torch import native
    from tpulsar_torch.kernels import fourier as tfr

    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", dtype)
    monkeypatch.setenv("TPULSAR_ACCEL_Z_CHUNK", str(zchunk))
    tb = _stage_bank(zmax)
    nz, width, nr, topk = len(tb.zs), tb.width, 2 * nbins, 16
    specs = torch.from_numpy(_specs(nd=2, nbins=nbins, seed=nbins,
                                    tones=((nbins // 4, 6.0),)))
    bf = torch.from_numpy(tb.bank_fft)
    args = (tb.seg, tb.step, tb.width, nz)
    pieces = ta._corr_piece_list(specs, bf, *args)
    assert pieces[-1].shape[2] == nz % zchunk
    assert pieces[0].dtype == ta.plane_dtype("cpu")
    stages = tuple(tfr.harmonic_stages(mh))
    blocks = ta._stage_blocks_plain(pieces, width, nr, stages,
                                    tfr.BLOCK_R)
    got = ta._blocks_topk(blocks, stages, nr, topk)
    _assert_same(got, ta._accel_block_topk(specs, bf, *args, mh, topk))
    if dtype == "f32":
        want = native.accel_stage_topk_zsegs(
            [p.numpy() for p in pieces], width, nr, stages, tfr.BLOCK_R,
            topk)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), w)
    bmax, bcol, bz, zarg0 = blocks
    assert bmax.shape == (2, len(stages), -(-nr // tfr.BLOCK_R))
    for i, h in enumerate(stages):
        nb = -(-(nr // h) // tfr.BLOCK_R)
        assert torch.isneginf(bmax[:, i, nb:]).all()
        assert not bcol[:, i, nb:].any() and not bz[:, i, nb:].any()
        assert (bmax[:, i, :nb] >= 0).all()
    pad = width // tfr.BLOCK_R
    assert pad >= 2 and not bmax[:, 0, :pad].any() and not zarg0.any()
    assert torch.equal(bcol[:, 0, :pad],
                       torch.arange(pad, dtype=torch.int32).expand(2, pad)
                       * tfr.BLOCK_R)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_kernel_plain_version_keeps_the_tie_rules(dtype):
    """Pieces of small integers tie in nearly every z maximum and block
    maximum: the plain version equals the torch consumer on the
    assembled plane (first z, first column, stable top-k) and, on f32,
    the native consumer; 6 blocks against k = 8 pad with column 0's z."""
    from tpulsar_torch import native
    from tpulsar_torch.kernels import fourier as tfr

    rng = np.random.default_rng(5)
    nd, nsegs, two_step, width, stages, topk = 2, 3, 96, 40, (1, 2, 4), 8
    pieces = [torch.from_numpy(rng.integers(
        0, 3, (nd, nsegs, zc, two_step)).astype(np.float32)).to(dtype)
        for zc in (4, 4, 4, 1)]
    nz, nr = 13, width + nsegs * two_step - 5
    blocks = ta._stage_blocks_plain(pieces, width, nr, stages,
                                    tfr.BLOCK_R)
    got = ta._blocks_topk(blocks, stages, nr, topk)
    plane = ta._assemble_plane(pieces, width, nr)
    _assert_same(got, ta._stage_topk(
        ta._harmonic_stage_maxes(plane, stages, nz), stages, topk))
    if dtype == torch.float32:
        want = native.accel_stage_topk_zsegs(
            [p.numpy() for p in pieces], width, nr, stages, tfr.BLOCK_R,
            topk)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), w)


def test_stage_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper checks a call as the kernel takes it, on either
    device (cuda_dd._accel_stage_args): pieces of one dtype (float32 or
    bfloat16) and layout with a last chunk of 1..zc rows, at most
    ACCEL_STAGE_MAX_NZ z rows, the stages 1, 2, 4, ... up to 32, a
    block of 32, 64, 128 or 256 columns, and a plane that the pieces
    cover; then it refuses pieces off the card and launches nothing
    (the plain version is accel._stage_blocks_plain)."""
    from tpulsar_torch.kernels import cuda_dd

    ok, last = torch.zeros((1, 2, 4, 16)), torch.zeros((1, 2, 3, 16))
    limit = cuda_dd.ACCEL_STAGE_MAX_NZ
    assert cuda_dd._accel_stage_args([ok, last], 8, 40, (1, 2), 64) \
        == (7, 4)
    assert cuda_dd._accel_stage_args([torch.zeros((1, 1, limit, 16))], 8,
                                     20, (1,), 64) == (limit, limit)
    before = cuda_dd.LAUNCHES["accel_stage"]
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_dd.accel_stage_blocks([ok, last], 8, 40, (1, 2), 64)
    assert cuda_dd.LAUNCHES["accel_stage"] == before
    big = torch.zeros((1, 1, limit + 1, 16))
    for pieces, width, nr, stages, block_r in (
            ([], 8, 40, (1, 2), 64),
            ([ok, torch.zeros((1, 2, 5, 16))], 8, 40, (1, 2), 64),
            ([ok, torch.zeros((1, 2, 3, 8))], 8, 40, (1, 2), 64),
            ([ok, last.to(torch.bfloat16)], 8, 40, (1, 2), 64),
            ([ok.double()], 8, 40, (1, 2), 64),
            ([big], 8, 20, (1,), 64),
            ([ok, last], 8, 40, (1, 3), 64),
            ([ok, last], 8, 40, (2, 4), 64),
            ([ok, last], 8, 40, (1, 2, 4, 8, 16, 32, 64), 64),
            ([ok, last], 8, 40, (1, 2), 48),
            ([ok, last], 8, 40, (1, 2), 512),
            ([ok, last], 8, 8, (1, 2), 64),
            ([ok, last], 8, 8 + 2 * 16 + 1, (1, 2), 64)):
        with pytest.raises(ValueError):
            cuda_dd._accel_stage_args(pieces, width, nr, stages, block_r)


def test_kernel_rows_counter_counts_the_batched_rows_the_kernel_wrote(
        monkeypatch):
    """tpulsar_accel_kernel_rows_total counts the batched DM rows of
    spectra on the card, where every batch goes through the stage
    kernel (tests/test_torch_accel_stage.py reads 1.0 of the batched
    trials there): on the CPU, by the torch consumer (pinned by
    TPULSAR_ACCEL_BATCH=1) or the native one, it stays at 0 while the
    batched trials count every row, the clamped tail's once."""
    from tpulsar_torch.obs import telemetry

    def counts():
        return (telemetry.accel_kernel_rows_total().value(),
                telemetry.accel_batch_trials_total().value(path="batched"))

    specs = torch.from_numpy(_specs(nd=5, nbins=2000, seed=9))
    _jb, tb = _bank()
    k0, b0 = counts()
    native_out = ta.accel_search_batch(specs, tb, max_numharm=2, topk=4,
                                       dm_chunk=2)
    k1, b1 = counts()
    monkeypatch.setenv("TPULSAR_ACCEL_BATCH", "1")
    ta._reset_batch_state()
    try:
        out = ta.accel_search_batch(specs, tb, max_numharm=2, topk=4,
                                    dm_chunk=2)
        k2, b2 = counts()
    finally:
        ta._reset_batch_state()
    assert (k1 - k0, b1 - b0) == (0, 5)
    assert (k2 - k1, b2 - b1) == (0, 5)
    for h in out:
        for i in range(3):
            np.testing.assert_array_equal(out[h][i], native_out[h][i])
