"""tpulsar_torch dedispersion (stage 1 + stage 2) against the JAX
package: the plain PyTorch versions the CUDA kernels are held to on
the card must equal the JAX reference BIT FOR BIT — stage 1 on uint8
input (integer sums), stage 2 always (both sum subbands in order) —
and must match the Pallas kernels run in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp

    from tpulsar.kernels import dedisperse as jdd
    from tpulsar.kernels import pallas_dd
except ImportError:
    # a machine with the card but without JAX runs only the `cuda`
    # tests: python -m pytest --noconftest -m cuda <this file>
    jnp = jdd = pallas_dd = None

from tpulsar_torch.kernels import cuda_dd  # noqa: E402
from tpulsar_torch.kernels import dedisperse as tdd  # noqa: E402


def _jax_stage1(data, shifts, nsub, ds):
    pad = jdd._pad_bucket(int(np.max(shifts, initial=0)))
    return np.asarray(jdd._form_subbands_jit(
        jnp.asarray(data), jnp.asarray(shifts), nsub, ds, pad))


def _jax_stage2(subb, shifts):
    pad = jdd._pad_bucket(int(np.max(shifts, initial=0)))
    return np.asarray(jdd._dedisperse_subbands_scan(
        jnp.asarray(subb), jnp.asarray(shifts), pad))


@pytest.mark.parametrize("ds", [1, 2, 3, 10])
def test_stage1_uint8_bit_identical(ds):
    """uint8 stage 1, tolerance 0 (exact): every partial sum is an
    integer, so any summation order gives the same float32."""
    rng = np.random.default_rng(13 + ds)
    nchan, T, nsub = 40, 1503, 8
    data = rng.integers(0, 256, size=(nchan, T), dtype=np.uint8)
    shifts = rng.integers(0, 400, size=nchan).astype(np.int32)
    shifts[::5] = 0
    want = _jax_stage1(data, shifts, nsub, ds)
    got = tdd.form_subbands(torch.from_numpy(data), shifts, nsub,
                            ds).numpy()
    assert got.dtype == np.float32 and got.shape == (nsub, T // ds)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ds", [1, 2, 3])
def test_stage1_matches_pallas_interpret(ds):
    """The Pallas stage-1 kernel in interpret mode, exact."""
    rng = np.random.default_rng(21)
    nchan, T, nsub = 32, 1500, 8
    data = rng.integers(0, 255, size=(nchan, T), dtype=np.uint8)
    shifts = rng.integers(0, 300, size=nchan).astype(np.int32)
    want = np.asarray(pallas_dd.form_subbands_pallas(
        jnp.asarray(data), shifts, nsub, ds, block_t=512,
        interpret=True))
    got = tdd.form_subbands(torch.from_numpy(data), shifts, nsub,
                            ds).numpy()
    np.testing.assert_array_equal(got, want)


def test_stage1_edge_clamp():
    """Shifts that run past the end read the last sample (uint8,
    exact), against the jit reference and the Pallas kernel."""
    nchan, T, nsub = 8, 300, 2
    data = (np.arange(nchan * T) % 251).astype(np.uint8).reshape(nchan, T)
    shifts = np.full(nchan, 280, np.int32)
    shifts[0] = 0
    shifts[5] = 299
    got = tdd.form_subbands(torch.from_numpy(data), shifts, nsub,
                            2).numpy()
    np.testing.assert_array_equal(got, _jax_stage1(data, shifts, nsub, 2))
    pal = np.asarray(pallas_dd.form_subbands_pallas(
        jnp.asarray(data), shifts, nsub, 2, block_t=128, interpret=True))
    np.testing.assert_array_equal(got, pal)


def test_stage1_float32_close():
    """float32 stage 1 at rtol 1e-6: the reference's channel sum
    (`sum(axis=0)`) runs in XLA's order, the port's in channel order,
    so the two may differ in the last bit."""
    rng = np.random.default_rng(5)
    nchan, T, nsub = 32, 2000, 4
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    shifts = rng.integers(0, 500, size=nchan).astype(np.int32)
    got = tdd.form_subbands(torch.from_numpy(data), shifts, nsub,
                            3).numpy()
    np.testing.assert_allclose(got, _jax_stage1(data, shifts, nsub, 3),
                               rtol=1e-6, atol=1e-5)


def test_stage2_bit_identical_to_scan():
    """Stage 2 sums subbands in order from zero, as the reference's
    scan does: tolerance 0."""
    rng = np.random.default_rng(7)
    nsub, T, ndms = 16, 1500, 41
    subb = rng.standard_normal((nsub, T)).astype(np.float32)
    shifts = rng.integers(0, 700, size=(ndms, nsub)).astype(np.int32)
    shifts[:, 0] = 0
    got = tdd.dedisperse_subbands(torch.from_numpy(subb), shifts).numpy()
    np.testing.assert_array_equal(got, _jax_stage2(subb, shifts))


def test_stage2_matches_pallas_interpret_and_edge_clamp():
    """The Pallas stage-2 kernel (interpret mode), including shifts
    past the end of the series: exact."""
    rng = np.random.default_rng(11)
    nsub, T, ndms = 8, 1200, 37
    subb = rng.standard_normal((nsub, T)).astype(np.float32)
    shifts = rng.integers(0, 290, size=(ndms, nsub)).astype(np.int32)
    shifts[3] = 1190
    want = np.asarray(pallas_dd.dedisperse_subbands_pallas(
        subb, shifts, block_t=256, dm_chunk=32, interpret=True))
    got = tdd.dedisperse_subbands(torch.from_numpy(subb), shifts).numpy()
    np.testing.assert_array_equal(got, want)
    ramp = np.arange(4 * 400, dtype=np.float32).reshape(4, 400)
    sh = np.full((3, 4), 350, np.int32)
    sh[1] = 0
    np.testing.assert_array_equal(
        tdd.dedisperse_subbands(torch.from_numpy(ramp), sh).numpy(),
        _jax_stage2(ramp, sh))


def test_two_stage_pass_on_survey_geometry():
    """One pass of the Mock survey plan's geometry at a short length:
    plan_pass_shifts, stage 1 on uint8, stage 2 — exact."""
    rng = np.random.default_rng(3)
    freqs = 1214.2 + np.arange(96) * (322.617 / 96)
    nsub, dt, ds = 16, 65.476e-6 * 8, 2
    dms = np.round(100.0 + 0.3 * np.arange(12), 6)
    ch_j, sub_j = jdd.plan_pass_shifts(freqs, nsub, 101.8, dms, dt, ds)
    ch_t, sub_t = tdd.plan_pass_shifts(freqs, nsub, 101.8, dms, dt, ds)
    np.testing.assert_array_equal(ch_t, ch_j)
    np.testing.assert_array_equal(sub_t, sub_j)
    data = rng.integers(0, 256, size=(96, 6000), dtype=np.uint8)
    subb_j = _jax_stage1(data, ch_j, nsub, ds)
    subb_t = tdd.form_subbands(torch.from_numpy(data), ch_t, nsub, ds)
    np.testing.assert_array_equal(subb_t.numpy(), subb_j)
    np.testing.assert_array_equal(
        tdd.dedisperse_subbands(subb_t, sub_t).numpy(),
        _jax_stage2(subb_j, sub_j))


@pytest.mark.parametrize("ds", [1, 2, 3])
def test_dedisperse_pass_bit_identical_to_jax(ds):
    """The whole two-stage pass on a uint8 block of the survey
    geometry: tolerance 0 against the JAX package's dedisperse_pass,
    and max_shift_samples exact (the series' contaminated tail)."""
    rng = np.random.default_rng(21 + ds)
    freqs = 1214.2 + np.arange(96) * (322.617 / 96)
    nsub, dt = 16, 65.476e-6 * 8
    dms = np.round(100.0 + 0.3 * np.arange(12), 6)
    data = rng.integers(0, 256, size=(96, 6000), dtype=np.uint8)
    want = np.asarray(jdd.dedisperse_pass(jnp.asarray(data), freqs, nsub,
                                          101.8, dms, dt, ds))
    got = tdd.dedisperse_pass(data, freqs, nsub, 101.8, dms, dt, ds,
                              device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (12, 6000 // ds)
    np.testing.assert_array_equal(got.numpy(), want)
    for max_dm in (0.0, 103.3, 1000.0):
        assert tdd.max_shift_samples(freqs, max_dm, dt) == \
            jdd.max_shift_samples(freqs, max_dm, dt)


def test_dedisperse_pass_takes_a_device():
    """dedisperse_pass runs on the device it is given (default the
    card: it raises without one), not where its input lies."""
    data = np.zeros((8, 300), np.uint8)
    freqs = np.linspace(1200.0, 1500.0, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdd.dedisperse_pass(torch.from_numpy(data), freqs, 2, 10.0,
                                [10.0], 1e-3, 1)
    cuda_dd.reset_counts()
    out = tdd.dedisperse_pass(data, freqs, 2, 10.0, [10.0, 11.0], 1e-3,
                              1, device="cpu")
    assert tuple(out.shape) == (2, 300)
    assert cuda_dd.LAUNCHES["form_subbands"] == 0


def test_host_helpers_match():
    assert tdd._pad_bucket(0) == jdd._pad_bucket(0) == 0
    for m in (-3, 1, 255, 256, 257, 1000, 5000):
        assert tdd._pad_bucket(m) == jdd._pad_bucket(m)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(
        tdd._edge_pad(torch.from_numpy(x), 3).numpy(),
        np.asarray(jdd._edge_pad(jnp.asarray(x), 3)))
    assert tdd._edge_pad(torch.from_numpy(x), 0).shape == (3, 4)
    y = np.random.default_rng(0).standard_normal((3, 103)).astype(
        np.float32)
    np.testing.assert_allclose(
        tdd.downsample(torch.from_numpy(y), 5).numpy(),
        np.asarray(jdd.downsample(jnp.asarray(y), 5)), rtol=1e-6, atol=1e-6)
    freqs = np.linspace(1200.0, 1500.0, 32)
    np.testing.assert_array_equal(
        tdd.shift_samples(100.0, freqs, freqs[-1], 1e-3),
        jdd.shift_samples(100.0, freqs, freqs[-1], 1e-3))
    np.testing.assert_array_equal(tdd.subband_reference_freqs(freqs, 8),
                                  jdd.subband_reference_freqs(freqs, 8))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x8 = torch.zeros((8, 100), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_dd.form_subbands(x8.to(torch.int16), np.zeros(8, np.int32),
                              2, 1)
    with pytest.raises(ValueError):
        cuda_dd.form_subbands(x8, np.zeros(7, np.int32), 2, 1)
    with pytest.raises(ValueError):
        cuda_dd.form_subbands(x8, -np.ones(8, np.int32), 2, 1)
    with pytest.raises(ValueError):
        cuda_dd.form_subbands(x8, np.zeros(8, np.int32), 3, 1)
    sub = torch.zeros((4, 100))
    with pytest.raises(ValueError):
        cuda_dd.dedisperse_subbands(sub.double(), np.zeros((2, 4), int))
    with pytest.raises(ValueError):
        cuda_dd.dedisperse_subbands(sub, np.zeros((2, 5), int))
    with pytest.raises(ValueError):
        cuda_dd.dedisperse_subbands(sub, np.full((2, 4), 0.5))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    """On a CPU tensor a wrapper runs the plain version and launches
    nothing: the launch counters stay at 0."""
    cuda_dd.reset_counts()
    data = torch.randint(0, 255, (8, 300), dtype=torch.uint8)
    sh = np.arange(8, dtype=np.int32)
    out = cuda_dd.form_subbands(data, sh, 2, 1)
    np.testing.assert_array_equal(
        out.numpy(), cuda_dd.form_subbands_plain(data, sh, 2, 1).numpy())
    cuda_dd.dedisperse_subbands(out, np.zeros((3, 2), np.int32))
    cuda_dd.dedisperse_subbands_beams(torch.stack([out, out]),
                                      np.zeros((3, 2), np.int32))
    assert cuda_dd.LAUNCHES == {"form_subbands": 0,
                                "dedisperse_subbands": 0,
                                "dedisperse_subbands_beams": 0,
                                "accel_stage": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [1, 3, 10])
def test_cuda_kernels_match_plain_versions(cuda_device, ds):
    """On the card: each kernel against its plain version, exact."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(ds)
    data = torch.randint(0, 256, (96, 50_003), generator=gen,
                         device=cuda_device, dtype=torch.uint8)
    sh = np.random.default_rng(ds).integers(0, 2000, 96).astype(np.int32)
    before = dict(cuda_dd.LAUNCHES)
    got = cuda_dd.form_subbands(data, sh, 16, ds)
    assert torch.equal(got, cuda_dd.form_subbands_plain(data, sh, 16, ds))
    sub_sh = (np.random.default_rng(ds).integers(0, 3000, 16)[None, :]
              + np.arange(40)[:, None]).astype(np.int32)
    out = cuda_dd.dedisperse_subbands(got, sub_sh)
    assert torch.equal(out, cuda_dd.dedisperse_subbands_plain(got, sub_sh))
    assert cuda_dd.LAUNCHES["form_subbands"] == before["form_subbands"] + 1
    # 40 rows are one launch (two groups of 20)
    assert cuda_dd.LAUNCHES["dedisperse_subbands"] == \
        before["dedisperse_subbands"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [1, 4])
def test_cuda_dedisperse_pass_is_the_two_kernels(cuda_device, ds):
    """On the card: dedisperse_pass launches each kernel once and
    equals their composition exactly."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(40 + ds)
    data = torch.randint(0, 256, (96, 50_003), generator=gen,
                         device=cuda_device, dtype=torch.uint8)
    freqs = 1214.2 + np.arange(96) * (322.617 / 96)
    dms = np.round(100.0 + 0.3 * np.arange(40), 6)
    before = dict(cuda_dd.LAUNCHES)
    got = tdd.dedisperse_pass(data, freqs, 16, 105.0, dms, 65.476e-6, ds,
                              device=cuda_device)
    assert cuda_dd.LAUNCHES["form_subbands"] == before["form_subbands"] + 1
    assert cuda_dd.LAUNCHES["dedisperse_subbands"] == \
        before["dedisperse_subbands"] + 1
    ch, sub = tdd.plan_pass_shifts(freqs, 16, 105.0, dms, 65.476e-6, ds)
    want = cuda_dd.dedisperse_subbands(
        cuda_dd.form_subbands(data, ch, 16, ds), sub)
    assert torch.equal(got, want)


def _mock_chunks():
    """Every stage-2 DM chunk of the full Mock survey plan (960
    channels, nsub 96, 3,932,160 samples), as the executor cuts them."""
    from tpulsar_torch.plan import ddplan
    from tpulsar_torch.search import executor

    freqs = 1214.289 + np.arange(960) * (322.617 / 960)
    params = executor.SearchParams.slice_defaults()
    for step in ddplan.survey_plan("pdev"):
        nfft = ddplan.choose_n(3_932_160 // step.downsamp)
        for ppass in step.passes():
            _, sub = tdd.plan_pass_shifts(freqs, 96, ppass.subdm,
                                          np.asarray(ppass.dms),
                                          65.476e-6, step.downsamp)
            chunk = executor.pass_chunk_size(len(sub), nfft, params)
            for lo in range(0, len(sub), chunk):
                yield step.downsamp, sub[lo: lo + chunk]


def test_stage2_launch_covers_every_mock_chunk_in_one_launch():
    """Each of the Mock plan's 85 chunks (38, 64 and 76 rows, spans up
    to 151 samples) is one launch that fits a block's shared memory."""
    shapes = {}
    for ds, sh in _mock_chunks():
        plan = cuda_dd.stage2_launch(sh)
        assert plan.smem_bytes <= cuda_dd.MAX_SMEM
        assert plan.span <= 151
        assert plan.rows <= cuda_dd.DD_GROUP_ROWS
        assert (plan.groups - 1) * plan.rows < len(sh) <= \
            plan.groups * plan.rows
        shapes[(len(sh), ds)] = shapes.get((len(sh), ds), 0) + 1
    assert sum(shapes.values()) == 85
    assert shapes[(38, 1)] == 56 and shapes[(64, 2)] == 12
    assert sum(v for (n, _), v in shapes.items() if n == 76) == 17
    # two blocks of the widest Mock chunk fit one SM's shared memory
    assert 2 * (cuda_dd.stage2_smem_bytes(96, 151) + 1024) <= 233_472


@pytest.mark.parametrize("ndms", list(range(1, 41)) + [64, 76, 100, 257])
def test_stage2_row_groups_are_even(ndms):
    """The fewest groups of at most DD_GROUP_ROWS rows, all of one
    size but the last, which is at most groups-1 rows shorter."""
    sh = np.zeros((ndms, 4), np.int32)
    plan = cuda_dd.stage2_launch(sh)
    assert plan.groups == -(-ndms // cuda_dd.DD_GROUP_ROWS)
    last = ndms - (plan.groups - 1) * plan.rows
    assert 1 <= plan.rows - last + 1 <= plan.groups
    expect = {38: (2, 19), 64: (4, 16), 76: (4, 19), 100: (5, 20)}
    if ndms in expect:
        assert (plan.groups, plan.rows) == expect[ndms]


def test_stage2_launch_tables_rebuild_the_shifts():
    """Each group's table holds its rows' shifts less the group's
    smallest shift per subband, [s][row], then those smallest shifts;
    the span is the largest such difference."""
    rng = np.random.default_rng(17)
    sh = rng.integers(0, 500, size=(45, 7)).astype(np.int32)
    plan = cuda_dd.stage2_launch(sh)
    R = cuda_dd.DD_GROUP_ROWS
    assert plan.tables.dtype == np.int32 and plan.tables.shape[1] % 4 == 0
    span = 0
    for g in range(plan.groups):
        rows = sh[g * plan.rows: (g + 1) * plan.rows]
        rel = plan.tables[g, :7 * R].reshape(7, R)
        lo = plan.tables[g, 7 * R: 7 * R + 7]
        np.testing.assert_array_equal(lo, rows.min(axis=0))
        np.testing.assert_array_equal(rel[:, :len(rows)].T + lo, rows)
        assert not rel[:, len(rows):].any()
        span = max(span, int(rel.max()))
    assert plan.span == span


def _largest_span(nsub):
    span = 0
    while cuda_dd.stage2_smem_bytes(nsub, span + 1) <= cuda_dd.MAX_SMEM:
        span += 1
    return span


def test_stage2_refuses_a_span_beyond_shared_memory():
    """The largest span that fits MAX_SMEM is taken; one more sample
    is refused (there is no other path)."""
    nsub = 96
    span = _largest_span(nsub)
    sh = np.zeros((38, nsub), np.int32)
    sh[5, 3] = span
    assert cuda_dd.stage2_launch(sh).span == span
    sh[5, 3] = span + 4
    with pytest.raises(ValueError, match="shared memory"):
        cuda_dd.stage2_launch(sh)
    with pytest.raises(ValueError):
        cuda_dd.stage2_launch(np.zeros((0, nsub), np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("ndms", [1, 6, 19, 32, 33, 38, 64, 76, 100])
def test_cuda_stage2_rows(cuda_device, ndms):
    """On the card, one launch per call at every row count, exact; T
    is not a multiple of the tile and the widest rows reach the T-1
    clamp."""
    rng = np.random.default_rng(ndms)
    nsub, T = 96, 30_011
    subb = torch.from_numpy(rng.standard_normal((nsub, T)).astype(
        np.float32)).to(cuda_device)
    sh = (rng.integers(0, 20, nsub)[None, :] * np.arange(ndms)[:, None]
          // 8 + rng.integers(0, 3, (ndms, nsub))).astype(np.int32)
    sh[:, :4] += T - 200
    before = cuda_dd.LAUNCHES["dedisperse_subbands"]
    got = cuda_dd.dedisperse_subbands(subb, sh)
    assert cuda_dd.LAUNCHES["dedisperse_subbands"] == before + 1
    assert torch.equal(got, cuda_dd.dedisperse_subbands_plain(subb, sh))


@pytest.mark.cuda
@pytest.mark.parametrize("span", ["zero", 151, "largest"])
def test_cuda_stage2_spans(cuda_device, span):
    """Spans of 0, 151 (the Mock plan's widest) and the largest that
    fits a block's shared memory, exact."""
    rng = np.random.default_rng(3)
    nsub, T, ndms = 96, 20_000, 38
    span = {"zero": 0, "largest": _largest_span(nsub)}.get(span, span)
    subb = torch.from_numpy(rng.standard_normal((nsub, T)).astype(
        np.float32)).to(cuda_device)
    base = rng.integers(0, 5000, nsub)
    # rows alternate between two shifts `span` apart, in every group
    sh = (base[None, :] + span * (np.arange(ndms)[:, None] % 2)).astype(
        np.int32)
    assert cuda_dd.stage2_launch(sh).span == span
    got = cuda_dd.dedisperse_subbands(subb, sh)
    assert torch.equal(got, cuda_dd.dedisperse_subbands_plain(subb, sh))


@pytest.mark.cuda
def test_cuda_stage2_unaligned_rows_and_clamp(cuda_device):
    """A T that leaves rows off 16-byte boundaries, a view that starts
    off one, and shifts past the end of the series: exact."""
    rng = np.random.default_rng(9)
    nsub, T = 13, 5_003
    full = torch.from_numpy(rng.standard_normal(nsub * T + 1).astype(
        np.float32)).to(cuda_device)
    subb = full[1:].view(nsub, T)
    sh = rng.integers(0, 150, (27, nsub)).astype(np.int32)
    sh[:, 5:] += T - 100
    got = cuda_dd.dedisperse_subbands(subb, sh)
    assert torch.equal(got, cuda_dd.dedisperse_subbands_plain(subb, sh))


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [1, 3, 10])
def test_cuda_stage1_float32_exact(cuda_device, ds):
    """float32 stage 1 keeps c order then r order from 0.0f, so it
    equals the plain version exactly; T and the shifts leave windows
    off 16-byte boundaries and reach the T-1 clamp."""
    rng = np.random.default_rng(40 + ds)
    nchan, T, nsub = 960, 40_009, 96
    data = torch.from_numpy(rng.standard_normal((nchan, T)).astype(
        np.float32)).to(cuda_device)
    sh = rng.integers(0, 220, nchan).astype(np.int32)
    sh[::7] = 0
    got = cuda_dd.form_subbands(data, sh, nsub, ds)
    assert torch.equal(got, cuda_dd.form_subbands_plain(data, sh, nsub, ds))


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [1, 2, 3, 5, 6, 10])
def test_cuda_stage1_uint8_mock_downsamples(cuda_device, ds):
    """uint8 stage 1 at every downsample of the Mock plan, 10 channels
    a subband, rows off 16-byte boundaries, exact."""
    rng = np.random.default_rng(ds)
    nchan, T, nsub = 960, 60_013, 96
    data = torch.from_numpy(rng.integers(0, 256, (nchan, T),
                                         dtype=np.uint8)).to(cuda_device)
    sh = rng.integers(0, 220, nchan).astype(np.int32)
    sh[::10] = 0
    got = cuda_dd.form_subbands(data, sh, nsub, ds)
    assert torch.equal(got, cuda_dd.form_subbands_plain(data, sh, nsub, ds))


@pytest.mark.cuda
def test_cuda_stage1_many_channels_per_subband(cuda_device):
    """uint8 with 600 channels in one subband (the 16-bit lanes are
    flushed every 255 channels), exact."""
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.integers(200, 256, (600, 9_001),
                                         dtype=np.uint8)).to(cuda_device)
    sh = rng.integers(0, 50, 600).astype(np.int32)
    got = cuda_dd.form_subbands(data, sh, 1, 2)
    assert torch.equal(got, cuda_dd.form_subbands_plain(data, sh, 1, 2))


@pytest.mark.cuda
def test_cuda_stream_step_matches_plain(cuda_device):
    """A stream emission on the card is one stage-2 launch with the
    240 channels as subbands; its first chunk_len columns equal the
    plain window scan exactly (dedisperse_stream_step's CPU route)."""
    from tpulsar_torch.stream.dedisp_state import StreamDedisp

    geom = dict(nchan=240, chunk_len=4096, ndms=100, dt=65.476e-6,
                f_lo_mhz=1214.36, f_hi_mhz=1536.64, dm_max=200.0,
                span_chunks=4)
    sd = StreamDedisp(geom, device=cuda_device)
    rng = np.random.default_rng(8)
    win = torch.from_numpy(rng.standard_normal(
        (240, sd.window_width), dtype=np.float32)).to(cuda_device)
    before = cuda_dd.LAUNCHES["dedisperse_subbands"]
    got = tdd.dedisperse_stream_step(win, sd.shifts, sd.chunk_len)
    assert cuda_dd.LAUNCHES["dedisperse_subbands"] == before + 1
    assert got.shape == (100, 4096)
    assert torch.equal(got, tdd.dedisperse_window_scan(win, sd.shifts,
                                                       sd.chunk_len))
