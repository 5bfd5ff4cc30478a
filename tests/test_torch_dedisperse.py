"""tpulsar_torch dedispersion (stage 1 + stage 2) against the JAX
package: the plain PyTorch versions the CUDA kernels are held to on
the card must equal the JAX reference BIT FOR BIT — stage 1 on uint8
input (integer sums), stage 2 always (both sum subbands in order) —
and must match the Pallas kernels run in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpulsar.kernels import dedisperse as jdd  # noqa: E402
from tpulsar.kernels import pallas_dd  # noqa: E402
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
    assert cuda_dd.LAUNCHES == {"form_subbands": 0,
                                "dedisperse_subbands": 0}


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
    assert cuda_dd.LAUNCHES["dedisperse_subbands"] == \
        before["dedisperse_subbands"] + 2
