"""The port's native PSRFITS unpack (tpulsar_torch/native, built with
g++ at first use) against the JAX package's (tpulsar/native) and the
port's own NumPy unpack, on the same bytes: every entry point and the
4-bit read paths of SpectraInfo are byte-identical.  The native path
never falls back: a library that does not build makes the read raise,
and only an explicit unpack="numpy" reads without it.

Tolerance: none — every comparison here is exact (uint8/int16 samples,
and float32 calibration computed in the same order by the same
source)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
from tpulsar import native as jnative  # noqa: E402
from tpulsar.io import psrfits as jpf  # noqa: E402
from tpulsar.io import synth  # noqa: E402
from tpulsar_torch import native as tnative  # noqa: E402
from tpulsar_torch.io import psrfits as tpf  # noqa: E402


@pytest.fixture(scope="module")
def beam(tmp_path_factory):
    """A 64-channel 4-bit beam with a dispersed pulsar (2 files' worth
    of rows in one merged file)."""
    spec = synth.BeamSpec(nchan=64, nsamp=1 << 14, nbits=4, seed=5)
    psr = synth.PulsarSpec(period_s=0.25, dm=50.0, snr_per_sample=1.0)
    return synth.synth_beam(str(tmp_path_factory.mktemp("nat")), spec,
                            pulsars=[psr], merged=True)


@pytest.mark.parametrize("nbits", [4, 2, 1])
def test_unpack_bits_matches_jax_and_numpy(nbits):
    raw = np.random.default_rng(nbits).integers(
        0, 256, size=(7, 301), dtype=np.uint8)
    got = tnative.unpack_bits(raw, nbits)
    assert got.dtype == np.int16 and got.shape == (7, 301 * 8 // nbits)
    np.testing.assert_array_equal(got, jnative.unpack_bits(raw, nbits))
    np.testing.assert_array_equal(
        got, tpf.unpack_samples(raw, nbits, unpack="numpy"))


def test_fused_unpacks_match_jax():
    rng = np.random.default_rng(2)
    nspec, nchan = 257, 96
    raw = rng.integers(0, 256, size=(nspec, nchan // 2), dtype=np.uint8)
    scl = rng.uniform(0.5, 3.0, nchan).astype(np.float32)
    offs = rng.normal(0.0, 5.0, nchan).astype(np.float32)
    cal = tnative.unpack4_calibrate(raw, scl, offs)
    assert cal.dtype == np.float32 and cal.shape == (nspec, nchan)
    np.testing.assert_array_equal(cal, jnative.unpack4_calibrate(
        raw, scl, offs))
    # the NumPy path's arithmetic: unpack, then x * scl + offs in f32
    x = tpf.unpack_samples(raw, 4, unpack="numpy").astype(np.float32)
    np.testing.assert_array_equal(cal, x * scl + offs)
    a = (scl / 7.0).astype(np.float32)
    b = rng.uniform(-20.0, 300.0, nchan).astype(np.float32)
    q = tnative.unpack4_quantize(raw, a, b)
    assert q.dtype == np.uint8
    np.testing.assert_array_equal(q, jnative.unpack4_quantize(raw, a, b))
    with pytest.raises(ValueError, match="per-channel"):
        tnative.unpack4_quantize(raw, a[:-1], b)


def test_read_all_uint8_native_numpy_and_jax_agree(beam):
    """read_all_uint8 — the read of the main path — gives one block
    three ways: the port's native path, the port's NumPy path, and the
    JAX package's native path; the float32 read agrees too.  The
    counter records which unpack ran."""
    tpf.reset_counts()
    nat = tpf.SpectraInfo(beam)
    blk, scale, off = nat.read_all_uint8()
    assert tpf.UNPACKS["native"] > 0 and tpf.UNPACKS["numpy"] == 0
    tpf.reset_counts()
    ref, scale_n, off_n = tpf.SpectraInfo(beam,
                                          unpack="numpy").read_all_uint8()
    assert tpf.UNPACKS["native"] == 0 and tpf.UNPACKS["numpy"] > 0
    jblk, jscale, joff = jpf.SpectraInfo(beam).read_all_uint8()
    assert blk.dtype == np.uint8 and blk.shape == (1 << 14, 64)
    np.testing.assert_array_equal(blk, ref)
    np.testing.assert_array_equal(blk, jblk)
    np.testing.assert_array_equal(scale, scale_n)
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_array_equal(
        nat.read_all(), tpf.SpectraInfo(beam, unpack="numpy").read_all())


def test_a_failed_build_raises_and_never_falls_back(beam, tmp_path,
                                                    monkeypatch):
    """With a compiler that fails, the native read raises with the
    compiler's command and exit code; the NumPy read, asked for
    explicitly, still works."""
    monkeypatch.setattr(tnative, "CXX", "false")
    monkeypatch.setenv("TPULSAR_CACHE_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="did not build") as err:
        tpf.SpectraInfo(beam).read_all_uint8()
    assert "$ false -O3 -march=native -ffp-contract=off" in str(err.value)
    assert "(exit 1)" in str(err.value)
    with pytest.raises(RuntimeError, match="did not build"):
        tpf.unpack_samples(np.zeros((1, 4), np.uint8), 2)
    blk, _s, _o = tpf.SpectraInfo(beam, unpack="numpy").read_all_uint8()
    assert blk.shape == (1 << 14, 64)
    assert tnative._lib is None


def test_unknown_unpack_is_refused(beam):
    with pytest.raises(ValueError, match="unpack must be one of"):
        tpf.SpectraInfo(beam, unpack="fast")
