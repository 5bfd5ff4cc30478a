"""tpulsar_torch RFI masking against the JAX package (same inputs,
made with numpy from a seed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpulsar.kernels import rfi as jrfi  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.kernels import rfi as trfi  # noqa: E402


def _dirty_block(seed=0, nchan=24, T=16384):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    data[5] += 4.0 * np.sin(np.arange(T) * 0.3).astype(np.float32)
    data[11] *= 6.0
    data[:, 9000:9300] += 8.0
    return data


def test_cell_stats_match():
    """Per-cell mean / std / max Fourier power at rtol 1e-5 (float32
    reductions and FFTs in two libraries, summed in different
    orders)."""
    data = _dirty_block()
    want = jrfi._cell_stats_chan(jnp.asarray(data), 1024)
    got = trfi._cell_stats_chan(torch.from_numpy(data), 1024)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (16, 24)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_variance_is_population_variance():
    """Hazard: torch.var defaults to correction=1, jnp.var to ddof 0.
    A block of [0, 2] has population std 1 (sample std 1.414)."""
    x = np.tile(np.array([0.0, 2.0], np.float32), (1, 512))
    _m, std, _p = trfi._cell_stats_chan(torch.from_numpy(x), 1024)
    _jm, jstd, _jp = jrfi._cell_stats_chan(jnp.asarray(x), 1024)
    assert float(std[0, 0]) == pytest.approx(1.0, rel=1e-6)
    assert float(std[0, 0]) == pytest.approx(float(jstd[0, 0]), rel=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_find_and_apply_mask_match(dtype):
    """The same cells masked and the same fill levels (fill rtol
    1e-5); the applied block equal (uint8: exactly, float32: at the
    fill's tolerance)."""
    data = _dirty_block(1)
    if dtype == np.uint8:
        data = np.clip(np.rint(data * 12 + 128), 0, 255).astype(np.uint8)
    jm = jrfi.find_rfi_chan(jnp.asarray(data), 1e-3, block_len=2048)
    tm = trfi.find_rfi_chan(torch.from_numpy(data), 1e-3, block_len=2048)
    np.testing.assert_array_equal(tm.cell_mask, jm.cell_mask)
    np.testing.assert_array_equal(tm.bad_channels, jm.bad_channels)
    np.testing.assert_array_equal(tm.bad_blocks, jm.bad_blocks)
    assert tm.masked_fraction == jm.masked_fraction > 0
    np.testing.assert_allclose(tm.chan_fill, jm.chan_fill, rtol=1e-5,
                               atol=1e-6)
    want = np.asarray(jrfi.apply_mask_chan(
        jnp.asarray(data), jnp.asarray(jm.full_mask()),
        jnp.asarray(jm.chan_fill), jm.block_len))
    got = trfi.apply_mask_chan(torch.from_numpy(data), jm.full_mask(),
                               jm.chan_fill, jm.block_len).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_short_observation_gets_one_cell():
    data = _dirty_block(2, T=1500)
    tm = trfi.find_rfi_chan(torch.from_numpy(data), 1e-3, block_len=2048)
    jm = jrfi.find_rfi_chan(jnp.asarray(data), 1e-3, block_len=2048)
    assert tm.block_len == jm.block_len == 1500
    assert tm.cell_mask.shape == jm.cell_mask.shape == (1, 24)


def test_mask_file_loads_in_both_packages(tmp_path):
    """The _rfifind.npz artifact is one format: a JAX-written mask
    loads in the port and a port-written one loads back equal in the
    JAX package, quantization map included."""
    data = _dirty_block(3)
    jm = jrfi.find_rfi_chan(jnp.asarray(data), 1e-3, block_len=2048)
    qs, qo = np.full(24, 0.5, np.float32), np.arange(24, dtype=np.float32)
    jpath = str(tmp_path / "j_rfifind.npz")
    jm.save(jpath, qscale=qs, qoff=qo)
    tm = state.load_rfi_mask(jpath)
    for f in ("cell_mask", "bad_channels", "bad_blocks", "chan_fill"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    assert (tm.block_len, tm.dt) == (jm.block_len, jm.dt)
    tpath = str(tmp_path / "t_rfifind.npz")
    state.save_rfi_mask(tm, tpath, qscale=qs, qoff=qo)
    back = jrfi.RFIMask.load(tpath)
    for f in ("cell_mask", "bad_channels", "bad_blocks", "chan_fill"):
        np.testing.assert_array_equal(getattr(back, f), getattr(jm, f))
    assert (back.block_len, back.dt) == (jm.block_len, jm.dt)
    q = jrfi.RFIMask.load_quantization(tpath)
    np.testing.assert_array_equal(q[0], qs)
    np.testing.assert_array_equal(q[1], qo)
    assert trfi.RFIMask.load_quantization(jpath) is not None
