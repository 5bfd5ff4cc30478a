"""tpulsar_torch single-pulse search against the JAX package (same
inputs, made with numpy from a seed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpulsar.kernels import singlepulse as jsp  # noqa: E402
from tpulsar_torch.kernels import singlepulse as tsp  # noqa: E402


def _series(seed=0, ndms=5, T=5300):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ndms, T)).astype(np.float32)
    x += np.linspace(0, 3, T, dtype=np.float32)[None, :]   # drift
    x[:, 1234:1240] += 6.0                                  # a pulse
    x[2, 1800:1820] += 3.0
    return x


@pytest.mark.parametrize("estimator", ["median", "median_sub4",
                                       "clipped_mean"])
def test_detrend_normalize_matches(estimator):
    """Every estimator, T not a multiple of the 1000-sample detrend
    block (the tail-block rule: the short tail gets its own
    baseline): rtol 1e-5 (float32 reductions in other orders)."""
    x = _series()
    want = np.asarray(jsp.detrend_normalize(jnp.asarray(x), 1000,
                                            estimator))
    got = tsp.detrend_normalize(torch.from_numpy(x), 1000,
                                estimator).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tail_block_gets_its_own_baseline():
    """The tail (T mod 1000 samples) is baselined by its own median:
    a tail offset by +50 comes out near zero mean, as in the
    reference."""
    x = np.zeros((1, 2300), np.float32)
    x[:, 2000:] = 50.0
    x += np.random.default_rng(1).standard_normal(x.shape).astype(
        np.float32)
    got = tsp.detrend_normalize(torch.from_numpy(x)).numpy()
    want = np.asarray(jsp.detrend_normalize(jnp.asarray(x)))
    assert abs(got[0, 2000:].mean()) < 0.2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_even_length_median_averages_the_middle_pair():
    """Hazard: torch.median([1, 2, 3, 10]) is 2 (the lower middle);
    jnp.median gives 2.5.  The detrend block (1000) is always even,
    so the port takes the mean of the two middles: exact."""
    x = np.array([[10.0, 1.0, 3.0, 2.0]], np.float32)
    assert float(torch.median(torch.from_numpy(x))) == 2.0
    got = tsp.median_lastdim(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(x, axis=-1)))
    assert got[0] == 2.5
    y = np.random.default_rng(2).standard_normal((3, 7, 1000)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tsp.median_lastdim(torch.from_numpy(y)).numpy(),
        np.asarray(jnp.median(y, axis=-1)))


def test_std_is_population_std():
    """Hazard: torch.std defaults to correction=1; jnp.std uses ddof
    0.  The normalized series must have population std 1."""
    x = _series(3, ndms=3, T=2000)
    got = tsp.detrend_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.std(axis=-1), 1.0, rtol=1e-5)


def test_boxcar_search_matches():
    """Top-k SNRs at rtol 1e-5 and identical sample indices (the
    cumsum runs in a different order in the two libraries)."""
    norm = np.array(jsp.detrend_normalize(jnp.asarray(_series(4))))
    ws, wi = jsp.boxcar_search(jnp.asarray(norm))
    ts, ti = tsp.boxcar_search(torch.from_numpy(norm))
    assert tuple(ts.shape) == tuple(ws.shape) == (9, 5, 128)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))


def test_device_search_and_events_match():
    """device_search -> events_from_topk: the same events in (dm,
    sample, downfact), sigma at rtol 1e-4."""
    x = _series(5)
    dms = np.array([10.0, 11.0, 12.0, 13.0, 14.0])
    ws, wi = jsp.device_search(jnp.asarray(x))
    ts, ti = tsp.device_search(torch.from_numpy(x))
    jev = jsp.events_from_topk(ws, wi, dms, 1e-3)
    tev = tsp.events_from_topk(ts.numpy(), ti.numpy(), dms, 1e-3)
    assert len(tev) == len(jev) > 0
    key = lambda e: sorted(zip(e["dm"], e["sample"], e["downfact"]))  # noqa: E731
    assert key(tev) == key(jev)
    np.testing.assert_allclose(np.sort(tev["sigma"]),
                               np.sort(jev["sigma"]), rtol=1e-4)


def test_singlepulse_file_identical(tmp_path):
    x = _series(6)
    dms = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    ev = jsp.single_pulse_search(jnp.asarray(x), dms, 1e-3)
    jsp.write_singlepulse_file(str(tmp_path / "j"), ev, 3.0)
    tsp.write_singlepulse_file(str(tmp_path / "t"), ev, 3.0)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    assert tsp.SP_EVENT_DTYPE == jsp.SP_EVENT_DTYPE
    assert tsp.DEFAULT_WIDTHS == jsp.DEFAULT_WIDTHS


def test_detrend_estimator_env(monkeypatch):
    monkeypatch.setenv("TPULSAR_SP_DETREND", "clipped_mean")
    assert tsp.detrend_estimator("median") == "clipped_mean"
    monkeypatch.setenv("TPULSAR_SP_DETREND", "bogus")
    with pytest.raises(ValueError):
        tsp.detrend_estimator()
