"""tpulsar_torch Fourier stages against the JAX package (same inputs,
made with numpy from a seed).  Spectra are compared at a tolerance:
the FFT libraries differ (pocketfft / cuFFT against XLA's).  The
harmonic-sum order and the top-k tie order are exact contracts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpulsar.kernels import fourier as jfr  # noqa: E402
from tpulsar_torch.kernels import fourier as tfr  # noqa: E402


def _series(seed=0, ndms=3, T=30000, dt=5e-4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ndms, T)).astype(np.float32)
    t = np.arange(T) * dt
    x += (((t / 0.05) % 1.0) < 0.1).astype(np.float32)[None, :] * 0.3
    x += np.cumsum(rng.standard_normal(T)).astype(np.float32) * 0.01
    return x


def test_fft_library_differs_within_tolerance():
    """Hazard: the FFT libraries are not bit-identical.  The complex
    spectrum agrees to 1e-4 of the spectrum's scale, not exactly."""
    x = _series()
    want = np.asarray(jfr.complex_spectrum(jnp.asarray(x)))
    got = tfr.complex_spectrum(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got[:, 0].tolist() == [0, 0, 0]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_pad_series_matches():
    x = _series(1, T=1000)
    for nfft in (1000, 900, 1152):
        np.testing.assert_allclose(
            tfr.pad_series(torch.from_numpy(x), nfft).numpy(),
            np.asarray(jfr.pad_series(jnp.asarray(x), nfft)), rtol=1e-6)


def test_block_edges_and_level():
    np.testing.assert_array_equal(tfr._block_edges(2_000_001),
                                  jfr._block_edges(2_000_001))
    p = np.random.default_rng(2).exponential(size=(4, 8192)).astype(
        np.float32)
    for est in ("median", "clipped_mean"):
        np.testing.assert_allclose(
            tfr._block_level(torch.from_numpy(p), est).numpy(),
            np.asarray(jfr._block_level(jnp.asarray(p), est)), rtol=1e-6)


@pytest.mark.parametrize("estimator", ["median", "clipped_mean"])
def test_whiten_powers_matches(estimator):
    """Whitening of identical powers, rtol 1e-5: medians are exact
    (even-length blocks average the two middles, as jnp.median)."""
    p = np.random.default_rng(3).exponential(size=(2, 40000)).astype(
        np.float32)
    p *= np.linspace(5, 1, 40000, dtype=np.float32)[None, :]
    edges = tuple(int(e) for e in jfr._block_edges(p.shape[-1]))
    want = np.asarray(jfr.whiten_powers(jnp.asarray(p), edges,
                                        estimator=estimator))
    got = tfr.whiten_powers(torch.from_numpy(p), edges,
                            estimator=estimator).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_whitened_spectrum_matches():
    """pad -> rfft -> whiten -> scale, unmasked and with a zap mask:
    rtol 1e-3 relative to the spectrum's scale (FFT library)."""
    x = _series(4)
    nfft = 30720
    want = np.asarray(jfr.whitened_spectrum(jnp.asarray(x), nfft=nfft))
    got = tfr.whitened_spectrum(torch.from_numpy(x), nfft=nfft).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
    nbins = nfft // 2 + 1
    keep = jfr.zap_mask(nbins, nfft * 5e-4, np.array([[20.0, 0.5]]))
    np.testing.assert_array_equal(
        tfr.zap_mask(nbins, nfft * 5e-4, np.array([[20.0, 0.5]])), keep)
    want = np.asarray(jfr.whitened_spectrum_masked(
        jnp.asarray(x), jnp.asarray(keep), nfft=nfft))
    got = tfr.whitened_spectrum_masked(torch.from_numpy(x), keep,
                                       nfft=nfft).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
    assert np.all(got[:, ~keep] == 0)


def test_interbin_and_harmonic_sum():
    """From one whitened spectrum: interbinned powers at rtol 1e-6 and
    the harmonic sums of identical powers exactly (the same terms
    summed in the same h order)."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((2, 5001))
         + 1j * rng.standard_normal((2, 5001))).astype(np.complex64)
    want = np.array(jfr.interbin_powers(jnp.asarray(w)))
    got = tfr.interbin_powers(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for h in (1, 2, 4, 8, 16):
        np.testing.assert_array_equal(
            tfr.harmonic_sum(torch.from_numpy(want), h).numpy(),
            np.asarray(jfr.harmonic_sum(jnp.asarray(want), h)))
    assert tfr.harmonic_stages(16) == jfr.harmonic_stages(16)


def test_blockmax_topk_ties_rank_like_lax_top_k():
    """Hazard: on ties torch.topk may return any index order, while
    jax.lax.top_k puts the lower index first.  The port ranks by
    larger value, then lower index."""
    v = np.array([[3, 5, 5, 1, 5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(v), 2)
    assert np.asarray(ji).tolist() == [[1, 2]]
    tv, ti = tfr.blockmax_topk(torch.from_numpy(v), 2, block_r=1)
    assert ti.tolist() == [[1, 2]] and tv.tolist() == [[5.0, 5.0]]
    # many ties across blocks, and fewer blocks than k (zero padding)
    rng = np.random.default_rng(6)
    s = rng.integers(0, 4, size=(3, 1000)).astype(np.float32)
    for topk, block_r in ((32, 64), (40, 32)):
        wv, wb = jfr.blockmax_topk(jnp.asarray(s), topk, block_r)
        gv, gb = tfr.blockmax_topk(torch.from_numpy(s), topk, block_r)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


def test_lo_stage_candidates_match():
    """Every stage's top-k from the same whitened spectrum: values at
    rtol 1e-5, bins identical."""
    x = _series(7)
    wspec = np.array(jfr.whitened_spectrum(jnp.asarray(x), nfft=30720))
    stages = (1, 2, 4, 8, 16)
    want = jfr.lo_stage_candidates(jnp.asarray(wspec), stages, 16)
    got = tfr.lo_stage_candidates(torch.from_numpy(wspec), stages, 16)
    for h in stages:
        np.testing.assert_allclose(got[h][0].numpy(),
                                   np.asarray(want[h][0]), rtol=1e-5)
        np.testing.assert_array_equal(got[h][1].numpy(),
                                      np.asarray(want[h][1]))


def test_power_spectrum_matches():
    """Raw powers with DC zeroed, at the FFT tolerance (1e-4 of the
    spectrum's scale, squared: 2e-4 of the largest power)."""
    x = _series(11)
    want = np.asarray(jfr.power_spectrum(jnp.asarray(x)))
    got = tfr.power_spectrum(x, device="cpu").numpy()
    assert got.shape == want.shape == (3, 15001)
    assert got[:, 0].tolist() == [0, 0, 0]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("keep", [False, True])
def test_periodicity_search_matches(keep):
    """The zero-acceleration search of (ndms, T) series, with and
    without a zaplist keep-mask: the same true bin count and stages,
    the powers at the lo stage's rtol 1e-5, and the same top-k bins
    except where two powers tie within that tolerance."""
    x = _series(12)
    keep_mask = None
    if keep:
        keep_mask = np.ones(15001, bool)
        keep_mask[3000:3100] = False
    want, wn = jfr.periodicity_search(jnp.asarray(x), 15.0,
                                      keep_mask=keep_mask,
                                      max_numharm=16, topk=16)
    got, gn = tfr.periodicity_search(x, 15.0, keep_mask=keep_mask,
                                     max_numharm=16, topk=16,
                                     device="cpu")
    assert gn == wn == 15001
    assert sorted(got) == sorted(want) == [1, 2, 4, 8, 16]
    for h in want:
        gv, gb = got[h]
        wv, wb = want[h]
        assert isinstance(gv, np.ndarray) and gv.shape == wv.shape
        np.testing.assert_allclose(gv, wv, rtol=1e-5)
        for row, col in zip(*np.nonzero(gb != wb)):
            # a tie: the JAX package ranks another bin of (within the
            # tolerance) the same power at this place
            assert gb[row, col] in wb[row], (h, row, col)
            assert np.isclose(wv[row, list(wb[row]).index(gb[row, col])],
                              gv[row, col], rtol=1e-5)


def test_host_functions_identical(tmp_path):
    p = np.array([5.0, 30.0, 80.0, 400.0])
    for h in (1, 4, 16):
        np.testing.assert_array_equal(
            tfr.sigma_from_power(p, h, numindep=100000),
            jfr.sigma_from_power(p, h, numindep=100000))
    assert tfr.power_threshold(6.0, 8) == jfr.power_threshold(6.0, 8)
    zl = tmp_path / "z.zaplist"
    zl.write_text("# f w\n60.0 0.5\n 120.0 1.0 # mains\n")
    np.testing.assert_array_equal(tfr.parse_zaplist(str(zl)),
                                  jfr.parse_zaplist(str(zl)))
