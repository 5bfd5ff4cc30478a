"""tpulsar_torch.search.refine (harmpolish) against the JAX package's
tpulsar.search.refine, on the same NumPy-seeded series.

The simplex and the response functions are the same host NumPy code,
so on the same spectrum they agree exactly; through refine_candidates
the spectra come from two FFT libraries (pocketfft vs XLA), so the
refined (r, z) agree to 1e-3 bins and the power to rtol 1e-3."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpulsar.search import refine as jref  # noqa: E402
from tpulsar.search import sifting as jsift  # noqa: E402
from tpulsar_torch.search import refine as tref  # noqa: E402
from tpulsar_torch.search import sifting as tsift  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)

R_ATOL = 1e-3        # bins
Z_ATOL = 1e-3        # bins of drift
POWER_RTOL = 1e-3


def _spectrum(nbins=4096, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=nbins) + 1j * rng.normal(size=nbins)
            ).astype(np.complex64)


@pytest.mark.parametrize("r0, z0, numharm", [
    (20.0, 0.0, 1),          # lower clamp
    (100.0, 180.0, 1),       # wide template, low r
    (4086.0, 0.0, 1),        # upper clamp
    (500.0, 4.0, 4),         # harmonics
])
def test_windowed_view_matches_full_spectrum_at_edges(r0, z0, numharm):
    """The fetched-window view reproduces the full-array refinement
    exactly where power_at's edge clamps engage, and the port's
    windows and simplex equal the reference's."""
    spec = _spectrum()
    nbins = len(spec)
    spans = tref._harmonic_windows(r0, z0, numharm, nbins)
    assert spans == jref._harmonic_windows(r0, z0, numharm, nbins)
    width = tref._window_width(max(hi - lo for lo, hi in spans))
    lows = np.asarray([lo for lo, _ in spans])
    fetched = tref._gather_windows(torch.from_numpy(spec), lows, width)
    view = tref._WindowedSpectrum(
        nbins, [(lo, fetched[i][: min(width, nbins - lo)])
                for i, lo in enumerate(lows)])
    got = tref.refine_peak(view, r0, z0, numharm=numharm)
    assert got == tref.refine_peak(spec, r0, z0, numharm=numharm)
    assert got == jref.refine_peak(spec, r0, z0, numharm=numharm)


@pytest.mark.parametrize("z", [0.0, 3.5, -12.25, 40.0])
def test_power_at_and_response_equal_the_reference(z):
    spec = _spectrum(seed=3)
    offs = np.linspace(-20.0, 20.0, 81)
    np.testing.assert_array_equal(tref._response_at(z, offs),
                                  jref._response_at(z, offs))
    for r in (57.3, 1000.0, 2047.5):
        assert tref.power_at(spec, r, z) == jref.power_at(spec, r, z)


def _series(T=1 << 15, dt=1e-3, seed=5):
    """Noise plus a drifting pulse train (z ~ 9 at the fundamental)
    and a steady tone."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) * dt
    T_s = T * dt
    f0, z_true = 21.3, 9.0
    fdot = z_true / T_s ** 2
    x = rng.standard_normal(T)
    x += 0.5 * np.cos(2 * np.pi * (f0 * t + 0.5 * fdot * t * t))
    x += 0.4 * np.cos(2 * np.pi * 7.77 * t)
    return x.astype(np.float32), dt, T_s


def _cands(mod, T_s):
    """The grid detections to refine: fundamental-bin (r, z) near each
    injected signal, off the truth by a fraction of a cell."""
    out = []
    for f, z, nh in ((21.3 + 4.5 / T_s, 8.0, 1), (7.77 + 0.3 / T_s, 0.0, 2),
                     (21.3 + 4.5 / T_s, 10.0, 2)):
        out.append(mod.Candidate(r=f * T_s, z=z, sigma=10.0, power=0.0,
                                 numharm=nh, dm=30.0, period_s=1.0 / f,
                                 freq_hz=f))
    return out


@pytest.mark.parametrize("zap", [False, True])
def test_refine_candidates_matches_jax(zap):
    x, dt, T_s = _series()
    nfft = len(x)
    keep = None
    if zap:
        keep = np.ones(nfft // 2 + 1, bool)
        keep[1000:1010] = False
    jc, tc = _cands(jsift, T_s), _cands(tsift, T_s)
    jref.refine_candidates(jc, {30.0: jnp.asarray(x)}, dt, nfft,
                           keep_mask=keep)
    tref.refine_candidates(tc, {30.0: torch.from_numpy(x)}, dt, nfft,
                           keep_mask=keep)
    for g, w in zip(tc, jc):
        assert g.r == pytest.approx(w.r, abs=R_ATOL)
        assert g.z == pytest.approx(w.z, abs=Z_ATOL)
        assert g.power == pytest.approx(w.power, rel=POWER_RTOL)
        assert g.freq_hz == pytest.approx(g.r / T_s, rel=1e-12)
        assert g.period_s == pytest.approx(T_s / g.r, rel=1e-12)
    # the drifting train is refined towards its true drift
    assert abs(tc[0].z - 9.0) < 1.0


def test_dedisperse_single_and_the_exact_oracle():
    """Refinement's series (stage 1 at ds 1, then stage 2 at one row)
    is bit-identical to the reference's on a uint8 block, and it tracks
    the exact single-stage oracle, whose port equals the reference's,
    as tests/test_dedisperse.py holds the reference to it."""
    from tpulsar.io import synth
    from tpulsar.kernels import dedisperse as jdd
    from tpulsar.search import executor as jex
    from tpulsar_torch.kernels import dedisperse as tdd
    from tpulsar_torch.search import executor as tex

    spec = synth.BeamSpec(nchan=32, nsamp=4096, seed=3)
    psr = synth.PulsarSpec(period_s=0.2, dm=50.0, snr_per_sample=3.0)
    dyn = synth.make_dynamic_spectrum(spec, pulsars=[psr]).T
    data = np.clip(np.rint(dyn * 16 + 128), 0, 255).astype(np.uint8)
    freqs = synth.channel_freqs(spec)
    dt, dm = spec.tsamp_s, psr.dm
    got = tex._dedisperse_single(torch.from_numpy(data), freqs, 8, dm, dt)
    want = jex._dedisperse_single(jnp.asarray(data), freqs, 8, dm, dt)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = tdd.dedisperse_exact(data, freqs, [dm], dt)
    np.testing.assert_array_equal(
        oracle, jdd.dedisperse_exact(data, freqs, [dm], dt))
    np.testing.assert_array_equal(
        tdd.dedisperse_exact(data, freqs, [dm], dt, downsamp=4),
        jdd.dedisperse_exact(data, freqs, [dm], dt, downsamp=4))
    valid = data.shape[1] - jdd.max_shift_samples(freqs, dm, dt) - 1
    assert np.corrcoef(got.numpy()[:valid], oracle[0, :valid])[0, 1] > 0.95
