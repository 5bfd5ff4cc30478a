"""tpulsar_torch.kernels.fold / fold_batch against the JAX package's
tpulsar.kernels.fold / fold_batch, on the same NumPy-seeded blocks.

Grid choices (dp, dpdot and DM offsets) are compared exactly: the
signals are strong, so no two grid points come near a tie.  Folded
sums go through other float orders (einsum vs XLA dot, index_add_ vs
XLA scatter, pocketfft vs XLA's FFT): chi2 at rtol 1e-4, profiles at
rtol 1e-4 of their peak, periods at rtol 1e-9."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpulsar.constants import KDM, dispersion_delay_s  # noqa: E402
from tpulsar.kernels import dedisperse as jdd  # noqa: E402
from tpulsar.kernels import fold as jfold  # noqa: E402
from tpulsar.kernels import fold_batch as jfb  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.kernels import dedisperse as tdd  # noqa: E402
from tpulsar_torch.kernels import fold as tfold  # noqa: E402
from tpulsar_torch.kernels import fold_batch as tfb  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)

CHI2_RTOL = 1e-4
PROFILE_RTOL = 1e-4
PERIOD_RTOL = 1e-9

NSUB, T, DT = 8, 1 << 13, 5e-4
P_TRUE, DM_TRUE = 0.15, 60.0
FREQS = np.linspace(1214.0, 1536.0, 64)


def _assert_same_fold(got, want):
    assert (got.nbin, got.npart) == (want.nbin, want.npart)
    # the grid choices, exactly
    assert got.delta_p == want.delta_p
    assert got.delta_pdot == want.delta_pdot
    assert got.delta_dm == want.delta_dm
    assert got.period_s == pytest.approx(want.period_s, rel=PERIOD_RTOL)
    assert got.pdot == want.pdot and got.dm == want.dm
    assert got.reduced_chi2 == pytest.approx(want.reduced_chi2,
                                             rel=CHI2_RTOL)
    for a, b in ((got.profile, want.profile),
                 (got.subints, want.subints)):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=PROFILE_RTOL * np.abs(b).max())


def _synth_subbands(snr=4.0, seed=0):
    """Unaligned subband block with a dispersed pulsar
    (tests/test_fold_batch.py's construction)."""
    rng = np.random.default_rng(seed)
    subrefs = jdd.subband_reference_freqs(FREQS, NSUB)
    t = np.arange(T) * DT
    subb = rng.normal(0, 1, (NSUB, T)).astype(np.float32)
    delays = KDM * DM_TRUE * (subrefs ** -2 - subrefs[-1] ** -2)
    for s in range(NSUB):
        ph = np.mod((t - delays[s]) / P_TRUE, 1.0)
        subb[s] += snr * np.exp(
            -0.5 * (np.minimum(ph, 1 - ph) / 0.03) ** 2)
    return subb, subrefs


@pytest.mark.parametrize("cands, period", [
    ([(P_TRUE, DM_TRUE)], P_TRUE),
    ([(P_TRUE * 1.001, DM_TRUE + 2.0), (P_TRUE, DM_TRUE),
      (P_TRUE * 0.999, DM_TRUE - 2.0)], P_TRUE),
    ([(0.8, 10.0), (0.81, 60.0)], 0.8),          # no-pdot tier
    ([(0.03, DM_TRUE)], 0.03),                   # 50-bin tier
])
def test_fold_subbands_batch_matches_jax(cands, period):
    subb, subrefs = _synth_subbands(snr=6.0)
    rules = jfold.fold_rules(period)
    want = jfb.fold_subbands_batch(subb, subrefs, DT, cands, rules)
    got = tfb.fold_subbands_batch(torch.from_numpy(subb), subrefs, DT,
                                  cands, tfold.fold_rules(period))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_fold(g, w)


def test_candidate_chunking_does_not_change_the_folds():
    """max_onehot_bytes' chunking: one candidate a chunk gives the
    batch's results."""
    subb, subrefs = _synth_subbands()
    rules = tfold.fold_rules(P_TRUE)
    cands = [(P_TRUE, DM_TRUE), (P_TRUE * 1.001, DM_TRUE + 2.0)]
    whole = tfb.fold_subbands_batch(torch.from_numpy(subb), subrefs, DT,
                                    cands, rules)
    per = (T // rules.npart + 1) * rules.nbin * 4
    split = tfb.fold_subbands_batch(torch.from_numpy(subb), subrefs, DT,
                                    cands, rules, max_onehot_bytes=per)
    for a, b in zip(whole, split):
        assert (a.delta_p, a.delta_pdot, a.delta_dm) == \
            (b.delta_p, b.delta_pdot, b.delta_dm)
        assert a.reduced_chi2 == pytest.approx(b.reduced_chi2, rel=1e-5)


def test_fold_candidates_by_pass_matches_jax():
    rng = np.random.default_rng(2)
    nchan, nsamp, dt = 64, 1 << 13, 5e-4
    freqs = np.linspace(1214.0, 1536.0, nchan)
    t = np.arange(nsamp) * dt
    data = rng.normal(8, 2, (nchan, nsamp)).astype(np.float32)
    delays = KDM * DM_TRUE * (freqs ** -2 - freqs[-1] ** -2)
    for c in range(nchan):
        ph = np.mod((t - delays[c]) / P_TRUE, 1.0)
        data[c] += 5.0 * np.exp(
            -0.5 * (np.minimum(ph, 1 - ph) / 0.03) ** 2)
    jplan = [jddplan.DedispStep(lodm=0.0, dmstep=2.0, dms_per_pass=38,
                                numpasses=2, numsub=NSUB, downsamp=1),
             jddplan.DedispStep(lodm=152.0, dmstep=3.0, dms_per_pass=20,
                                numpasses=1, numsub=NSUB, downsamp=2)]
    tplan = state.plan_from_jax([dataclasses.asdict(s) for s in jplan])
    cand_list = [(0, P_TRUE, DM_TRUE), (1, 2 * P_TRUE, DM_TRUE),
                 (2, P_TRUE, 20.0), (3, 0.4, 170.0)]
    want = jfb.fold_candidates_by_pass(
        jnp.asarray(data), freqs, dt, jplan, cand_list, NSUB,
        lambda d, ch_sh, ns, ds: jdd.form_subbands(
            d, jnp.asarray(ch_sh), ns, ds))
    got = tfb.fold_candidates_by_pass(
        torch.from_numpy(data), freqs, dt, tplan, cand_list, NSUB,
        tdd.form_subbands)
    assert set(got) == set(want) == {0, 1, 2, 3}
    for k in want:
        _assert_same_fold(got[k], want[k])
    assert got[0].reduced_chi2 > 20
    assert tfb.pass_of(tplan, 170.0) == (1, 0)
    assert tfb.pass_of(tplan, DM_TRUE) == (0, 0)


def _subband_pulse_train(nsub=16, T=1 << 15, dt=1e-3, p=0.08, dm=50.0,
                         amp=1.2, seed=7):
    """Stage-1-style subbands, inter-subband delays intact
    (tests/test_fold.py's construction)."""
    rng = np.random.default_rng(seed)
    sub_freqs = np.linspace(1220.0, 1520.0, nsub)
    data = rng.standard_normal((nsub, T)).astype(np.float32)
    t = np.arange(T) * dt
    delays = dispersion_delay_s(dm, sub_freqs, sub_freqs[-1])
    for s in range(nsub):
        phase = ((t - delays[s]) / p) % 1.0
        data[s] += (phase < 0.1) * amp
    return data, sub_freqs


@pytest.mark.parametrize("dm_off, p_off, rules", [
    (8.0, 0.4, dict(nbin=50, npart=24, mp=2, mdm=1, search_pdot=True,
                    dmstep=1)),
    (0.0, 0.0, dict(nbin=50, npart=24, mp=1, mdm=1, search_pdot=False,
                    dmstep=3)),
])
def test_fold_subbands_and_optimize_matches_jax(dm_off, p_off, rules):
    p_true, dm_true, dt = 0.08, 50.0, 1e-3
    data, sub_freqs = _subband_pulse_train(p=p_true, dm=dm_true, dt=dt)
    T_s = data.shape[1] * dt
    dm0 = dm_true + dm_off
    p0 = p_true * (1.0 + p_off * p_true / T_s)
    shifts0 = jdd.shift_samples(dm0, sub_freqs, sub_freqs[-1], dt)
    want = jfold.fold_subbands_and_optimize(
        data, sub_freqs, dt, p0, dm=dm0, rules=jfold.FoldRules(**rules),
        sub_shifts_dm0=shifts0)
    got = tfold.fold_subbands_and_optimize(
        torch.from_numpy(data), sub_freqs, dt, p0, dm=dm0,
        rules=tfold.FoldRules(**rules), sub_shifts_dm0=shifts0)
    _assert_same_fold(got, want)
    assert got.reduced_chi2 > 5.0


def _pulsar_series(T=1 << 16, dt=1e-3, period=0.1234, width=0.02,
                   amp=1.0, seed=4):
    rng = np.random.default_rng(seed)
    t = np.arange(T) * dt
    phase = (t / period) % 1.0
    dph = np.minimum(phase, 1 - phase)
    return (rng.standard_normal(T)
            + amp * np.exp(-0.5 * (dph / width) ** 2)).astype(np.float32)


@pytest.mark.parametrize("p_fold", [0.1234, 0.1234 + 0.7 * 0.1234 ** 2
                                    / 65.536])
def test_fold_and_optimize_matches_jax(p_fold):
    x = _pulsar_series()
    want = jfold.fold_and_optimize(x, dt=1e-3, period=p_fold, nbin=32,
                                   npart=16)
    got = tfold.fold_and_optimize(torch.from_numpy(x), dt=1e-3,
                                  period=p_fold, nbin=32, npart=16)
    # float32 linspace grids: the same grid point, to the rounding of
    # the two libraries' linspace (1e-6 of the grid's extent)
    T_s = len(x) * 1e-3
    dp_max, dpd_max = 2 * p_fold ** 2 / T_s, 4 * p_fold ** 2 / T_s ** 2
    assert got.delta_p == pytest.approx(want.delta_p, abs=1e-6 * dp_max)
    assert got.delta_pdot == pytest.approx(want.delta_pdot,
                                           abs=1e-6 * dpd_max)
    assert got.reduced_chi2 == pytest.approx(want.reduced_chi2,
                                             rel=CHI2_RTOL)
    np.testing.assert_allclose(got.profile, want.profile, rtol=0,
                               atol=PROFILE_RTOL
                               * np.abs(want.profile).max())
    assert got.reduced_chi2 > 3.0


def test_fold_rules_phase_bins_and_bestprof_text_match():
    for p in (0.0015, 0.02, 0.3, 2.0):
        for rows in (None, 12):
            assert dataclasses.astuple(tfold.fold_rules(p, rows)) == \
                dataclasses.astuple(jfold.fold_rules(p, rows))
    np.testing.assert_array_equal(
        tfold.phase_bins(1 << 16, 1e-3, 0.001, 1e-9, 16),
        jfold.phase_bins(1 << 16, 1e-3, 0.001, 1e-9, 16))
    rng = np.random.default_rng(1)
    fields = dict(period_s=0.123456789, pdot=-1.5e-9, dm=50.25, nbin=8,
                  npart=4, profile=rng.normal(size=8).astype(np.float32),
                  subints=np.zeros((4, 8), np.float32),
                  reduced_chi2=12.345678, delta_p=1.5e-7,
                  delta_pdot=-2e-10, delta_dm=-0.75)
    assert tfold.FoldResult(**fields).bestprof_text("J0000+00") == \
        jfold.FoldResult(**fields).bestprof_text("J0000+00")
