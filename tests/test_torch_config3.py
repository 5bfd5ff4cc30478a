"""BASELINE config 3 ("accelsearch zmax=200 numharm=16") through the
port against the JAX package, on the same NumPy-seeded inputs: the hi
stage at zmax 200 / 16 harmonics / topk 64, bench.py's config-3
composition (32 DM trials, stage 1 and 2, the whitened spectrum, the
hi stage) at a small size, search_beam at hi_accel_zmax=200,
hi_accel_numharm=16 on a steady and an accelerated pulsar, and the
operator's SearchingConfig mapped to SearchParams.

Tolerances: dedispersion of uint8 data is exact (integer sums); the
spectra go through pocketfft (torch) and XLA's FFT (JAX), so spectra
at rtol 1e-5 (atol 1e-3 of a unit-variance bin), planes and top-k
powers at test_torch_accel.py's PLANE_RTOL, r bins and z exactly at a
rank whose power stands clear of its neighbours by more than
PLANE_RTOL and as a set within such a tie (assert_topk_match);
search_beam's candidates and folds at test_torch_default_golden.py's
tolerances."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_accel import assert_topk_match  # noqa: E402
from test_torch_default_golden import assert_folds_match  # noqa: E402
from test_torch_slice import (  # noqa: E402, F401 (an autouse fixture)
    _assert_cands_match, one_torch_thread)
from tpulsar.config import core as jcore  # noqa: E402
from tpulsar.io import synth  # noqa: E402
from tpulsar.kernels import accel as ja  # noqa: E402
from tpulsar.kernels import dedisperse as jdd  # noqa: E402
from tpulsar.kernels import fourier as jfr  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.config import core as tcore  # noqa: E402
from tpulsar_torch.kernels import accel as ta  # noqa: E402
from tpulsar_torch.kernels import dedisperse as tdd  # noqa: E402
from tpulsar_torch.kernels import fourier as tfr  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402

#: config 3's hi stage (bench.py: build_template_bank(200.0),
#: accel_search_batch(..., max_numharm=16, topk=64))
ZMAX, NUMHARM, TOPK = 200.0, 16, 64
SPEC_RTOL, SPEC_ATOL = 1e-5, 1e-3


@pytest.fixture(autouse=True)
def _direct_family(monkeypatch):
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")


@pytest.fixture(scope="module")
def banks():
    return ja.build_template_bank(ZMAX), ta.build_template_bank(ZMAX)


def _assert_stages_match(got: dict, want: dict) -> None:
    """Every stage's top-k lists by assert_topk_match at PLANE_RTOL."""
    assert set(got) == set(want) == {1, 2, 4, 8, 16}
    for h in want:
        assert_topk_match(got[h], want[h])


def test_accel_search_batch_z200_h16_matches_jax(banks):
    """3 noise rows of 2^15 bins, each with a tone drifting at z = 150
    (the reference's own z response, template width 256): the same
    cells in all five stages, and the tone stage 1's top cell."""
    jb, tb = banks
    assert len(tb.zs) == 201 and tb.width == 256
    rng = np.random.default_rng(19)
    nd, nbins, r0, z0 = 3, 1 << 15, 9000, 150.0
    specs = (rng.normal(size=(nd, nbins))
             + 1j * rng.normal(size=(nd, nbins))).astype(np.complex64)
    resp = ja.gen_z_response(z0, tb.width)
    for i in range(nd):
        lo = r0 + 500 * i - tb.width // 2
        specs[i, lo: lo + tb.width] += 12.0 * resp
    want = ja.accel_search_batch(jnp.asarray(specs), jb,
                                 max_numharm=NUMHARM, topk=TOPK)
    got = ta.accel_search_batch(torch.from_numpy(specs), tb,
                                max_numharm=NUMHARM, topk=TOPK)
    _assert_stages_match(got, want)
    p1, r1, z1 = got[1]
    for i in range(nd):
        k = int(np.argmax(p1[i]))
        assert abs(0.5 * r1[i, k] - (r0 + 500 * i)) <= 0.5
        assert z1[i, k] == z0


def test_config3_composition_matches_jax(banks):
    """bench.py's config 3 at a small size (64 channels, 2^15 samples,
    32 DM trials from 0 at step 2, nsub 16, subdm 140, ds 1) on a
    4-bit block holding an accelerated pulsar: the JAX side composes
    form_subbands -> dedisperse_subbands -> complex_spectrum /
    whitened_powers / scale_spectrum -> accel_search_batch as bench.py
    does; the port runs dedisperse_pass and the same fourier steps."""
    jb, tb = banks
    spec = synth.BeamSpec(nchan=64, nsamp=1 << 15, nbits=4,
                          tsamp_s=327.68e-6, seed=23)
    psr = synth.PulsarSpec(period_s=0.05, dm=30.0, snr_per_sample=0.5,
                           pdot=1.5e-3)
    q, _scale, _off = synth._digitize(
        synth.make_dynamic_spectrum(spec, [psr]), spec.nbits)
    data = np.ascontiguousarray(q.T.astype(np.uint8))
    freqs = synth.channel_freqs(spec)
    dms = np.arange(32) * 2.0

    ch_sh, sub_sh = jdd.plan_pass_shifts(freqs, 16, 140.0, dms,
                                         spec.tsamp_s, 1)
    subb = jdd.form_subbands(jnp.asarray(data), jnp.asarray(ch_sh), 16, 1)
    jseries = jdd.dedisperse_subbands(subb, jnp.asarray(sub_sh))
    jspec = jfr.complex_spectrum(jseries)
    jpow, jwpow = jfr.whitened_powers(jspec)
    jw = jfr.scale_spectrum(jspec, jpow, jwpow)
    want = ja.accel_search_batch(jw, jb, max_numharm=NUMHARM, topk=TOPK)

    tseries = tdd.dedisperse_pass(torch.from_numpy(data), freqs, 16,
                                  140.0, dms, spec.tsamp_s, 1,
                                  device="cpu")
    tspec = tfr.complex_spectrum(tseries)
    tpow, twpow = tfr.whitened_powers(tspec)
    tw = tfr.scale_spectrum(tspec, tpow, twpow)
    got = ta.accel_search_batch(tw, tb, max_numharm=NUMHARM, topk=TOPK)

    assert tseries.shape == (32, 1 << 15)
    np.testing.assert_array_equal(tseries.numpy(), np.asarray(jseries))
    scale = float(np.abs(np.asarray(jspec)).max())
    np.testing.assert_allclose(tspec.numpy(), np.asarray(jspec),
                               rtol=SPEC_RTOL, atol=SPEC_RTOL * scale)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                               rtol=SPEC_RTOL, atol=SPEC_ATOL)
    _assert_stages_match(got, want)
    # the pulsar drifts beyond zmax 50: at its DM row, stage 1's top
    # cell sits at |z| > 50, past the default configuration's reach
    p1, _r1, z1 = got[1]
    row = int(np.argmin(np.abs(dms - psr.dm)))
    assert abs(z1[row, int(np.argmax(p1[row]))]) > 50


def _beam_and_plan(tmp_path, pdot: float):
    spec = synth.BeamSpec(nchan=64, nsamp=1 << 15, nbits=4,
                          tsamp_s=327.68e-6, seed=11)
    psr = synth.PulsarSpec(period_s=0.25, dm=50.0, snr_per_sample=0.5,
                           pdot=pdot)
    fns = synth.synth_beam(str(tmp_path / "beam"), spec, pulsars=[psr])
    plan = [jddplan.DedispStep(30.0, 2.0, 12, 2, 16, 1),
            jddplan.DedispStep(78.0, 4.0, 8, 1, 16, 2)]
    return fns, plan, psr, spec.nsamp * spec.tsamp_s


@pytest.mark.parametrize("pdot", [0.0, 1.5e-3],
                         ids=["steady", "accelerated"])
def test_search_beam_config3_matches_jax(tmp_path, pdot):
    """search_beam at hi_accel_zmax=200, hi_accel_numharm=16 in both
    packages on test_torch_default_beam.py's beam and plan, once with
    its steady pulsar and once with that pulsar accelerated (pdot
    1.5e-3), the parameters crossing through
    state.search_params_from_jax: the same candidates (z too) and
    folds.  The steady pulsar is the first fold (period within 1e-3);
    the accelerated one is the top candidate, drifting (z != 0), at a
    harmonic of its apparent period at mid-beam (synth's phase is
    t / (P + pdot t), whose period at t is (P + pdot t)^2 / P)."""
    fns, plan, psr, T = _beam_and_plan(tmp_path, pdot)
    jp = jex.SearchParams(nsub=16, topk_per_stage=16, hi_accel_zmax=200,
                          hi_accel_numharm=16, max_cands_to_fold=4,
                          make_plots=False)
    jo = jex.search_beam(fns, str(tmp_path / "jw"), str(tmp_path / "jr"),
                         jp, plan=plan)
    tp = state.search_params_from_jax(jp.provenance())
    assert (tp.hi_accel_zmax, tp.hi_accel_numharm) == (200, 16)
    to = tex.search_beam(
        fns, str(tmp_path / "tw"), str(tmp_path / "tr"), tp,
        plan=state.plan_from_jax([dataclasses.astuple(s) for s in plan]),
        device="cpu")

    assert to.num_dm_trials == jo.num_dm_trials == 32
    _assert_cands_match(to.candidates, jo.candidates)
    assert [c.z for c in to.candidates] == [c.z for c in jo.candidates]
    assert_folds_match(to.folded, jo.folded)
    assert to.folded and to.refined_dms
    if pdot == 0.0:
        assert abs(to.folded[0].period_s - psr.period_s) \
            / psr.period_s < 1e-3
    else:
        top = to.candidates[0]
        p_mid = (psr.period_s + pdot * T / 2) ** 2 / psr.period_s
        assert top.z != 0 and abs(top.dm - psr.dm) <= 4
        assert min(abs(n / top.freq_hz - p_mid) / p_mid
                   for n in (1, 2, 3, 4)) < 1e-3
    assert (tmp_path / "tr" / "search_params.txt").read_bytes() == \
        (tmp_path / "jr" / "search_params.txt").read_bytes()


def test_search_params_from_config3_matches_jax():
    """An operator selects config 3 with SearchingConfig.hi_accel_zmax
    = 200 and hi_accel_numharm = 16: both packages' from_config map it
    field for field, the hi stage on."""
    kw = dict(hi_accel_zmax=200, hi_accel_numharm=16)
    want = jex.SearchParams.from_config(jcore.SearchingConfig(**kw))
    got = tex.SearchParams.from_config(tcore.SearchingConfig(**kw))
    assert got.provenance() == want.provenance()
    assert (got.hi_accel_zmax, got.hi_accel_numharm) == (200, 16)
    assert got.run_hi_accel is True
    assert len(tex._get_bank(got.hi_accel_zmax).zs) == 201
