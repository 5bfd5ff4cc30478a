"""The plain reference: hand-computed cases, agreement with itself, and
with the program's plain versions at a tiny size on the CPU."""

import math

import numpy as np
import pytest
import torch

from port_bench import compare, harness
from port_bench import reference as ref


def test_dedisperse_hand_case():
    # two channels, one subband: channel 0 shifted by 2, channel 1 by 0;
    # then two DM rows of subband shifts 0 and 1
    block = torch.tensor([[1, 2, 3, 4, 5], [10, 20, 30, 40, 50]],
                         dtype=torch.uint8)
    out = ref.dedisperse(block, [2, 0], np.array([[0], [1]]), 1, 1)
    sub = [3 + 10, 4 + 20, 5 + 30, 5 + 40, 5 + 50]
    assert out[0].tolist() == sub
    assert out[1].tolist() == sub[1:] + [sub[-1]]
    ds = ref.dedisperse(block, [2, 0], np.array([[0]]), 1, 2)
    assert ds[0].tolist() == [sub[0] + sub[1], sub[2] + sub[3]]


def test_dedisperse_equals_the_programs_plain_versions():
    from tpulsar_torch.kernels import cuda_dd
    from tpulsar_torch.kernels import dedisperse as dd

    rng = np.random.default_rng(5)
    block = torch.from_numpy(rng.integers(0, 16, (16, 4000),
                                          dtype=np.uint8))
    freqs = 1214.0 + np.arange(16) * 20.0
    dms = np.asarray([0.0, 30.0, 61.5])
    for ds in (1, 3):
        chan, sub = ref.pass_shifts(freqs, 4, 30.0, dms, 6.5e-5, ds)
        pc, ps = dd.plan_pass_shifts(freqs, 4, 30.0, dms, 6.5e-5, ds)
        assert (chan == pc).all() and (sub == ps).all()
        want = cuda_dd.dedisperse_subbands_plain(
            cuda_dd.form_subbands_plain(block, pc, 4, ds), ps)
        got = ref.dedisperse(block, chan, sub, 4, ds)
        assert torch.equal(got.float(), want)


def test_single_pulse_hand_case():
    # a flat series with one 3-sample step: after the median detrend
    # and unit variance, the width-3 boxcar at the step holds 3 samples
    T = 4000
    x = torch.zeros((1, T), dtype=torch.int32)
    x[0, 1000:1003] = 10
    spr = ref.sp_reference(x, (1, 3), 8)
    det = np.zeros(T)
    det[1000:1003] = 10
    det /= det.std()
    want = det[1000:1003].sum() / math.sqrt(3)
    assert spr.snr([0], [3], [1000])[0] == pytest.approx(want)
    ev = ref.sp_events(spr, 5.0)
    assert ev[(0, 1000 // 32)][2] == 3


def test_interbin_and_harmonic_sums_hand_case():
    w = torch.tensor([[0, 1 + 1j, 2, 0]], dtype=torch.complex128)
    p2 = ref.interbin(w)
    half = math.pi ** 2 / 16
    assert p2[0].tolist() == pytest.approx(
        [0, half * 2, 2, half * 2, 4, half * 4, 0, 0])
    st = ref.lo_reference(w, 2, 1)
    assert st[2].sums[0].tolist() == pytest.approx(
        [p2[0, 0] + p2[0, 0], p2[0, 1] + p2[0, 2], p2[0, 2] + p2[0, 4],
         p2[0, 3] + p2[0, 6]])


def test_sigma_equals_the_programs():
    from tpulsar_torch.kernels import fourier

    p = np.asarray([3.0, 10.0, 25.0, 40.0, 80.0, 300.0])
    for h, ni in ((1, 1), (2, 1 << 20), (8, 100_000_000), (16, 12345)):
        assert ref.sigma_from_power(p, h, ni) == pytest.approx(
            fourier.sigma_from_power(p, h, ni), rel=1e-9, abs=1e-9)


def test_whitened_spectrum_equals_the_programs():
    from tpulsar_torch.kernels import fourier

    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=(3, 60000)) * 40)
                         .astype(np.float32))
    nfft = 60000
    keep = harness.zap_keep(nfft // 2 + 1, nfft * 1e-3,
                            harness.packaged_zaplist())
    got = ref.whitened_spectrum(x.double(), nfft, keep)
    want = fourier.whitened_spectrum_masked(x, keep, nfft).to(
        torch.complex128)
    assert torch.allclose(got, want, rtol=2e-4, atol=2e-4)


def test_zaplist_and_keep_mask_are_the_jobs():
    from tpulsar_torch.cli import search_job
    from tpulsar_torch.kernels import fourier

    zl = harness.packaged_zaplist()
    assert np.array_equal(zl, search_job.choose_zaplist(["x.fits"], None,
                                                        None))
    for T in (257.46, 51.49):
        assert np.array_equal(harness.zap_keep(1 << 17, T, zl),
                              fourier.zap_mask(1 << 17, T, zl))


def test_hi_plane_equals_the_programs_correlation():
    from tpulsar_torch.kernels import accel

    rng = np.random.default_rng(3)
    n = 20000
    spec = rng.normal(size=n) + 1j * rng.normal(size=n)
    bank = accel.build_template_bank(4.0)
    plane = accel._correlate_segments(
        torch.from_numpy(spec.astype(np.complex64)),
        torch.from_numpy(bank.bank_fft), bank.seg, bank.step, bank.width)
    st = ref.hi_reference(torch.from_numpy(spec), 4.0, 2, 4)
    got = st[1].plane[0]
    assert got.shape == plane.shape
    assert torch.allclose(got, plane.double(), rtol=1e-4,
                          atol=1e-4 * float(plane.max()))


def test_sift_equals_the_programs():
    from tpulsar_torch.search import sifting

    rng = np.random.default_rng(11)
    p = dict(sigma_threshold=4.0, r_err=1.1, min_num_dms=2,
             low_dm_cutoff=2.0, harm_frac_tol=0.001, max_harm=16,
             short_period_s=0.0005, long_period_s=15.0)
    rows = []
    fams = rng.uniform(0.2, 60, 40)
    for _ in range(600):
        f = rng.choice(fams) * rng.choice([1, 1, 2, 3]) \
            + rng.normal() * 1e-4 if rng.random() < 0.8 \
            else rng.uniform(0.1, 50)
        r = f * 100.0 + rng.normal() * 0.3
        rows.append((r, float(rng.choice([0.0, 2.0, -4.0])),
                     float(rng.uniform(2, 12)), float(rng.uniform(5, 60)),
                     int(rng.choice([1, 2, 4, 8])),
                     float(rng.choice([0.0, 1.0, 3.0, 7.5])), 1 / f, f))
    mine = ref.sift([ref.Cand(*r) for r in rows], p)
    theirs = sifting.sift([sifting.Candidate(*r) for r in rows],
                          sifting.SiftParams(**p))
    assert len(mine) > 10
    assert compare.sifted_mismatch(theirs, mine, False) == 0


def test_reference_agrees_with_itself_and_bf16_does_not():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 4000, (2, 50000),
                                      dtype=np.int32))
    a = ref.sp_reference(x, (1, 4), 16)
    b = ref.sp_reference(x, (1, 4), 16)
    assert torch.equal(a.cs, b.cs) and torch.equal(a.bmax, b.bmax)
    c = ref.sp_reference(x, (1, 4), 16, ref.Prec("bf16"))
    assert not torch.allclose(a.bmax, c.bmax.double(), atol=0.05)
