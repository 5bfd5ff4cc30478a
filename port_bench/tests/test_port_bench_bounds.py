"""Each bound's arithmetic from shapes."""

import math

import pytest

from port_bench import bounds
from tpulsar_torch.kernels import accel
from tpulsar_torch.plan import ddplan

T = 3_932_160


@pytest.mark.parametrize("ds", [1, 2, 3, 5, 6, 10])
def test_choose_n_is_the_surveys(ds):
    assert bounds.choose_n(T // ds) == ddplan.choose_n(T // ds)


def test_stage_bytes_from_shapes():
    assert bounds.stage1_bytes(960, T, 96, 1) == 960 * T + 96 * T * 4
    assert bounds.stage1_bytes(960, T, 96, 2) == 960 * T + 96 * (T // 2) * 4
    assert bounds.stage2_bytes(96, T, 1, 76) == (96 + 76) * T * 4
    assert bounds.stage2_bytes(96, T, 5, 76) == (96 + 76) * (T // 5) * 4


def test_hi_constants_are_the_programs():
    bank = accel.build_template_bank(50.0)
    assert bounds.HI_SEG == bank.seg
    assert bounds.template_width(50.0) == bank.width
    assert bounds.hi_nz(50.0) == len(bank.zs)


def test_hi_row_bound_at_ds1():
    nbins = bounds.pass_nbins(T, 1)
    assert nbins == T // 2 + 1
    nsegs = math.ceil(nbins / (8192 - 128))
    assert bounds.hi_row_flops(nbins, 50) == \
        nsegs * 52 * 5 * 16384 * math.log2(16384)
    assert bounds.hi_row_bound_s(nbins, 50, 8, 32) == pytest.approx(
        0.217e-3, rel=0.01)


def test_hi_bytes_hold_no_plane():
    nbins = bounds.pass_nbins(T, 1)
    b50 = bounds.hi_row_bytes(nbins, 8, 32)
    assert b50 == nbins * 8 + 4 * 32 * 12
    # the plane (nz x 2 nbins) would be 2 * 51 * nbins values: not here
    assert b50 < 2 * 51 * nbins
    assert bounds.hi_row_flops(nbins, 200) > bounds.hi_row_flops(nbins, 50)
