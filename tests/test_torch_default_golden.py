"""The port's default search (hi-accel stage, refinement and folding
on) against the JAX package's, on the five golden scenarios at their
own parameters (make_plots off): both packages' search_block on the
same block, and the port's list against the frozen golden files.

The JAX side runs the direct stage-2 family (TPULSAR_DD_FAMILY=direct).
Candidates compare as in test_torch_slice.py, with z equal (grid z for
unrefined candidates; the refined z comes out of the same host simplex
on spectra that agree to ~1e-6).  Folds: the same grid choices, the
period at rtol 1e-9, chi2 at rtol 1e-4."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from golden_scenarios import GOLDEN_DIR, _unpack, build_scenarios  # noqa: E402
from test_torch_slice import (  # noqa: E402, F401 (an autouse fixture)
    _assert_cands_match, one_torch_thread)
from tpulsar.kernels import rfi as jrfi  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.kernels import rfi as trfi  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402

PERIOD_RTOL = 1e-9
CHI2_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _direct_family(monkeypatch):
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")


def assert_folds_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.nbin, g.npart) == (w.nbin, w.npart)
        assert (g.delta_p, g.delta_pdot, g.delta_dm) == \
            (w.delta_p, w.delta_pdot, w.delta_dm)
        assert g.period_s == pytest.approx(w.period_s, rel=PERIOD_RTOL)
        assert g.dm == w.dm and g.pdot == w.pdot
        assert g.reduced_chi2 == pytest.approx(w.reduced_chi2,
                                               rel=CHI2_RTOL)


def run_both(name, **change):
    """search_block on a golden scenario through both packages, at the
    scenario's parameters (changed by `change`)."""
    data, freqs, dt, plan, params, zaplist, apply_rfi = _unpack(
        build_scenarios()[name])
    jp = dataclasses.replace(params, make_plots=False, **change)
    jdata = jnp.asarray(data)
    tdata = torch.from_numpy(data)
    if apply_rfi:
        jm = jrfi.find_rfi_chan(jdata, dt, block_len=2048)
        jdata = jrfi.apply_mask_chan(
            jdata, jnp.asarray(jm.full_mask()), jnp.asarray(jm.chan_fill),
            jm.block_len)
        tm = trfi.find_rfi_chan(tdata, dt, block_len=2048)
        tdata = trfi.apply_mask_chan(tdata, tm.full_mask(), tm.chan_fill,
                                     tm.block_len)
    want = jex.search_block(jdata, np.asarray(freqs), dt, plan, jp,
                            zaplist=zaplist)
    got = tex.search_block(
        tdata, np.asarray(freqs), dt,
        state.plan_from_jax([dataclasses.asdict(s) for s in plan]),
        state.search_params_from_jax(jp.provenance()), zaplist=zaplist,
        device="cpu")
    return got, want


@pytest.mark.parametrize("name", sorted(build_scenarios()))
def test_default_search_matches_jax(name):
    (tfinal, tfold, tsp, tn), (jfinal, jfold, jsp, jn) = run_both(name)
    assert tn == jn
    _assert_cands_match(tfinal, jfinal)
    assert [c.z for c in tfinal] == [c.z for c in jfinal]
    assert_folds_match(tfold, jfold)
    assert len(tfold) <= build_scenarios()[name][4].max_cands_to_fold
    # and the frozen golden list (tests/test_golden.py's tolerances)
    with open(os.path.join(os.path.dirname(__file__), GOLDEN_DIR,
                           f"{name}.json")) as fh:
        golden = json.load(fh)
    assert tn == golden["ntrials"]
    assert len(tfinal) == len(golden["candidates"])
    for c, ref in zip(tfinal, golden["candidates"]):
        assert round(c.dm, 2) == ref["dm"]
        assert c.numharm == ref["numharm"]
        assert c.num_dm_hits == ref["num_dm_hits"]
        assert c.freq_hz == pytest.approx(ref["freq_hz"], rel=1e-4)
        assert c.sigma == pytest.approx(ref["sigma"], rel=0.01)
        assert c.z == pytest.approx(ref["z"], abs=1.0)


def test_accel_binary_needs_the_hi_stage():
    """accel_binary's drifting pulsar is found at z != 0 by the hi
    stage: the port's top candidate sits at the injected drift (z ~ 9),
    and with the hi stage off no z != 0 candidate is left."""
    data, freqs, dt, plan, params, _z, _r = _unpack(
        build_scenarios()["accel_binary"])
    tplan = state.plan_from_jax([dataclasses.asdict(s) for s in plan])
    tp = state.search_params_from_jax(params.provenance())
    on = tex.search_block(data, freqs, dt, tplan, tp, device="cpu")[0]
    top = on[0]
    assert abs(top.z - 9.0) < 1.0 and top.dm == 35.0
    off = tex.search_block(data, freqs, dt, tplan,
                           dataclasses.replace(tp, run_hi_accel=False),
                           device="cpu")[0]
    assert any(abs(c.z) >= 2.0 for c in on)
    assert all(abs(c.z) < 2.0 for c in off)
