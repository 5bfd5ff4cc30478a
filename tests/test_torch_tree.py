"""The port's tree stage-2 family (tpulsar_torch/kernels/tree_dd.py)
against the JAX package's (tpulsar/kernels/tree_dd.py) and against the
direct family, on the same shift tables and subbands: the host plans
are equal (levels, tables, pad, cut, and the direct-vs-tree decision
under auto, tree and direct), the levels and residuals equal JAX's
tree, and both packages' search_beam under TPULSAR_DD_FAMILY=tree
give the same candidates, the same tree trial counts and the same
tree gauges.

Tolerances: the tree against JAX's tree at 1e-6 (both sum in the same
tree order; the fused detrend's statistics are each package's own);
the tree against the direct family at rtol 2e-6 / atol 2e-5, the JAX
package's own summation-order tolerance (tests/test_tree_dd.py);
candidates at tests/test_torch_slice.py's tolerances."""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_slice import (  # noqa: E402, F401 (a fixture)
    _assert_cands_match, one_torch_thread)
from tpulsar.io import synth  # noqa: E402
from tpulsar.kernels import dedisperse as jdd  # noqa: E402
from tpulsar.kernels import tree_dd as jtree  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.kernels import cuda_dd  # noqa: E402
from tpulsar_torch.kernels import tree_dd as ttree  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402

NCHAN = 960
FCTR, BW, TSAMP = 1375.5, 322.617, 65.476e-6
_FREQS = (FCTR - BW / 2) + (np.arange(NCHAN) + 0.5) * (BW / NCHAN)
RTOL, ATOL = 2e-6, 2e-5


def _pass_shifts(step_idx: int, pass_idx: int) -> np.ndarray:
    step = jddplan.survey_plan("pdev")[step_idx]
    ppass = step.passes()[min(pass_idx, step.numpasses - 1)]
    _ch, sub_sh = jdd.plan_pass_shifts(
        _FREQS, step.numsub, ppass.subdm, np.asarray(ppass.dms), TSAMP,
        step.downsamp)
    return sub_sh


@functools.lru_cache(maxsize=1)
def _tables():
    """Mock survey passes (early, late, higher downsamples), an odd
    subband count, and an irregular grid."""
    rng = np.random.default_rng(33)
    return {
        "ds1_first": (_pass_shifts(0, 0), None),
        "ds1_last": (_pass_shifts(0, 27), None),
        "ds3": (_pass_shifts(3, 4), None),
        "odd_nsub": (_pass_shifts(1, 3)[:, :45], None),
        "tight_budget": (_pass_shifts(0, 5), 550 * (2048 + 2048) * 4),
        "irregular": (rng.integers(0, 2000, size=(64, 32))
                      .astype(np.int32), None),
    }


@pytest.mark.parametrize("name", list(_tables()))
def test_build_tree_plan_equals_jax(name):
    sh, budget = _tables()[name]
    T = 2048
    jp = jtree.build_tree_plan(sh, T=T, budget=budget)
    tp = ttree.build_tree_plan(sh, T=T, budget=budget)
    assert tp.depth == jp.depth and tp.pad == jp.pad
    assert (tp.ndms, tp.nsub) == (jp.ndms, jp.nsub)
    np.testing.assert_array_equal(tp.pidx, jp.pidx)
    np.testing.assert_array_equal(tp.refs, jp.refs)
    for tl, jl in zip(tp.levels, jp.levels):
        for f in ("a", "da", "b", "db", "carry"):
            np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
        assert tl.moff == jl.moff
    assert tp.cost_rows == jp.cost_rows
    assert tp.residual_fraction == jp.residual_fraction


@pytest.mark.parametrize("family", ["auto", "tree", "direct"])
def test_plan_for_pass_decides_as_jax(family, monkeypatch):
    """On the CPU the decision is JAX's off the TPU (the cost model
    under auto); on a CUDA device auto keeps the direct CUDA kernel,
    where JAX's auto keeps the Pallas kernel."""
    monkeypatch.setenv("TPULSAR_DD_FAMILY", family)
    for name, (sh, _b) in _tables().items():
        for rows in (sh, sh[:12]):
            jp = jtree.plan_for_pass(rows, T=4096)
            tp = ttree.plan_for_pass(rows, T=4096, device="cpu")
            assert (tp is None) == (jp is None), (name, len(rows))
            if tp is not None:
                np.testing.assert_array_equal(tp.pidx, jp.pidx)
            on_card = ttree.plan_for_pass(rows, T=4096, device="cuda")
            assert (on_card is not None) == (family == "tree")
    if family == "auto":
        assert ttree.plan_for_pass(_pass_shifts(0, 14), T=4096) \
            is not None


@pytest.mark.parametrize("name", ["ds1_first", "ds1_last", "ds3",
                                  "odd_nsub", "tight_budget"])
def test_levels_and_residual_match_jax_and_direct(name):
    sh, budget = _tables()[name]
    T = 2048
    subb = np.random.default_rng(3).standard_normal(
        (sh.shape[1], T)).astype(np.float32)
    jp = jtree.build_tree_plan(sh, T=T, budget=budget)
    tp = ttree.build_tree_plan(sh, T=T, budget=budget)
    sub_t = torch.from_numpy(subb)
    tparts = ttree.tree_levels(sub_t, tp)
    jparts = np.asarray(jtree.tree_levels(jnp.asarray(subb), jp))
    np.testing.assert_allclose(tparts.numpy(), jparts, rtol=1e-6,
                               atol=1e-6)
    lo, n = 5, min(24, sh.shape[0] - 5)
    ts, tn = ttree.residual_series(tparts, tp, lo, n, T, fuse=True)
    js, jn = jtree.residual_series(jnp.asarray(jparts), jp, lo, n, T,
                                   fuse=True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6,
                               atol=1e-6)
    whole = ttree.dedisperse_tree_pass(sub_t, sh, tp).numpy()
    np.testing.assert_array_equal(whole[lo:lo + n], ts.numpy())
    direct = cuda_dd.dedisperse_subbands_plain(sub_t, sh).numpy()
    np.testing.assert_allclose(whole, direct, rtol=RTOL, atol=ATOL)


def test_level_row_count_is_checked():
    sh = _pass_shifts(0, 0)
    plan = ttree.build_tree_plan(sh, T=512)
    with pytest.raises(ValueError, match="plan expects"):
        ttree.tree_levels(torch.zeros((3, 512)), plan)


@pytest.fixture(scope="module")
def tree_searches(tmp_path_factory):
    """Both packages' search_beam on one beam with
    TPULSAR_DD_FAMILY=tree (module-scoped: the searches are the
    expensive part)."""
    root = tmp_path_factory.mktemp("tree")
    spec = synth.BeamSpec(nchan=64, nsamp=1 << 13, nbits=4,
                          tsamp_s=5.24288e-4, seed=8)
    psr = synth.PulsarSpec(period_s=0.2, dm=40.0, snr_per_sample=1.0)
    fns = synth.synth_beam(str(root / "data"), spec, pulsars=[psr],
                           merged=True)
    plan = [jddplan.DedispStep(lodm=20.0, dmstep=1.0, dms_per_pass=40,
                               numpasses=1, numsub=32, downsamp=1),
            jddplan.DedispStep(60.0, 2.0, 40, 1, 32, 2)]
    jp = jex.SearchParams(nsub=32, run_hi_accel=False, refine_cands=False,
                          topk_per_stage=8, max_cands_to_fold=0,
                          make_plots=False)
    saved = os.environ.get("TPULSAR_DD_FAMILY")
    os.environ["TPULSAR_DD_FAMILY"] = "tree"
    try:
        jo = jex.search_beam(fns, str(root / "jw"), str(root / "jr"),
                             jp, plan=plan)
        to = tex.search_beam(
            fns, str(root / "tw"), str(root / "tr"),
            state.search_params_from_jax(jp.provenance()),
            plan=state.plan_from_jax([dataclasses.astuple(s)
                                      for s in plan]), device="cpu")
    finally:
        if saved is None:
            os.environ.pop("TPULSAR_DD_FAMILY", None)
        else:
            os.environ["TPULSAR_DD_FAMILY"] = saved
    return jo, to


def _metrics(outcome):
    with open(os.path.join(outcome.resultsdir, "metrics.json")) as fh:
        return json.load(fh)


def test_search_beam_tree_family_matches_jax(tree_searches):
    jo, to = tree_searches
    assert to.num_dm_trials == jo.num_dm_trials == 80
    _assert_cands_match(to.candidates, jo.candidates)
    assert any(abs(c.period_s - 0.2) < 1e-3 for c in to.candidates)
    tm, jm = _metrics(to), _metrics(jo)
    series = tm["tpulsar_dedisp_trials_total"]["series"]
    assert series == {"tree": 80.0}
    assert series == jm["tpulsar_dedisp_trials_total"]["series"]


def test_tree_gauges_read_as_jax(tree_searches):
    jo, to = tree_searches
    tm, jm = _metrics(to), _metrics(jo)
    for name in ("tpulsar_dedisp_tree_depth",
                 "tpulsar_dedisp_residual_fraction"):
        assert tm[name]["type"] == "gauge"
        assert tm[name]["series"] == jm[name]["series"], name
        assert tm[name]["help"] == jm[name]["help"]
