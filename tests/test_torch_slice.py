"""The tpulsar_torch slice end to end against the JAX package: both
packages' search_beam on one synthesized beam file, configured through
tpulsar_torch.state from the JAX side's own provenance and plan, and
both packages' search_block on the five golden scenarios — all with
the hi-accel stage, refinement, folding and plots off.

The JAX side runs the direct stage-2 family (TPULSAR_DD_FAMILY=direct),
as the TPU ran it with the Pallas kernel engaged; the tree family sums
in another order.  Tolerances are tests/test_golden.py's."""

import dataclasses
import io
import os
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from golden_scenarios import _unpack, build_scenarios  # noqa: E402
from tpulsar.io import synth  # noqa: E402
from tpulsar.kernels import rfi as jrfi  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.kernels import rfi as trfi  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402

FREQ_RTOL = 1e-4
SIGMA_RTOL = 0.01
SP_SIGMA_RTOL = 1e-4

SLICE = dict(run_hi_accel=False, refine_cands=False, max_cands_to_fold=0,
             make_plots=False)


@pytest.fixture(autouse=True)
def _direct_family(monkeypatch):
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU tests (other test files
    import this fixture): the suite runs in several pytest-xdist
    processes at once, and a torch thread pool as wide as the machine
    in each of them oversubscribes the cores — the default-search
    files ran 6x slower that way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_cands_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dm == w.dm
        assert g.numharm == w.numharm
        assert g.num_dm_hits == w.num_dm_hits
        assert g.freq_hz == pytest.approx(w.freq_hz, rel=FREQ_RTOL)
        assert g.sigma == pytest.approx(w.sigma, rel=SIGMA_RTOL)


def _assert_events_match(got, want, near_ties: float = 0.0):
    """The same events in (dm, sample, downfact), sigma at rtol 1e-4.

    near_ties: the fraction of events allowed to move to a neighbouring
    sample or width of the same 32-sample cluster.  The boxcar SNRs
    come from a float32 cumsum that XLA and torch accumulate in other
    orders (up to ~1e-3 apart over 32k samples), so where two samples
    of a block nearly tie, the block's argmax may move."""
    assert len(got) == len(want)

    def by_ident(e):
        return {(float(d), int(s), int(w)): float(sg) for d, s, w, sg in
                zip(e["dm"], e["sample"], e["downfact"], e["sigma"])}

    g, w = by_ident(got), by_ident(want)
    only_g, only_w = set(g) - set(w), set(w) - set(g)
    assert len(only_g) <= near_ties * len(want)
    for dm, sample, _df in only_g:
        assert any(d == dm and abs(s - sample) < 32 for d, s, _ in only_w)
    common = sorted(set(g) & set(w))
    np.testing.assert_allclose([g[k] for k in common],
                               [w[k] for k in common], rtol=SP_SIGMA_RTOL)


def _tar_members(path):
    with tarfile.open(path) as tf:
        return {m.name: tf.extractfile(m).read() for m in tf.getmembers()}


def test_search_beam_matches_jax(tmp_path):
    spec = synth.BeamSpec(nchan=64, nsamp=1 << 15, nbits=4,
                          tsamp_s=327.68e-6, seed=7)
    psr = synth.PulsarSpec(period_s=0.25, dm=50.0, snr_per_sample=0.5)
    fns = synth.synth_beam(str(tmp_path / "beam"), spec, pulsars=[psr])
    plan = [jddplan.DedispStep(30.0, 2.0, 12, 2, 16, 1),
            jddplan.DedispStep(78.0, 4.0, 8, 1, 16, 2)]
    jp = jex.SearchParams(nsub=16, topk_per_stage=16, **SLICE)
    jo = jex.search_beam(fns, str(tmp_path / "jw"), str(tmp_path / "jr"),
                         jp, plan=plan)
    to = tex.search_beam(
        fns, str(tmp_path / "tw"), str(tmp_path / "tr"),
        state.search_params_from_jax(jp.provenance()),
        plan=state.plan_from_jax([dataclasses.astuple(s) for s in plan]),
        device="cpu")

    assert to.num_dm_trials == jo.num_dm_trials == 32
    assert to.masked_fraction == jo.masked_fraction
    _assert_events_match(to.sp_events, jo.sp_events)
    _assert_cands_match(to.candidates, jo.candidates)
    assert to.candidates and abs(
        to.candidates[0].period_s - 0.25) / 0.25 < 2e-3

    jr, tr = tmp_path / "jr", tmp_path / "tr"
    assert sorted(os.listdir(tr)) == sorted(os.listdir(jr))
    assert "metrics.json" in os.listdir(tr)
    base = to.basenm
    assert _tar_members(tr / f"{base}_inf.tgz") == \
        _tar_members(jr / f"{base}_inf.tgz")
    assert (tr / "header.json").read_bytes() == \
        (jr / "header.json").read_bytes()
    assert (tr / "search_params.txt").read_bytes() == \
        (jr / "search_params.txt").read_bytes()
    jm = jrfi.RFIMask.load(str(jr / f"{base}_rfifind.npz"))
    tm = jrfi.RFIMask.load(str(tr / f"{base}_rfifind.npz"))
    np.testing.assert_array_equal(tm.full_mask(), jm.full_mask())
    rows = (tr / f"{base}.accelcands").read_text().splitlines()
    assert len(rows) == len(
        (jr / f"{base}.accelcands").read_text().splitlines())
    with np.load(io.BytesIO((tr / f"{base}_sp.npz").read_bytes())) as z:
        assert len(z["events"]) == len(jo.sp_events)


@pytest.mark.parametrize("name", sorted(build_scenarios()))
def test_golden_scenarios_match_jax(name):
    """search_block on each golden scenario, both packages, the hi
    stage off on both."""
    data, freqs, dt, plan, params, zaplist, apply_rfi = _unpack(
        build_scenarios()[name])
    jp = dataclasses.replace(params, **SLICE)
    jdata = jnp.asarray(data)
    tdata = torch.from_numpy(data)
    if apply_rfi:
        jm = jrfi.find_rfi_chan(jdata, dt, block_len=2048)
        jdata = jrfi.apply_mask_chan(
            jdata, jnp.asarray(jm.full_mask()), jnp.asarray(jm.chan_fill),
            jm.block_len)
        tm = trfi.find_rfi_chan(tdata, dt, block_len=2048)
        np.testing.assert_array_equal(tm.full_mask(), jm.full_mask())
        tdata = trfi.apply_mask_chan(tdata, tm.full_mask(), tm.chan_fill,
                                     tm.block_len)
    jfinal, _f, jsp, jn = jex.search_block(
        jdata, np.asarray(freqs), dt, plan, jp, zaplist=zaplist)
    tfinal, tfold, tsp, tn = tex.search_block(
        tdata, np.asarray(freqs), dt,
        state.plan_from_jax([dataclasses.asdict(s) for s in plan]),
        state.search_params_from_jax(jp.provenance()), zaplist=zaplist,
        device="cpu")
    assert tn == jn and tfold == []
    _assert_events_match(tsp, jsp, near_ties=0.01)
    _assert_cands_match(tfinal, jfinal)
