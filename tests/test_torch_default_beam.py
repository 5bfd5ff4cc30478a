"""The port's default search end to end against the JAX package's:
both search_beam on one synthesized beam file (the same results
directory, metrics.json included, and the same folded candidate
files), and search_block's two other fold paths
(fold_batched=False, fold_by_rules=False) on a golden scenario.

Tolerances are test_torch_default_golden.py's."""

import dataclasses
import os
import tarfile

import pytest

torch = pytest.importorskip("torch")

from test_torch_default_golden import assert_folds_match, run_both  # noqa: E402
from test_torch_slice import (  # noqa: E402, F401 (an autouse fixture)
    _assert_cands_match, one_torch_thread)
from tpulsar.io import synth  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402


@pytest.fixture(autouse=True)
def _direct_family(monkeypatch):
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")


def _bestprof_values(path):
    """{member: {key: float}} of the header lines of every .bestprof
    in a _bestprof.tgz (the profile lines are compared through the
    folds themselves)."""
    out = {}
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            text = tf.extractfile(m).read().decode()
            vals = {}
            for line in text.splitlines():
                if line.startswith("# ") and "=" in line \
                        and not line.startswith("# Source"):
                    k, v = line[2:].split("=")
                    vals[k.strip()] = float(v)
            out[m.name] = vals
    return out


def test_search_beam_default_matches_jax(tmp_path):
    spec = synth.BeamSpec(nchan=64, nsamp=1 << 15, nbits=4,
                          tsamp_s=327.68e-6, seed=11)
    psr = synth.PulsarSpec(period_s=0.25, dm=50.0, snr_per_sample=0.5)
    fns = synth.synth_beam(str(tmp_path / "beam"), spec, pulsars=[psr])
    plan = [jddplan.DedispStep(30.0, 2.0, 12, 2, 16, 1),
            jddplan.DedispStep(78.0, 4.0, 8, 1, 16, 2)]
    jp = jex.SearchParams(nsub=16, topk_per_stage=16, hi_accel_zmax=16,
                          max_cands_to_fold=4, make_plots=False)
    jo = jex.search_beam(fns, str(tmp_path / "jw"), str(tmp_path / "jr"),
                         jp, plan=plan)
    to = tex.search_beam(
        fns, str(tmp_path / "tw"), str(tmp_path / "tr"),
        state.search_params_from_jax(jp.provenance()),
        plan=state.plan_from_jax([dataclasses.astuple(s) for s in plan]),
        device="cpu")

    assert to.num_dm_trials == jo.num_dm_trials == 32
    _assert_cands_match(to.candidates, jo.candidates)
    assert [c.z for c in to.candidates] == [c.z for c in jo.candidates]
    assert_folds_match(to.folded, jo.folded)
    assert to.folded and abs(to.folded[0].period_s - 0.25) / 0.25 < 1e-3
    assert to.refined_dms

    jr, tr = tmp_path / "jr", tmp_path / "tr"
    assert sorted(os.listdir(tr)) == sorted(os.listdir(jr))
    assert "metrics.json" in os.listdir(tr)
    base = to.basenm
    for suffix in ("_bestprof.tgz", "_pfd.tgz"):
        with tarfile.open(tr / f"{base}{suffix}") as t1, \
                tarfile.open(jr / f"{base}{suffix}") as t2:
            assert t1.getnames() == t2.getnames()
            assert len(t1.getnames()) == len(to.folded)
    got = _bestprof_values(tr / f"{base}_bestprof.tgz")
    want = _bestprof_values(jr / f"{base}_bestprof.tgz")
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            assert got[name][k] == pytest.approx(want[name][k], rel=1e-4,
                                                 abs=1e-9), (name, k)
    assert (tr / "search_params.txt").read_bytes() == \
        (jr / "search_params.txt").read_bytes()


@pytest.mark.parametrize("change", [dict(fold_batched=False),
                                    dict(fold_by_rules=False)])
def test_other_fold_paths_match_jax(change):
    (tfinal, tfold, _tsp, tn), (jfinal, jfold, _jsp, jn) = run_both(
        "accel_binary", **change)
    assert tn == jn
    _assert_cands_match(tfinal, jfinal)
    assert_folds_match(tfold, jfold)
    assert len(tfold) == 2
    assert tfold[0].reduced_chi2 > 20
