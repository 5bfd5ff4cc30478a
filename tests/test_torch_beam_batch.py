"""The port's batch-of-beams path (tpulsar_torch/kernels/beam_batch.py
and executor.search_beam_batch) against the JAX package's and against
the port's own solo search: the host planners and their environment
knobs equal JAX's; the coalesced stage-1/stage-2 calls are bit-equal
per beam to the solo calls; two beams searched as one group give
candidates, SP events, results files and checkpoint artifacts
bit-identical to the port's solo search of each (both stage-2
families), and JAX's search_beam_batch's at the slice tolerances; the
fall-outs to the solo path (resume state, a failed group, an
operator cap of 1, no batchmate) keep every beam's result; and `serve
--once --batch 2 --device cpu` answers two tickets on the batched
path.

Tolerances: the port against itself is exact (the results
directories under tools/torch_results_diff.py without --rtol);
against the JAX package, tests/test_torch_slice.py's."""

from __future__ import annotations

import dataclasses
import filecmp
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_checkpoint import ROOT  # noqa: E402
from test_torch_search_job import _config_file  # noqa: E402
from test_torch_serve import _results_diff  # noqa: E402
from test_torch_slice import (  # noqa: E402, F401 (a fixture)
    _assert_cands_match, _assert_events_match, one_torch_thread)
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
from tpulsar.io import synth  # noqa: E402
from tpulsar.kernels import beam_batch as jbb  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.kernels import beam_batch as tbb  # noqa: E402
from tpulsar_torch.kernels import cuda_dd  # noqa: E402
from tpulsar_torch.kernels import dedisperse as tdd  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402
from tpulsar_torch.serve import protocol as tprotocol  # noqa: E402

JPLAN = [jddplan.DedispStep(lodm=10.0, dmstep=2.0, dms_per_pass=16,
                            numpasses=2, numsub=16, downsamp=1),
         jddplan.DedispStep(42.0, 4.0, 16, 1, 16, 2)]
TPLAN = state.plan_from_jax([dataclasses.astuple(s) for s in JPLAN])
JPARAMS = jex.SearchParams(nsub=16, hi_accel_zmax=8, topk_per_stage=8,
                           max_cands_to_fold=2, make_plots=False)
TPARAMS = state.search_params_from_jax(JPARAMS.provenance())


# ------------------------------------------------------------ planners

def test_host_planners_equal_jax():
    zap = np.array([[60.0, 0.5], [120.0, 1.0]])
    for z in (None, zap):
        assert tbb.zaplist_digest(z) == jbb.zaplist_digest(z)
    args = (960, 3_932_160, 65.476e-6, 1214.0, 1536.0, 96)
    assert tbb.compat_key(*args, TPLAN, TPARAMS,
                          tbb.zaplist_digest(zap)) == \
        jbb.compat_key(*args, JPLAN, JPARAMS, jbb.zaplist_digest(zap))
    assert tbb.compat_key(*args, TPLAN, TPARAMS) != \
        tbb.compat_key(*args, TPLAN, tex.SearchParams())
    for n in range(1, 14):
        for cap in range(0, 6):
            assert tbb.plan_beam_groups(n, cap) == \
                tbb.BeamBatchPlan(**dataclasses.asdict(
                    jbb.plan_beam_groups(n, cap)))
    assert tbb.plan_beam_groups(5).groups == ((0, 1, 2, 3), (4,))
    for block, rows, nfft in ((3_774_873_600, 38, 3_932_160),
                              (1 << 20, 8, 8192), (1, 1, 1)):
        for budget in (None, 1 << 30, 80 << 30):
            assert tbb.budget_beams(block, rows, nfft, budget) == \
                jbb.budget_beams(block, rows, nfft, budget)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tbb.plan_beam_groups(1 if bad == -1 else bad,
                                 bad if bad == -1 else 0)


@pytest.mark.parametrize("knob, value", [
    ("TPULSAR_BEAM_BATCH", ""), ("TPULSAR_BEAM_BATCH", "3"),
    ("TPULSAR_BEAM_BATCH", "-1"), ("TPULSAR_BEAM_BATCH", "two"),
    ("TPULSAR_BEAM_BATCH_BYTES", ""),
    ("TPULSAR_BEAM_BATCH_BYTES", "2e9"),
    ("TPULSAR_BEAM_BATCH_BYTES", "0"),
    ("TPULSAR_BEAM_BATCH_BYTES", "lots"),
])
def test_env_knobs_parse_as_jax(knob, value, monkeypatch):
    monkeypatch.setenv(knob, value)
    fn = {"TPULSAR_BEAM_BATCH": "beam_batch_cap",
          "TPULSAR_BEAM_BATCH_BYTES": "beam_budget_bytes"}[knob]
    outcomes = []
    for mod in (jbb, tbb):
        try:
            outcomes.append(("ok", getattr(mod, fn)()))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


def test_budget_reads_the_cards_memory(monkeypatch):
    """On a CUDA device the default budget is DEVICE_BUDGET_SHARE of
    the card's memory, and at an 80 GB card's it affords two full Mock
    beams (the reference's 8 GiB affords one); the override and the
    CPU keep the reference's rule."""
    import types

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            total_memory=85_029_158_912))
    budget = tbb.beam_budget_bytes("cuda")
    assert budget == int(85_029_158_912 * tbb.DEVICE_BUDGET_SHARE)
    mock = (960 * 3_932_160, 38, 3_932_160)
    assert tbb.budget_beams(*mock, budget) == 2
    assert tbb.budget_beams(*mock, tbb.beam_budget_bytes("cpu")) == 1
    assert tbb.beam_budget_bytes("cpu") == jbb.beam_budget_bytes()
    monkeypatch.setenv("TPULSAR_BEAM_BATCH_BYTES", "3e9")
    assert tbb.beam_budget_bytes("cuda") == 3_000_000_000


# ------------------------------------------------- coalesced stages 1, 2

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_coalesced_stages_equal_solo_calls(dtype):
    """Stage 1 over the stacked blocks and stage 2 with a beam axis,
    per beam, are bit-equal to the solo calls (the plain versions: the
    CUDA kernels are held to them on the card)."""
    rng = np.random.default_rng(6)
    B, nchan, nsub, T, ds = 3, 32, 8, 3000, 2
    blocks = [torch.from_numpy((rng.integers(0, 256, (nchan, T))
                                if dtype == np.uint8 else
                                rng.standard_normal((nchan, T)))
                               .astype(dtype)) for _ in range(B)]
    freqs = np.linspace(1214.0, 1536.0, nchan)
    dms = np.arange(40) * 1.5 + 30.0
    chan_sh, sub_sh = tdd.plan_pass_shifts(freqs, nsub, 60.0, dms, 1e-3,
                                           ds)
    subb = tbb.form_subbands_beams(tbb.stack_blocks(blocks), chan_sh, B,
                                   nsub, ds)
    assert tuple(subb.shape) == (B * nsub, T // ds)
    series = tbb.dedisperse_beams(subb, sub_sh, B)
    assert tuple(series.shape) == (B * len(dms), T // ds)
    for b, blk in enumerate(blocks):
        solo_sub = tdd.form_subbands(blk, chan_sh, nsub, ds)
        assert torch.equal(subb[b * nsub:(b + 1) * nsub], solo_sub)
        assert torch.equal(series[b * len(dms):(b + 1) * len(dms)],
                           tdd.dedisperse_subbands(solo_sub, sub_sh))
    three = subb.reshape(B, nsub, -1)
    assert torch.equal(cuda_dd.dedisperse_subbands_beams(three, sub_sh),
                       series.reshape(B, len(dms), -1))
    with pytest.raises(ValueError, match="not divisible"):
        tbb.dedisperse_beams(subb[:-1], sub_sh, B)


@pytest.mark.cuda
def test_beam_axis_kernel_is_exact_on_the_card():
    """On the card: the stage-2 kernel at B = 2 equals its plain
    version and two B = 1 launches exactly, and counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(2)
    nsub, T = 96, 100_003
    freqs = np.linspace(1214.0, 1536.0, 960)
    _ch, sub_sh = tdd.plan_pass_shifts(freqs, nsub, 300.0,
                                       np.arange(76) * 0.5 + 290.0,
                                       65.476e-6, 1)
    subb = torch.from_numpy(rng.standard_normal((2, nsub, T))
                            .astype(np.float32)).cuda()
    cuda_dd.reset_counts()
    got = cuda_dd.dedisperse_subbands_beams(subb, sub_sh)
    torch.cuda.synchronize()
    assert cuda_dd.LAUNCHES["dedisperse_subbands_beams"] == 1
    want = cuda_dd.dedisperse_subbands_beams_plain(subb, sub_sh)
    assert torch.equal(got, want)
    for b in range(2):
        assert torch.equal(got[b], cuda_dd.dedisperse_subbands(subb[b],
                                                               sub_sh))


# ------------------------------------------------------- whole searches

def _beams(root, n=2):
    out = []
    for i in range(n):
        spec = synth.BeamSpec(nchan=32, nsamp=1 << 12, nbits=4,
                              tsamp_s=5.24288e-4, seed=3 + i)
        psr = synth.PulsarSpec(period_s=0.2, dm=20.0,
                               snr_per_sample=1.0)
        out.append(synth.synth_beam(str(root / f"d{i}"), spec,
                                    pulsars=[psr], merged=True))
    return out


@pytest.fixture
def fixed_plan(monkeypatch):
    """search_beam_batch plans each beam from its header, as
    search_beam does without a plan: pin both to the test's small
    plan."""
    for mod, plan in ((tex, TPLAN), (jex, JPLAN)):
        orig = mod._beam_geometry
        monkeypatch.setattr(
            mod, "_beam_geometry",
            lambda fns, params, _plan, baryv, _o=orig, _p=plan:
            _o(fns, params, _p, baryv))


def _specs(root, beams, tag, ckpt=True):
    return [tex.BeamSpec(fns=b, workdir=str(root / f"{tag}w{i}"),
                         resultsdir=str(root / f"{tag}r{i}"),
                         checkpoint_dir=(str(root / f"{tag}c{i}")
                                         if ckpt else None),
                         label=f"{tag}{i}")
            for i, b in enumerate(beams)]


def _solo(root, beams, params=TPARAMS):
    return [tex.search_beam(b, str(root / f"sw{i}"), str(root / f"sr{i}"),
                            params, plan=TPLAN,
                            checkpoint_dir=str(root / f"sc{i}"),
                            device="cpu")
            for i, b in enumerate(beams)]


def _same_cands(a, b):
    key = ("r", "z", "sigma", "power", "numharm", "dm", "period_s",
           "freq_hz", "dm_hits")
    return [tuple(getattr(c, k) for k in key) for c in a] == \
        [tuple(getattr(c, k) for k in key) for c in b]


@pytest.mark.parametrize("family", ["direct", "tree"])
def test_batched_beams_are_bit_identical_to_solo(family, tmp_path,
                                                 fixed_plan, monkeypatch):
    """The default search (hi stage, refinement, folds) on the direct
    family; the tree family at the zero-accel configuration."""
    monkeypatch.setenv("TPULSAR_DD_FAMILY", family)
    params = TPARAMS if family == "direct" else dataclasses.replace(
        TPARAMS, run_hi_accel=False, refine_cands=False)
    beams = _beams(tmp_path)
    solo = _solo(tmp_path, beams, params)
    res = tex.search_beam_batch(_specs(tmp_path, beams, "b"), params,
                                device="cpu")
    assert [(r.path, r.group_size, r.fallout, r.error) for r in res] == \
        [("batched", 2, "", None)] * 2
    for i, (s, r) in enumerate(zip(solo, res)):
        o = r.outcome
        assert _same_cands(o.candidates, s.candidates)
        assert np.array_equal(o.sp_events, s.sp_events)
        assert o.num_dm_trials == s.num_dm_trials == 48
        assert [f.profile.tobytes() for f in o.folded] == \
            [f.profile.tobytes() for f in s.folded]
        assert _results_diff().diff_results(
            str(tmp_path / f"sr{i}"), str(tmp_path / f"br{i}")) == []
        ckpts = [sorted(glob.glob(str(tmp_path / f"{t}c{i}" / "*.npz")))
                 for t in "sb"]
        assert len(ckpts[0]) == len(ckpts[1]) > 3
        for x, y in zip(*ckpts):
            assert os.path.basename(x) == os.path.basename(y)
            assert filecmp.cmp(x, y, shallow=False), x
        with open(os.path.join(o.resultsdir, "metrics.json")) as fh:
            m = json.load(fh)
        assert m["tpulsar_beam_batch_occupancy"]["series"] == {"": 2.0}
        assert m["tpulsar_beam_batch_trials_total"]["series"] == \
            {"batched": 96.0}
        assert m["tpulsar_dedisp_trials_total"]["series"] == \
            {family: 96.0}


def test_batched_beams_match_the_jax_batch(tmp_path, fixed_plan,
                                           monkeypatch):
    """Both packages' search_beam_batch on the same two beams (the
    zero-accel configuration, direct family): the same paths, and
    candidates and SP events at the slice tolerances."""
    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")
    beams = _beams(tmp_path)
    jp = dataclasses.replace(JPARAMS, run_hi_accel=False,
                             refine_cands=False, max_cands_to_fold=0)
    tp = state.search_params_from_jax(jp.provenance())
    jres = jex.search_beam_batch(
        [jex.BeamSpec(fns=b, workdir=str(tmp_path / f"jw{i}"),
                      resultsdir=str(tmp_path / f"jr{i}"))
         for i, b in enumerate(beams)], jp)
    tres = tex.search_beam_batch(_specs(tmp_path, beams, "t",
                                        ckpt=False), tp, device="cpu")
    for j, t in zip(jres, tres):
        assert (t.path, t.group_size) == (j.path, j.group_size) == \
            ("batched", 2)
        _assert_cands_match(t.outcome.candidates, j.outcome.candidates)
        _assert_events_match(t.outcome.sp_events, j.outcome.sp_events,
                             near_ties=0.01)


def test_fallouts_keep_every_beam(tmp_path, fixed_plan, monkeypatch):
    """Resume state, an operator cap of 1, and a failed group send
    beams to the solo path with the reason recorded; no beam fails
    its batchmate (the solo searches are stubbed: the point is the
    routing)."""
    beams = _beams(tmp_path, 3)
    calls = []

    def fake_solo(fns, workdir, resultsdir, params, **kw):
        calls.append(resultsdir)
        if resultsdir.endswith("r2"):
            raise RuntimeError("poisoned beam")
        return tex.SearchOutcome("b", resultsdir, [], [], tex._EMPTY_SP,
                                 0.0, 48, tex.StageTimers())

    monkeypatch.setattr(tex, "search_beam", fake_solo)
    # a beam whose checkpoint has a completed pass resumes solo; the
    # other two still form a group, which fails and degrades
    specs = _specs(tmp_path, beams, "f")
    monkeypatch.setattr(tex, "_has_resume_state",
                        lambda d: d.endswith("fc0"))

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tex, "_search_group", boom)
    with pytest.warns(UserWarning, match="degrades to the solo path"):
        res = tex.search_beam_batch(specs, TPARAMS, device="cpu")
    assert [(r.path, r.fallout) for r in res] == [
        ("solo", "resume"), ("solo", "group_failed"),
        ("solo", "group_failed")]
    assert res[0].outcome is not None and res[1].outcome is not None
    assert isinstance(res[2].error, RuntimeError) and \
        res[2].outcome is None
    assert len(calls) == 3
    monkeypatch.setattr(tex, "_has_resume_state", lambda d: False)
    monkeypatch.setenv("TPULSAR_BEAM_BATCH", "1")
    res = tex.search_beam_batch(specs[:2], TPARAMS, device="cpu")
    assert [(r.path, r.fallout) for r in res] == [("solo", "cap_1")] * 2
    monkeypatch.delenv("TPULSAR_BEAM_BATCH")
    res = tex.search_beam_batch(specs[:1], TPARAMS, device="cpu")
    assert [(r.path, r.fallout) for r in res] == \
        [("solo", "no_batchmates")]


def test_run_search_batch_has_resume_state_beam_fall_out(
        tmp_path, fixed_plan, monkeypatch):
    """run_search_batch with a real resume: beam 0's outdir holds a
    checkpoint of a completed search, so it resumes solo while beam 1
    (alone) also runs solo; both results land in their outdirs, equal
    to the solo search's, and the checkpoints are cleaned."""
    from tpulsar_torch import checkpoint as tckpt
    from tpulsar_torch.cli import search_job as tjob

    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")
    params = dataclasses.replace(TPARAMS, run_hi_accel=False,
                                 max_cands_to_fold=0)
    beams = _beams(tmp_path)
    ck0 = tckpt.default_root(str(tmp_path / "o0"))
    tex.search_beam(beams[0], str(tmp_path / "pw"), str(tmp_path / "pr"),
                    params, plan=TPLAN, checkpoint_dir=ck0, device="cpu")
    assert tckpt.progress_marker(ck0) > 0
    jobs = [{"ppfns": b, "workdir": str(tmp_path / f"w{i}"),
             "outdir": str(tmp_path / f"o{i}"), "zap": None,
             "label": f"j{i}"} for i, b in enumerate(beams)]
    out = tjob.run_search_batch(jobs, params, log=lambda m: None,
                                device="cpu")
    assert [(s, p) for s, _o, p in out] == [("done", "solo")] * 2
    assert _results_diff().diff_results(str(tmp_path / "pr"),
                                        str(tmp_path / "o0")) == []
    assert not os.path.exists(ck0)


def test_serve_once_batch_2_on_the_cpu(tmp_path):
    """`python -m tpulsar_torch serve --once --batch 2 --device cpu
    --no-warmstart` answers two tickets as one batched group: both
    done on the batched path, one batch_dispatch journal event naming
    both, the pulsar in both results."""
    cfg = _config_file(tmp_path, dm_max=8.0, use_hi_accel=False,
                       max_cands_to_fold=0)
    spool = str(tmp_path / "spool")
    for i in range(2):
        spec = synth.BeamSpec(nchan=32, nsamp=1 << 13, nbits=4,
                              tsamp_s=327.68e-6, seed=11 + i)
        psr = synth.PulsarSpec(period_s=0.25, dm=5.0,
                               snr_per_sample=0.5)
        fns = synth.synth_beam(str(tmp_path / f"beam{i}"), spec,
                               pulsars=[psr], merged=True)
        tprotocol.write_ticket(spool, f"t{i}", fns,
                               str(tmp_path / f"out{i}"), job_id=i)
    res = subprocess.run(
        [sys.executable, "-m", "tpulsar_torch", "--config", cfg, "serve",
         "--once", "--batch", "2", "--batch-linger", "0.5",
         "--device", "cpu", "--no-warmstart", "--spool", spool],
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                 TPULSAR_DD_FAMILY="direct"),
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "batch 2" in res.stdout
    for i in range(2):
        rec = tprotocol.read_result(spool, f"t{i}")
        assert rec["status"] == "done", rec
        assert rec["batch_path"] == "batched" and rec["batch_beams"] == 2
        assert rec["candidates"] >= 1
    from tpulsar_torch.obs import journal as tjournal
    dispatches = [e for e in tjournal.read_events(spool)
                  if e["event"] == "batch_dispatch"]
    assert len(dispatches) == 1
    assert dispatches[0]["beams"] == 2
    assert sorted(dispatches[0]["tickets"]) == ["t0", "t1"]
