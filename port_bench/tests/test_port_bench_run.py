"""A run driven on the CPU at a tiny size: sound, it is correct; with
the timed path broken underneath, or with the bfloat16 control in the
program's place, it is not."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import tiny, tiny_traffic
from port_bench import control, harness

SEED = 3_000_000_017
CELLS = {"palfa_mock_default": "mock_default.plan",
         "palfa_mock_zeroaccel": "mock_zeroaccel.plan"}


def run(config_name, trace=False, seconds=2.0):
    bench = harness.load_benchmark()
    metrics = harness.cell_metrics(bench, CELLS[config_name], trace)
    return harness.run(metrics, tiny(config_name), tiny_traffic(), SEED,
                       seconds, trace, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("config_name", sorted(CELLS))
def test_a_sound_run_is_correct(config_name):
    res, rows = run(config_name)
    assert res["correct"], rows
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"dm_trials_per_s", "setup_s"}
    assert list(res)[-1] == "check"
    names = {n for n, _v, _l in rows}
    assert {"sp_gap", "lo_gap", "outputs_missing"} <= names


def test_a_traced_run_reports_the_per_layer_metrics():
    res, _rows = run("palfa_mock_default", trace=True)
    assert res["correct"]
    for k in ("plan_loop_other_share", "sp_s_per_ktrial",
              "fft_lo_s_per_ktrial", "hi_s_per_ktrial", "hi_roofline"):
        assert k in res["metrics"]
    assert "window_s" in res["device"] and "breakdown" in res


def _drop_half(orig):
    def drain(pending, *a, **k):
        cands, events = orig(pending, *a, **k)
        dms = np.concatenate([np.asarray(p[0]) for p in pending])
        keep = dms[: len(dms) // 2]
        cands = [c for c in cands if c.dm in set(keep.tolist())]
        events = [e[np.isin(e["dm"], keep)] for e in events]
        return cands, events
    return drain


def _alter_candidate(orig):
    def drain(pending, *a, **k):
        cands, events = orig(pending, *a, **k)
        for c in cands[:1]:
            c.power *= 1.3
            c.sigma += 0.5
        return cands, events
    return drain


def _alter_event(orig):
    def drain(pending, *a, **k):
        cands, events = orig(pending, *a, **k)
        for e in events[:1]:
            if len(e):
                e["sigma"][0] += 0.5
        return cands, events
    return drain


@pytest.mark.parametrize("fault", [_drop_half, _alter_candidate,
                                   _alter_event],
                         ids=["half_of_the_batch_left_out",
                              "a_candidate_altered", "an_event_altered"])
@pytest.mark.parametrize("config_name", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault,
                                            config_name):
    from tpulsar_torch.search import executor

    monkeypatch.setattr(executor, "_drain", fault(executor._drain))
    res, rows = run(config_name)
    assert not res["correct"], rows


def test_a_lost_hi_row_counts_as_failed(monkeypatch):
    from tpulsar_torch.search import degraded

    orig = degraded.counts
    monkeypatch.setattr(degraded, "counts", lambda: {
        **orig(), "accel_rows_zero_filled": (1, 8, 1)})
    res, _rows = run("palfa_mock_default")
    assert res["failed"] > 0 and not res["correct"]


@pytest.mark.parametrize("config_name", sorted(CELLS))
def test_the_bf16_control_is_not_correct(config_name):
    cfg = tiny(config_name)
    nums = control.control_numbers(cfg, tiny_traffic(), SEED,
                                   torch.device("cpu"))
    ok, rows = harness.verdict({**nums, "compared": 1},
                               cfg["check"]["limits"])
    assert not ok, rows


def test_the_programs_bf16_plane_is_not_correct(monkeypatch):
    """The program's own lower-precision path, the hi plane stored in
    bfloat16, is the default configuration's control: hi_gap fails."""
    cfg = tiny("palfa_mock_default")
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", "f32")
    cfg["environment"] = cfg["control_environment"]
    bench = harness.load_benchmark()
    res, rows = harness.run(
        harness.cell_metrics(bench, "mock_default.plan", False), cfg,
        tiny_traffic(), SEED, 2.0, False, torch.device("cpu"),
        time.perf_counter())
    assert not res["correct"], rows
    assert {n: v > lim for n, v, lim in rows}["hi_gap"], rows


def test_the_command_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", "mock_default.plan", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", str(SEED), "--seconds", "5"],
        capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    assert json.loads(out.stdout.splitlines()[-1])["correct"]
