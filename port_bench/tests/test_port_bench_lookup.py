"""The harness finds each cell's configuration, traffic and metrics by
name from their files, and BENCHMARK.json keeps to its shape."""

import json
import os
import re

import pytest

from port_bench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["port_bench"]
    assert 1 <= b["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    b = bench()
    w, config, traffic = harness.find_cell(b, cell)
    assert config["name"] == w["config"]
    assert traffic["name"] == w["traffic"]
    for trace in (False, True):
        names = [m["name"] for m in harness.cell_metrics(b, cell, trace)]
        assert names
        for n in names:
            assert callable(harness.load_reader(n))


def test_every_metric_has_its_reader_file():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "port_bench", "metrics",
                                           m["name"] + ".py"))


def test_names_units_and_moves():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert NAME.match(c["name"])
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200


def test_cell_metrics_follow_the_workloads_key():
    b = bench()
    hi = harness.cell_metrics(b, "mock_zeroaccel.plan", True)
    assert "hi_roofline" not in {m["name"] for m in hi}
    full = harness.cell_metrics(b, "mock_default.plan", True)
    assert "hi_roofline" in {m["name"] for m in full}


def test_reader_returns_nothing_without_its_input():
    ctx = {"trace": None, "stage_s": {}, "trials": 0, "window_s": 0.0,
           "window_peak_bytes": 0, "stated": {"run_hi_accel": False}}
    for n in ("stage1_roofline", "stage2_roofline", "device_idle_share",
              "hi_roofline", "hi_s_per_ktrial", "peak_device_gib",
              "dm_trials_per_s"):
        assert harness.load_reader(n)(ctx) is None
