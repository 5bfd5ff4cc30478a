"""The port's contract linter (tpulsar_torch/analysis/) against the JAX
package's: every case of tests/test_analysis.py's mutation suite run
on both linters, each over its own package's fixture layout (the
port's walks tpulsar_torch/, tools/torch_*.py and chip_smoke.py), and
the port's own rules: the committed tree is clean with exactly
PORT_DIFFERENCES excused, a stale entry there is a finding, and the
bench-keys checker reports itself as not run."""

from __future__ import annotations

import json
import os
import textwrap

import pytest

from tpulsar.analysis import cli as jcli
from tpulsar.analysis import core as jcore
from tpulsar_torch.analysis import checkers as tcheckers
from tpulsar_torch.analysis import cli as tcli
from tpulsar_torch.analysis import core as tcore

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: per package: (package dir, a harness file outside env-knobs' scope,
#: core module, CLI module)
PKGS = {"jax": ("tpulsar", "tools/harness.py", jcore, jcli),
        "torch": ("tpulsar_torch", "tools/torch_harness.py", tcore,
                  tcli)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


def _write(root, relpath, text, name="tpulsar"):
    relpath = relpath.format(pkg=name)
    path = os.path.join(str(root), relpath)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(textwrap.dedent(text).replace("{pkg}", name))
    return relpath


def _findings(pkg, root, checker=None):
    out = PKGS[pkg][2].run_lint(str(root), checker_ids=[checker]
                                if checker else None)
    return [(f.path, f.line, f.message) for f in out]


# ------------------------------------------------------ 1. fault-points

def test_unknown_fault_point_fires_at_line(tmp_path, pkg):
    rel = _write(tmp_path, "bad.py", """\
        from {pkg}.resilience import faults
        faults.fire("not.a.point")
    """, PKGS[pkg][0])
    found = _findings(pkg, tmp_path, "fault-points")
    assert found and found[0][0] == rel and found[0][1] == 2
    assert "not.a.point" in found[0][2]


def test_known_fault_point_is_clean(tmp_path, pkg):
    _write(tmp_path, "ok.py", """\
        from {pkg}.resilience import faults
        faults.fire("spool.io")
        faults.targets("journal.append")
        faults.targets_prefix("accel.")
    """, PKGS[pkg][0])
    assert _findings(pkg, tmp_path, "fault-points") == []


# ---------------------------------------------------------- 2. metrics

def test_adhoc_metric_constructor_fires(tmp_path, pkg):
    rel = _write(tmp_path, "bad.py", """\
        from {pkg}.obs import metrics
        c = metrics.counter("tpulsar_bogus_total", "nope")
    """, PKGS[pkg][0])
    found = _findings(pkg, tmp_path, "metrics")
    assert [(rel, 2)] == [(p, ln) for p, ln, _ in found]
    assert "tpulsar_bogus_total" in found[0][2]
    assert "ad-hoc" in found[0][2]


def test_catalog_metric_constructed_elsewhere_fires(tmp_path, pkg):
    _write(tmp_path, "bad.py", """\
        from {pkg}.obs import metrics
        c = metrics.counter("tpulsar_passes_total", "dup")
    """, PKGS[pkg][0])
    found = _findings(pkg, tmp_path, "metrics")
    assert found and "outside the telemetry catalog" in found[0][2]


# --------------------------------------------------- 3. journal events

def test_unjournaled_event_literal_fires(tmp_path, pkg):
    rel = _write(tmp_path, "bad.py", """\
        from {pkg}.obs import journal
        journal.record("/spool", "weird_event", ticket="t1")
    """, PKGS[pkg][0])
    found = _findings(pkg, tmp_path, "journal-events")
    assert found and (found[0][0], found[0][1]) == (rel, 2)
    assert "weird_event" in found[0][2]


def test_verifier_comparison_against_unknown_event_fires(tmp_path, pkg):
    rel = _write(tmp_path, "{pkg}/chaos/aud.py", """\
        def check(events):
            names = [e.get("event") for e in events]
            return names.count("weird_event")
    """, PKGS[pkg][0])
    found = _findings(pkg, tmp_path, "journal-events")
    assert found and found[0][0] == rel
    assert "weird_event" in found[0][2]


def test_vocabulary_events_are_clean(tmp_path, pkg):
    _write(tmp_path, "{pkg}/chaos/ok.py", """\
        from {pkg}.obs import journal
        def check(spool, events):
            journal.record(spool, "takeover", ticket="t")
            name = events[0].get("event")
            return name in ("scale_up", "scale_down")
    """, PKGS[pkg][0])
    assert _findings(pkg, tmp_path, "journal-events") == []


# ------------------------------------------------------- 4. env knobs

def test_undeclared_env_knob_fires(tmp_path, pkg):
    rel = _write(tmp_path, "{pkg}/kernels/bad.py", """\
        import os
        v = os.environ.get("TPULSAR_BOGUS_KNOB", "0")
        w = os.getenv("TPULSAR_BOGUS_TOO")
        x = os.environ["TPULSAR_BOGUS_SUB"]
        y = "TPULSAR_BOGUS_IN" in os.environ
    """, PKGS[pkg][0])
    found = _findings(pkg, tmp_path, "env-knobs")
    assert [(p, ln) for p, ln, _ in found] == [
        (rel, 2), (rel, 3), (rel, 4), (rel, 5)]


def test_declared_knob_and_out_of_scope_read_are_clean(tmp_path, pkg):
    name, harness = PKGS[pkg][:2]
    _write(tmp_path, "{pkg}/obs/ok.py", """\
        import os
        v = os.environ.get("TPULSAR_TRACE", "")
    """, name)
    # harness knobs are out of the registry's scope
    _write(tmp_path, harness, """\
        import os
        v = os.environ.get("TPULSAR_BENCH_SCALE", "1")
    """, name)
    assert _findings(pkg, tmp_path, "env-knobs") == []


# ------------------------------------------------- 5. spool discipline

_BARE_WRITE = """\
    import json, os
    def stash(rec, path):
        with open(path, "w") as fh:
            json.dump(rec, fh)
        os.replace(path, path + ".final")
"""


def test_bare_spool_write_fires_per_call(tmp_path, pkg):
    rel = _write(tmp_path, "{pkg}/serve/bad.py", _BARE_WRITE,
                 PKGS[pkg][0])
    found = _findings(pkg, tmp_path, "spool-write")
    assert [(p, ln) for p, ln, _ in found] == [
        (rel, 3), (rel, 4), (rel, 5)]


def test_spool_write_out_of_scope_and_blessed_are_clean(tmp_path, pkg):
    name = PKGS[pkg][0]
    # same code outside the spool packages: not this checker's business
    _write(tmp_path, "{pkg}/io/ok.py", _BARE_WRITE, name)
    # and inside a blessed discipline module: it IS the mechanism
    _write(tmp_path, "{pkg}/serve/protocol.py", _BARE_WRITE, name)
    assert _findings(pkg, tmp_path, "spool-write") == []


# ------------------------------------------------------ 6. bench keys

def test_dangling_bench_gate_key_fires(tmp_path, pkg, capsys):
    """The JAX linter finds the dangling key; the port's bench-keys
    checker does not run (no gate until ROADMAP item 26) and says so
    rather than passing over the file."""
    _write(tmp_path, "tools/bench_gate.py", """\
        DEFAULT_KEYS = (
            ("serve.ok_key", "lower"),
            ("serve.dangling_key", "higher"),
        )
    """)
    with open(os.path.join(str(tmp_path), "BENCH_t.json"),
              "w") as fh:
        json.dump({"serve": {"ok_key": 1.5}}, fh)
    found = _findings(pkg, tmp_path, "bench-keys")
    if pkg == "torch":
        assert found == []
        assert tcli.main(["--root", str(tmp_path), "--checker",
                          "bench-keys"]) == 0
        out = capsys.readouterr().out
        assert "clean (0 of 6 checkers run)" in out
        assert "not run: bench-keys" in out
        return
    assert len(found) == 1
    assert found[0][0] == "tools/bench_gate.py"
    assert "serve.dangling_key" in found[0][2]
    assert "serve.ok_key" not in found[0][2]


# ------------------------------------------------ suppression + output

def test_suppression_comment_same_and_previous_line(tmp_path, pkg):
    _write(tmp_path, "{pkg}/serve/ok.py", """\
        import os
        def swap(a, b):
            os.rename(a, b)   # tpulsar: lint-ok[spool-write]
            # tpulsar: lint-ok[spool-write]
            os.replace(a, b)
    """, PKGS[pkg][0])
    assert _findings(pkg, tmp_path, "spool-write") == []


def test_suppression_is_checker_scoped(tmp_path, pkg):
    rel = _write(tmp_path, "{pkg}/serve/bad.py", """\
        import os
        def swap(a, b):
            os.rename(a, b)   # tpulsar: lint-ok[env-knobs]
    """, PKGS[pkg][0])
    found = _findings(pkg, tmp_path, "spool-write")
    assert found and found[0][0] == rel


def test_json_schema(tmp_path, pkg):
    core = PKGS[pkg][2]
    _write(tmp_path, "bad.py", """\
        from {pkg}.resilience import faults
        faults.fire("not.a.point")
    """, PKGS[pkg][0])
    doc = json.loads(core.render_json(core.run_lint(str(tmp_path))))
    assert doc["schema"] == "tpulsar-lint/v1"
    assert doc["ok"] is False
    assert doc["counts"] == {"fault-points": 1}
    (f,) = doc["findings"]
    assert set(f) == {"checker", "path", "line", "message", "hint"}
    assert f["checker"] == "fault-points" and f["line"] == 2


def test_cli_exit_codes(tmp_path, pkg, capsys):
    lint_main = PKGS[pkg][3].main
    assert lint_main(["--root", str(tmp_path)]) == 0
    _write(tmp_path, "bad.py", 'import os\nos.rename\n')
    _write(tmp_path, "worse.py", """\
        from {pkg}.resilience import faults
        faults.fired("nope.point")
    """, PKGS[pkg][0])
    assert lint_main(["--root", str(tmp_path)]) == 1
    assert lint_main(["--root", str(tmp_path),
                      "--checker", "no-such-checker"]) == 2
    capsys.readouterr()


def test_unparseable_file_is_a_finding_not_a_crash(tmp_path, pkg):
    rel = _write(tmp_path, "broken.py", "def nope(:\n")
    found = _findings(pkg, tmp_path)
    assert found and found[0][0] == rel
    assert found[0][2].startswith("cannot parse")


# ------------------------------------------------- the committed tree

def _excused_names(doc) -> list[tuple[str, str]]:
    return sorted((e["checker"], e["name"]) for e in doc["excused"])


def test_committed_tree_is_clean(capsys):
    """`python -m tpulsar_torch lint` exits 0 on the repo, 5 of the 6
    checkers run (bench-keys not, and says why), and the findings it
    excuses are exactly the 9 PORT_DIFFERENCES entries, each once
    (the compile-cache families and TPULSAR_CACHE_DIR left the list
    with the AOT layer, TPULSAR_PROFILE with the port's profiler;
    TPULSAR_TRACE_SYNC joined it when the port's device time came to
    CUDA events, tpulsar_accel_kernel_rows_total with the hi stage's
    CUDA stage kernel)."""
    report = tcore.lint(REPO_ROOT)
    assert report.findings == [], "\n".join(
        f.render() for f in report.findings)
    assert tcli.main(["--root", REPO_ROOT]) == 0
    text = capsys.readouterr().out
    assert "tpulsar_torch lint: clean (5 of 6 checkers run)" in text
    assert "not run: bench-keys" in text
    assert tcli.main(["--root", REPO_ROOT, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["findings"] == []
    assert list(doc["not_run"]) == ["bench-keys"]
    assert _excused_names(doc) == sorted(
        (d.checker, d.name) for d in tcheckers.PORT_DIFFERENCES)
    assert len(doc["excused"]) == len(tcheckers.PORT_DIFFERENCES) == 9


def test_stale_port_difference_is_a_finding(monkeypatch):
    """An entry that excuses nothing on the port's tree (the port
    reads TPULSAR_TRACE, so nothing differs there) is a finding
    anchored in checkers.py; on a fixture tree it is not judged."""
    stale = tcheckers.PortDifference("env-knobs", "TPULSAR_TRACE",
                                     "no longer differs", "a test")
    monkeypatch.setattr(tcheckers, "PORT_DIFFERENCES",
                        tcheckers.PORT_DIFFERENCES + (stale,))
    found = tcore.run_lint(REPO_ROOT, checker_ids=["env-knobs"])
    assert [(f.checker, f.path) for f in found] == [
        ("env-knobs", "tpulsar_torch/analysis/checkers.py")]
    assert "'TPULSAR_TRACE' excuses no finding" in found[0].message
    # another checker's run does not judge an env-knobs entry
    assert tcore.run_lint(REPO_ROOT, checker_ids=["spool-write"]) == []


def test_list_prints_every_port_difference(capsys):
    assert tcli.main(["--list"]) == 0
    out = capsys.readouterr().out
    for d in tcheckers.PORT_DIFFERENCES:
        assert f"{d.name}: {d.reason}; closed by: {d.closes}" in out
    assert "bench-keys" in out and "not run" in out
    # the port reads TPULSAR_PROFILE (search/executor.py): no longer a
    # difference
    assert "TPULSAR_PROFILE" not in out


def test_walk_covers_the_port_its_tools_and_the_smoke():
    """The port's linter walks tpulsar_torch/, tools/torch_*.py and
    chip_smoke.py, and nothing of the JAX package or its tools."""
    files = tcore.walk_files(REPO_ROOT)
    assert "chip_smoke.py" in files
    assert "tools/torch_trace_summarize.py" in files
    assert "tpulsar_torch/analysis/checkers.py" in files
    assert not [f for f in files if f.startswith(("tpulsar/", "tests/"))
                or (f.startswith("tools/")
                    and not f.startswith("tools/torch_"))]
