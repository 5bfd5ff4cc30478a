"""The port's knob registry (tpulsar_torch/config/knobs.py) against the
JAX package's: each knob the two share keeps the JAX entry's type,
default and text (where the port's default differs, PORT_DEFAULTS
names it, and where its text does, PORT_DOCS); the registry lists
exactly the TPULSAR_* knobs the port reads, by the env-knobs checker's
own rule; the markdown table
renders as `python -m tpulsar_torch.config.knobs`; and the hi stage's
three integer knobs, now read by their literal names, behave as
before."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from tpulsar.config import knobs as jknobs
from tpulsar_torch.analysis.checkers import EnvKnobsChecker
from tpulsar_torch.config import knobs as tknobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the knobs whose default is the port's own, and why
PORT_DEFAULTS = {
    # the port has no automatic plane cap (a TPU runtime's workaround)
    "TPULSAR_ACCEL_PLANE_ELEMS": "unset (no cap)",
    # kernels/beam_batch.py sizes the budget from the card's memory
    "TPULSAR_BEAM_BATCH_BYTES": ("half the card's memory on CUDA, "
                                 "8589934592 (8 GiB) on the CPU"),
    # the build directory of the port's libraries (aot/cachedir.py)
    "TPULSAR_CACHE_DIR": "tpulsar_torch/_build",
}

#: the knobs whose text is the port's own, and why
PORT_DOCS = {
    # the port's trace is the torch profiler's, not jax.profiler's
    "TPULSAR_PROFILE": ("torch profiler trace of the search block "
                        "(TensorBoard / Perfetto .pt.trace.json.gz)"),
}


@pytest.mark.parametrize("name", sorted(tknobs.KNOBS))
def test_shared_knob_equals_the_jax_entry(name):
    port, ref = tknobs.KNOBS[name], jknobs.KNOBS[name]
    assert (port.name, port.type) == (ref.name, ref.type)
    assert port.doc == PORT_DOCS.get(name, ref.doc)
    assert port.default == PORT_DEFAULTS.get(name, ref.default)


def _port_reads() -> dict[str, str]:
    """Every TPULSAR_* env read inside tpulsar_torch/ by the env-knobs
    checker's rule: name -> first site."""
    reads: dict[str, str] = {}
    checker = EnvKnobsChecker()
    pkg = os.path.join(ROOT, "tpulsar_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as fh:
                    tree = ast.parse(fh.read())
                for name, node in checker._reads(tree):
                    reads.setdefault(name, f"{path}:{node.lineno}")
    return reads


def test_registry_is_exactly_what_the_port_reads():
    reads = _port_reads()
    assert sorted(reads) == sorted(tknobs.KNOBS)
    assert len(tknobs.KNOBS) == 41
    for name in ("TPULSAR_ACCEL_SYNC_WINDOW",
                 "TPULSAR_ACCEL_BREAKER_THRESHOLD",
                 "TPULSAR_ACCEL_BATCH_BREAKER"):
        assert reads[name].startswith(
            os.path.join(ROOT, "tpulsar_torch", "kernels", "accel.py"))
    # the profiler hook sits where the JAX package's does
    assert reads["TPULSAR_PROFILE"].startswith(
        os.path.join(ROOT, "tpulsar_torch", "search", "executor.py"))


def test_table_renders_and_shared_rows_equal_the_jax_table():
    res = subprocess.run([sys.executable, "-m",
                          "tpulsar_torch.config.knobs"],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         timeout=60)
    assert res.returncode == 0, res.stderr
    rows = res.stdout.strip().splitlines()
    assert rows[:2] == ["| Variable | Type | Default | Effect |",
                        "|---|---|---|---|"]
    assert len(rows) == 2 + len(tknobs.KNOBS)
    jrows = set(jknobs.render_markdown().splitlines())
    for row in rows[2:]:
        name = row.split("`")[1]
        assert (row in jrows) == (name not in PORT_DEFAULTS
                                  and name not in PORT_DOCS), row


@pytest.mark.parametrize("name, default, fn", [
    ("TPULSAR_ACCEL_SYNC_WINDOW", 32, "_sync_window"),
    ("TPULSAR_ACCEL_BREAKER_THRESHOLD", 8, "_breaker_threshold"),
    ("TPULSAR_ACCEL_BATCH_BREAKER", 4, "_batch_breaker_threshold")])
def test_accel_integer_knobs_keep_their_rules(monkeypatch, name, default,
                                              fn):
    """The default when unset, empty or not an integer; max(1, value)
    otherwise."""
    from tpulsar_torch.kernels import accel

    read = getattr(accel, fn)
    monkeypatch.delenv(name, raising=False)
    assert read() == default
    for raw, want in (("", default), ("x", default), ("2.5", default),
                      ("0", 1), ("-3", 1), ("7", 7)):
        monkeypatch.setenv(name, raw)
        assert read() == want, raw
