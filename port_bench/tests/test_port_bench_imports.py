"""No module of the benchmark loads JAX or the JAX package, compared
by whole top-level names, and the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

import pytest

from port_bench import harness

BENCH = os.path.join(harness.ROOT, "port_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpulsar"}
#: modules of the yardstick that take nothing from the program
PLAIN = ("reference.py", "compare.py", "plan.py", "bounds.py", "beam.py")


def sources():
    for dirpath, _dirs, files in os.walk(BENCH):
        if os.sep + "tests" in dirpath + os.sep and \
                dirpath.startswith(os.path.join(BENCH, "tests")):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_reference_takes_nothing_of_the_program(name):
    mods = set(top_level_imports(os.path.join(BENCH, name)))
    assert "tpulsar_torch" not in mods
    assert mods <= {"__future__", "collections", "dataclasses", "math",
                    "numpy", "torch", "scipy", "port_bench"}


def test_names_are_compared_whole():
    assert "tpulsar_torch".split(".")[0] not in FORBIDDEN
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "tpulsar")


def test_a_run_loads_neither():
    code = ("import sys; sys.path.insert(0, %r); "
            "from port_bench import harness, control; "
            "import tpulsar_torch.search.executor, "
            "tpulsar_torch.kernels.cuda_dd; "
            "print(harness.loaded_forbidden())" % harness.ROOT)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
