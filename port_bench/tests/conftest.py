"""Settings of the benchmark's own tests (run with
`python -m pytest port_bench/tests`): the `cuda` marker for the tests
that need the card, a small torch thread pool, and one build
directory for the program's native library per session."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(scope="session", autouse=True)
def small_host(tmp_path_factory):
    import torch

    torch.set_num_threads(2)
    old = os.environ.get("TPULSAR_CACHE_DIR")
    os.environ["TPULSAR_CACHE_DIR"] = str(tmp_path_factory.mktemp("build"))
    yield
    if old is None:
        os.environ.pop("TPULSAR_CACHE_DIR", None)
    else:
        os.environ["TPULSAR_CACHE_DIR"] = old


def tiny(config_name: str) -> dict:
    """A configuration of the benchmark cut to a CPU test's size: 32
    channels, 32768 samples, three passes, the hi stage at zmax 4."""
    with open(os.path.join(ROOT, "port_bench", "configs",
                           config_name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["beam"].update(nchan=32, nsamp=32768, tsamp_s=6.5476e-05 * 8)
    cfg["plan"] = [[0.0, 2.0, 8, 2, 8, 1], [32.0, 4.0, 8, 1, 8, 2]]
    cfg["search"]["params"].update(nsub=8, hi_accel_zmax=4)
    cfg["check"].update(passes=3, hi_rows=2)
    return cfg


def tiny_traffic() -> dict:
    """The benchmark's traffic with its pulsar inside the tiny plan and
    bright enough to give candidates in a 17 s beam."""
    with open(os.path.join(ROOT, "port_bench", "traffic",
                           "plan.json")) as fh:
        tr = json.load(fh)
    tr["pulsar"].update(dm=[10.0, 30.0], sp_snr=[3.0, 4.0],
                        period_s=[0.2, 0.5], z=[-3.0, 3.0])
    tr["trace_passes"] = 2
    return tr
