"""The port's telemetry artifacts against the JAX package's: one
traced search_beam on the same synthesized beam in both packages
(TPULSAR_TRACE=1), then metrics.json (names, labels, pass and trial
counts) and the trace file (span names; the JAX package's own
summarize_file reproduces the port's .report stage totals within its
5% contract).

Both packages' metrics.json may hold the compile-cache families and
their traces backend_compile spans: the JAX package's runtime monitor
records its XLA compiles, the port a library lookup at first use
(tpulsar_torch/aot/warmstart.py), so whether a beam carries them
depends on what its process compiled before; the comparisons set
them aside.  The port times the file read as its own stage,
"read".

Both tracers hold process-wide state that other test files change:
tests/test_aot.py ends a test with the JAX tracer's stop(), which
pins it off whatever TPULSAR_TRACE says, so the fixture resets both
tracers to the environment's control before it searches."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from tpulsar.io import synth  # noqa: E402
from tpulsar.obs import trace as jtrace  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.obs import metrics as tmetrics  # noqa: E402
from tpulsar_torch.obs import trace as ttrace  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402
from tpulsar_torch.search.report import StageTimers  # noqa: E402

#: the compile-cache instruments of both packages' aot/ layers, and
#: the spans they emit
JAX_COMPILE_METRICS = {"tpulsar_compile_cache_hits_total",
                       "tpulsar_compile_cache_misses_total",
                       "tpulsar_backend_compile_seconds"}
JAX_COMPILE_SPANS = {"backend_compile", "aot_compile"}
#: the port's own families, of what the JAX package does not have: the
#: hi stage's CUDA stage kernel (recorded on the card only)
PORT_ONLY_METRICS = {"tpulsar_accel_kernel_rows_total"}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Both packages' traced search_beam on one beam (module-scoped:
    the searches are the expensive part)."""
    root = tmp_path_factory.mktemp("obs")
    spec = synth.BeamSpec(nchan=32, nsamp=1 << 13, nbits=4,
                          tsamp_s=5.24288e-4, seed=3)
    psr = synth.PulsarSpec(period_s=0.2, dm=20.0, snr_per_sample=1.0)
    fns = synth.synth_beam(str(root / "data"), spec, pulsars=[psr],
                           merged=True)
    plan = [jddplan.DedispStep(lodm=10.0, dmstep=2.0, dms_per_pass=8,
                               numpasses=2, numsub=16, downsamp=1),
            jddplan.DedispStep(42.0, 4.0, 8, 1, 16, 2)]
    jp = jex.SearchParams(nsub=16, hi_accel_zmax=8, topk_per_stage=8,
                          max_cands_to_fold=2, make_plots=False)
    saved = {k: os.environ.get(k)
             for k in ("TPULSAR_TRACE", "TPULSAR_DD_FAMILY")}
    os.environ.update(TPULSAR_TRACE="1", TPULSAR_DD_FAMILY="direct")
    jtrace.reset()
    ttrace.reset()
    try:
        jo = jex.search_beam(fns, str(root / "jw"), str(root / "jr"),
                             jp, plan=plan)
        to = tex.search_beam(
            fns, str(root / "tw"), str(root / "tr"),
            state.search_params_from_jax(jp.provenance()),
            plan=state.plan_from_jax([dataclasses.astuple(s)
                                      for s in plan]),
            device="cpu")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jtrace.reset()
        ttrace.reset()
    return jo, to


def _load(outcome, name):
    with open(os.path.join(outcome.resultsdir, name)) as fh:
        return json.load(fh)


def _catalog(telemetry) -> dict:
    """Every metric family of a package's instrument catalog
    (obs/telemetry.py) as its registry snapshot records it: each
    getter that needs no argument, called once."""
    import inspect

    for name, fn in vars(telemetry).items():
        if (inspect.isfunction(fn) and fn.__module__ == telemetry.__name__
                and not name.startswith("_")
                and all(p.default is not p.empty for p in
                        inspect.signature(fn).parameters.values())):
            fn()
    return telemetry.metrics.REGISTRY.snapshot()


def test_metrics_json_names_labels_and_counts(traced):
    jo, to = traced
    jm, tm = _load(jo, "metrics.json"), _load(to, "metrics.json")
    # every family the port records, gauges included, is a family of
    # the JAX package's catalog with the same type, help, label names
    # and buckets (a gauge is a point-in-time reading, kept whole in
    # the delta, so either file may also carry gauges that other
    # tests in this process set); the port's own families are not,
    # and a CPU beam records none of them
    from tpulsar.obs import telemetry as jtelemetry
    from tpulsar_torch.obs import telemetry as ttelemetry

    catalog = _catalog(jtelemetry)
    port = _catalog(ttelemetry)
    assert set(tm) <= set(port)
    assert PORT_ONLY_METRICS <= set(port)
    for name, rec in port.items():
        if name in PORT_ONLY_METRICS:
            assert name not in catalog and name not in tm, name
            continue
        assert name in catalog, name
        for key in ("type", "help", "labelnames"):
            assert rec[key] == catalog[name][key], (name, key)
        if rec["type"] == "histogram":
            assert rec["buckets"] == catalog[name]["buckets"], name
    # the counters and histograms of this beam are the JAX beam's
    assert {n for n, r in tm.items() if r["type"] != "gauge"} \
        - JAX_COMPILE_METRICS == \
        {n for n, r in jm.items() if r["type"] != "gauge"} \
        - JAX_COMPILE_METRICS
    # a library the beam's process built or loaded at first use is
    # accounted in-line, never under a gated program's name
    for name in JAX_COMPILE_METRICS & set(tm):
        assert set(tm[name]["series"]) <= {"(inline)"}, name
    for name in ("tpulsar_passes_total", "tpulsar_dm_trials_total",
                 "tpulsar_dedisp_trials_total",
                 "tpulsar_accel_batch_trials_total",
                 "tpulsar_checkpoint_events_total"):
        assert tm.get(name, {}).get("series") == \
            jm.get(name, {}).get("series"), name
    assert tm["tpulsar_passes_total"]["series"] == {"": 3.0}
    assert tm["tpulsar_dm_trials_total"]["series"] == {"": 24.0}
    assert tm["tpulsar_dedisp_trials_total"]["series"] == {"direct": 24.0}
    stages = tm["tpulsar_stage_seconds"]["series"]
    assert set(stages) == set(jm["tpulsar_stage_seconds"]["series"]) \
        | {"read"}
    # one observation per timed scope
    assert stages["subbanding"]["count"] == 3
    assert stages["sifting"]["count"] == 1


def test_trace_files_have_the_same_spans(traced):
    jo, to = traced
    jt = _load(jo, f"{jo.basenm}_trace.json")["traceEvents"]
    tt = _load(to, f"{to.basenm}_trace.json")["traceEvents"]
    jnames = {e["name"] for e in jt if e["ph"] == "X"}
    tnames = {e["name"] for e in tt if e["ph"] == "X"}
    assert tnames - JAX_COMPILE_SPANS == \
        (jnames - JAX_COMPILE_SPANS) | {"read"}
    assert {"search_block", "dm_chunk", "hi-accelsearch",
            "refinement", "folding"} <= tnames
    # the chunk spans nest under the root span, and the stage scopes
    # under the chunk spans
    chunks = [e for e in tt if e["name"] == "dm_chunk"]
    assert [(c["args"]["pass_idx"], c["args"]["n"]) for c in chunks] == \
        [(0, 8), (1, 8), (2, 8)]
    assert {c["args"]["parent"] for c in chunks} == {"search_block"}
    assert {"dedispersing", "single-pulse", "FFT", "lo-accelsearch"} <= \
        {e["name"] for e in tt if e["args"].get("parent") == "dm_chunk"}


def test_jax_summarize_reproduces_the_port_report(traced):
    """The JAX package's trace.summarize_file over the port's trace
    file gives the port's stage totals within the JAX package's
    contract (5%, or 0.05 s)."""
    _jo, to = traced
    summary = jtrace.summarize_file(
        os.path.join(to.resultsdir, f"{to.basenm}_trace.json"))
    for stage, secs in to.timers.times.items():
        got = summary["rollup"].get(stage, {}).get("seconds", 0.0)
        assert got == pytest.approx(secs, rel=0.05, abs=0.05), stage
    assert summary["root_seconds"] > 0
    report = open(os.path.join(to.resultsdir,
                               f"{to.basenm}.report")).read()
    assert "hi-accelsearch" in report and "read" in report


def test_ladder_families_match_the_jax_catalog():
    """The hi stage's ladder families (the rescue outcome counter and
    the breaker-skipped overlay, beside the path-labelled trials and
    seconds) are in the port's catalog with the JAX catalog's type,
    help, labels and buckets."""
    from tpulsar.obs import telemetry as jtelemetry
    from tpulsar_torch.obs import telemetry as ttelemetry

    catalog = _catalog(jtelemetry)
    port = _catalog(ttelemetry)
    for name in ("tpulsar_rescue_rows_total",
                 "tpulsar_accel_undispatched_rows_total",
                 "tpulsar_accel_batch_trials_total",
                 "tpulsar_accel_stage_seconds",
                 "tpulsar_circuit_transitions_total",
                 "tpulsar_retry_attempts_total"):
        assert name in port, name
        for key in ("type", "help", "labelnames", "buckets"):
            assert port[name].get(key) == catalog[name].get(key), (name,
                                                                   key)


@pytest.mark.parametrize("name", [
    "tpulsar_gateway_requests_total",
    "tpulsar_gateway_request_seconds",
    "tpulsar_gateway_submissions_total",
    "tpulsar_frontdoor_host_capacity",
    "tpulsar_frontdoor_routed_total",
    "tpulsar_dataplane_bytes_total",
    "tpulsar_dataplane_blobs_total",
    "tpulsar_dataplane_verify_failures_total",
    "tpulsar_dataplane_transfer_seconds",
    "tpulsar_pool_rotate_seconds",
    "tpulsar_download_bytes_total",
    "tpulsar_download_failures_total",
    "tpulsar_upload_seconds",
    "tpulsar_uploads_total",
])
def test_front_door_and_data_plane_families_match_the_jax_catalog(name):
    """The gateway's, the federation router's, the blob data plane's
    and the orchestration daemons' families are in the port's catalog
    with the JAX catalog's type, help, labels and buckets."""
    from tpulsar.obs import telemetry as jtelemetry
    from tpulsar_torch.obs import telemetry as ttelemetry

    catalog = _catalog(jtelemetry)
    port = _catalog(ttelemetry)
    assert name in port, name
    for key in ("type", "help", "labelnames", "buckets"):
        assert port[name].get(key) == catalog[name].get(key), key


@pytest.mark.parametrize("name", [
    "tpulsar_chaos_actions_total",
    "tpulsar_chaos_violations_total",
])
def test_chaos_families_match_the_jax_catalog(name):
    """The chaos harness's families (the conductor's timeline actions,
    the verifier's violations) are in the port's catalog with the JAX
    catalog's type, help and labels."""
    from tpulsar.obs import telemetry as jtelemetry
    from tpulsar_torch.obs import telemetry as ttelemetry

    catalog = _catalog(jtelemetry)
    port = _catalog(ttelemetry)
    assert name in port, name
    for key in ("type", "help", "labelnames", "buckets"):
        assert port[name].get(key) == catalog[name].get(key), key


def test_stage_timer_is_one_span_and_one_observation():
    ttrace.start(clear=True)
    try:
        before = tmetrics.REGISTRY.snapshot()
        timers = StageTimers()
        for _ in range(2):
            with timers.timing("sifting"):
                pass
        spans = [e for e in ttrace.events() if e["name"] == "sifting"]
        delta = tmetrics.diff_snapshots(tmetrics.REGISTRY.snapshot(),
                                        before)
    finally:
        ttrace.reset()
    assert len(spans) == 2
    assert delta["tpulsar_stage_seconds"]["series"]["sifting"][
        "count"] == 2


def test_outstream_writes_what_the_jax_package_writes(tmp_path):
    """obs/log.py's OutStream (the reference's .outs(msg) call shape):
    both packages' streams write the same levels and messages to their
    log files, under their own logger names."""
    import logging

    from tpulsar.obs import log as jlog
    from tpulsar_torch.obs import log as tlog

    lines = {}
    for name, pkg in (("jax", jlog), ("torch", tlog)):
        path = tmp_path / f"{name}.log"
        out = pkg.OutStream("outstream_parity", str(path), screen=False)
        out.outs("first")
        out.outs("second", level=logging.WARNING)
        out.outs("hidden", level=logging.DEBUG)
        for h in list(out.logger.handlers):
            out.logger.removeHandler(h)
            h.close()
        lines[name] = [ln.split(" ", 2)[2] for ln in
                       path.read_text().splitlines()]
    assert lines["torch"] == [
        "tpulsar_torch.outstream_parity INFO: first",
        "tpulsar_torch.outstream_parity WARNING: second"]
    assert [ln.replace("tpulsar.", "tpulsar_torch.", 1)
            for ln in lines["jax"]] == lines["torch"]
