"""The hi stage's degradation ladder, its knobs and its native CPU
consumer in tpulsar_torch.kernels.accel, against the JAX package's
tpulsar.kernels.accel: the same seeded spectra and the same
TPULSAR_FAULTS spec through both packages.

Each ladder test is the counterpart of one of the JAX package's
(tests/test_accel.py, tests/test_accel_batch.py, tests/test_telemetry.py)
and asserts, between the packages: the same fault firings, the same
degraded and provenance ledgers (their flags and their running
counts), the same deltas of the path-labelled and rescue
counters, and the same top-k.  Tolerances: within the port, exact (with
one torch thread, at these sizes, the per-DM row program, the batched
program and the native consumer give the same bits; with several
threads the CPU's FFT of 8192 points and more rounds a batch and a
single transform differently); between the packages, powers at rtol
2e-4, r bins and z exactly at a rank whose power stands clear of its
neighbours and as a set within a tie (torch's and XLA's FFTs round
differently; tests/test_torch_accel.py's assert_topk_match)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_accel import assert_topk_match  # noqa: E402
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from torch_build_dir import own_build_dir  # noqa: E402, F401 (autouse)
from tpulsar import native as jnative  # noqa: E402
from tpulsar.kernels import accel as ja  # noqa: E402
from tpulsar.kernels import fourier as jfr  # noqa: E402
from tpulsar.obs import telemetry as jtm  # noqa: E402
from tpulsar.resilience import faults as jfaults  # noqa: E402
from tpulsar.resilience import policy as jpolicy  # noqa: E402
from tpulsar.search import degraded as jdeg  # noqa: E402
from tpulsar_torch import native as tnative  # noqa: E402
from tpulsar_torch.kernels import accel as ta  # noqa: E402
from tpulsar_torch.kernels import accel_batch as tab  # noqa: E402
from tpulsar_torch.kernels import fourier as tfr  # noqa: E402
from tpulsar_torch.obs import telemetry as ttm  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402
from tpulsar_torch.resilience import policy as tpolicy  # noqa: E402
from tpulsar_torch.search import degraded as tdeg  # noqa: E402

POWER_RTOL = 2e-4
PATHS = ("batched", "per_dm", "rescued")
UNIMPL = "UNIMPLEMENTED: TPU backend error (Unimplemented)."

PKG = {
    "jax": dict(ak=ja, faults=jfaults, deg=jdeg, tm=jtm, policy=jpolicy,
                arr=jnp.asarray),
    "torch": dict(ak=ta, faults=tfaults, deg=tdeg, tm=ttm,
                  policy=tpolicy, arr=torch.from_numpy),
}


@pytest.fixture(autouse=True)
def clean_accel_state(monkeypatch):
    """The batch verdict, the batch breaker, the fault registry, the
    degraded ledgers and the tracer are process state in both
    packages: reset around every test (a tracer left started would make
    a later search in this process write a trace file)."""
    monkeypatch.delenv("TPULSAR_ACCEL_BATCH", raising=False)
    for p in PKG.values():
        p["ak"]._reset_batch_state()
        p["faults"].reset()
        p["deg"].reset()
    yield
    for p in PKG.values():
        p["faults"].reset()
        p["ak"]._reset_batch_state()
        p["deg"].reset()
        p["tm"].trace.reset()


def _specs(ndms, nbins=4096, seed=5):
    """tests/test_accel_batch.py's spectra: seeded noise with a strong
    bin."""
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(ndms, nbins))
         + 1j * rng.normal(size=(ndms, nbins))).astype(np.complex64)
    s[:, nbins // 4] += 20.0
    return s


def _noise(ndms, nbins, seed):
    """tests/test_accel.py's spectra: seeded noise."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(ndms, nbins))
            + 1j * rng.normal(size=(ndms, nbins))).astype(np.complex64)


BANKS = {}


def _bank(which, zmax=8.0, seg=1 << 11):
    key = (which, zmax, seg)
    if key not in BANKS:
        BANKS[key] = PKG[which]["ak"].build_template_bank(zmax, seg=seg)
    return BANKS[key]


def _counters(tm) -> dict:
    out = {}
    for p in PATHS:
        out[f"trials.{p}"] = tm.accel_batch_trials_total().value(path=p)
        out[f"seconds.{p}"] = tm.accel_stage_seconds().series(
            path=p)["count"]
    for o in ("rescued", "lost"):
        out[f"rescue.{o}"] = tm.rescue_rows_total().value(outcome=o)
    out["undispatched"] = tm.accel_undispatched_rows_total().value()
    out["retries"] = tm.retry_attempts_total().value(
        point="accel.row_dispatch")
    return out


def _ledger_counts(p) -> dict:
    """The running (n, of, calls) of every counted flag of both ledgers
    (the port's degraded.counts(); the JAX package keeps the same
    tallies in its module state)."""
    deg = p["deg"]
    return {k: tuple(v) for d in (deg._COUNTS, deg._PROV_COUNTS)
            for k, v in d.items()}


def _run(which, specs, spec=None, raises=None, bank=None, **kw):
    """One accel_search_batch call of package `which` under the fault
    spec; returns (result or exception, record of the call)."""
    p = PKG[which]
    p["deg"].reset()
    if spec:
        p["faults"].configure(spec)
    before = _counters(p["tm"])
    try:
        if raises is None:
            out = p["ak"].accel_search_batch(
                p["arr"](specs), bank or _bank(which), **kw)
        else:
            with pytest.raises(raises) as ei:
                p["ak"].accel_search_batch(
                    p["arr"](specs), bank or _bank(which), **kw)
            out = ei.value
    finally:
        fired = {pt: p["faults"].fired(pt)
                 for pt in ("accel.chunk", "accel.row_dispatch")}
        p["faults"].reset()
    after = _counters(p["tm"])
    rec = dict(snapshot=p["deg"].snapshot(), counts=_ledger_counts(p),
               prov=p["deg"].provenance_snapshot(), fired=fired,
               counters={k: after[k] - before[k] for k in after})
    return out, rec


def _both(specs, spec=None, **kw):
    """The same call in both packages; asserts their records equal and
    returns (jax result, port result, the record)."""
    jout, jrec = _run("jax", specs, spec, **kw)
    tout, trec = _run("torch", specs, spec, **kw)
    assert trec == jrec
    return jout, tout, trec


def _assert_equal(a, b):
    """Within one package: exact."""
    assert set(a) == set(b)
    for h in a:
        for x, y in zip(a[h], b[h]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _assert_close(tout, jout):
    """Between the packages: assert_topk_match at POWER_RTOL."""
    assert set(tout) == set(jout)
    for h in jout:
        assert_topk_match(tout[h], jout[h], rtol=POWER_RTOL)


def _no_native(monkeypatch):
    monkeypatch.setattr(ja, "_native_cpu_path_usable", lambda: False)
    _torch_consumer(monkeypatch)


def _torch_consumer(monkeypatch):
    """The port's batched CPU path through the torch consumer, where the
    native consumer would otherwise take it."""
    monkeypatch.setattr(ta, "_native_cpu_path_usable", lambda dev: False)


# ------------------------------------------------- refusal classes

def test_refusal_classes_are_exactly_the_four():
    """Only CUDA's out-of-memory error, an injected refusal, a deadline
    and a poisoned session enter the ladder.  The injected refusal is
    still a RuntimeError, so every earlier isinstance check holds."""
    assert set(ta.REFUSED) == {torch.cuda.OutOfMemoryError,
                               tfaults.DispatchRefused,
                               tpolicy.DeadlineExceeded,
                               tfaults.SessionPoisoned}
    tfaults.configure("accel.chunk:unimplemented")
    with pytest.raises(tfaults.DispatchRefused, match="UNIMPLEMENTED"):
        tfaults.fire("accel.chunk")
    assert issubclass(tfaults.DispatchRefused, RuntimeError)
    # a plain RuntimeError (what CUDA's sticky errors are) is no refusal
    assert not isinstance(RuntimeError("CUDA error: an illegal memory "
                                       "access was encountered"),
                          ta.REFUSED)
    accel_err = getattr(torch, "AcceleratorError", None)
    if accel_err is not None:
        assert not issubclass(accel_err, ta.REFUSED)


@pytest.mark.parametrize("where", ["batch", "row", "drain"])
def test_non_refusal_runtime_error_propagates_untouched(where,
                                                        monkeypatch):
    """A RuntimeError that is not a refusal (a CUDA error that poisons
    the context) leaves accel_search_batch as it was raised, from a
    batch, from a row and from a drain: no retry, no rescue, nothing
    recorded."""
    boom = RuntimeError("CUDA error: an illegal memory access was "
                        "encountered")
    calls = []

    def explode(*a, **k):
        calls.append(1)
        raise boom

    _torch_consumer(monkeypatch)
    if where == "batch":
        monkeypatch.setattr(ta, "accel_chunk_topk", explode)
    elif where == "row":
        monkeypatch.setenv("TPULSAR_ACCEL_BATCH", "0")
        monkeypatch.setattr(ta, "accel_row_topk", explode)
    else:
        monkeypatch.setattr(ta, "_device_get", explode)
    before = _counters(ttm)
    with pytest.raises(RuntimeError) as ei:
        ta.accel_search_batch(torch.from_numpy(_specs(4, seed=2)),
                              _bank("torch"), max_numharm=2, topk=8,
                              dm_chunk=2)
    assert ei.value is boom
    assert len(calls) == 1                      # never retried
    assert _counters(ttm) == before
    # nothing but the pin's own note (the row case sets the pin)
    assert set(tdeg.snapshot()) <= {"accel_batch_pinned"}
    assert tdeg.provenance_snapshot() == {} and tdeg.counts() == {}
    assert _ledger_counts(PKG["torch"]) == {}


# ----------------------------------------- tests/test_accel.py ladder

def test_forced_fallback_matches_batch(monkeypatch):
    """tests/test_accel.py:105: the batch verdict pinned True and False
    gives the same candidates, in both packages."""
    specs = _noise(2, 5000, 11)
    res = {}
    for ok in (True, False):
        monkeypatch.setattr(ja, "_BATCH_OK", ok)
        monkeypatch.setattr(ta, "_BATCH_OK", ok)
        res[ok] = _both(specs, max_numharm=2, topk=8)
    _assert_equal(res[True][1], res[False][1])
    for ok in (True, False):
        _assert_close(res[ok][1], res[ok][0])


def test_per_dm_fallback_zero_fills_refused_rows(monkeypatch):
    """tests/test_accel.py:291: a row refused on dispatch, on its retry
    and in the host rescue is zero-filled, recorded 1/3 in the loss
    ledger; the other rows equal the clean run's."""
    specs = _noise(3, 5000, 23)
    monkeypatch.setattr(ja, "_BATCH_OK", False)
    monkeypatch.setattr(ta, "_BATCH_OK", False)
    _no_native(monkeypatch)
    jclean, tclean, _ = _both(specs, max_numharm=2, topk=8)

    real = {"jax": ja.accel_row_topk, "torch": ta.accel_row_topk}

    def flaky(which, exc):
        def row(full, bf, i, **kw):
            if int(i) == 1:
                raise exc(UNIMPL)
            return real[which](full, bf, i, **kw)
        return row

    monkeypatch.setattr(ja, "accel_row_topk",
                        flaky("jax", jax.errors.JaxRuntimeError))
    monkeypatch.setattr(ta, "accel_row_topk",
                        flaky("torch", tfaults.DispatchRefused))
    jout, tout, rec = _both(specs, max_numharm=2, topk=8)
    assert rec["snapshot"]["accel_rows_zero_filled"].startswith(
        "1/3 across 1")
    assert rec["counters"]["rescue.lost"] == 1
    assert rec["counters"]["trials.per_dm"] == 2
    for h in tclean:
        for r in (0, 2):
            for k in range(3):
                np.testing.assert_array_equal(tout[h][k][r],
                                              tclean[h][k][r])
        assert np.all(tout[h][0][1] == 0.0)
    _assert_close(tout, jout)


def test_per_dm_fallback_recovers_deferred_drain_error(monkeypatch):
    """tests/test_accel.py:335: a refusal at the window's fetch is not
    a window of lost rows: each pending row is fetched alone and
    nothing is degraded."""
    specs = _noise(3, 5000, 29)
    monkeypatch.setattr(ja, "_BATCH_OK", False)
    monkeypatch.setattr(ta, "_BATCH_OK", False)
    _no_native(monkeypatch)
    jclean, tclean, _ = _both(specs, max_numharm=2, topk=8)

    state = {"jax": False, "torch": False}
    real_jget, real_tget = jax.device_get, ta._device_get

    def flaky(which, real, exc):
        def get(x):
            if not state[which] and isinstance(x, list) and len(x) > 1:
                state[which] = True
                raise exc(UNIMPL)
            return real(x)
        return get

    monkeypatch.setattr(jax, "device_get",
                        flaky("jax", real_jget, jax.errors.JaxRuntimeError))
    monkeypatch.setattr(ta, "_device_get",
                        flaky("torch", real_tget, tfaults.DispatchRefused))
    jout, tout, rec = _both(specs, max_numharm=2, topk=8)
    monkeypatch.setattr(jax, "device_get", real_jget)
    assert state == {"jax": True, "torch": True}
    assert "accel_rows_zero_filled" not in rec["snapshot"]
    assert rec["counters"]["trials.per_dm"] == 3
    _assert_equal(tout, tclean)
    _assert_close(tout, jout)


def test_per_dm_fallback_total_refusal_raises(monkeypatch):
    """tests/test_accel.py:377: every row refused twice and unrescuable
    raises AccelStageRefused (rescue_exhausted: the recompute ran),
    never an all-zero result."""
    specs = _noise(2, 4000, 31)
    monkeypatch.setattr(ja, "_BATCH_OK", False)
    monkeypatch.setattr(ta, "_BATCH_OK", False)
    _no_native(monkeypatch)

    def refuse(exc):
        def row(full, bf, i, **kw):
            raise exc(UNIMPL)
        return row

    monkeypatch.setattr(ja, "accel_row_topk",
                        refuse(jax.errors.JaxRuntimeError))
    monkeypatch.setattr(ta, "accel_row_topk",
                        refuse(tfaults.DispatchRefused))
    jexc, jrec = _run("jax", specs, raises=ja.AccelStageRefused,
                      max_numharm=2, topk=8)
    texc, trec = _run("torch", specs, raises=ta.AccelStageRefused,
                      max_numharm=2, topk=8)
    assert trec == jrec
    assert str(texc) == str(jexc)
    assert texc.rescue_exhausted is jexc.rescue_exhausted is True
    # the executor's chunk rescue owns the outcome counts of a raise
    assert trec["counters"]["rescue.rescued"] == 0
    assert trec["counters"]["rescue.lost"] == 0


# ------------------------------------- tests/test_accel_batch.py ladder

def _trials(rec):
    return {p: rec["counters"][f"trials.{p}"] for p in PATHS}


def test_refused_batch_degrades_per_batch_only():
    """tests/test_accel_batch.py:179: the second batch refused on
    dispatch and on its retry: only its rows ride the per-DM path,
    results equal the clean run's, the verdict survives."""
    specs = _specs(6, seed=21)
    jclean, tclean, _ = _both(specs, max_numharm=2, topk=8, dm_chunk=2)
    jout, tout, rec = _both(specs, "accel.chunk:unimplemented:after=1,"
                            "count=2", max_numharm=2, topk=8, dm_chunk=2)
    _assert_equal(tout, tclean)
    _assert_close(tout, jout)
    assert rec["fired"]["accel.chunk"] == 2
    assert rec["snapshot"]["accel_batches_refused"].startswith("1/3")
    assert "accel_rows_zero_filled" not in rec["snapshot"]
    assert "accel_batch_downgraded" not in rec["snapshot"]
    assert _trials(rec) == {"batched": 4, "per_dm": 2, "rescued": 0}
    assert ta._BATCH_OK is not False and ja._BATCH_OK is not False


def test_refused_clamped_tail_keeps_resolved_rows():
    """tests/test_accel_batch.py:228: starts (0, 2, 3); the refused tail
    @3 degrades only its unresolved row 4 — row 3 was delivered by the
    batch @2."""
    specs = _specs(5, seed=29)
    assert tab.plan_batches_explicit(5, 2).starts == (0, 2, 3)
    jclean, tclean, _ = _both(specs, max_numharm=2, topk=8, dm_chunk=2)
    jout, tout, rec = _both(specs, "accel.chunk:unimplemented:after=2,"
                            "count=2", max_numharm=2, topk=8, dm_chunk=2)
    _assert_equal(tout, tclean)
    _assert_close(tout, jout)
    assert _trials(rec) == {"batched": 4, "per_dm": 1, "rescued": 0}
    assert rec["snapshot"]["accel_batches_refused"].startswith("1/3")
    assert "accel_rows_zero_filled" not in rec["snapshot"]


def test_batch_breaker_pins_per_dm_path(monkeypatch):
    """tests/test_accel_batch.py:278: TPULSAR_ACCEL_BATCH_BREAKER
    consecutive refused batches pin the per-DM path for the process;
    every row still resolves per-DM."""
    monkeypatch.setenv("TPULSAR_ACCEL_BATCH_BREAKER", "2")
    specs = _specs(6, seed=23)
    jclean, tclean, _ = _both(specs, max_numharm=2, topk=8, dm_chunk=2)
    jout, tout, rec = _both(specs, "accel.chunk:unimplemented:rate=1.0",
                            max_numharm=2, topk=8, dm_chunk=2)
    _assert_equal(tout, tclean)
    _assert_close(tout, jout)
    assert rec["fired"]["accel.chunk"] == 4      # 2 batches x 2 tries
    assert "accel_batch_downgraded" in rec["snapshot"]
    assert "accel_rows_zero_filled" not in rec["snapshot"]
    assert _trials(rec) == {"batched": 0, "per_dm": 6, "rescued": 0}
    assert ta._BATCH_OK is False and ja._BATCH_OK is False


def test_batch_breaker_accumulates_across_calls(monkeypatch):
    """tests/test_accel_batch.py:312: the breaker's count survives
    across calls (one batch per call), so the second call pins."""
    monkeypatch.setenv("TPULSAR_ACCEL_BATCH_BREAKER", "2")
    for seed, pinned in ((33, False), (34, True)):
        _both(_specs(2, seed=seed), "accel.chunk:unimplemented:rate=1.0",
              max_numharm=2, topk=8, dm_chunk=2)
        assert (ta._BATCH_OK is False) is pinned
        assert (ja._BATCH_OK is False) is pinned
    assert "accel_batch_downgraded" in tdeg.snapshot()


def test_refused_batch_then_refused_rows_rescue():
    """tests/test_accel_batch.py:361: both rungs refused — every batch
    and every row dispatch — so the host rescue recomputes all rows;
    trials and one seconds observation under 'rescued', none under
    'per_dm'."""
    ndms = 4
    specs = _specs(ndms, seed=27)
    jclean, tclean, _ = _both(specs, max_numharm=2, topk=8, dm_chunk=2)
    jout, tout, rec = _both(
        specs, "accel.chunk:unimplemented:rate=1.0;"
        "accel.row_dispatch:unimplemented:rate=1.0",
        max_numharm=2, topk=8, dm_chunk=2)
    assert rec["fired"]["accel.chunk"] > 0
    _assert_equal(tout, tclean)
    _assert_close(tout, jout)
    assert rec["counters"]["rescue.rescued"] == ndms
    assert _trials(rec) == {"batched": 0, "per_dm": 0, "rescued": ndms}
    assert rec["counters"]["seconds.rescued"] == 1
    assert rec["counters"]["seconds.per_dm"] == 0
    assert "accel_rows_zero_filled" not in rec["snapshot"]
    assert rec["prov"]["accel_rows_rescued"].startswith(f"{ndms}/{ndms}")


# ------------------------------------ tests/test_telemetry.py ladder

def test_circuit_breaker_transitions_recorded():
    """tests/test_telemetry.py:367, on both packages' policy engines:
    the same transitions counted and traced."""
    deltas = {}
    for which in ("jax", "torch"):
        p = PKG[which]
        tr = p["tm"].trace
        tr.start()
        clock = [0.0]
        c = p["tm"].circuit_transitions_total()
        before = {s: c.value(point="test.breaker", state=s)
                  for s in ("open", "reopen", "closed")}
        br = p["policy"].CircuitBreaker(
            failure_threshold=2, cooloff_s=10.0, clock=lambda: clock[0],
            name="test.breaker")
        br.record_failure()
        br.record_failure()            # -> open
        assert not br.allow()
        clock[0] = 11.0                # cooloff elapsed -> half-open
        assert br.allow()
        br.record_failure()            # half-open trial failed -> reopen
        clock[0] = 22.0
        br.record_success()            # trial succeeded -> closed
        deltas[which] = {s: c.value(point="test.breaker", state=s)
                         - before[s] for s in before}
        names = [e["name"] for e in tr.events()]
        assert "circuit_open" in names and "circuit_closed" in names
    assert deltas["torch"] == deltas["jax"] == {"open": 1, "reopen": 1,
                                                "closed": 1}


def test_faulted_accel_run_shows_rescue_metrics_and_trace(monkeypatch):
    """tests/test_telemetry.py:392: every row dispatch refused on the
    pinned per-DM path with the row breaker at 3: all 6 rows rescued,
    none lost, the breaker-skipped rows in the undispatched overlay,
    retries counted, and circuit_open and accel_rows_refused on both
    traces."""
    monkeypatch.setenv("TPULSAR_ACCEL_BATCH", "0")
    monkeypatch.setenv("TPULSAR_ACCEL_BREAKER_THRESHOLD", "3")
    rng = np.random.default_rng(0)
    spec = (rng.standard_normal((6, 4096))
            + 1j * rng.standard_normal((6, 4096))).astype(np.complex64)
    names = {}
    recs = {}
    for which in ("jax", "torch"):
        tr = PKG[which]["tm"].trace
        tr.start()
        _out, recs[which] = _run(
            which, spec, "accel.row_dispatch:unimplemented:rate=1.0",
            bank=_bank(which, 8.0, 1 << 10), max_numharm=4, topk=8)
        names[which] = [e["name"] for e in tr.events()]
    assert recs["torch"] == recs["jax"]
    c = recs["torch"]["counters"]
    assert c["rescue.rescued"] == 6 and c["rescue.lost"] == 0
    assert c["undispatched"] == 3 and c["retries"] > 0
    for which in names:
        assert "circuit_open" in names[which]
        assert "accel_rows_refused" in names[which]


# ----------------------------------------------------------- the knobs

@pytest.mark.parametrize("value", ["0", "65", "four", "2.5", "-3"])
def test_z_chunk_knob_rejects_bad_values(value, monkeypatch):
    """TPULSAR_ACCEL_Z_CHUNK outside the integers 1..64 raises in both
    packages (the JAX package resolves it once per process)."""
    monkeypatch.setenv("TPULSAR_ACCEL_Z_CHUNK", value)
    monkeypatch.setattr(ja, "_Z_CHUNK_RESOLVED", None)
    with pytest.raises(ValueError, match="TPULSAR_ACCEL_Z_CHUNK"):
        ja.z_chunk()
    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="TPULSAR_ACCEL_Z_CHUNK"):
            ta.z_chunk(dev)


def test_z_chunk_knob_pins_both_devices_and_keeps_results(monkeypatch):
    """A valid TPULSAR_ACCEL_Z_CHUNK pins the z chunk on either device,
    moves plane_dm_chunk as in the JAX package, and changes no result
    (the torch consumer, where the z chunk is used)."""
    _torch_consumer(monkeypatch)
    specs = torch.from_numpy(_specs(3, seed=3))
    base = ta.accel_search_batch(specs, _bank("torch"), max_numharm=4,
                                 topk=8)
    monkeypatch.setenv("TPULSAR_ACCEL_Z_CHUNK", "3")
    monkeypatch.setattr(ja, "_Z_CHUNK_RESOLVED", None)
    assert ta.z_chunk("cpu") == ta.z_chunk("cuda") == ja.z_chunk() == 3
    for nbins in (1_966_081, 196_609):
        assert ta.plane_dm_chunk(nbins, 51) == ja.plane_dm_chunk(nbins, 51)
    pieces = ta._corr_piece_list(specs, torch.from_numpy(
        _bank("torch").bank_fft), 1 << 11, _bank("torch").step,
        _bank("torch").width, 9)
    assert [p.shape[2] for p in pieces] == [3, 3, 3]
    _assert_equal(ta.accel_search_batch(specs, _bank("torch"),
                                        max_numharm=4, topk=8), base)


@pytest.mark.parametrize("gib", ["0.5", "16", "0"])
def test_hbm_budget_knob_sizes_batches_as_jax(gib, monkeypatch):
    """TPULSAR_ACCEL_HBM_GB sets the plane budget: plane_dm_chunk and
    the batch plan equal the JAX package's under the same budget (the
    JAX package reads the variable at import, so its constant is set
    to the same bytes)."""
    monkeypatch.setenv("TPULSAR_ACCEL_HBM_GB", gib)
    monkeypatch.setattr(ja, "PLANE_HBM_BUDGET",
                        int(float(gib) * (1 << 30)))
    assert ta.plane_budget_bytes() == ja.PLANE_HBM_BUDGET
    for nbins in (1_966_081, 983_041, 5000):
        assert ta.plane_dm_chunk(nbins, 51) == ja.plane_dm_chunk(nbins, 51)


@pytest.mark.parametrize("value", ["lots", "", "4GB"])
def test_hbm_budget_knob_rejects_non_numbers(value, monkeypatch):
    """A TPULSAR_ACCEL_HBM_GB that is not a number raises, as float()
    of it raises at the JAX package's import."""
    monkeypatch.setenv("TPULSAR_ACCEL_HBM_GB", value)
    with pytest.raises(ValueError):
        float(value)
    with pytest.raises(ValueError, match="TPULSAR_ACCEL_HBM_GB"):
        ta.plane_dm_chunk(5000, 9)


@pytest.mark.parametrize("elems", ["4e7", "1", "junk"])
def test_plane_elems_cap_matches_jax(elems, monkeypatch):
    """TPULSAR_ACCEL_PLANE_ELEMS forces the plane element cap on any
    device (a bad value caps at 1e9), as in the JAX package; without
    it no cap applies here (the automatic one is a TPU runtime's)."""
    nbins, nz = 1_966_081, 51
    free = ta.plane_dm_chunk(98_305, nz)
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_ELEMS", elems)
    for nb in (nbins, 98_305):
        assert ta.plane_dm_chunk(nb, nz) == ja.plane_dm_chunk(nb, nz)
    if elems == "4e7":
        assert ta.plane_dm_chunk(98_305, nz) < free


@pytest.mark.parametrize("window, drains", [("1", 3), ("32", 1),
                                            ("bad", 1)])
def test_sync_window_knob_drains_like_jax(window, drains, monkeypatch):
    """TPULSAR_ACCEL_SYNC_WINDOW: batches enqueued per blocking drain
    (a bad value is 32): the same number of drains in both packages."""
    monkeypatch.setenv("TPULSAR_ACCEL_SYNC_WINDOW", window)
    _no_native(monkeypatch)
    seen = {"jax": 0, "torch": 0}
    real_jget, real_tget = jax.device_get, ta._device_get

    def count(which, real):
        def get(x):
            if isinstance(x, list):
                seen[which] += 1
            return real(x)
        return get

    monkeypatch.setattr(jax, "device_get", count("jax", real_jget))
    monkeypatch.setattr(ta, "_device_get", count("torch", real_tget))
    jout, tout, _ = _both(_specs(5, seed=8), max_numharm=2, topk=8,
                          dm_chunk=2)
    monkeypatch.setattr(jax, "device_get", real_jget)
    assert seen == {"jax": drains, "torch": drains}
    _assert_close(tout, jout)


def test_breaker_knobs_read_as_jax(monkeypatch):
    """The deadline and both breaker thresholds parse as in the JAX
    package, bad values included."""
    for env, val in (("TPULSAR_ACCEL_DISPATCH_DEADLINE_S", "0.25"),
                     ("TPULSAR_ACCEL_DISPATCH_DEADLINE_S", "soon"),
                     ("TPULSAR_ACCEL_BREAKER_THRESHOLD", "0"),
                     ("TPULSAR_ACCEL_BREAKER_THRESHOLD", "x"),
                     ("TPULSAR_ACCEL_BATCH_BREAKER", "7"),
                     ("TPULSAR_ACCEL_BATCH_BREAKER", "")):
        monkeypatch.setenv(env, val)
        assert ta._dispatch_deadline_s() == ja._dispatch_deadline_s()
        assert ta._breaker_threshold() == ja._breaker_threshold()
        assert ta._batch_breaker_threshold() == \
            ja._batch_breaker_threshold()


def test_batch_pin_and_cached_verdict_notes(monkeypatch):
    """TPULSAR_ACCEL_BATCH=0 pins the per-DM path with the JAX package's
    degraded note, and a cached False verdict re-notes itself after the
    ledger is reset."""
    monkeypatch.setenv("TPULSAR_ACCEL_BATCH", "0")
    jout, tout, rec = _both(_specs(3, seed=4), max_numharm=2, topk=8)
    assert rec["snapshot"] == {
        "accel_batch_pinned": "TPULSAR_ACCEL_BATCH=0 (per-DM accel path)"}
    assert _trials(rec) == {"batched": 0, "per_dm": 3, "rescued": 0}
    _assert_close(tout, jout)
    monkeypatch.delenv("TPULSAR_ACCEL_BATCH")
    _no_native(monkeypatch)
    _jout, _tout, rec = _both(_specs(3, seed=4), max_numharm=2, topk=8)
    assert rec["snapshot"]["accel_batch_pinned"] == \
        "cached verdict: per-DM accel path"


# -------------------------------------------------- the native consumer

@pytest.mark.parametrize("zmax, nbins, nd, mh, topk",
                         [(8.0, 6000, 3, 8, 16), (20.0, 1 << 13, 2, 16, 64),
                          (8.0, 700, 1, 4, 64)])
def test_native_consumer_matches_torch_and_jax_native(zmax, nbins, nd, mh,
                                                      topk):
    """tests/test_accel.py:195: the native consumer of the pieces split
    by z chunk is bit-identical to the port's torch _accel_block_topk
    on the same spectra, and to the JAX package's native library on the
    same plane."""
    specs = torch.from_numpy(_noise(nd, nbins, 11 + nd))
    bank = ta.build_template_bank(zmax, seg=1 << 11)
    nz = len(bank.zs)
    bf = torch.from_numpy(bank.bank_fft)
    args = (bank.seg, bank.step, bank.width, nz)
    want = ta._accel_block_topk(specs, bf, *args, mh, topk)
    stages = tfr.harmonic_stages(mh)
    plane = ta._correlate_block(specs, bf, *args).numpy()
    zp = [p.numpy() for p in ta._correlate_zpieces(specs, bf, *args)]
    got = tnative.accel_stage_topk_zsegs(zp, bank.width, 2 * nbins,
                                         stages, tfr.BLOCK_R, topk)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w.numpy())
    if jnative.load() is not None:
        jgot = jnative.accel_stage_topk(plane, stages, jfr.BLOCK_R, topk)
        for i in range(3):
            np.testing.assert_array_equal(got[i], jgot[i])


def test_native_search_batch_equals_torch_consumer_and_jax(monkeypatch):
    """tests/test_accel.py:239: accel_search_batch through the native
    consumer equals the torch consumer exactly,
    and the JAX package's native path to the cross-package tolerance;
    both count the call under path="batched"."""
    specs = _noise(5, 5000, 12)
    bank_kw = dict(max_numharm=8, topk=16, dm_chunk=2)
    jb, tb = _bank("jax", 10.0), _bank("torch", 10.0)
    jout, jrec = _run("jax", specs, bank=jb, **bank_kw)
    tout, trec = _run("torch", specs, bank=tb, **bank_kw)
    assert trec == jrec and _trials(trec)["batched"] == 5
    _torch_consumer(monkeypatch)
    plain, _ = _run("torch", specs, bank=tb, **bank_kw)
    _assert_equal(tout, plain)
    _assert_close(tout, jout)


def test_native_consumer_is_skipped_when_the_jax_package_skips_it(
        monkeypatch):
    """The native consumer runs where the JAX package's runs: on every
    batched CPU hi stage with an f32 plane, but not with a fault naming
    an accel point or a TPULSAR_ACCEL_BATCH pin, and never on a CUDA
    device or a bf16 plane.  The port reads no knob of its own for it
    (the JAX package's TPULSAR_ACCEL_NATIVE=0 does not turn it off)."""
    assert ta._native_cpu_path_usable("cpu")
    assert not ta._native_cpu_path_usable("cuda")
    monkeypatch.setenv("TPULSAR_ACCEL_PLANE_DTYPE", "bf16")
    assert not ta._native_cpu_path_usable("cpu")
    monkeypatch.delenv("TPULSAR_ACCEL_PLANE_DTYPE")
    monkeypatch.setenv("TPULSAR_ACCEL_NATIVE", "0")
    assert ta._native_cpu_path_usable("cpu")
    monkeypatch.delenv("TPULSAR_ACCEL_NATIVE")
    for env in ("TPULSAR_ACCEL_BATCH=1", "TPULSAR_ACCEL_BATCH=0"):
        k, v = env.split("=")
        monkeypatch.setenv(k, v)
        assert not ta._native_cpu_path_usable("cpu")
        monkeypatch.delenv(k)
    tfaults.configure("accel.chunk:unimplemented:count=0,after=99")
    assert not ta._native_cpu_path_usable("cpu")
    tfaults.reset()
    assert ta._native_cpu_path_usable("cpu")


def test_zpieces_native_consumer_bit_identical():
    """tests/test_accel_batch.py:114: the z-chunked consumer on the
    pieces of a zmax-20 bank equals _accel_block_topk bit for bit."""
    nbins = 6000
    specs = torch.from_numpy(_specs(3, nbins=nbins, seed=11))
    bank = _bank("torch", 20.0)
    nz = len(bank.zs)
    bf = torch.from_numpy(bank.bank_fft)
    want = ta._accel_block_topk(specs, bf, bank.seg, bank.step,
                                bank.width, nz, 8, 16)
    zp = ta._correlate_zpieces(specs, bf, bank.seg, bank.step,
                               bank.width, nz)
    got = tnative.accel_stage_topk_zsegs(
        [p.numpy() for p in zp], bank.width, 2 * nbins,
        tfr.harmonic_stages(8), tfr.BLOCK_R, 16)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w.numpy())


def test_zsegs_rejects_oversized_last_chunk():
    """tests/test_accel_batch.py:478: a last chunk taller than the
    chunk height (or of zero height) would index past the pointer
    table; the port refuses it with ValueError (the JAX package returns
    None), never calling the kernel."""
    stages = tfr.harmonic_stages(2)
    ok_a = np.zeros((1, 1, 4, 8), np.float32)
    for bad in (np.zeros((1, 1, 7, 8), np.float32),
                np.zeros((1, 1, 0, 8), np.float32)):
        with pytest.raises(ValueError, match="does not follow"):
            tnative.accel_stage_topk_zsegs([ok_a, bad], 2, 16, stages,
                                           tfr.BLOCK_R, 4)
        assert jnative.accel_stage_topk_zsegs(
            [ok_a, bad], 2, 16, stages, jfr.BLOCK_R, 4) is None
    with pytest.raises(ValueError, match="stages must start at 1"):
        tnative.accel_stage_topk_zsegs([ok_a], 2, 16, [2], tfr.BLOCK_R, 4)


def test_native_accel_build_failure_raises(tmp_path, monkeypatch):
    """The native consumer follows the unpack's rule: a library that
    does not build makes the CPU hi stage raise; the torch consumer,
    chosen explicitly through the TPULSAR_ACCEL_BATCH=1 pin, still
    runs."""
    monkeypatch.setattr(tnative, "CXX", "false")
    monkeypatch.setenv("TPULSAR_CACHE_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    specs = torch.from_numpy(_specs(2, seed=6))
    with pytest.raises(RuntimeError, match="did not build"):
        ta.accel_search_batch(specs, _bank("torch"), max_numharm=2,
                              topk=4)
    monkeypatch.setenv("TPULSAR_ACCEL_BATCH", "1")
    out = ta.accel_search_batch(specs, _bank("torch"), max_numharm=2,
                                topk=4)
    assert out[1][0].shape == (2, 4)
    assert tnative._lib is None


def test_native_library_is_keyed_by_both_sources():
    """The build key hashes every source: the accel consumer's source is
    part of it, so an edited accel_host.cpp never loads a stale
    library."""
    names = [p.rsplit("/", 1)[-1] for p in tnative.SOURCES]
    assert names == ["unpack.cpp", "accel_host.cpp"]
    assert "libtpulsar_native_" in tnative.library_path()
