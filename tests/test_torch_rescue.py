"""The host rescue (tpulsar_torch.resilience.rescue) and the executor's
whole-chunk rescue, against the JAX package's (tpulsar/resilience/
rescue.py, tpulsar/search/executor.py): the counterparts of
tests/test_resilience.py's host-rescue, accel end-to-end and executor
end-to-end tests, each run through both packages on the same seeded
spectra with the same TPULSAR_FAULTS spec.

Tolerances: within the port, exact (on the CPU the rescue runs the
per-DM row program on the same device, so rescued rows are the clean
per-DM rows bit for bit, and with one torch thread at these sizes the
batched and native paths give the same bits too); between the packages, r bins and z exactly and
powers at rtol 2e-4 (tests/test_torch_accel.py); the beams' candidate
lists to tests/test_resilience.py's tolerances."""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_accel_ladder import (PKG, _assert_close,  # noqa: E402
                                     _assert_equal, _both, _run)
from test_torch_accel_ladder import clean_accel_state  # noqa: E402, F401
from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from tpulsar.io import accelcands as jcands  # noqa: E402
from tpulsar.io import synth  # noqa: E402
from tpulsar.kernels import accel as ja  # noqa: E402
from tpulsar.obs import trace as jtrace  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.resilience import rescue as jrescue  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar_torch import state  # noqa: E402
from tpulsar_torch.io import accelcands as tcands  # noqa: E402
from tpulsar_torch.kernels import accel as ta  # noqa: E402
from tpulsar_torch.obs import trace as ttrace  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402
from tpulsar_torch.resilience import rescue as trescue  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402

RESCUE = {"jax": jrescue, "torch": trescue}


@pytest.fixture(scope="module")
def small_spectra():
    """tests/test_resilience.py's fixture: 6 x 4096 seeded noise
    spectra and build_template_bank(8.0, seg=1 << 10), per package."""
    rng = np.random.default_rng(0)
    spec = (rng.standard_normal((6, 4096))
            + 1j * rng.standard_normal((6, 4096))).astype(np.complex64)
    return spec, {w: PKG[w]["ak"].build_template_bank(8.0, seg=1 << 10)
                  for w in PKG}


@pytest.fixture
def perdm_path(monkeypatch):
    """Pin the per-DM accel path (the path the faults instrument) in
    both packages."""
    monkeypatch.setenv("TPULSAR_ACCEL_BATCH", "0")
    monkeypatch.setattr(ja, "_BATCH_OK", None)
    monkeypatch.setattr(ta, "_BATCH_OK", None)


def _both_small(small_spectra, spec=None, raises=None):
    specs, banks = small_spectra
    out = {}
    recs = {}
    for w in ("jax", "torch"):
        out[w], recs[w] = _run(
            w, specs, spec, raises=raises and {
                "jax": ja.AccelStageRefused,
                "torch": ta.AccelStageRefused}[w],
            bank=banks[w], max_numharm=4, topk=8)
    assert recs["torch"] == recs["jax"]
    return out["jax"], out["torch"], recs["torch"]


# --------------------------------------------------- host rescue (unit)

def test_rescue_disabled_by_env(monkeypatch):
    monkeypatch.setenv("TPULSAR_HOST_RESCUE", "0")
    for mod in RESCUE.values():
        assert not mod.enabled()
        assert mod.rescue_accel_rows(None, None, [1], max_numharm=4,
                                     topk=8) == ({}, False)
        assert mod.rescue_accel_chunk(None, None, max_numharm=4,
                                      topk=8) is None


def test_rescue_no_rows_is_noop():
    for mod in RESCUE.values():
        assert mod.rescue_accel_rows(None, None, [], max_numharm=4,
                                     topk=8) == ({}, False)
    assert trescue.cpu_device() == torch.device("cpu")


def test_rescue_unfetchable_spectra_not_exhausted():
    """A rescue whose fetch is refused reports recompute_ran=False in
    both packages: the chunk-level rescue, which fetches again, is
    still a live second chance."""
    class _Unfetchable:
        def __array__(self, *a, **k):
            raise tfaults.DispatchRefused("UNIMPLEMENTED: poisoned "
                                          "session")

    for mod in RESCUE.values():
        assert mod.rescue_accel_rows(_Unfetchable(), None, [0, 1],
                                     max_numharm=4, topk=8) == ({}, False)
        assert mod.rescue_accel_chunk(_Unfetchable(), None, max_numharm=4,
                                      topk=8) is None


def test_rescue_fetch_error_that_is_no_refusal_propagates(
        small_spectra, perdm_path, monkeypatch):
    """Only a refusal of the rescue's fetch reads as "nothing to
    rescue": any other error (a CUDA error that poisons the context, a
    bug) leaves the rescue, and accel_search_batch, untouched."""
    specs, banks = small_spectra
    boom = RuntimeError("CUDA error: an illegal memory access was "
                        "encountered")

    def explode(x):
        raise boom

    monkeypatch.setattr(trescue, "_to_host", explode)
    with pytest.raises(RuntimeError) as ei:
        trescue.rescue_accel_rows(torch.from_numpy(specs), banks["torch"],
                                  [0], max_numharm=4, topk=8)
    assert ei.value is boom
    tfaults.configure("accel.row_dispatch:unimplemented:rate=1.0")
    with pytest.raises(RuntimeError) as ei:
        ta.accel_search_batch(torch.from_numpy(specs), banks["torch"],
                              max_numharm=4, topk=8)
    assert ei.value is boom


def test_rescue_never_takes_spectra_off_the_card(small_spectra):
    """Spectra that lie on a device (here a meta tensor, which has no
    host copy either) are never fetched or recomputed on the host: the
    row and chunk rescues report nothing ran, and ``available`` is
    False for any device but the CPU."""
    specs, banks = small_spectra
    dev = torch.empty(specs.shape, dtype=torch.complex64, device="meta")
    assert trescue.rescue_accel_rows(dev, banks["torch"], [0, 1],
                                     max_numharm=4, topk=8) == ({}, False)
    assert trescue.rescue_accel_chunk(dev, banks["torch"], max_numharm=4,
                                      topk=8) is None
    assert trescue.available("cpu")
    assert not trescue.available("cuda")
    assert not trescue.available("meta")


def test_rescue_fetch_bounded_by_watchdog(monkeypatch):
    """A fetch that hangs is bounded by the dispatch watchdog's
    deadline: the rows are reported unrescued, the caller gets control
    back."""
    monkeypatch.setenv("TPULSAR_ACCEL_DISPATCH_DEADLINE_S", "0.05")

    class _Hanging:
        def __array__(self, *a, **k):
            time.sleep(30)

    for mod in RESCUE.values():
        t0 = time.monotonic()
        assert mod.rescue_accel_rows(_Hanging(), None, [0], max_numharm=4,
                                     topk=8) == ({}, False)
        assert time.monotonic() - t0 < 10


def test_rescue_chunk_partial_keeps_recovered_rows(small_spectra,
                                                   monkeypatch):
    """One failed row of a chunk rescue does not discard the others:
    they come back, the failed row is zero-filled and reported in
    lost_rows — in both packages, with the same rows."""
    specs, banks = small_spectra
    res = {}
    for w, ak, arr in (("jax", ja, jnp.asarray),
                       ("torch", ta, torch.from_numpy)):
        real = ak.accel_row_topk

        def flaky(block, bank_fft, i, _real=real, **kw):
            if int(i) == 2:
                raise tfaults.DispatchRefused("transient host refusal")
            return _real(block, bank_fft, i, **kw)

        monkeypatch.setattr(ak, "accel_row_topk", flaky)
        part, lost = RESCUE[w].rescue_accel_chunk(
            arr(specs), banks[w], max_numharm=4, topk=8)
        monkeypatch.setattr(ak, "accel_row_topk", real)
        full, lost2 = RESCUE[w].rescue_accel_chunk(
            arr(specs), banks[w], max_numharm=4, topk=8)
        assert lost == [2] and lost2 == []
        keep = [i for i in range(specs.shape[0]) if i != 2]
        for h in part:
            for a, b in zip(part[h], full[h]):
                np.testing.assert_array_equal(np.asarray(a)[keep],
                                              np.asarray(b)[keep])
            assert np.all(np.asarray(part[h][0])[2] == 0.0)
        res[w] = full
    _assert_close(res["torch"], res["jax"])
    # the rescue IS the per-DM row program: bit for bit on the CPU
    rows = {}
    for i in range(specs.shape[0]):
        rows[i] = ta.accel_row_topk(
            torch.from_numpy(specs), torch.from_numpy(banks["torch"].bank_fft),
            i, seg=banks["torch"].seg, step=banks["torch"].step,
            width=banks["torch"].width, nz=len(banks["torch"].zs),
            max_numharm=4, topk=8)
    for si, h in enumerate(res["torch"]):
        for i, tup in rows.items():
            np.testing.assert_array_equal(res["torch"][h][0][i],
                                          tup[0][si].numpy())


# ------------------------------------------- accel end-to-end (CPU)

def test_all_rows_refused_rescued_bit_identical(small_spectra,
                                                perdm_path):
    """100% refusal of the row dispatches: every row host-rescued,
    bit-identical to the clean per-DM run in the port, the provenance
    ledger (not the loss ledger) records 6/6 — the same records as the
    JAX package's."""
    jclean, tclean, _ = _both_small(small_spectra)
    jout, tout, rec = _both_small(
        small_spectra, "accel.row_dispatch:unimplemented:rate=1.0")
    _assert_equal(tout, tclean)
    _assert_close(tout, jout)
    assert rec["fired"]["accel.row_dispatch"] > 0
    assert rec["prov"]["accel_rows_rescued"].startswith("6/6")
    assert "accel_rows_zero_filled" not in rec["snapshot"]
    assert rec["counters"]["rescue.rescued"] == 6
    assert rec["counters"]["trials.rescued"] == 6


def test_poisoned_session_rescued(small_spectra, perdm_path):
    """A poison fault refuses the first dispatch and everything after;
    the row breaker stops dispatching and the host rescue completes the
    block."""
    jclean, tclean, _ = _both_small(small_spectra)
    jout, tout, rec = _both_small(small_spectra,
                                  "accel.row_dispatch:poison")
    _assert_equal(tout, tclean)
    _assert_close(tout, jout)
    assert "accel_rows_rescued" in rec["prov"]


def test_hung_dispatch_retried_under_watchdog(small_spectra, perdm_path,
                                              monkeypatch):
    """One hung row dispatch under a watchdog: the hang becomes a
    refusal, the synchronous retry succeeds (count=1), nothing needs
    rescue.  The deadline (0.5 s) is far above a healthy row's dispatch
    on a loaded CPU and far below the hang (5 s); it is set after the
    clean run, whose first dispatch may include the JAX package's
    compile."""
    jclean, tclean, _ = _both_small(small_spectra)
    monkeypatch.setenv("TPULSAR_ACCEL_DISPATCH_DEADLINE_S", "0.5")
    jout, tout, rec = _both_small(
        small_spectra, "accel.row_dispatch:hang:seconds=5,count=1")
    _assert_equal(tout, tclean)
    _assert_close(tout, jout)
    assert rec["fired"]["accel.row_dispatch"] == 1
    assert rec["counters"]["retries"] == 1
    assert rec["counters"]["rescue.rescued"] == 0
    assert "accel_rows_zero_filled" not in rec["snapshot"]


def test_rescue_off_zero_fills_and_flags(small_spectra, perdm_path,
                                         monkeypatch):
    """TPULSAR_HOST_RESCUE=0: every row refused and nothing rescued
    raises AccelStageRefused ("is disabled", not exhausted) in both
    packages."""
    monkeypatch.setenv("TPULSAR_HOST_RESCUE", "0")
    jexc, texc, rec = _both_small(
        small_spectra, "accel.row_dispatch:unimplemented:rate=1.0",
        raises=True)
    assert str(texc) == str(jexc) and "is disabled" in str(texc)
    assert texc.rescue_exhausted is jexc.rescue_exhausted is False
    # every row dispatched (no breaker shortcut without a rescue)
    assert rec["fired"]["accel.row_dispatch"] == 12


def test_without_host_rescue_the_ladder_ends_on_the_device(
        small_spectra, perdm_path, monkeypatch):
    """Where the host rescue is not available (spectra on the card) the
    ladder ends where TPULSAR_HOST_RESCUE=0 ends it, on the device: two
    rows refused twice are zero-filled and recorded as lost, the others
    are the clean rows bit for bit, nothing is recomputed on the host,
    and every row is dispatched (no breaker shortcut)."""
    specs, banks = small_spectra
    _jclean, tclean, _ = _both_small(small_spectra)

    def no_host(*a, **k):
        raise AssertionError("host rescue ran")

    monkeypatch.setattr(trescue, "available", lambda dev: False)
    monkeypatch.setattr(trescue, "rescue_accel_rows", no_host)
    tout, rec = _run("torch", specs,
                     "accel.row_dispatch:unimplemented:count=4",
                     bank=banks["torch"], max_numharm=4, topk=8)
    assert rec["counters"]["rescue.lost"] == 2
    assert rec["counters"]["rescue.rescued"] == 0
    assert rec["counters"]["trials.per_dm"] == 4
    assert rec["counts"]["accel_rows_zero_filled"][:2] == (2, 6)
    assert "accel_rows_rescued" not in rec["prov"]
    for h in tout:
        np.testing.assert_array_equal(tout[h][0][:2], 0.0)
        for a, b in zip(tout[h], tclean[h]):
            np.testing.assert_array_equal(np.asarray(a)[2:],
                                          np.asarray(b)[2:])
    monkeypatch.setenv("TPULSAR_HOST_RESCUE", "1")
    texc, rec = _run("torch", specs, "accel.row_dispatch:poison",
                     raises=ta.AccelStageRefused, bank=banks["torch"],
                     max_numharm=4, topk=8)
    assert "does not run for spectra on the card" in str(texc)
    assert texc.rescue_exhausted is False
    # the open breaker routes nothing past the device without a rescue
    assert rec["counters"]["undispatched"] == 0


# ------------------------------------------------ the executor's rescue

def _hi_pass(which, specs, dm_chunk):
    jp = jex.SearchParams(hi_accel_zmax=8, topk_per_stage=8,
                          make_plots=False)
    if which == "jax":
        return jex._hi_accel_pass(jnp.asarray(specs), dm_chunk, 10.0, jp)
    tp = state.search_params_from_jax(jp.provenance())
    return tex._hi_accel_pass(torch.from_numpy(specs), dm_chunk, 10.0, tp)


def _cands_equal(tc, jc):
    assert len(tc) == len(jc) and len(tc) > 0
    for a, b in zip(tc, jc):
        assert (a.dm, a.numharm) == (b.dm, b.numharm)
        assert a.r == pytest.approx(b.r, rel=1e-9)
        assert a.z == pytest.approx(b.z, rel=1e-9)
        assert a.power == pytest.approx(b.power, rel=2e-4)


@pytest.mark.parametrize("chunk_fetch_ok", [True, False])
def test_executor_chunk_rescue_after_total_refusal(small_spectra,
                                                   perdm_path, monkeypatch,
                                                   chunk_fetch_ok):
    """tests/test_resilience.py's executor path: every row refused and
    the per-row rescue unable to fetch (not exhausted), so
    AccelStageRefused reaches _hi_accel_pass.  With a working fetch the
    whole chunk is recomputed on the host: the clean candidates, the
    chunk's provenance, an accel_chunk_rescue span.  Without one the
    chunk's hi stage is skipped loudly and its rows count as lost.
    The same ledgers, counters and candidates in both packages."""
    specs, _banks = small_spectra
    dms = [float(d) for d in np.arange(6) * 2.0]
    clean = {w: _hi_pass(w, specs, dms) for w in ("jax", "torch")}
    _cands_equal(clean["torch"], clean["jax"])
    got, recs, spans = {}, {}, {}
    for w, tr in (("jax", jtrace), ("torch", ttrace)):
        mod = RESCUE[w]
        real = mod._fetch_host
        calls = []

        def fetch(x, _real=real, _calls=calls):
            _calls.append(1)
            # the kernel's own per-row rescue (first call) cannot fetch
            if len(_calls) == 1 or not chunk_fetch_ok:
                return None
            return _real(x)

        monkeypatch.setattr(mod, "_fetch_host", fetch)
        p = PKG[w]
        p["deg"].reset()
        tr.start()
        p["faults"].configure("accel.row_dispatch:unimplemented:rate=1.0")
        before = {o: p["tm"].rescue_rows_total().value(outcome=o)
                  for o in ("rescued", "lost")}
        trials = p["tm"].accel_batch_trials_total().value(path="rescued")
        with pytest.warns(UserWarning, match="hi-accel chunk"):
            got[w] = _hi_pass(w, specs, dms)
        p["faults"].reset()
        monkeypatch.setattr(mod, "_fetch_host", real)
        recs[w] = dict(
            snapshot={k: v.split(";")[0] for k, v in
                      p["deg"].snapshot().items()},
            prov=p["deg"].provenance_snapshot(),
            rescue={o: p["tm"].rescue_rows_total().value(outcome=o)
                    - before[o] for o in before},
            trials=p["tm"].accel_batch_trials_total().value(
                path="rescued") - trials)
        spans[w] = [e["name"] for e in tr.events()]
    assert recs["torch"] == recs["jax"]
    if chunk_fetch_ok:
        _cands_equal(got["torch"], got["jax"])
        for a, b in zip(got["torch"], clean["torch"]):
            assert (a.r, a.z, a.power, a.dm) == (b.r, b.z, b.power, b.dm)
        assert recs["torch"]["prov"]["accel_rows_rescued"].startswith(
            "6/6")
        assert recs["torch"]["rescue"] == {"rescued": 6, "lost": 0}
        assert recs["torch"]["trials"] == 6
        assert "accel_chunk_rescue" in spans["torch"]
    else:
        assert got["torch"] == got["jax"] == []
        assert recs["torch"]["snapshot"]["accel_hi_chunk_skipped"] == \
            "6/6 across 1 call(s)"
        assert recs["torch"]["rescue"] == {"rescued": 0, "lost": 6}


def test_executor_skips_a_refused_chunk_on_the_device(small_spectra,
                                                     perdm_path,
                                                     monkeypatch):
    """Spectra on the card: AccelStageRefused reaches _hi_accel_pass,
    and the chunk's hi stage is skipped loudly at once (no host
    recompute, no accel_chunk_rescue span), its rows counted as
    lost."""
    specs, _banks = small_spectra
    dms = [float(d) for d in np.arange(6) * 2.0]

    def no_host(*a, **k):
        raise AssertionError("host rescue ran")

    monkeypatch.setattr(trescue, "available", lambda dev: False)
    monkeypatch.setattr(trescue, "rescue_accel_chunk", no_host)
    monkeypatch.setattr(trescue, "rescue_accel_rows", no_host)
    PKG["torch"]["deg"].reset()
    ttrace.start()
    lost = PKG["torch"]["tm"].rescue_rows_total().value(outcome="lost")
    tfaults.configure("accel.row_dispatch:unimplemented:rate=1.0")
    try:
        with pytest.warns(UserWarning, match="hi-accel chunk skipped"):
            assert _hi_pass("torch", specs, dms) == []
    finally:
        tfaults.reset()
    assert PKG["torch"]["deg"].counts()["accel_hi_chunk_skipped"][:2] == \
        (6, 6)
    assert PKG["torch"]["tm"].rescue_rows_total().value(
        outcome="lost") - lost == 6
    assert "accel_chunk_rescue" not in [e["name"] for e in ttrace.events()]


# ------------------------------------------ executor end-to-end (CPU)

def test_beam_with_total_accel_refusal_matches_clean(tmp_path):
    """tests/test_resilience.py:663 on the port, and against the JAX
    package's run of the same faulted beam: with 100% of the accel row
    dispatches refused, the port's candidate list equals its clean
    run's; search_params.txt records accel_rows_rescued provenance and
    no loss flag; the .report has its "Rescued work" section."""
    spec = synth.BeamSpec(nchan=24, nsamp=1 << 13, nbits=4,
                          tsamp_s=5.24288e-4)
    psr = synth.PulsarSpec(period_s=0.15, dm=6.0, snr_per_sample=0.5,
                           width_frac=0.05)
    fns = synth.synth_beam(str(tmp_path / "beam"), spec, pulsars=[psr],
                           merged=True)
    plan = [jddplan.DedispStep(lodm=0.0, dmstep=2.0, dms_per_pass=8,
                               numpasses=1, numsub=24, downsamp=1)]
    jp = jex.SearchParams(nsub=24, hi_accel_zmax=8, topk_per_stage=8,
                          max_cands_to_fold=0, make_plots=False)
    tp = state.search_params_from_jax(jp.provenance())
    tplan = state.plan_from_jax([dataclasses.astuple(s) for s in plan])
    spec_f = "accel.row_dispatch:unimplemented:rate=1.0"

    def tsearch(name):
        return tex.search_beam(fns, str(tmp_path / f"tw{name}"),
                               str(tmp_path / f"tr{name}"), tp,
                               plan=tplan, device="cpu")

    clean = tsearch("0")
    tfaults.configure(spec_f)
    try:
        rescued = tsearch("1")
    finally:
        tfaults.reset()
    PKG["jax"]["faults"].configure(spec_f)
    try:
        jres = jex.search_beam(fns, str(tmp_path / "jw"),
                               str(tmp_path / "jr"), params=jp, plan=plan)
    finally:
        PKG["jax"]["faults"].reset()

    def cands(out, mod):
        return mod.parse_candlist(os.path.join(
            out.resultsdir, f"{out.basenm}.accelcands"))

    c0, c1 = cands(clean, tcands), cands(rescued, tcands)
    cj = cands(jres, jcands)
    assert len(c0) == len(c1) == len(cj) and len(c1) > 0
    for a, b, j in zip(c0, c1, cj):
        for other in (b, j):
            assert (a.dm, a.numharm) == (other.dm, other.numharm)
            assert a.r == pytest.approx(other.r, rel=1e-9)
            assert a.z == pytest.approx(other.z, rel=1e-9)
        # clean (native consumer) and rescued (row program) are the
        # same bits on the CPU; the JAX run to tests/test_resilience.py's
        # tolerances
        assert (a.power, a.sigma) == (b.power, b.sigma)
        assert a.power == pytest.approx(j.power, rel=1e-4)
        assert a.sigma == pytest.approx(j.sigma, rel=1e-3)

    def params_ns(out):
        ns: dict = {}
        with open(os.path.join(out.resultsdir, "search_params.txt")) as fh:
            exec(fh.read(), {}, ns)
        return ns

    for out in (rescued, jres):
        ns = params_ns(out)
        assert ns["rescued_modes"]["accel_rows_rescued"].startswith("8/8")
        assert "accel_rows_zero_filled" not in ns["degraded_modes"]
        assert "accel_hi_chunk_skipped" not in ns["degraded_modes"]
        with open(os.path.join(out.resultsdir,
                               f"{out.basenm}.report")) as fh:
            rep = fh.read()
        assert "Rescued work" in rep and "accel_rows_rescued" in rep
    assert params_ns(rescued)["rescued_modes"] == \
        params_ns(jres)["rescued_modes"]
    assert params_ns(clean)["rescued_modes"] == {}
