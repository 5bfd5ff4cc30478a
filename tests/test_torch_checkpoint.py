"""The port's pass-level checkpoint/resume against the JAX package's.

The store contract (atomic writes, sha256 verification, torn / stale /
foreign manifests, ENOSPC degradation, the checkpoint.write/load fault
points) is one parametrised test over both packages' stores; the
checkpoint fingerprint, data_id and the pass / sifted / fold codecs
are pinned equal between the packages; the port's executor resumes a
search killed after pass k with results identical to an uninterrupted
run (k in {0, 1, 2}, and a real SIGKILL of the job subprocess).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_slice import one_torch_thread  # noqa: E402, F401 (autouse)
from tpulsar import checkpoint as jckpt  # noqa: E402
from tpulsar.checkpoint import hashing as jhashing  # noqa: E402
from tpulsar.io import synth  # noqa: E402
from tpulsar.kernels import fold as jfold  # noqa: E402
from tpulsar.plan import ddplan as jddplan  # noqa: E402
from tpulsar.resilience import faults as jfaults  # noqa: E402
from tpulsar.search import executor as jex  # noqa: E402
from tpulsar.search import sifting as jsift  # noqa: E402
from tpulsar_torch import checkpoint as tckpt  # noqa: E402
from tpulsar_torch.checkpoint import hashing as thashing  # noqa: E402
from tpulsar_torch.kernels import fold as tfold  # noqa: E402
from tpulsar_torch.plan import ddplan as tddplan  # noqa: E402
from tpulsar_torch.resilience import faults as tfaults  # noqa: E402
from tpulsar_torch.search import executor as tex  # noqa: E402
from tpulsar_torch.search import sifting as tsift  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {"jax": (jckpt, jhashing, jfaults),
        "torch": (tckpt, thashing, tfaults)}


@pytest.fixture(autouse=True)
def _no_fault_leak():
    for _c, _h, f in PKGS.values():
        f.reset()
    yield
    for _c, _h, f in PKGS.values():
        f.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    """(checkpoint package, hashing module, faults module) of one
    package: each store case runs against both."""
    return PKGS[request.param]


class _Journal:
    """Captures a store's journal callback events."""

    def __init__(self):
        self.events: list[tuple[str, dict]] = []

    def __call__(self, event, **extra):
        self.events.append((event, extra))

    def names(self):
        return [e for e, _ in self.events]

    def of(self, name):
        return [kw for e, kw in self.events if e == name]


# ------------------------------------------------------------- store

def test_store_roundtrip_and_manifest(tmp_path, pkg):
    ckpt, hashing, _f = pkg
    root = str(tmp_path / "ck")
    store = ckpt.CheckpointStore(root, "fp-1")
    assert store.save("pass_0000", b"alpha", kind="pass", pass_idx=0)
    assert store.save("rfi_mask", b"beta", kind="stage", ext=".npz")
    doc = ckpt.read_manifest(root)
    assert doc["schema"] == ckpt.SCHEMA == "tpulsar-checkpoint/1"
    assert doc["fingerprint"] == "fp-1"
    ent = doc["entries"]["pass_0000"]
    assert ent["bytes"] == 5
    assert ent["sha256"] == hashing.sha256_bytes(b"alpha")
    assert ent["kind"] == "pass"
    store2 = ckpt.CheckpointStore(root, "fp-1")
    assert store2.load("pass_0000") == b"alpha"
    assert store2.load("rfi_mask") == b"beta"
    assert store2.load("missing") is None
    assert set(store2.entries(kind="pass")) == {"pass_0000"}
    assert not [n for n in os.listdir(root) if n.endswith(".tmp")]


def test_store_reads_the_other_packages_directory(tmp_path):
    """Same schema, file names and digests: each package's store loads
    what the other wrote."""
    for writer, reader in ((jckpt, tckpt), (tckpt, jckpt)):
        root = str(tmp_path / f"ck_{writer.__name__}")
        w = writer.CheckpointStore(root, "fp")
        assert w.save("pass_0003", b"payload", kind="pass", ext=".npz")
        r = reader.CheckpointStore(root, "fp")
        assert r.load("pass_0003") == b"payload"
        assert reader.progress_marker(root) == 1
        assert reader.verify_root(root)["ok"]


def test_corrupt_artifact_discarded_and_journaled(tmp_path, pkg):
    ckpt, _h, _f = pkg
    root = str(tmp_path / "ck")
    j = _Journal()
    store = ckpt.CheckpointStore(root, "fp", journal=j)
    store.save("pass_0000", b"payload")
    with open(os.path.join(root, "pass_0000.bin"), "wb") as fh:
        fh.write(b"garbage")         # same length: the sha must catch it
    store2 = ckpt.CheckpointStore(root, "fp", journal=j)
    assert store2.load("pass_0000") is None
    assert not store2.has("pass_0000")
    bad = j.of("checkpoint_invalid")
    assert bad and bad[-1]["key"] == "pass_0000"
    assert "mismatch" in bad[-1]["reason"]
    assert "pass_0000" not in ckpt.CheckpointStore(root, "fp").entries()


def test_torn_manifest_wipes_and_recomputes(tmp_path, pkg):
    ckpt, _h, _f = pkg
    root = str(tmp_path / "ck")
    ckpt.CheckpointStore(root, "fp").save("pass_0000", b"x")
    with open(ckpt.manifest_path(root), "w") as fh:
        fh.write('{"schema": "tpulsar-checkpo')      # torn mid-write
    j = _Journal()
    store2 = ckpt.CheckpointStore(root, "fp", journal=j)
    assert store2.entries() == {}
    assert j.of("checkpoint_invalid")[0]["scope"] == "manifest"
    assert store2.save("pass_0000", b"y")
    assert store2.load("pass_0000") == b"y"


def test_stale_schema_manifest_rejected(tmp_path, pkg):
    ckpt, _h, _f = pkg
    root = str(tmp_path / "ck")
    ckpt.CheckpointStore(root, "fp").save("pass_0000", b"x")
    with open(ckpt.manifest_path(root)) as fh:
        doc = json.load(fh)
    doc["schema"] = "tpulsar-checkpoint/0"
    with open(ckpt.manifest_path(root), "w") as fh:
        json.dump(doc, fh)
    j = _Journal()
    store2 = ckpt.CheckpointStore(root, "fp", journal=j)
    assert store2.entries() == {}
    assert "checkpoint_invalid" in j.names()


def test_fingerprint_mismatch_wipes(tmp_path, pkg):
    ckpt, _h, _f = pkg
    root = str(tmp_path / "ck")
    ckpt.CheckpointStore(root, "fp-A").save("pass_0000", b"x")
    j = _Journal()
    store = ckpt.CheckpointStore(root, "fp-B", journal=j)
    assert store.entries() == {}
    assert ckpt.read_manifest(root)["fingerprint"] == "fp-B"
    assert j.of("checkpoint_invalid")[0]["reason"] == \
        "fingerprint_mismatch"


def test_tmp_litter_swept_at_open(tmp_path, pkg):
    ckpt, _h, _f = pkg
    root = str(tmp_path / "ck")
    ckpt.CheckpointStore(root, "fp").save("pass_0000", b"x")
    litter = os.path.join(root, "pass_0001.bin.1234.tmp")
    with open(litter, "wb") as fh:
        fh.write(b"partial")
    ckpt.CheckpointStore(root, "fp")
    assert not os.path.exists(litter)


def test_enospc_disables_store_for_the_beam(tmp_path, pkg):
    ckpt, _h, faults = pkg
    root = str(tmp_path / "ck")
    j = _Journal()
    store = ckpt.CheckpointStore(root, "fp", journal=j)
    assert store.save("pass_0000", b"x")
    faults.configure("checkpoint.write:unimplemented:errno=ENOSPC")
    assert not store.save("pass_0001", b"y")
    assert store.disabled
    assert "checkpoint_disabled" in j.names()
    faults.reset()
    assert not store.save("pass_0002", b"z")     # sticky for the beam
    assert "pass_0001" not in store.entries()
    assert ckpt.CheckpointStore(root, "fp").load("pass_0000") == b"x"


def test_transient_eio_skips_one_artifact_only(tmp_path, pkg):
    ckpt, _h, faults = pkg
    root = str(tmp_path / "ck")
    j = _Journal()
    store = ckpt.CheckpointStore(root, "fp", journal=j)
    faults.configure("checkpoint.write:unimplemented:count=1")
    assert not store.save("pass_0000", b"x")     # EIO-shaped default
    assert not store.disabled
    assert "checkpoint_write_failed" in j.names()
    assert store.save("pass_0001", b"y")


def test_load_fault_treated_as_corruption(tmp_path, pkg):
    ckpt, _h, faults = pkg
    root = str(tmp_path / "ck")
    j = _Journal()
    store = ckpt.CheckpointStore(root, "fp", journal=j)
    store.save("pass_0000", b"x")
    faults.configure("checkpoint.load:unimplemented:count=1")
    assert store.load("pass_0000") is None
    assert j.of("checkpoint_invalid")[-1]["key"] == "pass_0000"


def test_verify_root_and_progress_marker(tmp_path, pkg):
    ckpt, _h, _f = pkg
    root = str(tmp_path / "ck")
    assert ckpt.progress_marker(root) == -1
    store = ckpt.CheckpointStore(root, "fp")
    assert ckpt.progress_marker(root) == 0
    store.save("pass_0000", b"a")
    store.save("pass_0001", b"b")
    assert ckpt.progress_marker(root) == 2
    assert ckpt.verify_root(root)["ok"]
    with open(os.path.join(root, "pass_0001.bin"), "wb") as fh:
        fh.write(b"corrupt")
    rep = ckpt.verify_root(root)
    assert not rep["ok"]
    assert [e["key"] for e in rep["entries"] if not e["ok"]] == \
        ["pass_0001"]


def test_sha256_helpers_agree(tmp_path):
    p = tmp_path / "blob"
    p.write_bytes(b"the one hashing helper")
    assert thashing.sha256_file(str(p)) \
        == thashing.sha256_bytes(b"the one hashing helper") \
        == jhashing.sha256_file(str(p))


def test_fault_specs_parse_alike():
    """One TPULSAR_FAULTS value parses in both packages."""
    assert tfaults.FAULT_POINTS == jfaults.FAULT_POINTS
    spec = "checkpoint.write:delay:seconds=0.5,after=2;accel.chunk:poison"
    j, t = jfaults.parse_spec(spec), tfaults.parse_spec(spec)
    assert {k: (v.mode, v.seconds, v.after) for k, v in j.items()} == \
        {k: (v.mode, v.seconds, v.after) for k, v in t.items()}


# ------------------------------------- fingerprint, data_id, codecs

def _synth_beam(root, nchan=32, nsamp=1 << 13, dm=5.0, seed=11):
    spec = synth.BeamSpec(nchan=nchan, nsamp=nsamp, nbits=4,
                          tsamp_s=327.68e-6, seed=seed)
    psr = synth.PulsarSpec(period_s=0.25, dm=dm, snr_per_sample=0.5)
    return synth.synth_beam(str(root), spec, pulsars=[psr], merged=True)


def test_fingerprint_and_data_id_equal_across_packages(tmp_path):
    fns = _synth_beam(tmp_path / "beam")
    jp = jex.SearchParams(dm_max=8.0)
    tp = tex.SearchParams(dm_max=8.0)
    *_j, jplan, jnsub, jbaryv, jid = jex._beam_geometry(fns, jp, None,
                                                        None)
    *_t, tplan, tnsub, tbaryv, tid = tex._beam_geometry(fns, tp, None,
                                                        None)
    assert tid == jid and "P2030" in tid and "mjd=" in tid
    assert (tnsub, tbaryv) == (jnsub, jbaryv)
    assert [tuple(vars(s).values()) for s in tplan] == \
        [tuple(vars(s).values()) for s in jplan]
    zap = np.asarray([[60.0, 0.5], [120.0, 1.0]])
    for z in (None, zap):
        assert tex._ckpt_fingerprint(tplan, tp, z, tbaryv, tnsub, tid) \
            == jex._ckpt_fingerprint(jplan, jp, z, jbaryv, jnsub, jid)
    # and it moves with the configuration and with the beam
    assert tex._ckpt_fingerprint(tplan, tex.SearchParams(dm_max=9.0),
                                 None, tbaryv, tnsub, tid) != \
        tex._ckpt_fingerprint(tplan, tp, None, tbaryv, tnsub, tid)
    assert tex._ckpt_fingerprint(tplan, tp, None, tbaryv, tnsub,
                                 tid + "x") != \
        tex._ckpt_fingerprint(tplan, tp, None, tbaryv, tnsub, tid)


def _cands(mod, n=3):
    out = []
    for i in range(n):
        c = mod.Candidate(r=100.5 + i, z=2.0 * i, sigma=9.25 - i,
                          power=40.125 + i, numharm=2 ** (i % 5),
                          dm=10.0 + i / 3, period_s=0.25 / (i + 1),
                          freq_hz=4.0 * (i + 1))
        c.dm_hits = [(10.0 + k, 5.5 + k) for k in range(i % 4 + 1)]
        out.append(c)
    return out


def _ckey(c):
    return (c.r, c.z, c.sigma, c.power, c.numharm, c.dm, c.period_s,
            c.freq_hz, tuple(c.dm_hits))


def _events():
    ev = np.zeros(4, dtype=tex._EMPTY_SP.dtype)
    for name in ev.dtype.names:
        ev[name] = np.arange(4) + 0.5
    return ev


@pytest.mark.parametrize("n", [3, 500])
@pytest.mark.parametrize("enc, dec", [(jex, tex), (tex, jex)],
                         ids=["jax->torch", "torch->jax"])
def test_pass_and_sifted_codecs_read_each_other(enc, dec, n):
    src = _cands(jsift if enc is jex else tsift, n)
    ev = _events()
    cands, events, ntr = dec._decode_pass(enc._encode_pass(src, ev, 76))
    assert ntr == 76 and np.array_equal(events, ev)
    # pass payloads carry no DM-hit history (sifting builds it)
    assert [_ckey(c)[:-1] for c in cands] == [_ckey(c)[:-1] for c in src]
    cands, events, ntr = dec._decode_sifted(
        enc._encode_sifted(src, ev, 152))
    assert ntr == 152 and np.array_equal(events, ev)
    assert [_ckey(c) for c in cands] == [_ckey(c) for c in src]
    assert all(type(c.numharm) is int for c in cands)


@pytest.mark.parametrize("enc, dec", [(jex, tex), (tex, jex)],
                         ids=["jax->torch", "torch->jax"])
def test_fold_codec_reads_each_other(enc, dec):
    rng = np.random.default_rng(3)
    res_cls = (jfold if enc is jex else tfold).FoldResult
    res = res_cls(period_s=0.2500001, pdot=1e-12, dm=50.5, nbin=64,
                  npart=32, profile=rng.standard_normal(64),
                  subints=rng.standard_normal((32, 64)),
                  reduced_chi2=23.5, delta_p=1e-7, delta_pdot=0.0,
                  delta_dm=0.5)
    cand = types.SimpleNamespace(period_s=0.25, dm=50.0)
    got, ident = dec._decode_fold(enc._encode_fold(res, cand))
    assert ident == (0.25, 50.0)
    assert isinstance(got, (tfold if dec is tex else jfold).FoldResult)
    for f in ("period_s", "pdot", "dm", "nbin", "npart", "reduced_chi2",
              "delta_p", "delta_pdot", "delta_dm"):
        assert getattr(got, f) == getattr(res, f), f
    assert np.array_equal(got.profile, res.profile)
    assert np.array_equal(got.subints, res.subints)


def test_undecodable_payloads_decode_to_none():
    for mod in (jex, tex):
        for dec in (mod._decode_pass, mod._decode_sifted,
                    mod._decode_fold):
            assert dec(b"sha-valid but not an npz") is None
            assert dec(None) is None


# ---------------------------------------------------- executor resume

def _small_beam():
    rng = np.random.default_rng(21)
    data = rng.integers(0, 16, size=(24, 4096), dtype=np.uint8)
    freqs = 1214.2 + (np.arange(24) + 0.5) * (322.6 / 24)
    plan = [tddplan.DedispStep(0.0, 1.0, 8, 2, 12, 1),
            tddplan.DedispStep(16.0, 2.0, 8, 1, 12, 2)]   # 3 passes
    return torch.from_numpy(data), freqs, plan


PARAMS = tex.SearchParams(run_hi_accel=False, max_cands_to_fold=0,
                          make_plots=False)
FOLD_PARAMS = tex.SearchParams(
    run_hi_accel=False, make_plots=False, refine_cands=False,
    to_prepfold_sigma=0.0, max_cands_to_fold=2, fold_by_rules=False,
    fold_batched=False,
    # a loosened sift: pure noise must still give fold-worthy
    # candidates for the fold artifacts to be exercised
    sifting=tsift.SiftParams(sigma_threshold=2.0, min_num_dms=1))


def _search(data, freqs, plan, params, **kw):
    return tex.search_block(data, freqs, 65e-6, plan, params,
                            device="cpu", **kw)


def _truncate_to(ckdir: str, keep_passes: int) -> None:
    """The state a SIGKILL after pass ``keep_passes - 1`` leaves: every
    later pass artifact and the sifted/fold artifacts gone."""
    man_path = tckpt.manifest_path(ckdir)
    with open(man_path) as fh:
        doc = json.load(fh)
    for key in list(doc["entries"]):
        if key == "sifted" or key.startswith("fold_") or (
                key.startswith("pass_")
                and int(key[len("pass_"):]) >= keep_passes):
            os.unlink(os.path.join(ckdir, doc["entries"][key]["file"]))
            del doc["entries"][key]
    with open(man_path, "w") as fh:
        json.dump(doc, fh)


@pytest.mark.parametrize("keep", [0, 1, 2])
def test_resume_parity_after_kill_at_pass_k(tmp_path, keep):
    """Killed after pass k, the resumed port search gives candidates
    (every field, DM-hit history included), SP events and trial counts
    identical to an uninterrupted port run, and recomputes only passes
    k..2."""
    data, freqs, plan = _small_beam()
    gold_c, _f, gold_sp, gold_n = _search(data, freqs, plan, PARAMS)
    ck = str(tmp_path / "ck")
    _search(data, freqs, plan, PARAMS, checkpoint_dir=ck)
    _truncate_to(ck, keep)
    j = _Journal()
    seen = []
    res_c, _f, res_sp, res_n = _search(
        data, freqs, plan, PARAMS, checkpoint_dir=ck,
        checkpoint_journal=j, progress_cb=seen.append)
    assert res_n == gold_n
    assert [_ckey(c) for c in res_c] == [_ckey(c) for c in gold_c]
    assert np.array_equal(res_sp, gold_sp)
    assert [kw["pass_idx"] for kw in j.of("pass_complete")] == \
        list(range(keep, 3))
    assert ("resume" in j.names()) == (keep > 0)
    assert [p["pass_idx"] for p in seen] == list(range(keep + 1, 4))
    assert seen[-1]["ntrials_done"] == gold_n


def test_resume_parity_after_torn_manifest(tmp_path):
    data, freqs, plan = _small_beam()
    gold_c = _search(data, freqs, plan, PARAMS)[0]
    ck = str(tmp_path / "ck")
    _search(data, freqs, plan, PARAMS, checkpoint_dir=ck)
    with open(tckpt.manifest_path(ck), "w") as fh:
        fh.write("{torn")
    j = _Journal()
    res_c = _search(data, freqs, plan, PARAMS, checkpoint_dir=ck,
                    checkpoint_journal=j)[0]
    assert [_ckey(c) for c in res_c] == [_ckey(c) for c in gold_c]
    assert j.of("checkpoint_invalid")[0]["scope"] == "manifest"
    assert "resume" not in j.names()


def test_enospc_mid_search_finishes_uncheckpointed(tmp_path):
    """A sick checkpoint volume never fails a healthy beam: identical
    science, checkpointing disabled for the rest of the beam, the
    degradation journaled."""
    data, freqs, plan = _small_beam()
    gold_c = _search(data, freqs, plan, PARAMS)[0]
    tfaults.configure(
        "checkpoint.write:unimplemented:errno=ENOSPC,after=1")
    j = _Journal()
    res_c = _search(data, freqs, plan, PARAMS,
                    checkpoint_dir=str(tmp_path / "ck"),
                    checkpoint_journal=j)[0]
    tfaults.reset()
    assert [_ckey(c) for c in res_c] == [_ckey(c) for c in gold_c]
    assert "checkpoint_disabled" in j.names()
    assert [kw["pass_idx"] for kw in j.of("pass_complete")] == [0]


def test_sifted_and_fold_artifacts_resume(tmp_path):
    """A crash during folding resumes past the whole plan loop through
    the 'sifted' artifact and re-folds only the missing candidate."""
    data, freqs, plan = _small_beam()
    ck = str(tmp_path / "ck")
    gold_c, gold_f, _sp, _n = _search(data, freqs, plan, FOLD_PARAMS,
                                      checkpoint_dir=ck)
    assert len(gold_f) == 2
    with open(tckpt.manifest_path(ck)) as fh:
        doc = json.load(fh)
    assert "sifted" in doc["entries"]
    assert {"fold_0000", "fold_0001"} <= set(doc["entries"])
    os.unlink(os.path.join(ck, doc["entries"]["fold_0001"]["file"]))
    del doc["entries"]["fold_0001"]
    with open(tckpt.manifest_path(ck), "w") as fh:
        json.dump(doc, fh)
    j = _Journal()
    res_c, res_f, _sp, _n = _search(data, freqs, plan, FOLD_PARAMS,
                                    checkpoint_dir=ck,
                                    checkpoint_journal=j)
    assert [_ckey(c) for c in res_c] == [_ckey(c) for c in gold_c]
    assert len(res_f) == 2
    for a, b in zip(res_f, gold_f):
        assert np.array_equal(a.profile, b.profile)
        assert np.array_equal(a.subints, b.subints)
        assert a.reduced_chi2 == b.reduced_chi2
    assert j.of("pass_complete") == []
    assert "resume" in j.names()
    assert set(tckpt.read_manifest(ck)["entries"]) >= {"fold_0001"}


def test_stale_fold_artifact_identity_mismatch_discarded(tmp_path):
    """fold_NNNN artifacts are keyed by position: one bound to another
    candidate's identity is discarded and re-folded."""
    data, freqs, plan = _small_beam()
    ck = str(tmp_path / "ck")
    gold_c, gold_f, _sp, _n = _search(data, freqs, plan, FOLD_PARAMS,
                                      checkpoint_dir=ck)
    store = tckpt.CheckpointStore(ck, tckpt.read_manifest(ck)[
        "fingerprint"])
    res, _ident = tex._decode_fold(store.load("fold_0000"))
    ghost = types.SimpleNamespace(period_s=123.456, dm=7.0)
    store.save("fold_0000", tex._encode_fold(res, ghost), kind="fold",
               ext=".npz")
    j = _Journal()
    res_c, res_f, _sp, _n = _search(data, freqs, plan, FOLD_PARAMS,
                                    checkpoint_dir=ck,
                                    checkpoint_journal=j)
    assert [_ckey(c) for c in res_c] == [_ckey(c) for c in gold_c]
    for a, b in zip(res_f, gold_f):
        assert np.array_equal(a.profile, b.profile)
    bad = [kw for kw in j.of("checkpoint_invalid")
           if kw.get("key") == "fold_0000"]
    assert bad and "identity" in bad[0]["reason"]


def test_undecodable_pass_payload_discarded_with_excuse(tmp_path):
    data, freqs, plan = _small_beam()
    gold_c = _search(data, freqs, plan, PARAMS)[0]
    ck = str(tmp_path / "ck")
    _search(data, freqs, plan, PARAMS, checkpoint_dir=ck)
    store = tckpt.CheckpointStore(ck, tckpt.read_manifest(ck)[
        "fingerprint"])
    store.save("pass_0001", b"sha-valid but not an npz", kind="pass",
               ext=".npz")
    store.discard("sifted", reason="test")
    j = _Journal()
    res_c = _search(data, freqs, plan, PARAMS, checkpoint_dir=ck,
                    checkpoint_journal=j)[0]
    assert [_ckey(c) for c in res_c] == [_ckey(c) for c in gold_c]
    bad = [kw for kw in j.of("checkpoint_invalid")
           if kw.get("key") == "pass_0001"]
    assert bad and "undecodable" in bad[0]["reason"]
    assert [kw["pass_idx"] for kw in j.of("pass_complete")] == [1]


def test_port_resumes_a_directory_the_jax_package_wrote(tmp_path,
                                                        monkeypatch):
    """Same fingerprint, layout and codecs: the JAX package's
    search_block checkpoints a block, and the port's search_block on
    the same block resumes every pass of it (nothing recomputed)."""
    import jax.numpy as jnp

    monkeypatch.setenv("TPULSAR_DD_FAMILY", "direct")
    data, freqs, plan = _small_beam()
    jplan = [jddplan.DedispStep(*vars(s).values()) for s in plan]
    jp = jex.SearchParams(**{k: v for k, v in PARAMS.provenance().items()
                             if k != "sifting"})
    ck = str(tmp_path / "ck")
    jc = jex.search_block(jnp.asarray(data.numpy()), freqs, 65e-6, jplan,
                          jp, checkpoint_dir=ck, data_id="beam")[0]
    jstore = tckpt.read_manifest(ck)
    j = _Journal()
    tc = _search(data, freqs, plan, PARAMS, checkpoint_dir=ck,
                 data_id="beam", checkpoint_journal=j)[0]
    assert tckpt.read_manifest(ck)["fingerprint"] == \
        jstore["fingerprint"]
    assert "resume" in j.names() and j.of("pass_complete") == []
    assert j.of("checkpoint_invalid") == []
    assert [_ckey(c) for c in tc] == [_ckey(c) for c in jc]


# ---------------------------------------------------- a real SIGKILL

_JOB = [sys.executable, "-m", "tpulsar_torch.cli.search_job",
        "--device", "cpu", "--no-accel"]


def _job_env(tmp_path, fns, outdir, extra=None):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "searching:\n  dm_max: 40.0\n"
        f"processing:\n  base_working_directory: {tmp_path / 'work'}\n"
        f"  base_results_directory: {tmp_path / 'res'}\n"
        f"basic:\n  log_dir: {tmp_path / 'logs'}\n"
        f"download:\n  datadir: {tmp_path / 'raw'}\n"
        f"background:\n  jobtracker_db: {tmp_path / 'jt.db'}\n"
        f"resultsdb:\n  url: {tmp_path / 'results.db'}\n")
    env = dict(os.environ, PYTHONPATH=ROOT, TPULSAR_CONFIG=str(cfg),
               DATAFILES=";".join(fns), OUTDIR=str(outdir),
               OMP_NUM_THREADS="1")
    env.pop("TPULSAR_FAULTS", None)
    env.update(extra or {})
    return env


def _pass_keys(ckdir: str) -> list[str]:
    doc = tckpt.read_manifest(ckdir) or {}
    return sorted(k for k, v in (doc.get("entries") or {}).items()
                  if v.get("kind") == "pass"
                  and os.path.exists(os.path.join(ckdir, v["file"])))


def test_sigkilled_job_resumes_with_identical_results(tmp_path,
                                                     monkeypatch):
    """`python -m tpulsar_torch.cli.search_job --device cpu` on a
    6-pass beam is SIGKILLed once its manifest shows two passes; the
    rerun resumes after the last durable pass (its metrics.json counts
    only the passes it computed) and writes the results an
    uninterrupted job writes."""
    from tpulsar_torch import config as tcfg
    from tpulsar_torch.cli import search_job

    fns = _synth_beam(tmp_path / "beam")
    killed = tmp_path / "killed"
    ckdir = tckpt.default_root(str(killed))
    # slow checkpoint writes (the fault layer's delay mode) hold the
    # job between passes long enough to be killed there
    proc = subprocess.Popen(
        _JOB, env=_job_env(tmp_path, fns, killed, {
            "TPULSAR_FAULTS": "checkpoint.write:delay:seconds=0.4"}),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        deadline = time.time() + 240
        while len(_pass_keys(ckdir)) < 2:
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.time() < deadline, "no pass checkpointed in time"
            time.sleep(0.05)
        os.killpg(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        proc.stderr.close()
    assert proc.returncode == -signal.SIGKILL
    done = _pass_keys(ckdir)
    assert 2 <= len(done) < 6
    assert not os.path.exists(killed / "metrics.json")

    rerun = subprocess.run(_JOB, env=_job_env(tmp_path, fns, killed),
                           capture_output=True, text=True, timeout=600)
    assert rerun.returncode == 0, rerun.stderr
    assert rerun.stderr == ""
    assert not os.path.exists(ckdir)
    with open(killed / "metrics.json") as fh:
        m = json.load(fh)
    assert m["tpulsar_passes_total"]["series"][""] == 6 - len(done)
    assert m["tpulsar_checkpoint_events_total"]["series"]["resumed"] \
        >= len(done)

    # the uninterrupted control: the same job, in this process
    control = tmp_path / "control"
    cfg = _job_env(tmp_path, fns, control)["TPULSAR_CONFIG"]
    monkeypatch.setenv("TPULSAR_CONFIG", cfg)
    tcfg.set_settings(tcfg.load_config(cfg))
    try:
        with restore_job_globals():
            assert search_job.main(
                fns + ["--outdir", str(control), "--device", "cpu",
                       "--no-accel"]) == 0
    finally:
        tcfg.set_settings(None)
    with open(control / "metrics.json") as fh:
        assert json.load(fh)["tpulsar_passes_total"]["series"][""] == 6
    assert results_diff().diff_results(str(killed), str(control)) == []


def results_diff():
    """tools/torch_results_diff.py, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_results_diff",
        os.path.join(ROOT, "tools", "torch_results_diff.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def restore_job_globals():
    """Restore what search_job.main changes in its process: the TERM
    and INT handlers, the warning display and the logging fallback."""
    import logging
    import warnings
    sig = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                            signal.SIGINT)}
    show, last = warnings.showwarning, logging.lastResort
    try:
        yield
    finally:
        for s, h in sig.items():
            signal.signal(s, h)
        warnings.showwarning = show
        logging.lastResort = last
