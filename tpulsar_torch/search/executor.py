"""The per-beam search executor — counterpart of
tpulsar/search/executor.py, for the solo single-beam path.

Stage sequence (reference: lib/python/PALFA2_presto_search.py):

  rfifind            -> kernels.rfi.find_rfi_chan / apply_mask_chan
  prepsubband -sub   -> kernels.dedisperse.form_subbands   (CUDA kernel)
  prepsubband        -> kernels.dedisperse.dedisperse_subbands (CUDA kernel)
                        or the shift tree, kernels.tree_dd (PyTorch)
  single_pulse_search-> kernels.singlepulse.device_search
  realfft/zapbirds/
  rednoise/accelsearch(z=0) -> kernels.fourier.whitened_spectrum +
                               lo_stage_candidates
  accelsearch(zmax>0)-> kernels.accel.accel_search_batch (cuFFT + torch)
  sifting            -> search.sifting
  harmpolish         -> search.refine.refine_candidates (stage 1 + stage
                        2 at one DM row, then a host simplex)
  prepfold           -> kernels.fold_batch.fold_candidates_by_pass (stage
                        1 per originating pass, batched folds per tier)

This package runs the JAX package's default search (SearchParams():
the full survey DDplan, dedispersion, the zero-accel and the zmax-50
hi-accel periodicity searches, sifting, refinement, folding and
plots) on one device, with both stage-2 families (the direct CUDA
kernel, and the shift tree where kernels/tree_dd.plan_for_pass picks
it), and with pass-level checkpoint/resume (checkpoint/): the RFI
mask, every DDplan pass's partials, the sifted list and each folded
candidate are checksummed artifacts, and a re-entered search
recomputes only what is missing or corrupt.  search_beam_batch
searches compatible beams as coalesced groups (kernels/beam_batch.py)
with per-beam results identical to the solo path's.  A mesh of
devices (parallel/) shards each pass: search_block's `mesh`,
_search_pass_sharded.

Artifacts written to the results directory have the JAX package's
names and formats:
  <base>_rfifind.npz             RFI mask
  <base>.accelcands              sifted candidate list
  <base>_cand{k}.pfd.npz         folded candidate k (tarred)
  <base>_cand{k}.bestprof        its prepfold-style summary (tarred)
  <base>_DM*.singlepulse         per-DM single-pulse events (tarred)
  <base>_DM*.inf                 per-DM series metadata (tarred)
  <base>_sp.npz                  all single-pulse events
  header.json                    beam header record
  <base>_cand{k}.png             fold plot of candidate k (make_plots)
  <base>_singlepulse_DMs*.png    single-pulse plots (make_plots)
  search_params.txt              config provenance (python-literal)
  <base>.report                  per-stage timing breakdown
  metrics.json                   the metrics registry's delta over
                                 this beam (obs/metrics.py)
  <base>_trace.json              Chrome trace of the beam
                                 (TPULSAR_TRACE=1; obs/trace.py)
  <base>_*.tgz                   result-class tarballs
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import io
import json
import os
import shutil
import socket
import tarfile
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from tpulsar_torch import checkpoint as ckpt_mod
from tpulsar_torch import resolve_device
from tpulsar_torch.io import accelcands, datafile
from tpulsar_torch.kernels import accel as accel_k
from tpulsar_torch.kernels import beam_batch as bb
from tpulsar_torch.kernels import cuda_dd
from tpulsar_torch.kernels import dedisperse as dd
from tpulsar_torch.kernels import fold as fold_k
from tpulsar_torch.kernels import fourier as fr
from tpulsar_torch.kernels import rfi as rfi_k
from tpulsar_torch.kernels import singlepulse as sp_k
from tpulsar_torch.kernels import tree_dd
from tpulsar_torch.obs import telemetry
from tpulsar_torch.obs import trace as trace_mod
from tpulsar_torch.plan import ddplan
from tpulsar_torch.search import degraded, sifting
from tpulsar_torch.search import report
from tpulsar_torch.search.report import StageTimers


@dataclasses.dataclass
class SearchParams:
    """Search configuration — the JAX package's SearchParams, field for
    field with the same defaults (so provenance() dicts round-trip
    between the packages)."""
    nsub: int = 96
    rfifind_blocklen: int = 2048
    rfi_threshold: float = 4.0
    lo_accel_numharm: int = 16
    lo_accel_zmax: int = 0
    hi_accel_numharm: int = 8
    hi_accel_zmax: int = 50
    run_hi_accel: bool = True
    topk_per_stage: int = 32
    sp_threshold: float = 5.0
    sp_widths: tuple[int, ...] = sp_k.DEFAULT_WIDTHS
    sp_detrend: str = "median"
    sifting: sifting.SiftParams = dataclasses.field(
        default_factory=sifting.SiftParams)
    to_prepfold_sigma: float = 6.0
    max_cands_to_fold: int = 100
    fold_by_rules: bool = True
    fold_batched: bool = True
    fold_nbin: int = 64
    fold_npart: int = 32
    max_dms_per_chunk: int = 128
    spectral_hbm_budget: int = 6 << 30
    seq_shard: str = "auto"
    seq_shard_min_bytes: int = 2 << 30
    block_quantize: str = "auto"
    block_quantize_min: int = 1 << 30
    refine_cands: bool = True
    make_plots: bool = True
    low_T_to_search_s: float = 0.0
    dm_min: float = 0.0
    dm_max: float = 0.0

    def __post_init__(self):
        for field in ("seq_shard", "block_quantize"):
            v = getattr(self, field)
            if v not in ("on", "off", "auto"):
                raise ValueError(
                    f"{field} must be 'on'/'off'/'auto', got {v!r}")

    def provenance(self) -> dict:
        d = dataclasses.asdict(self)
        d["sifting"] = dataclasses.asdict(self.sifting)
        return d

    @classmethod
    def slice_defaults(cls, **kw) -> "SearchParams":
        """The zero-acceleration configuration (BASELINE config 2): the
        defaults with the hi-accel stage, refinement, folding and plots
        switched off (what `tpulsar search --no-accel` runs, minus the
        folds)."""
        base = dict(run_hi_accel=False, refine_cands=False,
                    max_cands_to_fold=0, make_plots=False)
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_config(cls, searching) -> "SearchParams":
        """Build from a SearchingConfig domain (config/), so a queued
        beam job honours the operator's searching settings — the JAX
        package's mapping, field for field."""
        return cls(
            nsub=searching.nsub,
            lo_accel_numharm=searching.lo_accel_numharm,
            lo_accel_zmax=searching.lo_accel_zmax,
            hi_accel_numharm=searching.hi_accel_numharm,
            hi_accel_zmax=searching.hi_accel_zmax,
            run_hi_accel=searching.use_hi_accel
            and searching.hi_accel_zmax > 0,
            sp_threshold=searching.singlepulse_threshold,
            sifting=sifting.SiftParams(
                sigma_threshold=searching.sifting_sigma_threshold,
                r_err=searching.sifting_r_err,
                min_num_dms=searching.sifting_min_num_dms,
                low_dm_cutoff=searching.sifting_low_dm_cutoff),
            to_prepfold_sigma=searching.to_prepfold_sigma,
            max_cands_to_fold=searching.max_cands_to_fold,
            low_T_to_search_s=searching.low_T_to_search,
            dm_min=searching.dm_min,
            dm_max=searching.dm_max)


class TooShortToSearchError(ValueError):
    """Observation below the low_T_to_search threshold."""


@dataclasses.dataclass
class SearchOutcome:
    basenm: str
    resultsdir: str
    candidates: list[sifting.Candidate]
    folded: list
    sp_events: np.ndarray
    masked_fraction: float
    num_dm_trials: int
    timers: StageTimers
    refined_dms: list[float] = dataclasses.field(default_factory=list)
    #: library lookups attributable to THIS beam
    #: (kernels/cuda_dd.COMPILES, the tally of aot/warmstart.py: a
    #: library found built, a library compiled by nvcc or g++).  A
    #: resident server's steady state is compile_misses == 0: the
    #: beam paid no compile.
    compile_hits: int = 0
    compile_misses: int = 0


def check_supported(mesh, dev) -> None:
    """Refuse a mesh whose devices are not of the entry's device type
    (the block is formed on `dev` and sharded from there; the package
    never moves work to another kind of device on its own).  Every
    SearchParams field runs; SearchParams validates its own values."""
    if mesh is not None and mesh.device_type != torch.device(dev).type:
        raise ValueError(f"mesh on {mesh.device_type} devices for a "
                         f"search on {torch.device(dev)}: pass a mesh "
                         f"of the entry's device type")


def search_beam(fns: list[str], workdir: str, resultsdir: str,
                params: SearchParams | None = None,
                zaplist: np.ndarray | None = None,
                plan: list[ddplan.DedispStep] | None = None,
                baryv: float | None = None,
                checkpoint_dir: str | None = None,
                checkpoint_journal=None,
                mesh=None, device=None) -> SearchOutcome:
    """Search one beam end-to-end and write the results directory.

    device: where the search runs, "cuda" by default; without a GPU
    the caller must pass device="cpu" (the plain PyTorch versions of
    the kernels then run).

    baryv: average barycentric velocity (v/c) of the observation; None
    computes it from the beam header, 0.0 disables the correction.

    checkpoint_dir: pass-level crash resume (checkpoint/) — the RFI
    mask, every DDplan pass's partials, the sifted list and each
    folded candidate are durably checkpointed with sha256 manifest
    entries, and a re-entered search verifies the manifest and
    recomputes only what is missing or corrupt.  checkpoint_journal:
    optional ``callable(event, **extra)`` that receives the
    ``resume`` / ``pass_complete`` / ``checkpoint_invalid`` /
    ``checkpoint_disabled`` events.  mesh: as search_block's."""
    params = params or SearchParams()
    dev = resolve_device(device)
    check_supported(mesh, dev)
    compiles0 = dict(cuda_dd.COMPILES)
    if trace_mod.enabled():
        # one trace file per beam: its rollup matches THIS beam's
        # .report, not every beam this process searched
        trace_mod.start(clear=True)
    # metrics.json is the registry's DELTA over this beam
    metrics_base = telemetry.metrics.REGISTRY.snapshot()
    os.makedirs(workdir, exist_ok=True)
    os.makedirs(resultsdir, exist_ok=True)

    obj, si, basenm, plan, nsub, baryv, data_id = _beam_geometry(
        fns, params, plan, baryv)
    timers = StageTimers()
    timers.bind_if_traced(dev)
    store = None
    if checkpoint_dir:
        # opened here (not in search_block) so the RFI mask and the
        # fold artifacts checkpoint too, not just the pass loop
        store = _open_checkpoint(
            checkpoint_dir,
            _ckpt_fingerprint(plan, params, zaplist, baryv, nsub,
                              data_id=data_id),
            checkpoint_journal)
    data, mask = _read_and_mask(si, params, basenm, resultsdir, store,
                                timers, dev)
    res = _search_block(data, si.freqs, si.dt, plan, params, zaplist,
                        baryv, nsub, timers, store, None, dev, mesh)
    out = _finalize_results(
        resultsdir, basenm, obj, si, plan, params, zaplist, baryv,
        data, mask, res, timers, metrics_base)
    out.compile_hits = cuda_dd.COMPILES["hits"] - compiles0["hits"]
    out.compile_misses = cuda_dd.COMPILES["misses"] - compiles0["misses"]
    return out


def _beam_geometry(fns, params, plan, baryv):
    """Header-derived per-beam facts needed before any device work:
    the data object, the DDplan, the effective nsub, the barycentric
    velocity, and the checkpoint data_id (file names/sizes/MJD + block
    shape, as the JAX package spells it — another beam's dumps must
    never be resumed)."""
    obj = datafile.autogen_dataobj(fns)
    si = obj.specinfo
    if baryv is None:
        baryv = _compute_baryv(si)
    if si.T < params.low_T_to_search_s:
        raise TooShortToSearchError(
            f"observation is {si.T:.1f} s < low_T_to_search "
            f"{params.low_T_to_search_s:.1f} s "
            f"(reference PALFA2_presto_search.py:450)")
    basenm = os.path.splitext(os.path.basename(sorted(fns)[0]))[0]
    nsub = params.nsub if si.num_channels % params.nsub == 0 else \
        ddplan.largest_divisor_leq(si.num_channels, params.nsub)
    if plan is None:
        plan, _obs, nsub = ddplan.plan_for(
            si, lodm=params.dm_min,
            hidm=params.dm_max if params.dm_max > 0 else 1000.0,
            numsub=params.nsub)
    shape_id = (f"({si.num_channels}, {int(si.N)})|{si.dt!r}|"
                f"{si.freqs[0]!r}|{si.freqs[-1]!r}")
    data_id = ";".join(
        f"{os.path.basename(fn)}:{os.path.getsize(fn)}" for fn in
        sorted(fns)) + f"|mjd={float(si.start_MJD[0])!r}" \
        + "|" + shape_id
    return obj, si, basenm, plan, nsub, baryv, data_id


# ------------------------------------------------------ batch of beams

@dataclasses.dataclass
class BeamSpec:
    """One beam's inputs to :func:`search_beam_batch` — exactly the
    arguments :func:`search_beam` takes, as data."""
    fns: list[str]
    workdir: str
    resultsdir: str
    zaplist: np.ndarray | None = None
    baryv: float | None = None
    checkpoint_dir: str | None = None
    checkpoint_journal: object = None
    #: ticket id / display label for telemetry and error reporting
    label: str = ""


@dataclasses.dataclass
class BeamBatchResult:
    """Per-beam outcome of a batch dispatch: the SearchOutcome (or the
    per-beam error — one beam's failure never fails its batchmates),
    plus which path searched it."""
    spec: BeamSpec
    outcome: SearchOutcome | None = None
    error: BaseException | None = None
    path: str = "solo"             # "batched" | "solo"
    group_size: int = 1
    fallout: str = ""              # why a beam left the batch


def search_beam_batch(specs: list[BeamSpec],
                      params: SearchParams | None = None,
                      cap: int = 0, progress_cb=None,
                      device=None) -> list[BeamBatchResult]:
    """Search B beams, coalescing compatibility-keyed groups into one
    dispatch stream (kernels/beam_batch.py): stage 1 runs once a pass
    over the group's stacked channel blocks and stage 2 once a chunk
    through the CUDA kernel's beam axis; the stages after
    dedispersion run on each beam's rows at the solo shapes.

    Per-beam results discipline is preserved: every beam keeps its own
    results directory, checkpoint store (pass artifacts sliced out of
    the batched arrays — byte-identical to a solo run's), journal
    chain, and SearchOutcome.  A beam that cannot ride the batch
    (checkpoint resume state, incompatible geometry, an unreadable
    input, a ragged group remainder, or any failure inside the
    coalesced section) falls out to the solo path; it never fails its
    batchmates.  ``cap`` pins the largest coalesced group (0 =
    TPULSAR_BEAM_BATCH, then the working-set budget); group sizes are
    quantized to the BATCH_QUANTA ladder either way.  device: as
    search_beam's."""
    params = params or SearchParams()
    dev = resolve_device(device)
    results = [BeamBatchResult(spec=s) for s in specs]

    preludes: dict[int, tuple] = {}
    solo: dict[int, str] = {}
    groups: dict[str, list[int]] = {}
    for i, spec in enumerate(specs):
        try:
            pre = _beam_geometry(spec.fns, params, None, spec.baryv)
        except Exception:
            # unreadable header or too-short beam: the solo path
            # surfaces the same error (or clean skip) attributably
            solo[i] = "prelude_failed"
            continue
        preludes[i] = pre
        if spec.checkpoint_dir and _has_resume_state(spec.checkpoint_dir):
            # resume state binds the beam to the solo path: resuming
            # SKIPS completed passes, and a group runs every pass for
            # every member
            solo[i] = "resume"
            continue
        _obj, si, _basenm, plan, nsub, _baryv, _data_id = pre
        key = bb.compat_key(si.num_channels, int(si.N), float(si.dt),
                            float(si.freqs[0]), float(si.freqs[-1]),
                            nsub, plan, params,
                            zap_digest=bb.zaplist_digest(spec.zaplist))
        groups.setdefault(key, []).append(i)

    cap = cap or bb.beam_batch_cap()
    for idxs in groups.values():
        if cap == 1 or len(idxs) == 1:
            for i in idxs:
                solo.setdefault(i, "no_batchmates" if len(idxs) == 1
                                else "cap_1")
            continue
        _obj, si, _basenm, plan, _nsub, _baryv, _id = preludes[idxs[0]]
        eff_cap = min(cap or len(idxs),
                      _budget_beam_cap(si, plan, params, dev))
        for members in bb.plan_beam_groups(len(idxs), cap=eff_cap).groups:
            sub = [idxs[m] for m in members]
            if len(sub) == 1:
                solo.setdefault(sub[0], "ragged_remainder")
                continue
            try:
                outcomes = _search_group(
                    [specs[i] for i in sub], [preludes[i] for i in sub],
                    params, progress_cb, dev)
            except Exception as e:
                warnings.warn(
                    f"coalesced {len(sub)}-beam group failed ({e}); "
                    f"every member degrades to the solo path")
                for i in sub:
                    solo.setdefault(i, "group_failed")
                continue
            for i, out in zip(sub, outcomes):
                results[i].outcome = out
                results[i].path = "batched"
                results[i].group_size = len(sub)
                telemetry.beam_batch_beams_total().inc(path="batched")

    for i, reason in sorted(solo.items()):
        spec = specs[i]
        results[i].fallout = reason
        try:
            results[i].outcome = search_beam(
                spec.fns, spec.workdir, spec.resultsdir, params,
                zaplist=spec.zaplist, baryv=spec.baryv,
                checkpoint_dir=spec.checkpoint_dir,
                checkpoint_journal=spec.checkpoint_journal, device=dev)
        except Exception as e:
            results[i].error = e
        telemetry.beam_batch_beams_total().inc(path="solo")
        if results[i].outcome is not None:
            telemetry.beam_batch_trials_total().inc(
                results[i].outcome.num_dm_trials, path="solo")
    return results


def _has_resume_state(checkpoint_dir: str) -> bool:
    try:
        return ckpt_mod.progress_marker(checkpoint_dir) > 0
    except OSError:
        return False


def _budget_beam_cap(si, plan, params: SearchParams, dev) -> int:
    """How many beams the coalesced working set affords for this
    geometry on ``dev`` (beam_batch.budget_beams with the executor's
    own block and chunk arithmetic, against the device's budget)."""
    f32_bytes = int(si.N) * si.num_channels * 4
    quantize = (params.block_quantize == "on"
                or (params.block_quantize == "auto"
                    and f32_bytes > params.block_quantize_min))
    block_bytes = f32_bytes // 4 if quantize else f32_bytes
    step0 = plan[0]
    nfft = ddplan.choose_n(int(si.N) // step0.downsamp)
    chunk_rows = pass_chunk_size(int(step0.dms_per_pass), nfft, params)
    return bb.budget_beams(block_bytes, chunk_rows, nfft,
                           bb.beam_budget_bytes(dev))


def _search_group(specs: list[BeamSpec], pres: list[tuple],
                  params: SearchParams, progress_cb,
                  dev) -> list[SearchOutcome]:
    """One coalesced group end to end.  All members share a compat
    key, so the plan geometry, nsub, dt and channel table are
    identical; what stays per beam is the data block, the RFI mask,
    the zaplist/baryv-derived keep mask, the checkpoint store, and
    everything after the plan loop (sift, refine, fold, artifacts),
    which runs through the solo path's own helpers."""
    B = len(specs)
    _obj0, si0, _b0, plan, nsub, _bv0, _id0 = pres[0]
    freqs, dt = si0.freqs, si0.dt
    compiles0 = dict(cuda_dd.COMPILES)

    degraded.reset()
    if trace_mod.enabled():
        trace_mod.start(clear=True)
    metrics_base = telemetry.metrics.REGISTRY.snapshot()
    timers = StageTimers()
    timers.bind_if_traced(dev)

    stores, datas, masks = [], [], []
    for spec, (obj, si, basenm, _plan, _nsub, baryv, data_id) in zip(
            specs, pres):
        os.makedirs(spec.workdir, exist_ok=True)
        os.makedirs(spec.resultsdir, exist_ok=True)
        store = None
        if spec.checkpoint_dir:
            store = _open_checkpoint(
                spec.checkpoint_dir,
                _ckpt_fingerprint(plan, params, spec.zaplist, baryv,
                                  nsub, data_id=data_id),
                spec.checkpoint_journal)
        data, mask = _read_and_mask(si, params, basenm, spec.resultsdir,
                                    store, timers, dev)
        stores.append(store)
        datas.append(data)
        masks.append(mask)
    # the group's stage-1 input, and each beam's block a view of it
    stacked = bb.stack_blocks(datas)
    datas = list(stacked.split(datas[0].shape[0]))

    telemetry.beam_batch_occupancy().set(B)
    with trace_mod.span("search_beam_batch", nbeams=B,
                        npasses=sum(s.numpasses for s in plan)):
        with timers.attached(dev):
            per = _group_plan_loop(stacked, freqs, dt, plan, params,
                                   [s.zaplist for s in specs],
                                   [p[5] for p in pres], nsub, timers,
                                   stores, progress_cb, dev)
        # per-beam attribution past this point: the plan loop's delta
        # is SHARED (one dispatch stream served the whole group, so
        # every member's metrics.json carries it), but each beam's
        # sift/fold/finalize runs on its own, so its counters and
        # stage seconds land only in ITS results directory
        group_delta = telemetry.metrics.diff_snapshots(
            telemetry.metrics.REGISTRY.snapshot(), metrics_base)
        outcomes = []
        for b, (spec, pre) in enumerate(zip(specs, pres)):
            obj, si, basenm, _plan, _nsub, baryv, _id = pre
            finish_base = telemetry.metrics.REGISTRY.snapshot()
            timers_b = StageTimers()
            timers_b.times = dict(timers.times)
            res = _sift_fold_finish(
                datas[b], freqs, dt, params, spec.zaplist, baryv, nsub,
                timers_b, stores[b], per[b]["cands"], per[b]["sp"],
                per[b]["ntr"], None, plan)
            outcomes.append(_finalize_results(
                spec.resultsdir, basenm, obj, si, plan, params,
                spec.zaplist, baryv, datas[b], masks[b], res, timers_b,
                finish_base, metrics_extra=group_delta))
    for out in outcomes:
        out.compile_hits = cuda_dd.COMPILES["hits"] - compiles0["hits"]
        out.compile_misses = (cuda_dd.COMPILES["misses"]
                              - compiles0["misses"])
    return outcomes


def _group_plan_loop(stacked, freqs, dt, plan, params, zaplists,
                     baryvs, nsub, timers, stores, progress_cb, dev):
    """The coalesced plan loop: every pass's stage 1 is one launch
    over the beams' stacked channel blocks and every chunk's stage 2
    one launch of the beam axis; the tree family instead runs its
    levels and residuals per beam, as the solo loop does.  The stages after dedispersion run
    on each beam's rows at the solo shapes (torch's CUDA reductions
    choose their launch shape from the row count, which would make a
    row's sums depend on its batchmates; the reference hands them
    B*chunk rows).  Chunk boundaries are the SOLO pass_chunk_size, so
    each beam's candidates, SP events and per-pass checkpoint
    artifacts are byte-identical to a solo run's."""
    B = len(stores)
    per = [{"cands": [], "sp": [], "ntr": 0} for _ in range(B)]
    npasses = sum(s.numpasses for s in plan)
    pass_idx = -1
    sp_est = sp_k.detrend_estimator(params.sp_detrend)

    for step_idx, step in enumerate(plan):
        for ppass in step.passes():
            pass_idx += 1
            starts = [(len(p["cands"]), len(p["sp"]), p["ntr"])
                      for p in per]
            dms = np.asarray(ppass.dms)
            with timers.timing("subbanding"):
                chan_shifts, sub_shifts = dd.plan_pass_shifts(
                    freqs, nsub, ppass.subdm, dms, dt, step.downsamp)
                subb_all = bb.form_subbands_beams(
                    stacked, chan_shifts, B, nsub, step.downsamp)
                _fence(dev)
            T_ds = int(subb_all.shape[1])
            dt_ds = dt * step.downsamp
            chunk_sz = pass_chunk_size(len(dms), ddplan.choose_n(T_ds),
                                       params)
            t_dd0 = timers.times.get("dedispersing", 0.0)
            # per-beam levels: the solo program, so the tree family's
            # summation order is untouched
            levels = [_tree_levels(subb_all[b * nsub:(b + 1) * nsub],
                                   sub_shifts, T_ds, timers, dev)
                      for b in range(B)]
            tree_plan = levels[0][0]
            fam = "direct" if tree_plan is None else "tree"

            # per-beam keep masks for this pass's spectrum length
            nfft = ddplan.choose_n(T_ds)
            nbins = nfft // 2 + 1
            T_s = nfft * dt_ds
            keeps = [fr.zap_mask(nbins, T_s, z, bv) if z is not None
                     else None for z, bv in zip(zaplists, baryvs)]

            pending: list[list] = [[] for _ in range(B)]
            for lo in range(0, len(dms), chunk_sz):
                dm_chunk = dms[lo: lo + chunk_sz]
                n = len(dm_chunk)
                with trace_mod.span("beam_batch_chunk",
                                    pass_idx=pass_idx, lo=int(lo),
                                    n=int(n), nbeams=B):
                    with timers.timing("dedispersing"):
                        if tree_plan is not None:
                            pairs = [tree_dd.residual_series(
                                parts, tree_plan, lo, n, T=T_ds,
                                fuse=True, estimator=sp_est)
                                for _plan, parts in levels]
                        else:
                            series = bb.dedisperse_beams(
                                subb_all, sub_shifts[lo: lo + n], B)
                            pairs = [(series[b * n:(b + 1) * n], None)
                                     for b in range(B)]
                            del series
                        _fence(dev)
                    # the stages after dedispersion run per beam, at the
                    # solo shapes: torch's CUDA reductions pick their
                    # launch shape from the row count, so a row's sums
                    # would depend on its batchmates
                    for b in range(B):
                        pending[b].append(_chunk_stages(
                            *pairs[b], dm_chunk, nfft, T_s, keeps[b],
                            params, timers, dev))
                    del pairs

            for b in range(B):
                cands, events = _drain(pending[b], dt_ds, T_s, nbins,
                                       params, timers)
                per[b]["cands"].extend(cands)
                per[b]["sp"].extend(events)
                per[b]["ntr"] += len(dms)
            del pending, subb_all, levels
            telemetry.dedisp_trials_total().inc(B * len(dms), family=fam)
            telemetry.dedisp_stage_seconds().observe(
                timers.times.get("dedispersing", 0.0) - t_dd0,
                family=fam)
            telemetry.passes_total().inc(B)
            telemetry.dm_trials_total().inc(B * len(dms))
            telemetry.beam_batch_trials_total().inc(B * len(dms),
                                                    path="batched")
            for b, store in enumerate(stores):
                if store is None:
                    continue
                c0, s0, t0 = starts[b]
                ntr_pass = per[b]["ntr"] - t0
                with report.checkpoint_save():
                    durable = store.save(
                        f"pass_{pass_idx:04d}",
                        _encode_pass(
                            per[b]["cands"][c0:],
                            (np.concatenate(per[b]["sp"][s0:])
                             if len(per[b]["sp"]) > s0 else _EMPTY_SP),
                            ntr_pass),
                        kind="pass", ext=".npz", pass_idx=pass_idx)
                    if durable:
                        store.journal("pass_complete",
                                      pass_idx=pass_idx,
                                      npasses=npasses, ntrials=ntr_pass)
            timers.resolve()
            if progress_cb is not None:
                progress_cb({
                    "pass_idx": pass_idx + 1, "npasses": npasses,
                    "step_idx": step_idx, "nbeams": B,
                    "ntrials_done": per[0]["ntr"],
                    "ncands": sum(len(p["cands"]) for p in per),
                    "stage_s": {k: round(v, 2)
                                for k, v in timers.times.items() if v},
                })
    return per


def _fence(dev: torch.device) -> None:
    """Wait for the device, so that the wall-clock StageTimers.times
    of a scope hold the device work it enqueued (kernels launch
    asynchronously).  Only those wall times need it: the record's
    device seconds come from CUDA events (search/report.py).  The wait
    counts as host-wait:fence."""
    if dev.type == "cuda":
        with report.host_wait("fence", dev):
            torch.cuda.synchronize(dev)


def _read_and_mask(si, params, basenm, resultsdir, store, timers, dev):
    """Read the beam block, move it to the device channel-major in its
    native dtype, find and apply the RFI mask (checkpoint-aware).
    Returns the masked (nchan, T) tensor and the RFIMask.  The mask
    artifact lands in resultsdir and, when a store is open, in the
    checkpoint manifest, so a resumed beam rewrites the byte-identical
    mask file without recomputing it."""
    f32_bytes = int(si.N) * si.num_channels * 4
    quantize = (params.block_quantize == "on"
                or (params.block_quantize == "auto"
                    and f32_bytes > params.block_quantize_min))
    with timers.timing("read"):
        if quantize:
            block, qscale, qoff = si.read_all_uint8()
        else:
            block = si.read_all()             # (T, nchan) ascending freq
            qscale = qoff = None
    with timers.timing("rfifind"):
        # one transfer in the file's (T, nchan) order, one transpose on
        # the device: the block lives channel-major in its native dtype
        data = torch.from_numpy(block).to(dev).T.contiguous()
        del block
        mask_path = os.path.join(resultsdir, f"{basenm}_rfifind.npz")
        payload = store.load("rfi_mask") if store is not None else None
        if payload is not None:
            # resume: the verified checkpoint payload IS the output
            # artifact — byte-identical mask file, no recompute
            with open(mask_path, "wb") as fh:
                fh.write(payload)
            mask = rfi_k.RFIMask.load(mask_path)
        else:
            mask = rfi_k.find_rfi_chan(data, si.dt,
                                       block_len=params.rfifind_blocklen,
                                       threshold=params.rfi_threshold)
            # the quantization affine travels with the mask (chan_fill
            # is in quantized units when it is present)
            mask.save(mask_path, qscale=qscale, qoff=qoff)
            if store is not None:
                with open(mask_path, "rb") as fh:
                    store.save("rfi_mask", fh.read(), kind="stage",
                               ext=".npz")
        data = rfi_k.apply_mask_chan(data, mask.full_mask(),
                                     mask.chan_fill, mask.block_len)
        _fence(dev)
    return data, mask


def _finalize_results(resultsdir, basenm, obj, si, plan, params,
                      zaplist, baryv, data, mask, res: "_BlockResult",
                      timers, metrics_base,
                      metrics_extra=None) -> SearchOutcome:
    """Write the per-beam results directory (artifacts, plots,
    provenance, report, telemetry delta, tarballs) and build the
    SearchOutcome — shared by the solo and the batch-of-beams paths,
    so a beam's output layout cannot depend on which path searched
    it."""
    final, folded, sp_events, num_trials = res[:4]
    accelcands.write_candlist(
        final, os.path.join(resultsdir, f"{basenm}.accelcands"),
        baryv=baryv)
    if zaplist is not None and len(zaplist):
        with open(os.path.join(resultsdir, f"{basenm}.zaplist"),
                  "w") as fh:
            fh.write("# freq_Hz width_Hz (zaplist used)\n")
            for freq, width in np.atleast_2d(zaplist):
                fh.write(f"{freq:12.4f} {width:10.4f}\n")
    _write_sp_files(resultsdir, basenm, sp_events)
    for step in plan:
        for ppass in step.passes():
            _write_inf_files(resultsdir, basenm, si,
                             np.asarray(ppass.dms), si.dt * step.downsamp,
                             data.shape[1] // step.downsamp)
    for i, fres in enumerate(folded):
        stem = os.path.join(resultsdir, f"{basenm}_cand{i+1}")
        np.savez_compressed(
            stem + ".pfd.npz", profile=fres.profile,
            subints=fres.subints, period_s=fres.period_s,
            pdot=fres.pdot, dm=fres.dm,
            reduced_chi2=fres.reduced_chi2)
        with open(stem + ".bestprof", "w") as fh:
            fh.write(fres.bestprof_text(si.source))

    if params.make_plots:
        with timers.timing("plotting"):
            from tpulsar_torch.search import plots
            for i, fres in enumerate(folded):
                plots.prepfold_plot(
                    fres,
                    os.path.join(resultsdir, f"{basenm}_cand{i+1}.png"),
                    source=si.source,
                    extra_title=f"{basenm} cand {i+1}")
            plots.single_pulse_plots(
                sp_events, resultsdir, basenm,
                t_obs=data.shape[1] * si.dt)

    _write_header_json(resultsdir, obj)
    deg = degraded.snapshot()
    resc = degraded.provenance_snapshot()
    _write_search_params(resultsdir, params, basenm, si, num_trials,
                         baryv=baryv, degraded_modes=deg,
                         rescued_modes=resc)
    timers.write_report(os.path.join(resultsdir, f"{basenm}.report"),
                        basenm, degraded=deg, rescued=resc)
    # telemetry artifacts ride with the beam: the Chrome-trace file
    # (TPULSAR_TRACE=1) and the per-beam metrics delta
    if trace_mod.enabled():
        trace_mod.save(os.path.join(resultsdir,
                                    f"{basenm}_trace.json"))
    mdelta = telemetry.metrics.diff_snapshots(
        telemetry.metrics.REGISTRY.snapshot(), metrics_base)
    if metrics_extra is not None:
        # batch path: the group-shared plan-loop delta composed with
        # this beam's own finish-phase delta (metrics_base was taken
        # at the start of this beam's finish, not the group's)
        mdelta = telemetry.metrics.merge_deltas(metrics_extra, mdelta)
    with open(os.path.join(resultsdir, "metrics.json"), "w") as fh:
        json.dump(mdelta, fh, indent=1)
    _tar_result_classes(resultsdir, basenm)
    return SearchOutcome(basenm=basenm, resultsdir=resultsdir,
                         candidates=final, folded=folded,
                         sp_events=sp_events,
                         masked_fraction=mask.masked_fraction,
                         num_dm_trials=num_trials, timers=timers,
                         refined_dms=res.refined_dms)


def _budget_dm_chunk(nfft: int, hi: bool, budget: int) -> int:
    """Largest DM chunk whose per-trial spectral working set fits the
    spectral memory budget (the JAX package's arithmetic, kept so both
    packages chunk every pass identically)."""
    per_trial = (4 + 4 + 4 + 2 + 2 + 4 + 4 + 4
                 + (2 if hi else 8)) * nfft
    return max(4, int(budget // per_trial))


def pass_chunk_size(ndms: int, nfft: int, params: SearchParams) -> int:
    """The DM-chunk size a pass runs with: the memory budget and
    max_dms_per_chunk cap, then an even split (76 trials at a 51-trial
    budget run as 38+38, not 51+25)."""
    chunk_sz = min(params.max_dms_per_chunk,
                   _budget_dm_chunk(
                       nfft,
                       hi=params.run_hi_accel and params.hi_accel_zmax > 0,
                       budget=params.spectral_hbm_budget))
    chunk_sz = min(chunk_sz, ndms)
    n_chunks = -(-ndms // chunk_sz)
    return -(-ndms // n_chunks)


def search_block(data, freqs: np.ndarray, dt: float,
                 plan: list[ddplan.DedispStep],
                 params: SearchParams | None = None,
                 zaplist: np.ndarray | None = None, baryv: float = 0.0,
                 nsub: int | None = None,
                 timers: StageTimers | None = None,
                 checkpoint_dir: str | None = None,
                 data_id: str = "",
                 checkpoint_journal=None,
                 progress_cb=None,
                 mesh=None, device=None):
    """Run the plan loop, sifting, refinement and folding on an
    in-memory (nchan, T) block (uint8 or float32; a numpy array or a
    tensor, moved to `device`).

    checkpoint_dir: when set, per-pass candidate dumps (plus the
    sifted list and each folded candidate) are written there as
    sha256-manifested artifacts (checkpoint/) and completed work is
    verified and skipped on re-entry.  data_id identifies the input
    beam; it is folded into the checkpoint fingerprint with the
    block's shape, so another beam's dumps in the same directory are
    never resumed.  checkpoint_journal: see search_beam.

    progress_cb: optional callable(dict) invoked after every completed
    dedispersion pass with {pass_idx, npasses, step_idx, ntrials_done,
    ncands, stage_s}.

    mesh: a parallel.mesh.Mesh of `device`'s type (make_mesh) — each
    pass's DM trials are sharded over its dm axis (dedispersion,
    single-pulse, lo and hi stages run per shard; the per-trial top-k
    blocks are gathered), or its time axis (params.seq_shard).  None
    = one device.  Candidates are those of the single-device path up
    to float reduction order.

    Returns (candidates, folded, sp_events, num_dm_trials): folded[k]
    is the fold of candidates[k]."""
    params = params or SearchParams()
    dev = resolve_device(device)
    check_supported(mesh, dev)
    nchan = data.shape[0]
    nsub = nsub or (params.nsub if nchan % params.nsub == 0
                    else ddplan.largest_divisor_leq(nchan, params.nsub))
    store = None
    if checkpoint_dir:
        shape_id = (f"{tuple(data.shape)}|{dt!r}|{freqs[0]!r}|"
                    f"{freqs[-1]!r}")
        store = _open_checkpoint(
            checkpoint_dir,
            _ckpt_fingerprint(plan, params, zaplist, baryv, nsub,
                              data_id=data_id + "|" + shape_id),
            checkpoint_journal)
    res = _search_block(data, freqs, dt, plan, params, zaplist, baryv,
                        nsub, timers, store, progress_cb, dev, mesh)
    return res.final, res.folded, res.sp_events, res.num_trials


class _BlockResult(NamedTuple):
    final: list
    folded: list
    sp_events: np.ndarray
    num_trials: int
    refined_dms: list[float]     # the DM groups refinement dedispersed


def _block_profiler(dev: torch.device):
    """TPULSAR_PROFILE=<dir>: a torch profiler trace of the whole block
    search, the counterpart of the JAX package's jax.profiler.trace
    (view the <host>_<pid>.<ts>.pt.trace.json.gz in Perfetto or
    TensorBoard).  Read per call; unset is a null context.  The
    directory is made before the search starts, and a profiler that
    cannot start or export raises: a search with the knob set never
    runs unprofiled."""
    profile_dir = os.environ.get("TPULSAR_PROFILE", "").strip()
    if not profile_dir:
        return contextlib.nullcontext()
    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, on_trace_ready=_trace_writer(profile_dir))


def _trace_writer(profile_dir: str):
    """The profiler's on_trace_ready: the file
    torch.profiler.tensorboard_trace_handler(dir, use_gzip=True)
    writes, <host>_<pid>.<ns>.pt.trace.json.gz, but gzipped at level 1
    from a raw export beside it: for a quarter Mock beam's 424 MB
    trace the handler's level 9 took 17.9 s on an H100 machine's host,
    level 1 2.6 s, for a 1.4x larger file
    (tools/torch_profile_cost.py)."""
    def write(prof) -> None:
        name = (f"{socket.gethostname()}_{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json")
        raw = os.path.join(profile_dir, name)
        try:
            prof.export_chrome_trace(raw)
            with open(raw, "rb") as fin, \
                    gzip.open(raw + ".gz", "wb", compresslevel=1) as fout:
                shutil.copyfileobj(fin, fout, 1 << 20)
        except BaseException:
            with contextlib.suppress(FileNotFoundError):
                os.remove(raw + ".gz")
            raise
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(raw)
    return write


def _search_block(data, freqs, dt, plan, params, zaplist, baryv, nsub,
                  timers, store, progress_cb, dev, mesh) -> _BlockResult:
    """search_block's body, on a checked configuration and device,
    under the trace's search_block root span (and, with
    TPULSAR_PROFILE set, inside a profiler whose stop and export fall
    outside that span)."""
    timers = timers or StageTimers()
    degraded.reset()
    with _block_profiler(dev), timers.attached(dev):
        # one root name for the profile and the port's own trace (the
        # span opens the profiler's range while a profiler runs)
        with trace_mod.span("search_block",
                            npasses=sum(s.numpasses for s in plan)):
            return _search_block_inner(data, freqs, dt, plan, params,
                                       zaplist, baryv, nsub, timers,
                                       store, progress_cb, dev, mesh)


def _search_block_inner(data, freqs, dt, plan, params, zaplist, baryv,
                        nsub, timers, store, progress_cb, dev,
                        mesh) -> _BlockResult:
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data))
    data = data.to(dev).contiguous()

    all_cands: list[sifting.Candidate] = []
    sp_chunks: list[np.ndarray] = []
    num_trials = 0
    npasses = sum(s.numpasses for s in plan)
    pass_idx = -1
    # a verified 'sifted' artifact short-circuits the whole plan loop
    # (and sifting and refinement): the crash being resumed happened
    # during folding, and every pass's science is already inside it
    sifted_state = (_load_decoded(store, "sifted", _decode_sifted)
                    if store is not None else None)
    for step_idx, step in enumerate(plan):
        if sifted_state is not None:
            break
        for ppass in step.passes():
            pass_idx += 1
            if store is not None:
                done = _load_decoded(store, f"pass_{pass_idx:04d}",
                                     _decode_pass)
                if done is not None:
                    cands, events, ntr = done
                    all_cands.extend(cands)
                    if len(events):
                        sp_chunks.append(events)
                    num_trials += ntr
                    continue
            pass_cands_start = len(all_cands)
            pass_sp_start = len(sp_chunks)
            pass_trials_start = num_trials
            with timers.timing("subbanding"):
                chan_shifts, sub_shifts = dd.plan_pass_shifts(
                    freqs, nsub, ppass.subdm, np.asarray(ppass.dms),
                    dt, step.downsamp)
                subb = dd.form_subbands(data, chan_shifts, nsub,
                                        step.downsamp)
                _fence(dev)
            dt_ds = dt * step.downsamp
            dms = np.asarray(ppass.dms)
            if mesh is not None:
                # the mesh shards the direct kernel; the tree family
                # is the single-device path's, as in the reference
                with timers.timing("sharded-search"):
                    cands, events = _search_pass_sharded(
                        mesh, subb, sub_shifts, dms, dt_ds, params,
                        zaplist, baryv)
                events = [events] if len(events) else []
            else:
                cands, events = _search_pass(
                    subb, sub_shifts, dms, dt_ds, pass_idx, params,
                    zaplist, baryv, timers, dev)
            del subb
            all_cands.extend(cands)
            sp_chunks.extend(events)
            num_trials += len(dms)
            if store is not None:
                ntr_pass = num_trials - pass_trials_start
                with report.checkpoint_save():
                    durable = store.save(
                        f"pass_{pass_idx:04d}",
                        _encode_pass(
                            all_cands[pass_cands_start:],
                            (np.concatenate(sp_chunks[pass_sp_start:])
                             if len(sp_chunks) > pass_sp_start
                             else _EMPTY_SP),
                            ntr_pass),
                        kind="pass", ext=".npz", pass_idx=pass_idx)
                    if durable:
                        # journaled ONLY once the artifact is durable:
                        # a consumer reads this event as "never
                        # recompute pass k again"
                        store.journal("pass_complete",
                                      pass_idx=pass_idx,
                                      npasses=npasses,
                                      ntrials=ntr_pass)
            telemetry.passes_total().inc()
            telemetry.dm_trials_total().inc(len(dms))
            # the pass drained: its scopes' events are read here
            timers.resolve()
            if progress_cb is not None:
                progress_cb({
                    "pass_idx": pass_idx + 1, "npasses": npasses,
                    "step_idx": step_idx, "ntrials_done": num_trials,
                    "ncands": len(all_cands),
                    "stage_s": {k: round(v, 2)
                                for k, v in timers.times.items() if v},
                })

    return _sift_fold_finish(data, freqs, dt, params, zaplist, baryv,
                             nsub, timers, store, all_cands, sp_chunks,
                             num_trials, sifted_state, plan)


def _search_pass(subb, sub_shifts, dms, dt_ds, pass_idx, params,
                 zaplist, baryv, timers, dev) -> tuple:
    """One dedispersion pass on one device, in DM chunks: stage 2 (the
    direct kernel, or the shift tree where kernels/tree_dd.py picks
    it), then _chunk_stages, drained once at the pass's end.  Returns
    (candidates, SP event arrays)."""
    sp_est = sp_k.detrend_estimator(params.sp_detrend)
    T_ds = int(subb.shape[1])
    chunk_sz = pass_chunk_size(len(dms), ddplan.choose_n(T_ds),
                               params)
    t_dd0 = timers.times.get("dedispersing", 0.0)
    # the stage-2 family of THIS pass (kernels/tree_dd.py): tree
    # passes run the shared merge levels once here, and each
    # chunk below pays only its residual layer, with the SP
    # detrend fused into it
    tree_plan, tree_parts = _tree_levels(subb, sub_shifts, T_ds,
                                         timers, dev)
    fam = "direct" if tree_parts is None else "tree"
    # FFT-friendly padded length (reference: PRESTO choose_N via
    # prepsubband -numout)
    nfft = ddplan.choose_n(T_ds)
    nbins = nfft // 2 + 1
    T_s = nfft * dt_ds
    keep = fr.zap_mask(nbins, T_s, zaplist, baryv) \
        if zaplist is not None else None
    # top-k-sized device outputs are held to one host transfer
    # per pass; event and candidate order is chunk order
    pending: list[tuple] = []
    for lo in range(0, len(dms), chunk_sz):
        dm_chunk = dms[lo: lo + chunk_sz]
        # per-chunk child span: the stage scopes below nest
        # under it, so the trace shows the pass/chunk structure
        with trace_mod.span("dm_chunk", pass_idx=pass_idx,
                            lo=int(lo), n=int(len(dm_chunk)),
                            family=fam):
            with timers.timing("dedispersing"):
                if tree_parts is not None:
                    series, norm = tree_dd.residual_series(
                        tree_parts, tree_plan, lo, len(dm_chunk),
                        T=T_ds, fuse=True, estimator=sp_est)
                else:
                    series = dd.dedisperse_subbands(
                        subb, sub_shifts[lo: lo + len(dm_chunk)])
                    norm = None
                _fence(dev)
            pending.append(_chunk_stages(
                series, norm, dm_chunk, nfft, T_s, keep, params,
                timers, dev))
            del series, norm

    cands, events = _drain(pending, dt_ds, T_s, nbins, params,
                           timers)
    del pending, tree_parts
    # per-family throughput instruments
    telemetry.dedisp_trials_total().inc(len(dms), family=fam)
    telemetry.dedisp_stage_seconds().observe(
        timers.times.get("dedispersing", 0.0) - t_dd0,
        family=fam)
    return cands, events


def _sharded_chunks(params: SearchParams, n_dm: int, ndms_pad: int,
                   nbins: int, nz: int, hi_sharded: bool, device
                   ) -> tuple[int, list[int]]:
    """The sharded pass's DM chunk and each chunk's first trial, over
    a table padded to ndms_pad trials (a multiple of n_dm).  The chunk
    is a multiple of the dm axis, bounded by max_dms_per_chunk and,
    with the hi stage, by plane_dm_chunk rows a shard (the single-
    device hi batch, so a shard's hi call has its shapes).  The last
    chunk is clamped to end at the table's end (the reference's rule,
    which keeps one compiled shape; here it re-covers rows of the
    chunk before it).  Each chunk is n_dm launches of chunk / n_dm
    rows of the stage-2 kernel."""
    chunk = params.max_dms_per_chunk
    if hi_sharded:
        chunk = min(chunk, accel_k.plane_dm_chunk(
            nbins, nz, device=device) * n_dm)
    chunk = min(max(n_dm, (chunk // n_dm) * n_dm), ndms_pad)
    return chunk, [min(c0, ndms_pad - chunk)
                   for c0 in range(0, ndms_pad, chunk)]


def _search_pass_sharded(mesh, subb, sub_shifts, dms, dt_ds,
                         params: SearchParams, zaplist, baryv) -> tuple:
    """One dedispersion pass with the DM axis sharded over the mesh
    (the reference's _search_pass_sharded).

    Runs the single-device chunk loop's pipeline — dedisperse, SP
    boxcars, whiten, lo harmonic stages, hi z-template correlation —
    in each shard per DM chunk (parallel/mesh.sharded_pass_fn), then
    converts the gathered top-k blocks with the same host code.
    Returns (candidates, sp_events).

    Gates, as in the reference: the hi stage runs sharded only when
    the batched hi path is usable and no fault names an accel point
    (else it runs through _hi_accel_pass, the single-device route with
    its ladder); the sequence-parallel front end follows
    params.seq_shard; a per-trial spectrum above
    params.spectral_hbm_budget goes to the distributed-FFT pass."""
    from tpulsar_torch.parallel import dist_fft
    from tpulsar_torch.parallel import mesh as pmesh
    from tpulsar_torch.resilience import faults

    n_dm = int(mesh.shape["dm"])
    T_ds = int(subb.shape[-1])
    nfft = ddplan.choose_n(T_ds)
    nbins = nfft // 2 + 1
    T_s = nfft * dt_ds
    hi = params.run_hi_accel and params.hi_accel_zmax > 0
    # a fault spec naming an accel dispatch point pins the single-
    # device hi route: the sharded pass never dispatches per-row or
    # per-chunk accel work, so the fault would never fire under it
    hi_sharded = (hi and accel_k._batch_path_usable()
                  and not faults.targets_prefix("accel."))
    bank = _get_bank(params.hi_accel_zmax) if hi else None
    nz = len(bank.zs) if hi else 0
    dd_pad = dd._pad_bucket(int(np.asarray(sub_shifts).max(initial=0)))
    # sequence-parallel front end: shard the subband block's TIME axis
    # instead of replicating it, when the halo fits a shard's chunk
    seq = (params.seq_shard == "on"
           or (params.seq_shard == "auto"
               and subb.nelement() * subb.element_size()
               > params.seq_shard_min_bytes))
    seq_ok = (n_dm > 1 and T_ds % n_dm == 0
              and dd_pad <= T_ds // n_dm)
    # a per-trial spectral tail beyond the budget cannot be resharded
    # to whole per-device series: the spectrum itself is distributed
    if (seq_ok and params.seq_shard != "off"
            and dist_fft.spectral_bytes_per_trial(nfft)
            > params.spectral_hbm_budget):
        return pmesh.seq_dist_search(mesh, subb, sub_shifts, dms, dt_ds,
                                     nfft, params)
    if seq and not seq_ok and params.seq_shard == "on":
        warnings.warn(
            f"seq_shard='on' cannot be honoured for this pass "
            f"(n_dm={n_dm}, T'={T_ds}, halo={dd_pad} vs chunk="
            f"{T_ds // max(n_dm, 1)}); falling back to per-device "
            f"subband replication", stacklevel=2)
    spec = pmesh.PassSpec(
        nfft=nfft, max_numharm=params.lo_accel_numharm,
        topk=params.topk_per_stage, sp_widths=tuple(params.sp_widths),
        sp_topk=sp_k.DEFAULT_TOPK,
        sp_detrend=sp_k.detrend_estimator(params.sp_detrend),
        whiten_est=fr.whiten_estimator(),
        hi=hi_sharded, hi_numharm=params.hi_accel_numharm,
        hi_seg=bank.seg if hi_sharded else 0,
        hi_step=bank.step if hi_sharded else 0,
        hi_width=bank.width if hi_sharded else 0,
        hi_nz=nz if hi_sharded else 0,
        dd_pad=dd_pad, seq_sharded=seq and seq_ok)
    fn = pmesh.sharded_pass_fn(mesh, spec)
    keep = fr.zap_mask(nbins, T_s, zaplist, baryv) \
        if zaplist is not None else None
    bank_t = (torch.from_numpy(bank.bank_fft).to(subb.device)
              if hi_sharded else None)

    padded = pmesh.shard_dm_table(np.asarray(sub_shifts), n_dm)
    ndms = len(dms)
    chunk, starts = _sharded_chunks(params, n_dm, len(padded), nbins,
                                    nz, hi_sharded, subb.device)

    stages_lo = fr.harmonic_stages(params.lo_accel_numharm)
    stages_hi = fr.harmonic_stages(params.hi_accel_numharm) if hi else []
    # the gathered blocks' DM-row axis
    row_dim = {"lo_vals": 1, "lo_bins": 1, "sp_snr": 1, "sp_idx": 1,
               "hi_vals": 0, "hi_rbins": 0, "hi_zidx": 0}
    host: dict[str, np.ndarray] = {}
    for s0 in starts:
        out = fn(subb, padded[s0:s0 + chunk], keep, bank_t)
        for k, t in out.items():
            v = t.cpu().numpy()
            d = row_dim[k]
            if k not in host:
                host[k] = np.empty(v.shape[:d] + (len(padded),)
                                   + v.shape[d + 1:], v.dtype)
            host[k][(slice(None),) * d + (slice(s0, s0 + chunk),)] = v

    # both stages search the numbetween=2 half-bin grid (bin_scale)
    lo_res = {h: (host["lo_vals"][si, :ndms], host["lo_bins"][si, :ndms])
              for si, h in enumerate(stages_lo)}
    cands = sifting.make_candidates(
        lo_res, dms, T_s, _lo_sigma_fn(nbins),
        sigma_min=params.sifting.sigma_threshold, bin_scale=0.5)
    if hi_sharded:
        zs = np.asarray(bank.zs)
        hi_res = {h: (host["hi_vals"][:ndms, si],
                      host["hi_rbins"][:ndms, si],
                      zs[host["hi_zidx"][:ndms, si]])
                  for si, h in enumerate(stages_hi)}
        cands.extend(sifting.make_candidates(
            hi_res, dms, T_s, _hi_sigma_fn(nbins, nz),
            sigma_min=params.sifting.sigma_threshold,
            z_min_abs=accel_k.DZ / 2, bin_scale=0.5))
    elif hi:
        # the hi stage through the single-device route (its own
        # ladder), re-dedispersing in chunks
        degraded.note("sharded_hi_fallback",
                      "batched hi path unusable on the mesh path; hi "
                      "stage re-dedisperses per chunk (2x stage-2 "
                      "cost)")
        for lo in range(0, ndms, params.max_dms_per_chunk):
            dm_chunk = dms[lo: lo + params.max_dms_per_chunk]
            series = dd.dedisperse_subbands(
                subb, np.asarray(sub_shifts)[lo: lo + len(dm_chunk)])
            wspec = (fr.whitened_spectrum_masked(series, keep, nfft=nfft)
                     if keep is not None else
                     fr.whitened_spectrum(series, nfft=nfft))
            cands.extend(_hi_accel_pass(wspec, dm_chunk, T_s, params))
    events = sp_k.events_from_topk(
        host["sp_snr"][:, :ndms], host["sp_idx"][:, :ndms], dms, dt_ds,
        threshold=params.sp_threshold, widths=tuple(params.sp_widths))
    return cands, events


def _tree_levels(subb, sub_shifts, T_ds, timers, dev):
    """(tree plan, merge-level partials) for a pass the tree family
    runs (kernels/tree_dd.plan_for_pass decides), else (None, None):
    the levels run once per pass, timed as dedispersing, and the tree
    gauges record the plan."""
    tree_plan = tree_dd.plan_for_pass(sub_shifts, T=T_ds, device=dev)
    if tree_plan is None:
        return None, None
    with timers.timing("dedispersing"):
        parts = tree_dd.tree_levels(subb, tree_plan)
        _fence(dev)
    telemetry.dedisp_tree_depth().set(tree_plan.depth)
    telemetry.dedisp_residual_fraction().set(
        round(tree_plan.residual_fraction, 4))
    return tree_plan, parts


def _chunk_stages(series, norm, dm_chunk, nfft, T_s, keep, params,
                  timers, dev) -> tuple:
    """The stages after dedispersion of one DM chunk: the SP boxcar
    top-k (after the detrend, unless the tree's residual fused it and
    gave ``norm``), the whitened spectrum (zaplist ``keep`` mask), the
    lo stage, and the hi stage.  Returns the chunk's pending entry
    (dm_chunk, sp_pair, lo_res, hi_cands): the SP and lo outputs stay
    on the device until the pass drains (_drain)."""
    with timers.timing("single-pulse"):
        if norm is not None:
            sp_pair = sp_k.boxcar_search(norm, tuple(params.sp_widths),
                                         sp_k.DEFAULT_TOPK)
        else:
            sp_pair = sp_k.device_search(series, tuple(params.sp_widths),
                                         estimator=params.sp_detrend)
        _fence(dev)
    with timers.timing("FFT"):
        wspec = (fr.whitened_spectrum_masked(series, keep, nfft=nfft)
                 if keep is not None else
                 fr.whitened_spectrum(series, nfft=nfft))
        _fence(dev)
    with timers.timing("lo-accelsearch"):
        # half-bin detection grid (interbinning): bin indices are
        # half-bin units, hence bin_scale=0.5 in _drain
        res = fr.lo_stage_candidates(
            wspec, tuple(fr.harmonic_stages(params.lo_accel_numharm)),
            params.topk_per_stage)
        _fence(dev)
    hi_cands: list = []
    if params.run_hi_accel and params.hi_accel_zmax > 0:
        with timers.timing("hi-accelsearch"):
            # ends in its own host transfer: no fence
            hi_cands = _hi_accel_pass(wspec, dm_chunk, T_s, params)
    return dm_chunk, sp_pair, res, hi_cands


def _drain(pending, dt_ds, T_s, nbins, params, timers) -> tuple:
    """A pass's chunks, drained: one host transfer for the SP outputs
    and one for the lo outputs (charged to their own timer: the first
    transfer waits for all the pass's queued device work), then the
    host halves in chunk order.  Returns (candidates, SP event
    arrays)."""
    dev = pending[0][1][0].device if pending else None
    with timers.timing("pipeline-drain"), report.host_wait("drain", dev):
        sp_host = [(s.cpu().numpy(), i.cpu().numpy())
                   for _c, (s, i), _r, _h in pending]
        lo_host = [{h: (v.cpu().numpy(), b.cpu().numpy())
                    for h, (v, b) in res.items()}
                   for _c, _s, res, _h in pending]
    cands: list = []
    events: list = []
    for (dm_chunk, _sp, _res, hi_cands), (snrs, idx), res_h in zip(
            pending, sp_host, lo_host):
        with timers.timing("single-pulse"):
            ev = sp_k.events_from_topk(
                snrs, idx, dm_chunk, dt_ds,
                threshold=params.sp_threshold,
                widths=tuple(params.sp_widths))
            if len(ev):
                events.append(ev)
        with timers.timing("lo-accelsearch"):
            cands.extend(sifting.make_candidates(
                res_h, dm_chunk, T_s, _lo_sigma_fn(nbins),
                sigma_min=params.sifting.sigma_threshold,
                bin_scale=0.5))
        cands.extend(hi_cands)
    return cands, events


def _sift_fold_finish(data, freqs, dt, params, zaplist, baryv, nsub,
                      timers, store, all_cands, sp_chunks, num_trials,
                      sifted_state, plan) -> _BlockResult:
    """Everything after the plan loop: sift, refine, checkpoint the
    sifted list, fold (checkpoint-aware)."""
    nfft_full = ddplan.choose_n(data.shape[1])
    T_s_full = nfft_full * dt
    _series_for = _BoundedCache(
        lambda dm: _dedisperse_single(data, freqs, nsub, dm, dt))
    by_dm: dict[float, list] = {}
    if sifted_state is not None:
        # resumed past every pass AND past sift/refine: the verified
        # artifact carries the refined, sigma-sorted list (plus the SP
        # events and the trial count) as the original attempt computed
        # them — the crash happened during folding
        final, sp_events, num_trials = sifted_state
    else:
        with timers.timing("sifting"):
            final = sifting.sift(all_cands, params.sifting)
        sp_events = (np.concatenate(sp_chunks) if sp_chunks
                     else _EMPTY_SP)
        # one bin scale for the reported r column: candidates of
        # different passes carry pass-local (downsampled, padded) bin
        # units
        for c in final:
            c.r = c.freq_hz * T_s_full

        # sub-bin refinement of the fold-worthy candidates (PRESTO's
        # harmpolish): each (r, z) optimized on a full-resolution
        # series for its DM, its sigma recomputed from the refined
        # power
        to_refine = [c for c in final
                     if c.sigma >= params.to_prepfold_sigma]
        to_refine = to_refine[: params.max_cands_to_fold]
        if params.refine_cands and to_refine:
            from tpulsar_torch.search import refine

            with timers.timing("refinement"):
                # lo/hi identity by DETECTION z: refinement perturbs z
                # off exact zero, which must not move a lo candidate
                # onto the hi search's nz-times-larger trial count
                was_hi = {id(c): abs(c.z) >= accel_k.DZ / 2
                          for c in to_refine}
                keep_full = fr.zap_mask(nfft_full // 2 + 1, T_s_full,
                                        zaplist, baryv) \
                    if zaplist is not None else None
                for c in to_refine:
                    by_dm.setdefault(c.dm, []).append(c)
                for dm, group in by_dm.items():
                    refine.refine_candidates(
                        group, {dm: _series_for(dm)}, dt, nfft_full,
                        keep_mask=keep_full)
                nz_hi = (len(_get_bank(params.hi_accel_zmax).zs)
                         if params.run_hi_accel
                         and params.hi_accel_zmax > 0
                         else 1)
                nbins_full = nfft_full // 2 + 1
                for c in to_refine:
                    # trial count approximated with the full-resolution
                    # bin count (pass-local counts differ by <= the
                    # downsample)
                    nind = max(1, (nbins_full
                                   * (nz_hi if was_hi[id(c)] else 1))
                               // c.numharm)
                    c.sigma = float(fr.sigma_from_power(
                        c.power, c.numharm, numindep=nind))
                final.sort(key=lambda c: -c.sigma)
        if store is not None:
            with report.checkpoint_save():
                store.save("sifted",
                           _encode_sifted(final, sp_events, num_trials),
                           kind="stage", ext=".npz")

    # fold the top of the (re-ranked) list: final is sigma-descending
    # and the fold set is its >= threshold prefix, so folded[k] is the
    # fold of final[k] (the _cand{k+1} files and the .accelcands rows
    # stay in one-to-one order)
    to_fold = [c for c in final if c.sigma >= params.to_prepfold_sigma]
    to_fold = to_fold[: params.max_cands_to_fold]
    with timers.timing("folding"):
        folded = _fold(data, freqs, dt, params, nsub, plan, to_fold,
                       _series_for, store)
    return _BlockResult(final, folded, sp_events, num_trials,
                        list(by_dm))


def _fold(data, freqs, dt, params, nsub, plan, to_fold, series_for,
          store) -> list:
    """Fold each candidate of to_fold, in order: by default from its
    originating pass's subbands, one batch per period tier
    (fold_by_rules and fold_batched); else per DM from subbands formed
    at that DM (fold_by_rules) or from its full-resolution series.
    Verified fold_NNNN artifacts are reused and each new fold is
    saved."""
    if not to_fold:
        return []
    folded = _load_folds(store, to_fold)

    def _save_fold(k: int) -> None:
        if store is not None:
            with report.checkpoint_save():
                store.save(f"fold_{k:04d}",
                           _encode_fold(folded[k], to_fold[k]),
                           kind="fold", ext=".npz", cand=k)

    missing = [k for k in range(len(to_fold)) if k not in folded]
    if params.fold_by_rules and params.fold_batched:
        from tpulsar_torch.kernels import fold_batch as fbk

        if missing:
            folded.update(fbk.fold_candidates_by_pass(
                data, freqs, dt, plan,
                [(k, to_fold[k].period_s, to_fold[k].dm)
                 for k in missing],
                nsub, dd.form_subbands))
            for k in missing:
                _save_fold(k)
        return [folded[k] for k in range(len(to_fold))]

    # group by DM so each DM's subband block is formed once even when
    # same-DM candidates interleave in the sigma ordering
    groups: dict[float, list[int]] = {}
    for k in missing:
        groups.setdefault(to_fold[k].dm, []).append(k)
    for dm, idxs in groups.items():
        if params.fold_by_rules:
            # fold from subbands so the DM axis is a per-subband phase
            # rotation (PALFA2_presto_search.py:168-175)
            ch_sh, sub_sh = dd.plan_pass_shifts(freqs, nsub, dm, [dm],
                                                dt, 1)
            subb = dd.form_subbands(data, ch_sh, nsub, 1)
            subrefs = dd.subband_reference_freqs(freqs, nsub)
            for k in idxs:
                c = to_fold[k]
                folded[k] = fold_k.fold_subbands_and_optimize(
                    subb, subrefs, dt, c.period_s, dm=dm,
                    rules=fold_k.fold_rules(c.period_s),
                    sub_shifts_dm0=sub_sh[0])
                _save_fold(k)
            del subb
        else:
            for k in idxs:
                c = to_fold[k]
                folded[k] = fold_k.fold_and_optimize(
                    series_for(c.dm), dt, c.period_s, dm=c.dm,
                    nbin=params.fold_nbin, npart=params.fold_npart)
                _save_fold(k)
    return [folded[k] for k in range(len(to_fold))]


def _load_folds(store, to_fold) -> dict[int, fold_k.FoldResult]:
    """The verified fold artifacts of to_fold, by position.  Each
    carries its candidate's (input period, dm) identity: when the
    sifted list was regenerated since the folds were written, position
    k may name a different candidate, and a sha-valid fold is then
    discarded, never attributed to it."""
    out: dict[int, fold_k.FoldResult] = {}
    if store is None:
        return out
    for k in range(len(to_fold)):
        payload = store.load(f"fold_{k:04d}")
        if payload is None:
            continue
        dec = _decode_fold(payload)
        if dec is None:
            store.discard(f"fold_{k:04d}", reason="undecodable payload")
            continue
        res, ident = dec
        if ident != (to_fold[k].period_s, to_fold[k].dm):
            store.discard(f"fold_{k:04d}",
                          reason="candidate identity mismatch "
                                 "(sifted list regenerated)")
            continue
        out[k] = res
    return out


class _BoundedCache:
    """LRU-bounded memo for per-DM device tensors (a long beam's
    full-resolution series is too big to keep one per candidate DM).
    A hit re-inserts the key, so the first key is always the least
    recently used."""

    def __init__(self, fn, capacity: int = 4):
        self._fn = fn
        self._cap = capacity
        self._d: dict = {}

    def __call__(self, key):
        if key in self._d:
            self._d[key] = self._d.pop(key)     # touch: move to MRU
        else:
            while len(self._d) >= self._cap:
                self._d.pop(next(iter(self._d)))
            self._d[key] = self._fn(key)
        return self._d[key]


def _dedisperse_single(data, freqs, nsub, dm, dt) -> torch.Tensor:
    """One full-resolution DM series (T,) on the data's device: stage 1
    at downsample 1, then stage 2 at one row."""
    chan_shifts, sub_shifts = dd.plan_pass_shifts(freqs, nsub, dm, [dm],
                                                  dt, 1)
    subb = dd.form_subbands(data, chan_shifts, nsub, 1)
    return dd.dedisperse_subbands(subb, sub_shifts)[0]


def _hi_accel_pass(wspec, dm_chunk, T_s, params: SearchParams
                   ) -> list[sifting.Candidate]:
    """accelsearch zmax > 0 over a DM chunk of already-whitened complex
    spectra (the spectrum is shared with the lo stage).  When every
    row was refused and the per-row rescue recovered none
    (AccelStageRefused), a CPU run recomputes the whole chunk on the
    host before its hi stage is skipped loudly; on the card the chunk
    is skipped loudly at once."""
    bank = _get_bank(params.hi_accel_zmax)
    try:
        res = accel_k.accel_search_batch(
            wspec, bank, max_numharm=params.hi_accel_numharm,
            topk=params.topk_per_stage)
    except accel_k.AccelStageRefused as exc:
        res = _hi_chunk_rescue(exc, wspec, dm_chunk, bank, params)
        if res is None:
            return []
    else:
        # the chunk's trials feed the denominator: the count of DM
        # trials that went through the hi stage (n stays 0)
        degraded.count("accel_hi_chunk_skipped", 0, len(dm_chunk))
    # z~0 rows are the lo search's (z_min_abs); the plane is on the
    # half-bin grid (bin_scale)
    return sifting.make_candidates(
        res, dm_chunk, T_s,
        _hi_sigma_fn(wspec.shape[-1], len(bank.zs)),
        sigma_min=params.sifting.sigma_threshold,
        z_min_abs=accel_k.DZ / 2, bin_scale=0.5)


def _hi_chunk_rescue(exc, wspec, dm_chunk, bank, params: SearchParams):
    """The executor's last resort before losing a chunk's hi science
    (the JAX package's, tpulsar/search/executor.py): recompute the
    WHOLE chunk on the host CPU — slower, but a complete beam.  Only
    for spectra already on the CPU (no work moves off the card), and
    skipped when the kernel's own per-row rescue already ran on these
    spectra and recovered nothing (``rescue_exhausted``).  Returns the
    stage dict, or None after recording the chunk's hi stage as
    skipped (the beam keeps its SP, lo, fold and other chunks' hi
    science)."""
    import time as _time

    from tpulsar_torch.resilience import rescue

    chunk_res = None
    t_rescue = _time.perf_counter()
    if not getattr(exc, "rescue_exhausted", False) \
            and rescue.available(wspec.device):
        with telemetry.trace.span("accel_chunk_rescue", n=len(dm_chunk)):
            chunk_res = rescue.rescue_accel_chunk(
                wspec, bank, max_numharm=params.hi_accel_numharm,
                topk=params.topk_per_stage)
    if chunk_res is None:
        degraded.count("accel_hi_chunk_skipped", len(dm_chunk),
                       len(dm_chunk), extra=str(exc)[:160])
        telemetry.rescue_rows_total().inc(len(dm_chunk), outcome="lost")
        warnings.warn(f"hi-accel chunk skipped: {exc}")
        return None
    # observed only when the rescue delivered rows: the trials counter
    # and this histogram describe the same calls
    telemetry.accel_stage_seconds().observe(
        _time.perf_counter() - t_rescue, path="rescued")
    res, lost_rows = chunk_res
    n_ok = len(dm_chunk) - len(lost_rows)
    telemetry.rescue_rows_total().inc(n_ok, outcome="rescued")
    if n_ok:
        # the kernel raised before its own trials accounting, so the
        # chunk-rescued rows are counted here, once
        telemetry.accel_batch_trials_total().inc(n_ok, path="rescued")
    if lost_rows:
        telemetry.rescue_rows_total().inc(len(lost_rows), outcome="lost")
    degraded.provenance_count(
        "accel_rows_rescued", n_ok, len(dm_chunk),
        extra="whole chunk refused by the runtime; recomputed on "
              "the host CPU backend — rescued rows were slower "
              "but complete")
    # a partial chunk rescue is partial coverage, never dressed as
    # complete: lost rows feed the loss ledger
    degraded.count(
        "accel_rows_zero_filled", len(lost_rows), len(dm_chunk),
        extra="chunk-rescue recompute failed for these rows; "
              "powers zero-filled — hi-accel coverage is PARTIAL")
    degraded.count("accel_hi_chunk_skipped", 0, len(dm_chunk))
    warnings.warn(
        f"hi-accel chunk refused by the runtime and recomputed "
        f"on the host CPU backend ({n_ok}/{len(dm_chunk)} rows"
        + (f"; {len(lost_rows)} rows lost and zero-filled"
           if lost_rows else "")
        + f"; provenance recorded): {exc}")
    return res


_BANK_CACHE: dict[int, accel_k.TemplateBank] = {}


def _get_bank(zmax: int) -> accel_k.TemplateBank:
    if zmax not in _BANK_CACHE:
        _BANK_CACHE[zmax] = accel_k.build_template_bank(float(zmax))
    return _BANK_CACHE[zmax]


def _lo_sigma_fn(nbins: int):
    """Stage sigma with the zero-accel search's trial count: ~nbins/h
    independent summed powers per DM per stage."""
    return lambda p, h: fr.sigma_from_power(
        p, h, numindep=max(1, nbins // h))


def _hi_sigma_fn(nbins: int, nz: int):
    """Stage sigma with the accelerated search's (r, z) plane trial
    count."""
    return lambda p, h: fr.sigma_from_power(
        p, h, numindep=max(1, (nbins * nz) // h))


_EMPTY_SP = np.empty(0, dtype=sp_k.SP_EVENT_DTYPE)

_CAND_FIELDS = ("r", "z", "sigma", "power", "numharm", "dm",
                "period_s", "freq_hz")


def _ckpt_fingerprint(plan, params, zaplist, baryv, nsub,
                      data_id: str = "") -> str:
    """Configuration + input fingerprint stored with the checkpoints:
    dumps from a different search configuration OR a different beam
    must not be resumed.  The JAX package's recipe, byte for byte: the
    same plan, parameters, zaplist, baryv, nsub and data_id give the
    same fingerprint in both packages."""
    zap = (np.asarray(zaplist).tobytes() if zaplist is not None
           else b"none")
    blob = repr((
        [(s.lodm, s.dmstep, s.dms_per_pass, s.numpasses, s.numsub,
          s.downsamp) for s in plan],
        sorted(params.provenance().items()), baryv, nsub, data_id,
    )).encode() + zap
    return ckpt_mod.sha256_bytes(blob)


def _open_checkpoint(ckdir: str, fingerprint: str, journal=None):
    """Open the beam's CheckpointStore and journal the ``resume``
    event when it holds prior artifacts — the record that this attempt
    started from saved work."""
    store = ckpt_mod.CheckpointStore(
        ckdir, fingerprint, journal=journal,
        warn=lambda msg: warnings.warn(msg, stacklevel=2))
    ent = store.entries()
    if ent:
        store.journal("resume", artifacts=len(ent),
                      passes_done=len(store.entries(kind="pass")))
    return store


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _load_decoded(store, key: str, decode):
    """Verified load + decode.  A payload whose bytes verify but whose
    layout does not decode is DISCARDED through the store (journaling
    ``checkpoint_invalid``), so its recompute has its excuse on
    record."""
    payload = store.load(key)
    if payload is None:
        return None
    out = decode(payload)
    if out is None:
        store.discard(key, reason="undecodable payload")
    return out


def _encode_pass(cands: list[sifting.Candidate], events: np.ndarray,
                 ntrials: int) -> bytes:
    """One pass's partials as an npz payload (the JAX package's
    fields)."""
    arrs = {f: np.asarray([getattr(c, f) for c in cands])
            for f in _CAND_FIELDS}
    return _npz_bytes(events=events, ntrials=np.int64(ntrials), **arrs)


def _decode_cands(z) -> list[sifting.Candidate]:
    """Candidates from a payload's field columns.  Each column is read
    once: an npz archive decompresses an array on every access, so
    indexing it per candidate is quadratic in the candidate count
    (minutes a pass at a full beam's thousands of candidates)."""
    cols = [[(int if f == "numharm" else float)(v)
             for v in z[f].tolist()] for f in _CAND_FIELDS]
    return [sifting.Candidate(**dict(zip(_CAND_FIELDS, row)))
            for row in zip(*cols)]


def _decode_pass(payload: bytes | None):
    """(cands, events, ntrials) from a verified pass payload, else
    None (an undecodable payload is recomputed like a missing one)."""
    if payload is None:
        return None
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            return _decode_cands(z), z["events"], int(z["ntrials"])
    except (OSError, ValueError, KeyError):
        return None


def _encode_sifted(final: list[sifting.Candidate],
                   sp_events: np.ndarray, num_trials: int) -> bytes:
    """The post-refinement sigma-sorted list WITH each candidate's
    DM-hit history, plus the beam's SP events and trial count —
    everything folding and the result writers need."""
    arrs = {f: np.asarray([getattr(c, f) for c in final])
            for f in _CAND_FIELDS}
    hit_counts = np.asarray([len(c.dm_hits) for c in final], np.int64)
    flat = [pair for c in final for pair in c.dm_hits]
    hits = (np.asarray(flat, np.float64).reshape(-1, 2) if flat
            else np.zeros((0, 2), np.float64))
    return _npz_bytes(events=sp_events, ntrials=np.int64(num_trials),
                      hit_counts=hit_counts, hits=hits, **arrs)


def _decode_sifted(payload: bytes | None):
    if payload is None:
        return None
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            cands = _decode_cands(z)
            hit_counts, hits = z["hit_counts"], z["hits"]
            if len(hit_counts) != len(cands):
                return None
            off = 0
            for c, k in zip(cands, hit_counts.tolist()):
                c.dm_hits = [(float(dm), float(sg))
                             for dm, sg in hits[off:off + k]]
                off += k
            return cands, z["events"], int(z["ntrials"])
    except (OSError, ValueError, KeyError):
        return None


def _encode_fold(res: fold_k.FoldResult,
                 cand: sifting.Candidate) -> bytes:
    """A fold result PLUS the identity of the candidate it folded (the
    sift-time input period/dm): the binding is stored, not derived
    from the optimized values."""
    return _npz_bytes(
        profile=res.profile, subints=res.subints,
        scalars=np.asarray(
            [res.period_s, res.pdot, res.dm, res.reduced_chi2,
             res.delta_p, res.delta_pdot, res.delta_dm], np.float64),
        geom=np.asarray([res.nbin, res.npart], np.int64),
        cand_ident=np.asarray([cand.period_s, cand.dm], np.float64))


def _decode_fold(payload: bytes | None):
    """(FoldResult, (input_period_s, input_dm)) or None."""
    if payload is None:
        return None
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            s, g, ident = z["scalars"], z["geom"], z["cand_ident"]
            return fold_k.FoldResult(
                period_s=float(s[0]), pdot=float(s[1]), dm=float(s[2]),
                nbin=int(g[0]), npart=int(g[1]), profile=z["profile"],
                subints=z["subints"], reduced_chi2=float(s[3]),
                delta_p=float(s[4]), delta_pdot=float(s[5]),
                delta_dm=float(s[6])), (float(ident[0]),
                                        float(ident[1]))
    except (OSError, ValueError, KeyError):
        return None


def _compute_baryv(si) -> float:
    """Average barycentric velocity for the observation from the beam
    header (reference obs_info, PALFA2_presto_search.py:269).  Unknown
    telescopes get 0.0 with a warning."""
    from tpulsar_torch.astro import barycenter
    try:
        return barycenter.average_baryv(
            si.ra2000, si.dec2000, float(si.start_MJD[0]), float(si.T),
            obs=si.telescope)
    except ValueError:
        import warnings
        warnings.warn(
            f"no observatory coordinates for telescope "
            f"{si.telescope!r}; candidate frequencies will be "
            f"topocentric (baryv=0)")
        return 0.0


def _write_inf_files(resultsdir, basenm, si, dms, dt, nsamp) -> None:
    """Minimal .inf metadata per DM series (PRESTO-inf-like keys)."""
    for dm in np.atleast_1d(dms):
        path = os.path.join(resultsdir, f"{basenm}_DM{dm:.2f}.inf")
        with open(path, "w") as fh:
            fh.write(f" Data file name without suffix          =  "
                     f"{basenm}_DM{dm:.2f}\n")
            fh.write(f" Telescope used                         =  "
                     f"{si.telescope}\n")
            fh.write(f" Object being observed                  =  "
                     f"{si.source}\n")
            fh.write(f" Epoch of observation (MJD)             =  "
                     f"{si.start_MJD[0]:.15f}\n")
            fh.write(f" Width of each time series bin (sec)    =  {dt!r}\n")
            fh.write(f" Number of bins in the time series      =  {nsamp}\n")
            fh.write(f" Dispersion measure (cm-3 pc)           =  {dm}\n")


def _write_sp_files(resultsdir, basenm, events: np.ndarray) -> None:
    """One .singlepulse file per DM with events, each holding that DM's
    events in their order in `events` (sp_k.write_singlepulse_file's
    files): one stable sort groups them, where a scan of every event
    for every DM took most of a Mock beam's results writing."""
    if len(events):
        ev = events[np.argsort(events["dm"], kind="stable")]
        dms, starts = np.unique(ev["dm"], return_index=True)
        for dm, a, b in zip(dms, starts, [*starts[1:], len(ev)]):
            sp_k.write_singlepulse_rows(os.path.join(
                resultsdir, f"{basenm}_DM{dm:.2f}.singlepulse"), ev[a:b])
    np.savez_compressed(os.path.join(resultsdir, f"{basenm}_sp.npz"),
                        events=events)


def _write_header_json(resultsdir, obj) -> None:
    """Beam header record for the uploader."""
    import json
    si = obj.specinfo
    hdr = {
        "obs_name": getattr(obj, "obs_name", si.source),
        "beam_id": int(obj.beam_id) if obj.beam_id is not None else -1,
        "original_file": obj.original_file,
        "source_name": obj.source_name,
        "ra_deg": float(si.ra2000),
        "dec_deg": float(si.dec2000),
        "gal_l": obj.galactic_longitude,
        "gal_b": obj.galactic_latitude,
        "obstime_s": float(si.T),
        "timestamp_mjd": obj.timestamp_mjd,
        "center_freq_mhz": si.fctr,
        "bw_mhz": float(si.BW),
        "num_channels": si.num_channels,
        "sample_time_us": obj.sample_time,
        "project_id": obj.project_id,
        "observers": obj.observers,
        "file_size": obj.file_size,
        "data_size": int(obj.data_size),
        "num_samples": int(si.N),
        "telescope": si.telescope,
        "backend": si.backend,
    }
    with open(os.path.join(resultsdir, "header.json"), "w") as fh:
        json.dump(hdr, fh, indent=1)


def _write_search_params(resultsdir, params, basenm, si, num_trials,
                         baryv: float = 0.0,
                         degraded_modes: dict | None = None,
                         rescued_modes: dict | None = None) -> None:
    """Provenance dump, python-literal assignments like the reference's
    search_params.txt (PALFA2_presto_search.py:695-700)."""
    with open(os.path.join(resultsdir, "search_params.txt"), "w") as fh:
        fh.write(f"basenm = {basenm!r}\n")
        fh.write(f"source = {si.source!r}\n")
        fh.write(f"backend = {si.backend!r}\n")
        fh.write(f"num_dm_trials = {num_trials}\n")
        fh.write(f"baryv = {baryv!r}\n")
        fh.write(f"degraded_modes = {dict(degraded_modes or {})!r}\n")
        fh.write(f"rescued_modes = {dict(rescued_modes or {})!r}\n")
        for k, v in params.provenance().items():
            fh.write(f"{k} = {v!r}\n")


_TAR_CLASSES = (("_pfd.tgz", "_cand*.pfd.npz"),
                ("_bestprof.tgz", "_cand*.bestprof"),
                ("_singlepulse.tgz", "_DM*.singlepulse"),
                ("_inf.tgz", "_DM*.inf"),
                ("_accelcands.tgz", ".accelcands"))


def _tar_result_classes(resultsdir: str, basenm: str) -> None:
    """Tar up result classes like the reference's clean_up
    (PALFA2_presto_search.py:702-724), removing the loose .inf and
    .singlepulse files."""
    import glob
    for suffix, pattern in _TAR_CLASSES:
        files = sorted(glob.glob(os.path.join(resultsdir,
                                              f"{basenm}{pattern}")))
        if not files:
            continue
        tarpath = os.path.join(resultsdir, f"{basenm}{suffix}")
        # gzip's own default level: tarfile's 9 spent ~16 s of a Mock
        # beam's finish on ~32 MB of .singlepulse text, for tarballs
        # 4% smaller
        with tarfile.open(tarpath, "w:gz", compresslevel=6) as tf:
            for f in files:
                tf.add(f, arcname=os.path.basename(f))
        if suffix in ("_inf.tgz", "_singlepulse.tgz"):
            for f in files:
                os.remove(f)
