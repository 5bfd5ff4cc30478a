"""The per-beam search executor — counterpart of
tpulsar/search/executor.py, for the solo single-beam path.

Stage sequence (reference: lib/python/PALFA2_presto_search.py):

  rfifind            -> kernels.rfi.find_rfi_chan / apply_mask_chan
  prepsubband -sub   -> kernels.dedisperse.form_subbands   (CUDA kernel)
  prepsubband        -> kernels.dedisperse.dedisperse_subbands (CUDA kernel)
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

This package runs the JAX package's default search (SearchParams()
with make_plots=False: the full survey DDplan, dedispersion, the
zero-accel and the zmax-50 hi-accel periodicity searches, sifting,
refinement and folding), with the direct stage-2 family on one
device.  Plots, checkpointing, the multi-chip mesh and the tree
stage-2 family are not ported yet: search_beam and search_block raise
NotImplementedError when asked for any of them.

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
  search_params.txt              config provenance (python-literal)
  <base>.report                  per-stage timing breakdown
  <base>_*.tgz                   result-class tarballs
The JAX package's metrics.json and trace file belong to its
observability layer and are not written here.
"""

from __future__ import annotations

import dataclasses
import os
import tarfile
from typing import NamedTuple

import numpy as np
import torch

from tpulsar_torch import resolve_device
from tpulsar_torch.io import accelcands, datafile
from tpulsar_torch.kernels import accel as accel_k
from tpulsar_torch.kernels import dedisperse as dd
from tpulsar_torch.kernels import fold as fold_k
from tpulsar_torch.kernels import fourier as fr
from tpulsar_torch.kernels import rfi as rfi_k
from tpulsar_torch.kernels import singlepulse as sp_k
from tpulsar_torch.plan import ddplan
from tpulsar_torch.search import degraded, sifting
from tpulsar_torch.search.report import StageTimers


@dataclasses.dataclass
class SearchParams:
    """Search configuration — the JAX package's SearchParams, field for
    field with the same defaults (so provenance() dicts round-trip
    between the packages).  Fields this package does not run yet are
    refused by search_beam/search_block (see check_supported)."""
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


def check_supported(params: SearchParams, checkpoint_dir=None,
                    mesh=None) -> None:
    """Refuse, by name, every option that belongs to a later slice of
    the port."""
    later = []
    if params.make_plots:
        later.append("plots (make_plots)")
    if checkpoint_dir:
        later.append("checkpoint/resume (checkpoint_dir)")
    if mesh is not None:
        later.append("the multi-device mesh (mesh)")
    if ddplan.dedisp_family_override() == "tree":
        later.append("the tree stage-2 family (TPULSAR_DD_FAMILY=tree; "
                     "kernels/tree_dd.py)")
    if later:
        raise NotImplementedError(
            "tpulsar_torch does not run these yet (a later slice of "
            "the port): " + "; ".join(later))


def search_beam(fns: list[str], workdir: str, resultsdir: str,
                params: SearchParams | None = None,
                zaplist: np.ndarray | None = None,
                plan: list[ddplan.DedispStep] | None = None,
                baryv: float | None = None,
                checkpoint_dir: str | None = None,
                mesh=None, device=None) -> SearchOutcome:
    """Search one beam end-to-end and write the results directory.

    device: where the search runs, "cuda" by default; without a GPU
    the caller must pass device="cpu" (the plain PyTorch versions of
    the kernels then run).

    baryv: average barycentric velocity (v/c) of the observation; None
    computes it from the beam header, 0.0 disables the correction."""
    params = params or SearchParams()
    check_supported(params, checkpoint_dir, mesh)
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    os.makedirs(resultsdir, exist_ok=True)

    obj, si, basenm, plan, nsub, baryv = _beam_geometry(
        fns, params, plan, baryv)
    timers = StageTimers()
    data, mask = _read_and_mask(si, params, basenm, resultsdir, timers,
                                dev)
    res = _search_block(data, si.freqs, si.dt, plan, params, zaplist,
                        baryv, nsub, timers, dev)
    return _finalize_results(
        resultsdir, basenm, obj, si, plan, params, zaplist, baryv,
        data, mask, res, timers)


def _beam_geometry(fns, params, plan, baryv):
    """Header-derived per-beam facts needed before any device work:
    the data object, the DDplan, the effective nsub and the
    barycentric velocity."""
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
    return obj, si, basenm, plan, nsub, baryv


def _fence(dev: torch.device) -> None:
    """Wait for the device, so that a stage timer holds the device
    work its scope enqueued (kernels launch asynchronously)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _read_and_mask(si, params, basenm, resultsdir, timers, dev):
    """Read the beam block, move it to the device channel-major in its
    native dtype, find and apply the RFI mask.  Returns the masked
    (nchan, T) tensor and the RFIMask; the mask artifact lands in
    resultsdir."""
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
        mask = rfi_k.find_rfi_chan(data, si.dt,
                                   block_len=params.rfifind_blocklen,
                                   threshold=params.rfi_threshold)
        # the quantization affine travels with the mask (chan_fill is
        # in quantized units when it is present)
        mask.save(mask_path, qscale=qscale, qoff=qoff)
        data = rfi_k.apply_mask_chan(data, mask.full_mask(),
                                     mask.chan_fill, mask.block_len)
        _fence(dev)
    return data, mask


def _finalize_results(resultsdir, basenm, obj, si, plan, params,
                      zaplist, baryv, data, mask, res: "_BlockResult",
                      timers) -> SearchOutcome:
    """Write the per-beam results directory (artifacts, provenance,
    report, tarballs) and build the SearchOutcome."""
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
    _write_header_json(resultsdir, obj)
    deg = degraded.snapshot()
    resc = degraded.provenance_snapshot()
    _write_search_params(resultsdir, params, basenm, si, num_trials,
                         baryv=baryv, degraded_modes=deg,
                         rescued_modes=resc)
    timers.write_report(os.path.join(resultsdir, f"{basenm}.report"),
                        basenm, degraded=deg, rescued=resc)
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
                 mesh=None, device=None):
    """Run the plan loop, sifting, refinement and folding on an
    in-memory (nchan, T) block (uint8 or float32; a numpy array or a
    tensor, moved to `device`).

    Returns (candidates, folded, sp_events, num_dm_trials): folded[k]
    is the fold of candidates[k]."""
    params = params or SearchParams()
    check_supported(params, checkpoint_dir, mesh)
    res = _search_block(data, freqs, dt, plan, params, zaplist, baryv,
                        nsub, timers, resolve_device(device))
    return res.final, res.folded, res.sp_events, res.num_trials


class _BlockResult(NamedTuple):
    final: list
    folded: list
    sp_events: np.ndarray
    num_trials: int
    refined_dms: list[float]     # the DM groups refinement dedispersed


def _search_block(data, freqs, dt, plan, params, zaplist, baryv, nsub,
                  timers, dev) -> _BlockResult:
    """search_block's body, on a checked configuration and device."""
    timers = timers or StageTimers()
    degraded.reset()
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data))
    data = data.to(dev).contiguous()
    nchan = data.shape[0]
    nsub = nsub or (params.nsub if nchan % params.nsub == 0
                    else ddplan.largest_divisor_leq(nchan, params.nsub))

    all_cands: list[sifting.Candidate] = []
    sp_chunks: list[np.ndarray] = []
    num_trials = 0
    stages = tuple(fr.harmonic_stages(params.lo_accel_numharm))
    for step in plan:
        for ppass in step.passes():
            with timers.timing("subbanding"):
                chan_shifts, sub_shifts = dd.plan_pass_shifts(
                    freqs, nsub, ppass.subdm, np.asarray(ppass.dms),
                    dt, step.downsamp)
                subb = dd.form_subbands(data, chan_shifts, nsub,
                                        step.downsamp)
                _fence(dev)
            dt_ds = dt * step.downsamp
            dms = np.asarray(ppass.dms)
            chunk_sz = pass_chunk_size(
                len(dms), ddplan.choose_n(subb.shape[1]), params)
            # top-k-sized device outputs are held to one host transfer
            # per pass; event and candidate order is chunk order
            pending: list[tuple] = []
            for lo in range(0, len(dms), chunk_sz):
                dm_chunk = dms[lo: lo + chunk_sz]
                with timers.timing("dedispersing"):
                    series = dd.dedisperse_subbands(
                        subb, sub_shifts[lo: lo + len(dm_chunk)])
                    _fence(dev)
                num_trials += len(dm_chunk)
                # FFT-friendly padded length (reference: PRESTO
                # choose_N via prepsubband -numout)
                nfft = ddplan.choose_n(series.shape[1])
                T_s = nfft * dt_ds
                with timers.timing("single-pulse"):
                    sp_pair = sp_k.device_search(
                        series, tuple(params.sp_widths),
                        estimator=params.sp_detrend)
                    _fence(dev)
                with timers.timing("FFT"):
                    nbins = nfft // 2 + 1
                    keep = fr.zap_mask(nbins, T_s, zaplist, baryv) \
                        if zaplist is not None else None
                    wspec = (fr.whitened_spectrum_masked(series, keep,
                                                         nfft=nfft)
                             if keep is not None else
                             fr.whitened_spectrum(series, nfft=nfft))
                    del series
                    _fence(dev)
                with timers.timing("lo-accelsearch"):
                    # half-bin detection grid (interbinning): bin
                    # indices are half-bin units, hence bin_scale=0.5
                    res = fr.lo_stage_candidates(
                        wspec, stages, params.topk_per_stage)
                    _fence(dev)
                hi_cands: list = []
                if params.run_hi_accel and params.hi_accel_zmax > 0:
                    with timers.timing("hi-accelsearch"):
                        # ends in its own host transfer: no fence
                        hi_cands = _hi_accel_pass(wspec, dm_chunk, T_s,
                                                  params)
                del wspec
                pending.append((dm_chunk, T_s, nbins, sp_pair, res,
                                hi_cands))

            with timers.timing("pipeline-drain"):
                sp_host = [(s.cpu().numpy(), i.cpu().numpy())
                           for _c, _t, _n, (s, i), _r, _h in pending]
                lo_host = [{h: (v.cpu().numpy(), b.cpu().numpy())
                            for h, (v, b) in p[4].items()}
                           for p in pending]
            for (dm_chunk, T_s, nbins, _sp, _res, hi_cands), \
                    (snrs, idx), res_h in zip(pending, sp_host, lo_host):
                with timers.timing("single-pulse"):
                    ev = sp_k.events_from_topk(
                        snrs, idx, dm_chunk, dt_ds,
                        threshold=params.sp_threshold,
                        widths=tuple(params.sp_widths))
                    if len(ev):
                        sp_chunks.append(ev)
                with timers.timing("lo-accelsearch"):
                    all_cands.extend(sifting.make_candidates(
                        res_h, dm_chunk, T_s, _lo_sigma_fn(nbins),
                        sigma_min=params.sifting.sigma_threshold,
                        bin_scale=0.5))
                all_cands.extend(hi_cands)
            del pending, subb

    return _sift_fold_finish(data, freqs, dt, params, zaplist, baryv,
                             nsub, timers, all_cands, sp_chunks,
                             num_trials, plan)


def _sift_fold_finish(data, freqs, dt, params, zaplist, baryv, nsub,
                      timers, all_cands, sp_chunks, num_trials,
                      plan) -> _BlockResult:
    """Everything after the plan loop: sift, refine, fold."""
    nfft_full = ddplan.choose_n(data.shape[1])
    T_s_full = nfft_full * dt
    _series_for = _BoundedCache(
        lambda dm: _dedisperse_single(data, freqs, nsub, dm, dt))
    with timers.timing("sifting"):
        final = sifting.sift(all_cands, params.sifting)
    sp_events = (np.concatenate(sp_chunks) if sp_chunks else _EMPTY_SP)
    # one bin scale for the reported r column: candidates of different
    # passes carry pass-local (downsampled, padded) bin units
    for c in final:
        c.r = c.freq_hz * T_s_full

    # sub-bin refinement of the fold-worthy candidates (PRESTO's
    # harmpolish): each (r, z) optimized on a full-resolution series
    # for its DM, its sigma recomputed from the refined power
    to_refine = [c for c in final
                 if c.sigma >= params.to_prepfold_sigma]
    to_refine = to_refine[: params.max_cands_to_fold]
    by_dm: dict[float, list] = {}
    if params.refine_cands and to_refine:
        from tpulsar_torch.search import refine

        with timers.timing("refinement"):
            # lo/hi identity by DETECTION z: refinement perturbs z off
            # exact zero, which must not move a lo candidate onto the
            # hi search's nz-times-larger trial count
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
                     if params.run_hi_accel and params.hi_accel_zmax > 0
                     else 1)
            nbins_full = nfft_full // 2 + 1
            for c in to_refine:
                # trial count approximated with the full-resolution bin
                # count (pass-local counts differ by <= the downsample)
                nind = max(1, (nbins_full
                               * (nz_hi if was_hi[id(c)] else 1))
                           // c.numharm)
                c.sigma = float(fr.sigma_from_power(
                    c.power, c.numharm, numindep=nind))
            final.sort(key=lambda c: -c.sigma)

    # fold the top of the (re-ranked) list: final is sigma-descending
    # and the fold set is its >= threshold prefix, so folded[k] is the
    # fold of final[k] (the _cand{k+1} files and the .accelcands rows
    # stay in one-to-one order)
    to_fold = [c for c in final if c.sigma >= params.to_prepfold_sigma]
    to_fold = to_fold[: params.max_cands_to_fold]
    with timers.timing("folding"):
        folded = _fold(data, freqs, dt, params, nsub, plan, to_fold,
                       _series_for)
    return _BlockResult(final, folded, sp_events, num_trials,
                        list(by_dm))


def _fold(data, freqs, dt, params, nsub, plan, to_fold,
          series_for) -> list:
    """Fold each candidate of to_fold, in order: by default from its
    originating pass's subbands, one batch per period tier
    (fold_by_rules and fold_batched); else per DM from subbands formed
    at that DM (fold_by_rules) or from its full-resolution series."""
    if not to_fold:
        return []
    if params.fold_by_rules and params.fold_batched:
        from tpulsar_torch.kernels import fold_batch as fbk

        by_k = fbk.fold_candidates_by_pass(
            data, freqs, dt, plan,
            [(k, c.period_s, c.dm) for k, c in enumerate(to_fold)],
            nsub, dd.form_subbands)
        return [by_k[k] for k in range(len(to_fold))]

    folded: dict[int, fold_k.FoldResult] = {}
    # group by DM so each DM's subband block is formed once even when
    # same-DM candidates interleave in the sigma ordering
    groups: dict[float, list[int]] = {}
    for k, c in enumerate(to_fold):
        groups.setdefault(c.dm, []).append(k)
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
            del subb
        else:
            for k in idxs:
                c = to_fold[k]
                folded[k] = fold_k.fold_and_optimize(
                    series_for(c.dm), dt, c.period_s, dm=c.dm,
                    nbin=params.fold_nbin, npart=params.fold_npart)
    return [folded[k] for k in range(len(to_fold))]


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
    spectra (the spectrum is shared with the lo stage)."""
    bank = _get_bank(params.hi_accel_zmax)
    res = accel_k.accel_search_batch(
        wspec, bank, max_numharm=params.hi_accel_numharm,
        topk=params.topk_per_stage)
    # the chunk's trials feed the denominator: the count of DM trials
    # that went through the hi stage (n stays 0: nothing is skipped)
    degraded.count("accel_hi_chunk_skipped", 0, len(dm_chunk))
    # z~0 rows are the lo search's (z_min_abs); the plane is on the
    # half-bin grid (bin_scale)
    return sifting.make_candidates(
        res, dm_chunk, T_s,
        _hi_sigma_fn(wspec.shape[-1], len(bank.zs)),
        sigma_min=params.sifting.sigma_threshold,
        z_min_abs=accel_k.DZ / 2, bin_scale=0.5)


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
    for dm in np.unique(events["dm"]) if len(events) else []:
        sp_k.write_singlepulse_file(
            os.path.join(resultsdir, f"{basenm}_DM{dm:.2f}.singlepulse"),
            events, dm)
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
        with tarfile.open(tarpath, "w:gz") as tf:
            for f in files:
                tf.add(f, arcname=os.path.basename(f))
        if suffix in ("_inf.tgz", "_singlepulse.tgz"):
            for f in files:
                os.remove(f)
