"""Batched candidate folding — counterpart of
tpulsar/kernels/fold_batch.py, the default fold path.

A TIER of candidates (the same profile geometry, FoldRules) folds from
one subband block in one batch:

* **Fold by one-hot products.**  Per subintegration the phase-bin
  accumulation is a matrix product (nsub, L) x (ncand, L, nbin) with a
  one-hot of the bins — the reference's formulation, kept as
  torch.einsum: a matrix product sums in a fixed order on the GPU,
  where a scatter-add's atomics would not.  The candidate batch is
  chunked so the one-hot stays under max_onehot_bytes.
* **Fold once, rotate later.**  Subbands fold UNALIGNED with a shared
  per-candidate phase; the candidate DM's inter-subband delays become
  per-subband fractional-bin rotations of the folded profiles, applied
  in the Fourier domain (prepfold's fftrotate scheme,
  PALFA2_presto_search.py:168-175).
* **Coordinate descent on the device.**  The (dp, dpdot) grid, the DM
  grid and the second (dp, dpdot) grid run with device argmaxes for
  all candidates of the batch at once, and the results come back in
  one host transfer.

The search geometry matches kernels/fold.py.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulsar_torch.constants import KDM
from tpulsar_torch.kernels.fold import (FoldResult, FoldRules,
                                        _unit_variance_rows, fold_rules)

# Rolling x by a REAL shift s (out[b] = x[(b + s) mod nbin]) multiplies
# rfft(x)[k] by exp(+2*pi*i*k*s/nbin).

#: (dp, dpdot) grid points evaluated per step of the grid scan
_GRID_CHUNK = 256


def _phase(shifts: torch.Tensor, nbin: int) -> torch.Tensor:
    """exp(+2*pi*i*k*s/nbin) for rfft bin k: (..., K) from (...,),
    complex64 (the angle in float32, as the reference computes it)."""
    k = torch.arange(nbin // 2 + 1, dtype=torch.float32,
                     device=shifts.device)
    ang = (2.0 * np.pi / nbin) * shifts[..., None] * k
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _collapse_hat(F_stack, F_cnt, var_ps, sub_shifts, nbin: int):
    """Collapse the subband axis at one DM row per candidate, in rfft
    space.

    F_stack (c, npart, nsub, K) rfft of centred profiles, F_cnt
    (c, npart, K) rfft of per-bin counts (shared across subbands),
    var_ps (npart, nsub) measured sample variance, sub_shifts
    (c, nsub) real per-subband bin rotations.  Returns (S1h, C1h, V1h),
    each (c, npart, K)."""
    ph = _phase(sub_shifts, nbin)                    # (c, nsub, K)
    S1h = torch.einsum("cpsk,csk->cpk", F_stack, ph)
    C1h = F_cnt * ph.sum(dim=1)[:, None, :]
    V1h = F_cnt * torch.einsum("ps,csk->cpk", var_ps.to(ph.dtype), ph)
    return S1h, C1h, V1h


def _chi2_profiles(prof, csum, vsum, nbin: int) -> torch.Tensor:
    """Reduced chi-square against a flat baseline, batched over leading
    axes (kernels/fold.py's measured-variance model)."""
    tot = csum.sum(-1)
    mean_rate = prof.sum(-1) / torch.clamp(tot, min=1.0)
    expected = mean_rate[..., None] * csum
    var = torch.clamp(vsum, min=1e-9)
    return ((prof - expected) ** 2 / var).sum(-1) / (nbin - 1)


def _part_shift(dp, dpd, part_times, period, nbin: int):
    """Real per-subint bin shift for a (dp, dpdot) offset
    (kernels/fold.py _pp_shifts without the rounding)."""
    dphi = -(dp * part_times + 0.5 * dpd * part_times ** 2) / period ** 2
    return dphi * nbin


def _grid_profiles(S1h, C1h, V1h, a, nbin: int):
    """Apply per-subint rotations a (c, ..., npart) to the collapsed
    rfft profiles (c, npart, K); returns bin-space (prof, csum, vsum),
    each (c, ..., nbin)."""
    A = _phase(a, nbin)                              # (c, ..., npart, K)
    extra = A.dim() - 3

    def rot(X):
        Xb = X.reshape(X.shape[0], *([1] * extra), *X.shape[1:])
        return torch.fft.irfft((A * Xb).sum(dim=-2), nbin, dim=-1)

    return rot(S1h), rot(C1h), rot(V1h)


def _pp_best(S1h, C1h, V1h, dps, dpds, part_times, periods, nbin: int):
    """chi2 over each candidate's (dp, dpdot) grid, on the device, in
    steps of _GRID_CHUNK grid points; returns (best_dp, best_dpd), each
    (c,), at the first maximum."""
    c = dps.shape[0]
    dp_g = dps.repeat_interleave(dpds.shape[1], dim=1)     # (c, G)
    dpd_g = dpds.repeat(1, dps.shape[1])
    per = periods[:, None, None]
    chis = []
    for g0 in range(0, dp_g.shape[1], _GRID_CHUNK):
        dpc = dp_g[:, g0: g0 + _GRID_CHUNK, None]
        dpdc = dpd_g[:, g0: g0 + _GRID_CHUNK, None]
        a = _part_shift(dpc, dpdc, part_times[None, None], per, nbin)
        prof, csum, vsum = _grid_profiles(S1h, C1h, V1h, a, nbin)
        chis.append(_chi2_profiles(prof, csum, vsum, nbin))
    k = torch.argmax(torch.cat(chis, dim=1), dim=1)
    rows = torch.arange(c, device=dps.device)
    return dp_g[rows, k], dpd_g[rows, k]


def _optimize(F_stack, F_cnt, var_ps, r_dm, dps, dpds, part_times,
              periods, j0: int, nbin: int):
    """Full coordinate descent for a batch of candidates on the device:
    (dp, dpdot) at the nominal DM row, then the DM axis, then (dp,
    dpdot) again (kernels/fold.py's schedule with device argmaxes)."""
    c = F_stack.shape[0]
    rows = torch.arange(c, device=F_stack.device)
    per = periods[:, None]
    # round 1: p/pdot at the nominal DM row
    S0h, C0h, V0h = _collapse_hat(F_stack, F_cnt, var_ps, r_dm[:, j0],
                                  nbin)
    bdp, bdpd = _pp_best(S0h, C0h, V0h, dps, dpds, part_times, periods,
                         nbin)

    # the DM axis at the best (p, pdot), every DM row at once
    a_best = _part_shift(bdp[:, None], bdpd[:, None], part_times[None],
                         per, nbin)                  # (c, npart)
    A_best = _phase(a_best, nbin)                    # (c, npart, K)
    ph_dm = _phase(r_dm, nbin)                       # (c, nddm, nsub, K)
    SA = (F_stack * A_best[:, :, None, :]).sum(dim=1)        # (c, nsub, K)
    SJ = torch.einsum("csk,cjsk->cjk", SA, ph_dm)
    FA = F_cnt * A_best                                      # (c, npart, K)
    CJ = FA.sum(dim=1)[:, None, :] * ph_dm.sum(dim=2)
    VA = torch.einsum("cpk,ps->csk", FA, var_ps.to(FA.dtype))
    VJ = torch.einsum("csk,cjsk->cjk", VA, ph_dm)
    chis_dm = _chi2_profiles(torch.fft.irfft(SJ, nbin, dim=-1),
                             torch.fft.irfft(CJ, nbin, dim=-1),
                             torch.fft.irfft(VJ, nbin, dim=-1), nbin)
    bj = torch.argmax(chis_dm, dim=1)

    # round 2: p/pdot at the best DM row
    S2h, C2h, V2h = _collapse_hat(F_stack, F_cnt, var_ps,
                                  r_dm[rows, bj], nbin)
    bdp, bdpd = _pp_best(S2h, C2h, V2h, dps, dpds, part_times, periods,
                         nbin)
    a2 = _part_shift(bdp[:, None], bdpd[:, None], part_times[None], per,
                     nbin)
    prof, csum, vsum = _grid_profiles(S2h, C2h, V2h, a2, nbin)
    chi2 = _chi2_profiles(prof, csum, vsum, nbin)
    # subints at the candidate's NOMINAL parameters (the FoldResult
    # contract: the diagnostic subint stack before optimization)
    sub0 = torch.fft.irfft(
        torch.einsum("cpsk,csk->cpk", F_stack,
                     _phase(r_dm[:, j0], nbin)), nbin, dim=-1)
    return bdp, bdpd, bj, chi2, prof, sub0


def _fold_and_optimize_batch(subb, w, bins, r_dm, dps, dpds, periods,
                             part_times, nbin: int, npart: int, L: int,
                             j0: int):
    """The whole tier batch: fold cubes, then coordinate descent.

    subb (nsub, npart*L) float32 normalized subbands (zero-padded),
    w (npart*L,) 0/1 valid-sample mask,
    bins (c, npart*L) int64 phase bins (shared across subbands),
    r_dm (c, nddm, nsub) float32 per-DM-trial subband rotations,
    dps/dpds (c, ndp/ndpd) float32 per-candidate offset grids,
    periods (c,) float32, part_times (npart,) float32 subint
    mid-times in seconds."""
    nsub = subb.shape[0]
    # per-(part, sub) measured sample stats (candidate-independent)
    subb3 = subb.reshape(nsub, npart, L)
    w3 = w.reshape(npart, L)
    n_p = torch.clamp(w3.sum(-1), min=1.0)                 # (npart,)
    sum_ps = (subb3 * w3[None]).sum(-1)                    # (nsub, npart)
    ssq_ps = (subb3 ** 2 * w3[None]).sum(-1)
    mean_ps = (sum_ps / n_p).T                             # (npart, nsub)
    var_ps = torch.clamp((ssq_ps / n_p).T - mean_ps ** 2, min=1e-9)

    prof_parts, cnt_parts = [], []
    for p in range(npart):
        seg = subb[:, p * L: (p + 1) * L]
        binseg = bins[:, p * L: (p + 1) * L]
        oh = torch.zeros((*binseg.shape, nbin), dtype=subb.dtype,
                         device=subb.device).scatter_(2, binseg[..., None],
                                                      1.0)
        # one-hot products: (nsub, L) x (c, L, nbin)
        prof_parts.append(torch.einsum("sl,clb->csb", seg, oh))
        cnt_parts.append(torch.einsum("l,clb->cb", w[p * L: (p + 1) * L],
                                      oh))
        del oh
    stack = torch.stack(prof_parts, dim=1)      # (c, npart, nsub, nbin)
    cnt = torch.stack(cnt_parts, dim=1)         # (c, npart, nbin)
    del prof_parts, cnt_parts

    # centre each (subint, subband) on its measured baseline (the same
    # red-noise model as kernels/fold.py)
    stack = stack - mean_ps[None, :, :, None] * cnt[:, :, None, :]

    # one rfft of the folded cubes serves every rotation downstream
    F_stack = torch.fft.rfft(stack, dim=-1)     # (c, npart, nsub, K)
    F_cnt = torch.fft.rfft(cnt, dim=-1)         # (c, npart, K)
    return _optimize(F_stack, F_cnt, var_ps, r_dm, dps, dpds, part_times,
                     periods, j0, nbin)


def _sym_grid(extent: int, step: int) -> np.ndarray:
    """Symmetric grid around 0 (0 is always a point), as in
    kernels/fold.py."""
    pos = np.arange(0, extent + 1, step)
    return np.concatenate([-pos[:0:-1], pos]).astype(np.float64)


def fold_subbands_batch(subbands: torch.Tensor, sub_freqs_mhz,
                        dt: float, cands: list[tuple[float, float]],
                        rules: FoldRules,
                        max_onehot_bytes: int = 512 << 20,
                        ) -> list[FoldResult]:
    """Fold and optimize a TIER of candidates from one subband block.

    subbands: (nsub, T) stage-1 output at the pass's subdm/downsamp,
    NOT inter-subband aligned (alignment becomes per-subband profile
    rotations), on the device the search runs on.  cands:
    [(period_s, dm)] sharing `rules`.  dt: the block's (downsampled)
    sample interval.  The candidate batch is chunked so the per-part
    one-hot stays under max_onehot_bytes."""
    subb = subbands.to(torch.float32)
    dev = subb.device
    nsub, T = subb.shape
    nbin, npart = rules.nbin, rules.npart
    # unit variance per subband (chi2 variance-model conditioning)
    subb = _unit_variance_rows(subb)

    # pad T to npart*L
    L = -(-T // npart)
    Tp = npart * L
    if Tp != T:
        subb = torch.nn.functional.pad(subb, (0, Tp - T))
    w = torch.cat([torch.ones(T, dtype=torch.float32, device=dev),
                   torch.zeros(Tp - T, dtype=torch.float32, device=dev)])

    sub_freqs = np.asarray(sub_freqs_mhz, np.float64)
    ref_mhz = float(sub_freqs[-1])
    band_span = float(sub_freqs[0] ** -2 - ref_mhz ** -2)
    T_s = T * dt

    # per-candidate host precompute (float64 phase: ~T/p turns cannot
    # live in float32)
    t64 = np.arange(T, dtype=np.float64) * dt
    delays_unit = KDM * (sub_freqs ** -2 - ref_mhz ** -2)  # s per DM

    out: list[FoldResult] = []
    per_cand = L * nbin * 4
    max_batch = max(1, int(max_onehot_bytes // per_cand))
    for lo in range(0, len(cands), max_batch):
        chunk = cands[lo: lo + max_batch]
        nc = len(chunk)
        bins = np.zeros((nc, Tp), np.int64)
        r_dm_l, dps_l, dpds_l, ddms_l = [], [], [], []
        for i, (period, dm) in enumerate(chunk):
            ph = np.mod(t64 / period, 1.0)
            bins[i, :T] = np.minimum((ph * nbin).astype(np.int32),
                                     nbin - 1)
            # grids in profile-bin-drift units (prepfold's unit)
            dp_unit = period ** 2 / (nbin * T_s)
            dpd_unit = 2.0 * period ** 2 / (nbin * T_s ** 2)
            dps = _sym_grid(rules.mp * nbin, rules.pstep) * dp_unit
            if rules.search_pdot:
                dpds = _sym_grid(rules.mp * nbin, rules.pdstep) * dpd_unit
            else:
                dpds = np.zeros(1)
            ddm_unit = period / (nbin * KDM * max(abs(band_span), 1e-12))
            ddms = _sym_grid(rules.mdm * nbin, rules.dmstep) * ddm_unit
            # ABSOLUTE per-subband rotation at each DM trial: folding
            # unaligned subbands puts subband s's profile at phase
            # +delay_s/p relative to the aligned fold, so collapsing at
            # trial DM D rolls by +nbin*delay_s(D)/p
            D = dm + ddms                                   # (nddm,)
            r_dm_l.append(nbin * delays_unit[None, :] * D[:, None]
                          / period)                         # (nddm, nsub)
            dps_l.append(dps)
            dpds_l.append(dpds)
            ddms_l.append(ddms)
        j0 = (r_dm_l[0].shape[0] - 1) // 2   # the ddm = 0 row (centre)

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=dev)

        part_times = ((np.arange(npart, dtype=np.float32) + 0.5)
                      * (L * dt))
        res = _fold_and_optimize_batch(
            subb, w, torch.from_numpy(bins).to(dev), f32(np.stack(r_dm_l)),
            f32(np.stack(dps_l)), f32(np.stack(dpds_l)),
            f32([p for p, _ in chunk]), f32(part_times), nbin=nbin,
            npart=npart, L=L, j0=j0)
        bdp, bdpd, bj, chi2, prof, sub0 = (t.cpu().numpy() for t in res)
        for i, (period, dm) in enumerate(chunk):
            ddm = float(ddms_l[i][int(bj[i])])
            out.append(FoldResult(
                period_s=period - float(bdp[i]),
                pdot=-float(bdpd[i]), dm=dm + ddm, nbin=nbin,
                npart=npart, profile=prof[i], subints=sub0[i],
                reduced_chi2=float(chi2[i]), delta_p=float(bdp[i]),
                delta_pdot=float(bdpd[i]), delta_dm=ddm))
    return out


def pass_of(plan, dm: float) -> tuple[int, int]:
    """(step index, pass index) of the plan pass whose subdm is
    nearest `dm` (the first such pass on a tie): the pass a candidate
    folds from."""
    best = None
    for si, step in enumerate(plan):
        for pi, ppass in enumerate(step.passes()):
            d = abs(dm - ppass.subdm)
            if best is None or d < best[0]:
                best = (d, si, pi)
    return best[1], best[2]


def fold_candidates_by_pass(data, freqs, dt: float, plan, cand_list,
                            nsub: int, form_subbands_fn):
    """Group candidates by their originating dedispersion pass, form
    each pass's subband block ONCE at the pass's subdm and downsamp,
    tier-group within the pass, and batch-fold each tier — as prepfold
    folds the pass's subband files (PALFA2_presto_search.py:168-175,
    :514-529).

    cand_list: [(k, period_s, dm)], k the caller's index.  nsub: the
    executor's resolved subband count.  Returns {k: FoldResult}."""
    from tpulsar_torch.kernels import dedisperse as dd

    assignments: dict[tuple[int, int], list[tuple[int, float, float]]] = {}
    for k, period, dm in cand_list:
        assignments.setdefault(pass_of(plan, dm), []).append(
            (k, period, dm))

    results: dict[int, FoldResult] = {}
    for (si, pi), group in assignments.items():
        step = plan[si]
        ppass = step.passes()[pi]
        ch_sh, _ = dd.plan_pass_shifts(freqs, nsub, ppass.subdm,
                                       np.asarray(ppass.dms), dt,
                                       step.downsamp)
        subb = form_subbands_fn(data, ch_sh, nsub, step.downsamp)
        subrefs = dd.subband_reference_freqs(freqs, nsub)
        dt_ds = dt * step.downsamp
        # tier-group: one batch per FoldRules geometry
        tiers: dict[FoldRules, list[tuple[int, float, float]]] = {}
        for k, period, dm in group:
            tiers.setdefault(fold_rules(period), []).append(
                (k, period, dm))
        for rules, tcands in tiers.items():
            res = fold_subbands_batch(
                subb, subrefs, dt_ds, [(p, d) for _, p, d in tcands],
                rules)
            for (k, _, _), r in zip(tcands, res):
                results[k] = r
        del subb
    return results
