"""Candidate folding — counterpart of tpulsar/kernels/fold.py.

Replaces PRESTO's `prepfold` (reference: command construction at
lib/python/PALFA2_presto_search.py:142-228): fold a time series (or a
subband block) at a candidate (p, pdot, DM), then optimize the
candidate over a small (p, pdot) grid by shifting subintegration
profiles, as prepfold does, and report the best reduced chi-square.

Folding is a phase-binned accumulation: sample t goes to bin
floor(nbin * frac(phi(t))) with phi(t) = t/p - 0.5*pdot*t^2/p^2,
computed on the host in float64.  On the device it is an index_add_
(on CUDA an atomic scatter-add, whose float sums may differ in the
last bits from run to run); the (p, pdot) refinement shifts per-subint
profiles by whole bins with gathers.  This is the per-candidate path
(fold_batched=False); the default path is kernels/fold_batch.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpulsar_torch.constants import KDM


@dataclasses.dataclass
class FoldResult:
    period_s: float
    pdot: float
    dm: float
    nbin: int
    npart: int
    profile: np.ndarray        # (nbin,) optimized summed profile
    subints: np.ndarray        # (npart, nbin) at the *input* p/pdot
    reduced_chi2: float
    delta_p: float             # offset applied by optimization
    delta_pdot: float
    delta_dm: float = 0.0      # DM offset found by the fold search

    def bestprof_text(self, source: str = "") -> str:
        """Summary block in the spirit of prepfold's .bestprof (the
        reference's text, line for line)."""
        lines = [
            f"# Source = {source}",
            f"# P_topo (ms) = {self.period_s * 1e3:.12f}",
            f"# Pdot_topo (s/s) = {self.pdot:.6e}",
            f"# DM = {self.dm:.3f}",
            f"# N_bins = {self.nbin}",
            f"# N_parts = {self.npart}",
            f"# Reduced chi-sqr = {self.reduced_chi2:.4f}",
            f"# dP opt (s) = {self.delta_p:.6e}",
            f"# dPdot opt = {self.delta_pdot:.6e}",
            f"# dDM opt = {self.delta_dm:.4f}",
        ]
        lines += [f"{i:4d} {v:.7g}" for i, v in enumerate(self.profile)]
        return "\n".join(lines) + "\n"


@dataclasses.dataclass(frozen=True)
class FoldRules:
    """Period-dependent fold-search parameters — the reference's
    prepfold command rules (PALFA2_presto_search.py:195-211): 24-200
    profile bins, fewer subints for slow pulsars, no pdot search for
    the slowest, and p/pdot/DM factors mp/mdm that set the search
    extent in profile-bin-drift units."""
    nbin: int
    npart: int
    mp: int                 # -npfact: p/pdot extent = +-mp*nbin steps
    mdm: int                # -ndmfact: DM extent = +-mdm*nbin steps
    search_pdot: bool
    pstep: int = 1          # grid strides in bin-drift units
    pdstep: int = 2
    dmstep: int = 1


def fold_rules(period_s: float, numrows: int | None = None) -> FoldRules:
    """The reference's period tiers (PALFA2_presto_search.py:195-211);
    numrows clamps npart like its PSRFITS-row guard (:215-221)."""
    p = period_s
    if p < 0.002:
        r = FoldRules(nbin=24, npart=50, mp=2, mdm=2,
                      search_pdot=True, dmstep=3)
    elif p < 0.05:
        r = FoldRules(nbin=50, npart=40, mp=2, mdm=1,
                      search_pdot=True, dmstep=3)
    elif p < 0.5:
        r = FoldRules(nbin=100, npart=30, mp=1, mdm=1,
                      search_pdot=True)
    else:
        r = FoldRules(nbin=200, npart=30, mp=1, mdm=1,
                      search_pdot=False)
    if numrows is not None and r.npart > numrows:
        r = dataclasses.replace(r, npart=max(1, numrows))
    return r


def phase_bins(T: int, dt: float, period: float, pdot: float,
               nbin: int) -> np.ndarray:
    """Phase-bin index per sample, computed on the host in float64
    (accumulated phase reaches ~T/p turns; float32 cannot hold it)."""
    t = np.arange(T, dtype=np.float64) * dt
    phase = t / period - 0.5 * pdot * t * t / (period * period)
    return (np.floor(phase * nbin) % nbin).astype(np.int32)


def _part_bin_index(T: int, dt: float, period: float, pdot: float,
                    nbin: int, npart: int) -> np.ndarray:
    """part * nbin + bin per sample (the subint index in int64 on the
    host: T * npart overflows int32 for hour-long series)."""
    bins = phase_bins(T, dt, period, pdot, nbin)
    part = np.minimum(np.arange(T, dtype=np.int64) * npart // T,
                      npart - 1)
    return part * nbin + bins


def fold_series(series: torch.Tensor, dt: float, period: float,
                pdot: float, nbin: int, npart: int):
    """Fold a (T,) series into (npart, nbin) subint profiles, counts,
    and per-subint measured sample mean and variance (the chi2
    variance model: red noise inflates the variance, not the
    significance)."""
    T = series.shape[0]
    idx = torch.from_numpy(_part_bin_index(T, dt, period, pdot, nbin,
                                           npart)).to(series.device)
    n = npart * nbin
    z = torch.zeros(n, dtype=series.dtype, device=series.device)
    prof = z.clone().index_add_(0, idx, series).reshape(npart, nbin)
    counts = torch.zeros(n, dtype=torch.float32,
                         device=series.device).index_add_(
        0, idx, torch.ones_like(series, dtype=torch.float32)
    ).reshape(npart, nbin)
    sumsq = z.index_add_(0, idx, series * series).reshape(npart, nbin)
    n_i = torch.clamp(counts.sum(dim=1), min=1.0)
    mean_i = prof.sum(dim=1) / n_i
    var_i = torch.clamp(sumsq.sum(dim=1) / n_i - mean_i ** 2, min=1e-9)
    return prof, counts, mean_i, var_i


def _roll_index(shifts: torch.Tensor, nbin: int) -> torch.Tensor:
    """(..., nbin) gather index (b + shift) mod nbin for each shift."""
    ar = torch.arange(nbin, device=shifts.device)
    return (ar + shifts[..., None]) % nbin


def _shift_and_sum(subints: torch.Tensor, shifts: torch.Tensor,
                   nbin: int) -> torch.Tensor:
    """Roll subint i by shifts[..., i] bins and sum over subints:
    (npart, nbin) with shifts (..., npart) -> (..., nbin)."""
    idx = _roll_index(shifts, nbin)                  # (..., npart, nbin)
    src = subints.expand(*idx.shape)
    return torch.gather(src, -1, idx).sum(dim=-2)


def _profile_chi2(profile: torch.Tensor, counts: torch.Tensor,
                  varsum: torch.Tensor | None = None) -> torch.Tensor:
    """Reduced chi-square of profiles (..., nbin) against a flat
    baseline; varsum is the per-bin summed measured variance (None
    assumes unit-variance samples)."""
    tot = counts.sum(dim=-1, keepdim=True)
    mean_rate = profile.sum(dim=-1, keepdim=True) / torch.clamp(tot,
                                                                min=1.0)
    expected = mean_rate * counts
    var = torch.clamp(counts if varsum is None else varsum, min=1e-9)
    chi2 = ((profile - expected) ** 2 / var).sum(dim=-1)
    return chi2 / (profile.shape[-1] - 1)


def _grid_chi2(subints, counts, part_times, dps, dpdots, period: float,
               nbin: int, vcounts=None) -> np.ndarray:
    """chi2 for every (dp, dpdot) combination via subint shifting, as
    a (ndp, ndpd) host array.  A period error dp advances phase
    linearly in time, dphi(t) = -dp*t/p^2, a pdot error
    quadratically, dphi(t) = -0.5*dpdot*t^2/p^2; subint i (mid-time
    t_i) is shifted by round(nbin*dphi(t_i)).  All in float32 on the
    device, one dp row at a time."""
    p2 = torch.tensor(period, dtype=torch.float32,
                      device=subints.device) ** 2
    rows = []
    for dp in dps:
        dphi = -(dp * part_times[None, :]
                 + 0.5 * dpdots[:, None] * part_times[None, :] ** 2) / p2
        shifts = torch.round(dphi * nbin).to(torch.int64)
        prof = _shift_and_sum(subints, shifts, nbin)
        csum = _shift_and_sum(counts, shifts, nbin)
        vsum = (None if vcounts is None
                else _shift_and_sum(vcounts, shifts, nbin))
        rows.append(_profile_chi2(prof, csum, vsum))
    return torch.stack(rows).cpu().numpy()


def _fold_subbands_with_bins(subb: torch.Tensor, idx: torch.Tensor,
                             nbin: int, npart: int, nsub: int):
    """subb (nsub, T) + per-sample (part*nbin + bin) index -> per
    (part, sub, bin) profiles, counts, and per-(part, sub) measured
    sample mean and variance."""
    sub_off = (torch.arange(nsub, device=subb.device) * nbin)[:, None]
    full = ((idx[None, :] // nbin) * (nsub * nbin) + sub_off
            + (idx[None, :] % nbin)).reshape(-1)
    n = npart * nsub * nbin
    flat = subb.reshape(-1)
    prof = torch.zeros(n, dtype=subb.dtype, device=subb.device
                       ).index_add_(0, full, flat)
    counts = torch.zeros(n, dtype=torch.float32, device=subb.device
                         ).index_add_(0, full, torch.ones_like(flat))
    sumsq = torch.zeros(n, dtype=subb.dtype, device=subb.device
                        ).index_add_(0, full, flat * flat)
    prof = prof.reshape(npart, nsub, nbin)
    counts = counts.reshape(npart, nsub, nbin)
    sumsq = sumsq.reshape(npart, nsub, nbin)
    n_i = torch.clamp(counts.sum(dim=2), min=1.0)
    mean_i = prof.sum(dim=2) / n_i
    var_i = torch.clamp(sumsq.sum(dim=2) / n_i - mean_i ** 2, min=1e-9)
    return prof, counts, mean_i, var_i


def _shift_sum_cube(stack: torch.Tensor, part_shifts: torch.Tensor,
                    sub_shifts: torch.Tensor, nbin: int) -> torch.Tensor:
    """Roll stack[i, s] by part_shifts[i] + sub_shifts[s] bins and sum
    over both axes -> (nbin,)."""
    total = (part_shifts[:, None] + sub_shifts[None, :]) % nbin
    return torch.gather(stack, 2, _roll_index(total, nbin)).sum(dim=(0, 1))


def _dm_grid_chi2(stack, counts, vcounts, part_shifts, all_sub_shifts,
                  nbin: int) -> np.ndarray:
    """chi2 for every DM trial's per-subband shift row (host array)."""
    out = []
    for sub_sh in all_sub_shifts:
        prof = _shift_sum_cube(stack, part_shifts, sub_sh, nbin)
        csum = _shift_sum_cube(counts, part_shifts, sub_sh, nbin)
        vsum = _shift_sum_cube(vcounts, part_shifts, sub_sh, nbin)
        out.append(_profile_chi2(prof, csum, vsum))
    return torch.stack(out).cpu().numpy()


def _pp_shifts(dp, dpd, part_times, period, nbin, device):
    """Integer profile-bin shift per subint for a (dp, dpdot) offset,
    computed on the host in float64."""
    t = np.asarray(part_times, np.float64)
    dphi = -(dp * t + 0.5 * dpd * t * t) / period ** 2
    return torch.from_numpy(np.round(dphi * nbin).astype(np.int64)
                            ).to(device)


def _dm_bin_shifts(ddm, sub_freqs_mhz, ref_mhz, period, nbin):
    """Profile-bin shift per subband for a DM offset ddm."""
    dt_s = KDM * ddm * (np.asarray(sub_freqs_mhz, np.float64) ** -2
                        - ref_mhz ** -2)
    return np.round(dt_s / period * nbin).astype(np.int64)


def _sym_grid(extent: int, step: int) -> np.ndarray:
    """Symmetric grid around 0 (0 is always a point: the nominal
    parameters must be testable)."""
    pos = np.arange(0, extent + 1, step)
    return np.concatenate([-pos[:0:-1], pos]).astype(np.float64)


def _unit_variance_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row to zero mean and unit (population) variance."""
    mean = x.mean(dim=-1, keepdim=True)
    std = x.std(dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.clamp(std, min=1e-9)


def fold_subbands_and_optimize(
        subbands: torch.Tensor, sub_freqs_mhz: np.ndarray, dt: float,
        period: float, dm: float, pdot: float = 0.0,
        rules: FoldRules | None = None,
        sub_shifts_dm0: np.ndarray | None = None) -> FoldResult:
    """Fold subbands and refine the candidate over (p, pdot, DM).

    As prepfold folds subband files (PALFA2_presto_search.py:168-175),
    a DM offset is a per-subband rotation of already-folded profiles:
    profiles are accumulated per (subint, subband, bin) once, then the
    axes are searched by rolling the stack — coordinate descent (p/pdot
    grid, DM grid, p/pdot again).

    subbands: (nsub, T) tensor, each subband internally dedispersed to
    `dm` with inter-subband delays intact (stage-1 output).
    sub_shifts_dm0: integer sample shift per subband aligning the
    subbands at `dm` (the stage-2 row); None = already aligned."""
    rules = rules or fold_rules(period)
    nbin, npart = rules.nbin, rules.npart
    subb = subbands.to(torch.float32)
    dev = subb.device
    nsub, T = subb.shape
    if sub_shifts_dm0 is not None:
        from tpulsar_torch.kernels.dedisperse import shift_rows

        subb = shift_rows(subb, sub_shifts_dm0)
    # unit variance per subband so the chi2's variance model holds
    subb = _unit_variance_rows(subb)

    T_s = T * dt
    idx = torch.from_numpy(_part_bin_index(T, dt, period, pdot, nbin,
                                           npart)).to(dev)
    stack, counts, mean_ps, var_ps = _fold_subbands_with_bins(
        subb, idx, nbin, npart, nsub)
    # centre each (subint, subband) on its measured baseline and weight
    # its variance by its measured scatter
    stack = stack - mean_ps[..., None] * counts
    vcounts3 = var_ps[..., None] * counts

    part_times = (torch.arange(npart, dtype=torch.float32, device=dev)
                  + 0.5) * (T_s / npart)
    ref_mhz = float(np.asarray(sub_freqs_mhz)[-1])

    dp_unit = period ** 2 / (nbin * T_s)
    dpd_unit = 2.0 * period ** 2 / (nbin * T_s ** 2)
    dps = _sym_grid(rules.mp * nbin, rules.pstep) * dp_unit
    if rules.search_pdot:
        dpds = _sym_grid(rules.mp * nbin, rules.pdstep) * dpd_unit
    else:
        dpds = np.zeros(1)
    # DM unit: the offset that smears one profile bin across the band
    band_span = (float(np.asarray(sub_freqs_mhz)[0]) ** -2
                 - ref_mhz ** -2)
    ddm_unit = period / (nbin * KDM * max(band_span, 1e-12))
    ddms = _sym_grid(rules.mdm * nbin, rules.dmstep) * ddm_unit
    dps_t = torch.tensor(dps, dtype=torch.float32, device=dev)
    dpds_t = torch.tensor(dpds, dtype=torch.float32, device=dev)

    def pp_scan(sub_sh):
        """(p, pdot) grid at fixed per-subband shifts -> best point.
        Collapses the subband axis once at this DM, then reuses the
        2-d subint machinery."""
        idxs = _roll_index(sub_sh, nbin)[None].expand(npart, nsub, nbin)
        coll = torch.gather(stack, 2, idxs).sum(dim=1)
        ccoll = torch.gather(counts, 2, idxs).sum(dim=1)
        vcoll = torch.gather(vcounts3, 2, idxs).sum(dim=1)
        chi = _grid_chi2(coll, ccoll, part_times, dps_t, dpds_t, period,
                         nbin, vcounts=vcoll)
        i, j = np.unravel_index(np.argmax(chi), chi.shape)
        return float(dps[i]), float(dpds[j]), coll, ccoll, vcoll

    # round 1: p/pdot at the nominal DM
    zero_sub = torch.zeros(nsub, dtype=torch.int64, device=dev)
    best_dp, best_dpd, _, _, _ = pp_scan(zero_sub)

    # the DM axis at the best (p, pdot)
    pt_host = part_times.cpu().numpy()
    part_sh = _pp_shifts(best_dp, best_dpd, pt_host, period, nbin, dev)
    all_sub_sh = torch.from_numpy(np.stack([
        _dm_bin_shifts(d, sub_freqs_mhz, ref_mhz, period, nbin)
        for d in ddms])).to(dev)
    chis = _dm_grid_chi2(stack, counts, vcounts3, part_sh, all_sub_sh,
                         nbin)
    best_ddm = float(ddms[int(np.argmax(chis))])

    # round 2: p/pdot again at the best DM
    best_sub_sh = torch.from_numpy(_dm_bin_shifts(
        best_ddm, sub_freqs_mhz, ref_mhz, period, nbin)).to(dev)
    best_dp, best_dpd, coll, ccoll, vcoll = pp_scan(best_sub_sh)

    shifts = _pp_shifts(best_dp, best_dpd, pt_host, period, nbin, dev)
    prof = _shift_and_sum(coll, shifts, nbin)
    csum = _shift_and_sum(ccoll, shifts, nbin)
    vsum = _shift_and_sum(vcoll, shifts, nbin)
    red_chi2 = float(_profile_chi2(prof, csum, vsum))
    return FoldResult(
        period_s=period - best_dp, pdot=pdot - best_dpd,
        dm=dm + best_ddm, nbin=nbin, npart=npart,
        profile=prof.cpu().numpy(), subints=coll.cpu().numpy(),
        reduced_chi2=red_chi2, delta_p=best_dp, delta_pdot=best_dpd,
        delta_dm=best_ddm)


def fold_and_optimize(series: torch.Tensor, dt: float, period: float,
                      pdot: float = 0.0, dm: float = 0.0, nbin: int = 64,
                      npart: int = 32, np_grid: int = 21,
                      npd_grid: int = 11) -> FoldResult:
    """Fold a (T,) series tensor and refine the candidate over a
    (p, pdot) grid of +-2 Fourier-resolution period steps (prepfold's
    search breadth for search-mode candidates)."""
    series = series.to(torch.float32)
    dev = series.device
    # global normalization for conditioning only: the chi2 uses each
    # subint's measured variance
    series = _unit_variance_rows(series[None])[0]
    T_s = series.shape[0] * dt
    subints, counts, mean_i, var_i = fold_series(series, dt, period,
                                                 pdot, nbin, npart)
    subints = subints - mean_i[:, None] * counts
    vcounts = var_i[:, None] * counts

    # the period step that drifts one phase turn over T: dp = p^2/T
    dp_max = 2.0 * period ** 2 / T_s
    dpd_max = 4.0 * period ** 2 / T_s ** 2
    dps = torch.linspace(-dp_max, dp_max, np_grid, device=dev)
    dpdots = torch.linspace(-dpd_max, dpd_max, npd_grid, device=dev)
    part_times = (torch.arange(npart, dtype=torch.float32, device=dev)
                  + 0.5) * (T_s / npart)

    chi = _grid_chi2(subints, counts, part_times, dps, dpdots, period,
                     nbin, vcounts=vcounts)
    pi, pdi = np.unravel_index(np.argmax(chi), chi.shape)
    best_dp = float(dps[pi])
    best_dpd = float(dpdots[pdi])

    shifts = _pp_shifts(best_dp, best_dpd, part_times.cpu().numpy(),
                        period, nbin, dev)
    prof = _shift_and_sum(subints, shifts, nbin)
    csum = _shift_and_sum(counts, shifts, nbin)
    vsum = _shift_and_sum(vcounts, shifts, nbin)
    red_chi2 = float(_profile_chi2(prof, csum, vsum))
    # a positive best_dp means the pulse drifted as if the folding
    # period were too long by best_dp: the true period is smaller
    return FoldResult(period_s=period - best_dp, pdot=pdot - best_dpd,
                      dm=dm, nbin=nbin, npart=npart,
                      profile=prof.cpu().numpy(),
                      subints=subints.cpu().numpy(),
                      reduced_chi2=red_chi2, delta_p=best_dp,
                      delta_pdot=best_dpd)
