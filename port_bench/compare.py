"""The comparison that decides `correct`: the program's outputs of a
pass against the plain reference's, as gaps in sigma.

Each gap is the larger of two readings, over every output compared:
  * for each event or candidate the program reported, the distance
    between its sigma and the reference's sigma at the same row,
    width or harmonic stage, sample or bin (and z);
  * for each event or candidate the reference finds (above the
    threshold, among the top k of its row), how far its sigma lies
    above what the program reported in the same row, stage and block;
    where the program reported nothing there, above the larger of the
    threshold and the row's k-th block (for the hi stage also the
    block's z = 0 value, which the hi stage leaves to the lo stage).
A near tie at a threshold, a top-k edge or an argmax then reads as
the tie's width, and an output that is missing, moved or altered
reads as its own distance.

The sifted list of a call that completed is compared exactly: the
count of candidates in one list and not in the other.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from port_bench import reference as ref


def rows_of(dms: np.ndarray, values) -> np.ndarray:
    """Row index of each DM value (exact to 1e-6; -1 when none)."""
    dms = np.asarray(dms, np.float64)
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return np.zeros(0, np.int64)
    i = np.abs(v[:, None] - dms[None, :]).argmin(1)
    return np.where(np.abs(dms[i] - v) < 1e-6, i, -1)


def power_for_sigma(sigma: float, h: int, numindep: int) -> float:
    """The summed power at which sigma_from_power reaches `sigma`
    (bisection; the sigma rises with the power)."""
    lo, hi = 0.0, 1.0
    while ref.sigma_from_power(hi, h, numindep) < sigma:
        hi *= 2.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if ref.sigma_from_power(mid, h, numindep) < sigma:
            lo = mid
        else:
            hi = mid
    return lo


def sp_gap(spr: ref.SPRef, dms, events, threshold: float) -> tuple:
    """(gap, number compared) of a pass's single-pulse events."""
    widths = list(spr.widths)
    gaps = [0.0]
    ev = np.asarray(events)
    prog_best: dict = {}
    if len(ev):
        rows = rows_of(dms, ev["dm"])
        if (rows < 0).any() or not np.isin(ev["downfact"], widths).all():
            return float("inf"), len(ev)
        sig = ev["sigma"].astype(np.float64)
        samp = ev["sample"].astype(np.int64)
        T = spr.cs.shape[1] - 1
        w = ev["downfact"].astype(np.int64)
        inside = (samp >= 0) & (samp + w <= T)
        if not inside.all():
            return float("inf"), len(ev)
        gaps.append(float(np.abs(sig - spr.snr(rows, w, samp)).max()))
        for r, b, s in zip(rows.tolist(), (samp // ref.SP_BLOCK).tolist(),
                           sig.tolist()):
            prog_best[(r, b)] = max(s, prog_best.get((r, b), -np.inf))
    kth = spr.kth.double().cpu().numpy()
    ref_ev = ref.sp_events(spr, threshold)
    for (r, b), (s, _samp, w) in ref_ev.items():
        floor = max(prog_best.get((r, b), threshold),
                    kth[widths.index(w), r])
        gaps.append(max(0.0, s - floor))
    return max(gaps), len(ev) + len(ref_ev)


def _ref_cands(st: ref.StageRef, p_floor: float) -> tuple:
    """(rows, blocks, bins, powers) of a stage's block maxima among
    the top k, at or above p_floor, at r >= 1, with a positive
    power."""
    ok = (st.bmax >= st.kth[:, None]) & (st.bmax >= p_floor) \
        & (st.bmax > 0)
    rows, blks = torch.nonzero(ok, as_tuple=True)
    bins = blks * ref.CAND_BLOCK + st.barg[rows, blks]
    keep = bins >= 2
    rows, blks, bins = rows[keep], blks[keep], bins[keep]
    return (rows.cpu().numpy(), blks.cpu().numpy(), bins.cpu().numpy(),
            st.bmax[rows, blks].double().cpu().numpy())


def cand_gap(stages: dict, row_ids: np.ndarray, cands: dict,
             numindep, threshold: float, hi: bool = False,
             zs: np.ndarray | None = None) -> tuple:
    """(gap, number compared) of one stage family's candidates.

    stages: {h: StageRef} over the rows row_ids (pass row numbers);
    cands: the program's candidates of those rows, as columns row, h,
    bin, sigma (and z for the hi stage); numindep(h) the stage's trial
    count."""
    gaps = [0.0]
    n = 0
    local = {int(r): i for i, r in enumerate(row_ids)}
    for h, st in stages.items():
        sel = cands["h"] == h
        prows = cands["row"][sel]
        pbins = cands["bin"][sel]
        psig = cands["sigma"][sel]
        nr = st.sums.shape[-1]
        if len(prows):
            li = np.asarray([local[int(r)] for r in prows])
            if (pbins < 0).any() or (pbins >= nr).any():
                return float("inf"), n + len(prows)
            li_t = torch.as_tensor(li, device=st.sums.device)
            b_t = torch.as_tensor(pbins, device=st.sums.device)
            if hi:
                zi = np.rint(cands["z"][sel] / 2.0).astype(np.int64) \
                    + (len(zs) - 1) // 2
                if (zi < 0).any() or (zi >= len(zs)).any():
                    return float("inf"), n + len(prows)
                v = st.plane[li_t, torch.as_tensor(zi, device=b_t.device),
                             b_t]
            else:
                v = st.sums[li_t, b_t]
            rs = ref.sigma_from_power(v.double().cpu().numpy(), h,
                                      numindep(h))
            gaps.append(float(np.abs(psig - rs).max()))
            n += len(prows)
        best: dict = {}
        for r, b, s in zip(prows.tolist(),
                           (pbins // ref.CAND_BLOCK).tolist(),
                           psig.tolist()):
            best[(r, b)] = max(s, best.get((r, b), -np.inf))
        p_thr = power_for_sigma(threshold, h, numindep(h))
        rr, bb, rbins, pw = _ref_cands(st, p_thr)
        if hi and len(rr):
            zarg = st.zarg[torch.as_tensor(rr, device=st.zarg.device),
                           torch.as_tensor(rbins, device=st.zarg.device)]
            zval = zs[zarg.cpu().numpy()]
            keep = np.abs(zval) >= 1.0
            rr, bb, pw = rr[keep], bb[keep], pw[keep]
        if not len(rr):
            continue
        rs = ref.sigma_from_power(pw, h, numindep(h))
        kth = st.kth.double().cpu().numpy()
        floors = ref.sigma_from_power(np.maximum(kth, 0.0), h, numindep(h))
        zero = None
        if hi:
            zero = ref.sigma_from_power(
                np.maximum(st.zero_bmax.double().cpu().numpy(), 0.0), h,
                numindep(h))
        for j, (li, b, s) in enumerate(zip(rr.tolist(), bb.tolist(),
                                           rs.tolist())):
            r = int(row_ids[li])
            floor = max(best.get((r, b), threshold), floors[li])
            if zero is not None:
                floor = max(floor, zero[li, b])
            gaps.append(max(0.0, s - floor))
        n += len(rr)
    return max(gaps), n


def cand_columns(z: dict, dms: np.ndarray) -> dict:
    """A pass artifact's candidate columns as rows, harmonic stage,
    half-bin index, sigma, z (rows -1 when the DM is not the pass's)."""
    r = np.asarray(z["r"], np.float64)
    return {"row": rows_of(dms, z["dm"]),
            "h": np.asarray(z["numharm"], np.int64),
            "bin": np.rint(2.0 * r).astype(np.int64),
            "sigma": np.asarray(z["sigma"], np.float64),
            "z": np.asarray(z["z"], np.float64)}


def select(cols: dict, mask: np.ndarray) -> dict:
    return {k: v[mask] for k, v in cols.items()}


def sifted_mismatch(prog: list, want: list, refined: bool) -> int:
    """Candidates in one list and not in the other.  Each is keyed by
    every field, or, where refinement re-measured the fold-worthy
    candidates, by DM, harmonics and hit count."""
    def key(c):
        hits = len(c.hits) if hasattr(c, "hits") else len(c.dm_hits)
        if refined:
            return (c.dm, c.numharm, hits)
        return (c.r, c.z, c.sigma, c.power, c.numharm, c.dm, c.period_s,
                c.freq_hz, hits)
    a = sorted(map(key, prog))
    b = sorted(map(key, want))
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())
