"""Tree dedispersion: the log-depth shift-tree stage-2 family —
counterpart of tpulsar/kernels/tree_dd.py.

The second stage-2 family next to the direct shift-and-sum of
kernels/dedisperse.py (the CUDA kernel of kernels/cuda_dd.py), built
on the piecewise-linear tree of Taylor recombinations ("Accelerating
incoherent dedispersion", arXiv:1201.5380):

  * LEVELS (log depth): a binary merge tree over the subband axis.
    At each level, adjacent subband groups are combined once per
    DISTINCT relative-shift pattern the pass's DM trials induce on
    the merged group — one add of two shifted parent rows per
    pattern — so the pass's trials share the low levels.

  * RESIDUAL layer: at the cut level each trial selects, per
    remaining group, the partial matching its exact pattern at its
    exact group-reference shift, and sums them in group order.

Every output sums exactly the same clamped-gather terms as the direct
kernel — out[d, t] = sum_s subb[s, min(t + shift[d, s], T-1)] — in
tree order instead of subband order, so the direct family is the
oracle at summation-order tolerance.  The plan arithmetic below is
the JAX package's, copied (NumPy only): both packages build the same
levels, cut and tables for a pass.  The JAX package runs the tree
outside any Pallas kernel, so its port is plain PyTorch: the levels
and the residual gathers are strided views gathered by advanced
indexing, summed in the reference's order (bit-identical to its
programs).  The residual optionally fuses the single-pulse
detrend/normalize (singlepulse.detrend_normalize), as the reference
does.

The level cut doubles as the memory governor: level tensors are
(rows, ~T) float32, and the plan refuses to keep a level whose
working set exceeds TPULSAR_TREE_BUDGET (cut 0 is exactly the direct
formulation).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tpulsar_torch.kernels import dedisperse as dd
from tpulsar_torch.kernels import singlepulse as sp_k

#: offset-budget floor: each level's consumed shift budget rounds up
#: to a power-of-two bucket no smaller than this, so the static level
#: lengths (and with them the compile signatures) take few distinct
#: values across a plan — only SHAPES are static, the index tables
#: are runtime arrays, so passes that agree on the bucketed geometry
#: share one compiled program
OFF_QUANT = 64

#: merge-row padding quantum: level row counts round up to this so
#: near-identical passes of one step share a compile signature
#: (padding rows re-merge row 0 at offset 0 and are never referenced
#: downstream — ~64 wasted row-adds per level, a few % of the work,
#: buys one program per step instead of one per pass)
ROW_QUANT = 64

#: default per-level working-set budget (bytes) for the level tensors
#: (the plan cuts the tree earlier when a level would exceed it);
#: override with TPULSAR_TREE_BUDGET
TREE_BUDGET_DEFAULT = 2 << 30

#: detrend block length the fused residual program uses — the
#: normalize_series default, shared so fused and standalone detrend
#: are the same program family
DETREND_BLOCK = 1000


def level_budget() -> int:
    """The level working-set budget in bytes (TPULSAR_TREE_BUDGET)."""
    raw = os.environ.get("TPULSAR_TREE_BUDGET", "").strip()
    if not raw:
        return TREE_BUDGET_DEFAULT
    try:
        return int(float(raw))
    except ValueError:
        raise ValueError(
            f"TPULSAR_TREE_BUDGET must be a byte count, got {raw!r}")


def _ceilto(x: int, quantum: int) -> int:
    return -(-int(x) // quantum) * quantum


def _off_bucket(x: int) -> int:
    """Power-of-two offset bucket (>= OFF_QUANT), 0 for 0 — the
    signature-stability analogue of dedisperse._pad_bucket."""
    if x <= 0:
        return 0
    p = OFF_QUANT
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class TreeLevel:
    """One merge level: row i of the level output is
    parent[a[i], da[i]:] + parent[b[i], db[i]:] for the merged rows,
    followed by the carry rows (odd leftover group, copied through).
    ``moff`` is the level's consumed offset budget: the output length
    shrinks by exactly moff so no dynamic slice ever clamps."""

    a: np.ndarray        # (rows_m,) int32 parent row of the A term
    da: np.ndarray       # (rows_m,) int32 shift of the A term
    b: np.ndarray        # (rows_m,) int32 parent row of the B term
    db: np.ndarray       # (rows_m,) int32 shift of the B term
    carry: np.ndarray    # (ncarry,) int32 parent rows copied through
    moff: int

    @property
    def rows(self) -> int:
        return len(self.a) + len(self.carry)


@dataclasses.dataclass(frozen=True)
class TreeDDPlan:
    """Host-side plan for one pass's tree evaluation (shared by every
    DM trial of the pass).  ``pidx``/``refs`` are the residual
    layer's per-trial gather table at the cut level: absolute partial
    row and group-reference shift per remaining group."""

    levels: tuple[TreeLevel, ...]
    pidx: np.ndarray     # (ndms, G) int32
    refs: np.ndarray     # (ndms, G) int32
    pad: int             # base edge-pad (covers every composed shift)
    ndms: int
    nsub: int

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def groups(self) -> int:
        return self.pidx.shape[1]

    @property
    def moffs(self) -> tuple[int, ...]:
        return tuple(lv.moff for lv in self.levels)

    @property
    def rows_out(self) -> int:
        """Row count of the cut-level partial tensor."""
        return self.levels[-1].rows if self.levels else self.nsub

    def cut_len(self, T: int) -> int:
        """Static length of the cut-level partial tensor."""
        return T + self.pad - sum(self.moffs)

    @property
    def level_rows(self) -> int:
        """Merge-level row count (the shared, trial-independent work)."""
        return sum(lv.rows for lv in self.levels)

    @property
    def residual_rows(self) -> int:
        """Residual-layer gather count (the per-trial work)."""
        return self.ndms * self.groups

    @property
    def cost_rows(self) -> int:
        """Total row-ops — the number the cost model weighs against
        the direct kernel's ndms * nsub."""
        return self.level_rows + self.residual_rows

    @property
    def residual_fraction(self) -> float:
        return self.residual_rows / max(1, self.cost_rows)

    def geom(self) -> tuple:
        """Hashable compile-signature key (static shapes only)."""
        return (tuple((len(lv.a), len(lv.carry), lv.moff)
                      for lv in self.levels), self.pad)


def _build_levels(sub_shifts: np.ndarray):
    """Full-depth host build.  Returns per-level TreeLevels plus the
    (refs, pidx) snapshot AFTER each level (index 0 = the leaves),
    with pidx rows absolute into that level's partial tensor."""
    sh = np.asarray(sub_shifts, np.int64)
    ndms, nsub = sh.shape
    refs = sh.copy()
    pidx = np.tile(np.arange(nsub, dtype=np.int32), (ndms, 1))
    snapshots = [(refs.copy(), pidx.copy())]
    levels: list[TreeLevel] = []
    G = nsub
    while G > 1:
        G2, has_carry = G // 2, G % 2 == 1
        a: list = []
        da: list = []
        b: list = []
        db: list = []
        new_refs = np.empty((ndms, G2 + has_carry), np.int64)
        new_pidx = np.empty((ndms, G2 + has_carry), np.int32)
        out_rows = 0
        for g in range(G2):
            ra, rb = refs[:, 2 * g], refs[:, 2 * g + 1]
            ref = np.minimum(ra, rb)
            key = np.stack([pidx[:, 2 * g], ra - ref,
                            pidx[:, 2 * g + 1], rb - ref], 1)
            uniq, inv = np.unique(key, axis=0, return_inverse=True)
            a.extend(uniq[:, 0])
            da.extend(uniq[:, 1])
            b.extend(uniq[:, 2])
            db.extend(uniq[:, 3])
            new_refs[:, g] = ref
            new_pidx[:, g] = out_rows + inv
            out_rows += len(uniq)
        # pad the merge rows to the row quantum (row 0 re-merged at
        # offset 0: finite, never referenced) BEFORE the carry block,
        # so carry rows sit at stable absolute indices
        rows_m = _ceilto(max(out_rows, 1), ROW_QUANT)
        pad_n = rows_m - out_rows
        a += [0] * pad_n
        da += [0] * pad_n
        b += [0] * pad_n
        db += [0] * pad_n
        carry_rows = np.empty(0, np.int32)
        if has_carry:
            uniq_c = np.unique(pidx[:, -1])
            remap = {int(r): i for i, r in enumerate(uniq_c)}
            carry_rows = uniq_c.astype(np.int32)
            new_refs[:, -1] = refs[:, -1]
            new_pidx[:, -1] = rows_m + np.asarray(
                [remap[int(r)] for r in pidx[:, -1]], np.int32)
        moff = _off_bucket(max(max(da), max(db)))
        levels.append(TreeLevel(
            a=np.asarray(a, np.int32), da=np.asarray(da, np.int32),
            b=np.asarray(b, np.int32), db=np.asarray(db, np.int32),
            carry=carry_rows, moff=moff))
        refs, pidx = new_refs, new_pidx
        snapshots.append((refs.copy(), pidx.copy()))
        G = refs.shape[1]
    return levels, snapshots


def build_tree_plan(sub_shifts, T: int | None = None,
                    budget: int | None = None) -> TreeDDPlan:
    """Build the pass's tree plan, cut at the cheapest feasible level.

    The cut minimizes total row-ops (merge rows + ndms x remaining
    groups) subject to the level working-set budget: two adjacent
    level tensors are live during a merge, each (rows, ~T+pad)
    float32.  Cut 0 keeps no levels — the residual scan over all
    nsub groups, i.e. exactly the direct formulation."""
    sh = np.asarray(sub_shifts, np.int64)
    ndms, nsub = sh.shape
    levels, snapshots = _build_levels(sh)
    budget = level_budget() if budget is None else budget

    def pad_for(cut: int) -> int:
        base = sum(lv.moff for lv in levels[:cut])
        max_ref = int(snapshots[cut][0].max(initial=0))
        return base + _off_bucket(max_ref)

    candidates = [(0, ndms * nsub)]
    for cut in range(1, len(levels) + 1):
        cost = (sum(lv.rows for lv in levels[:cut])
                + ndms * snapshots[cut][0].shape[1])
        if T is not None and budget is not None:
            bytes_per_row = (T + pad_for(cut)) * 4
            peak = max(
                (levels[j].rows
                 + (levels[j - 1].rows if j else nsub))
                * bytes_per_row
                for j in range(cut))
            if peak > budget:
                break      # deeper cuts only grow the levels kept
        candidates.append((cut, cost))
    best_cost = min(c for _cut, c in candidates)
    # near-tie break toward the DEEPEST cut: adjacent passes of one
    # step land on near-identical costs, and a cut flip between them
    # would split one compile signature into two for a <5% cost
    # difference
    best_cut = max(cut for cut, c in candidates
                   if c <= best_cost * 1.05)
    refs_c, pidx_c = snapshots[best_cut]
    return TreeDDPlan(
        levels=tuple(levels[:best_cut]),
        pidx=pidx_c.astype(np.int32),
        refs=refs_c.astype(np.int32),
        pad=pad_for(best_cut), ndms=ndms, nsub=nsub)


def _cuda_stage2_active(device) -> bool:
    """True when stage 2 of a tensor on ``device`` is the hand-written
    CUDA kernel (kernels/cuda_dd.py): a CUDA device.  It stands where
    the reference's _pallas_stage2_active stands."""
    return torch.device(device).type == "cuda"


def plan_for_pass(sub_shifts, T: int, budget: int | None = None,
                  family: str | None = None,
                  device="cpu") -> TreeDDPlan | None:
    """THE direct-vs-tree decision point: the pass's TreeDDPlan when
    the tree family should run it, else None (direct family).

    ``family`` overrides the decision ("tree"/"direct"); by default
    the TPULSAR_DD_FAMILY override is consulted first, then: on the
    card (``device`` a CUDA device) 'auto' keeps the CUDA direct
    kernel (TPULSAR_DD_FAMILY=tree forces the tree, for the on-chip
    A/B); otherwise the ddplan cost model decides (tree must predict
    a clear row-op win) — the reference's rule with the CUDA kernel
    in place of its Pallas one."""
    from tpulsar_torch.plan import ddplan

    fam = family or ddplan.dedisp_family_override()
    if fam == "direct":
        return None
    sh = np.asarray(sub_shifts)
    if sh.ndim != 2 or sh.shape[1] < 2:
        return None
    if fam == "tree":
        return build_tree_plan(sh, T=T, budget=budget)
    if _cuda_stage2_active(device):
        return None
    plan = build_tree_plan(sh, T=T, budget=budget)
    choice = ddplan.choose_dedisp_family(
        plan.ndms, plan.nsub, tree_cost_rows=plan.cost_rows)
    return plan if choice == "tree" else None


# ------------------------------------------------------------- programs

def _rows_at(parent: torch.Tensor, rows, offs, length: int
             ) -> torch.Tensor:
    """out[i] = parent[rows[i], offs[i]: offs[i] + length], gathered
    from the (rows, L - length + 1, length) window view."""
    dev = parent.device
    win = parent.unfold(1, length, 1)
    return win[torch.as_tensor(rows, dtype=torch.long, device=dev),
               torch.as_tensor(offs, dtype=torch.long, device=dev)]


def tree_levels(subb: torch.Tensor, plan: TreeDDPlan) -> torch.Tensor:
    """The shared merge levels, run ONCE per pass: (nsub, T) ->
    (rows_cut, T + pad - sum(moffs)).  All shifts compose on one
    edge-padded copy, and each level's output length shrinks by its
    moff so no slice ever clamps (the reference's _tree_levels_jit)."""
    if subb.shape[0] != plan.nsub:
        raise ValueError(
            f"subband block has {subb.shape[0]} rows, plan expects "
            f"{plan.nsub}")
    cur = dd._edge_pad(subb.to(torch.float32), plan.pad)
    L = subb.shape[1] + plan.pad
    for lv in plan.levels:
        L_out = L - lv.moff
        parent = cur
        cur = _rows_at(parent, lv.a, lv.da, L_out)
        cur += _rows_at(parent, lv.b, lv.db, L_out)
        if len(lv.carry):
            cur = torch.cat([cur, _rows_at(parent, lv.carry,
                                           np.zeros_like(lv.carry),
                                           L_out)], dim=0)
        L = L_out
    return cur


def residual_series(parts: torch.Tensor, plan: TreeDDPlan, lo: int,
                    n: int, T: int, fuse: bool = False,
                    estimator: str = "median"):
    """Residual layer for the trial span [lo, lo+n) — the tree
    family's per-dm_chunk dispatch (the reference's
    _tree_residual_jit): each trial's pattern row per remaining group
    at its group-reference shift, accumulated from zero in group
    order.  Returns series, or (series, norm) with ``fuse`` (the SP
    detrend/normalize of the same series)."""
    pidx = plan.pidx[lo:lo + n]
    refs = plan.refs[lo:lo + n]
    series = torch.zeros((len(pidx), T), dtype=torch.float32,
                         device=parts.device)
    for g in range(pidx.shape[1]):
        series += _rows_at(parts, pidx[:, g], refs[:, g], T)
    if not fuse:
        return series
    return series, sp_k.detrend_normalize(series, DETREND_BLOCK,
                                          estimator)


def dedisperse_tree_pass(subb: torch.Tensor, sub_shifts,
                         plan: TreeDDPlan | None = None) -> torch.Tensor:
    """Whole-pass convenience (tests and the on-card A/B): levels +
    residual over every trial, no detrend fusion."""
    plan = plan or build_tree_plan(sub_shifts, T=int(subb.shape[1]))
    parts = tree_levels(subb, plan)
    return residual_series(parts, plan, 0, plan.ndms,
                           int(subb.shape[1]))
