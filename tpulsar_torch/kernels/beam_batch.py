"""Batch-of-beams: the host planner and the coalesced stage-1/stage-2
calls for searching B compatible beams through one dispatch stream —
counterpart of tpulsar/kernels/beam_batch.py.

The contract is the reference's: every beam's candidates and
checkpoint artifacts are bit-identical whether it ran batched or
solo.  So the beam axis rides the device work only where the per-beam
float arithmetic stays the solo path's:

  * stage 1 folds the beam axis into the SUBBAND axis: B beams'
    channel blocks stack to ``(B*nchan, T)`` and one ``form_subbands``
    launch runs with ``nsub' = B*nsub`` and the channel shifts tiled B
    times — each output subband sums exactly the channels, in exactly
    the order, of the solo call;
  * stage 2 is the CUDA kernel's beam axis
    (``cuda_dd.dedisperse_subbands_beams``, gridDim.y = B): beam y of
    the launch is the solo launch on beam y's subbands;
  * every later stage runs on each beam's rows at the solo shapes
    (search/executor._group_plan_loop): the reference hands them
    ``B*chunk`` rows, but torch's CUDA reductions size their launch by
    the row count, which would make a row's sums depend on its
    batchmates.

The JAX package runs stage 1/2 per beam wherever its solo path would
take a Pallas kernel (``coalesce_dd_ok``), because those kernels have
no beam axis.  Both of this package's stage-1/2 formulations (the CUDA
kernels and their plain versions) carry one bit-identically, so they
always coalesce; the tree family still runs its levels per beam, as
in the reference.

Group sizes are quantized to the shared :data:`~tpulsar_torch.kernels.
accel_batch.BATCH_QUANTA` ladder, and a beam that cannot ride the
batch falls out to the solo path (search/executor.search_beam_batch).
The planning below is the reference's host arithmetic, copied.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tpulsar_torch.kernels import cuda_dd
from tpulsar_torch.kernels import dedisperse as dd
from tpulsar_torch.kernels.accel_batch import quantize_batch

#: default coalesced working-set budget (bytes) the beam planner
#: sizes B against off the card — the beam-batch analogue of
#: SearchParams.spectral_hbm_budget, covering the B resident channel
#: blocks plus the per-chunk transients (TPULSAR_BEAM_BATCH_BYTES
#: overrides)
DEFAULT_BEAM_BUDGET = 8 << 30
#: on a CUDA device the default budget is this share of the card's
#: memory: the rest holds the hi stage's correlation planes (up to
#: 4 GiB, kernels/accel.plane_dm_chunk) and the allocator's slack.  At
#: the reference's 8 GiB a full Mock beam (a 3.77 GB uint8 block; about
#: 21 GB of budget_beams' model) never had a batchmate.
DEVICE_BUDGET_SHARE = 0.5


def beam_batch_cap() -> int:
    """The operator's beam-batch cap: ``TPULSAR_BEAM_BATCH`` pins the
    largest coalesced beam group (0 or unset = planner budget only;
    1 = coalescing off, every beam runs the solo path).  Invalid
    values fail loudly — a silently ignored pin would un-pin an A/B."""
    raw = os.environ.get("TPULSAR_BEAM_BATCH", "").strip()
    if not raw:
        return 0
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"TPULSAR_BEAM_BATCH must be an integer >= 0, got {raw!r}")
    if val < 0:
        raise ValueError(
            f"TPULSAR_BEAM_BATCH must be >= 0, got {val}")
    return val


def beam_budget_bytes(device=None) -> int:
    """The coalesced working-set budget: TPULSAR_BEAM_BATCH_BYTES,
    else DEVICE_BUDGET_SHARE of a CUDA ``device``'s memory, else
    DEFAULT_BEAM_BUDGET."""
    raw = os.environ.get("TPULSAR_BEAM_BATCH_BYTES", "").strip()
    if not raw:
        if device is not None and torch.device(device).type == "cuda":
            total = torch.cuda.get_device_properties(
                torch.device(device)).total_memory
            return int(total * DEVICE_BUDGET_SHARE)
        return DEFAULT_BEAM_BUDGET
    try:
        val = int(float(raw))
    except ValueError:
        raise ValueError(
            f"TPULSAR_BEAM_BATCH_BYTES must be a byte count, got "
            f"{raw!r}")
    if val <= 0:
        raise ValueError(
            f"TPULSAR_BEAM_BATCH_BYTES must be > 0, got {val}")
    return val


# ------------------------------------------------------------- compat key

def compat_key(nchan: int, nsamp: int, dt: float, f_lo: float,
               f_hi: float, nsub: int, plan, params,
               zap_digest: str = "") -> str:
    """The beam-compatibility fingerprint: two beams may share a
    coalesced dispatch exactly when every STATIC input to the device
    work matches — channel count, sample count, sample time, band
    edges, the DDplan geometry, the search params, and the zaplist
    (the whiten stage's keep mask is zap-derived).  Sky position and
    baryv do NOT key: they only shape per-beam host-side masks and
    refinement, which stay per-beam either way.  The same key as the
    JAX package's for the same beam (a ticket's declared ``compat``
    stamp is interchangeable between the packages)."""
    from tpulsar_torch.checkpoint import hashing

    geom = [(s.lodm, s.dmstep, s.dms_per_pass, s.numpasses, s.numsub,
             s.downsamp) for s in plan]
    prov = sorted(params.provenance().items())
    blob = repr((int(nchan), int(nsamp), float(dt), float(f_lo),
                 float(f_hi), int(nsub), geom, prov,
                 zap_digest)).encode()
    return hashing.sha256_bytes(blob)[:16]


def zaplist_digest(zaplist) -> str:
    """Stable digest of a zaplist array ('' = no zaplist)."""
    from tpulsar_torch.checkpoint import hashing
    if zaplist is None:
        return ""
    return hashing.sha256_bytes(
        np.ascontiguousarray(np.asarray(zaplist, np.float64))
        .tobytes())[:16]


# --------------------------------------------------------------- planning

@dataclasses.dataclass(frozen=True)
class BeamBatchPlan:
    """The host-side beam grouping for one coalesced search: which
    beam indices share each dispatch group.  Every group size is a
    :data:`BATCH_QUANTA` rung."""

    nbeams: int
    groups: tuple[tuple[int, ...], ...]

    @property
    def b_max(self) -> int:
        return max((len(g) for g in self.groups), default=0)


def plan_beam_groups(nbeams: int, cap: int = 0) -> BeamBatchPlan:
    """Greedy ladder decomposition of ``nbeams`` into quantized
    groups no wider than ``cap`` (0 = no cap): 5 beams at cap 0 plan
    as (4, 1); 7 at cap 3 as (3, 3, 1).  There are no clamped tails —
    re-covering a beam would recompute (and re-checkpoint) real
    per-beam science, so ragged remainders drop to the next rung
    down instead."""
    if nbeams < 1:
        raise ValueError(f"nbeams must be >= 1, got {nbeams}")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    groups = []
    start = 0
    while start < nbeams:
        left = nbeams - start
        b = quantize_batch(left if cap == 0 else max(1, min(cap,
                                                            left)))
        groups.append(tuple(range(start, start + b)))
        start += b
    return BeamBatchPlan(nbeams=nbeams, groups=tuple(groups))


def budget_beams(block_bytes: int, chunk_rows: int, nfft: int,
                 budget: int | None = None) -> int:
    """How many beams the coalesced working set affords: each beam
    keeps its channel block resident for the whole search (the fold
    stage re-subbands from it) and contributes ``chunk_rows`` rows of
    spectral transients per in-flight chunk (the same per-trial byte
    model as the executor's DM-chunk budget, x2 chunks in flight)."""
    if budget is None:
        budget = beam_budget_bytes()
    per_trial = 32 * nfft                  # executor's per-trial model
    per_beam = (3 * max(1, block_bytes)    # block + subbands + series
                + 2 * chunk_rows * per_trial)
    return max(1, int(budget // max(1, per_beam)))


# ------------------------------------------------------- device calls

def stack_blocks(blocks) -> torch.Tensor:
    """Concatenate B beams' (nchan, T) device blocks into the
    (B*nchan, T) stage-1 input (beam-major rows)."""
    return torch.cat(list(blocks), dim=0)


def form_subbands_beams(stacked: torch.Tensor, chan_shifts, nbeams: int,
                        nsub: int, downsamp: int) -> torch.Tensor:
    """Coalesced stage 1: (B*nchan, T) -> (B*nsub, T') in ONE
    form_subbands launch, the beam axis folded into the subband axis
    (the shifts tiled per beam; bit-equal to B solo calls)."""
    tiled = np.tile(np.asarray(chan_shifts), nbeams)
    return dd.form_subbands(stacked, tiled, nbeams * nsub, downsamp)


def dedisperse_beams(subb_stacked: torch.Tensor, sub_shifts,
                     nbeams: int) -> torch.Tensor:
    """Coalesced stage 2: (B*nsub, T') subbands + one (ndms, nsub)
    shift table -> (B*ndms, T') beam-major DM series, in one launch of
    the stage-2 kernel's beam axis (bit-equal per beam to
    ``dedisperse_subbands`` on that beam's subbands alone)."""
    nsub_total, T = subb_stacked.shape
    if nsub_total % nbeams:
        raise ValueError(
            f"stacked subband rows {nsub_total} not divisible by "
            f"nbeams {nbeams}")
    sub3 = subb_stacked.reshape(nbeams, nsub_total // nbeams, T)
    out = cuda_dd.dedisperse_subbands_beams(sub3, sub_shifts)
    return out.reshape(nbeams * out.shape[1], T)
