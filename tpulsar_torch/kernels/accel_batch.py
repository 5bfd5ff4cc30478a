"""Host-side batch planner for the batched FDAS acceleration search —
counterpart of tpulsar/kernels/accel_batch.py, copied.

The batched hi-accel path (kernels/accel.py) correlates all
z-templates against a batch of B whitened DM-trial spectra at once
(overlap-save correlation -> harmonic-stage sums -> block-max top-k).
This module decides B on the host, before any device work:

  * the memory-budgeted batch size: ``plane_dm_chunk`` turns the plane
    dtype and the device-memory budget into a row count, an input to
    batch planning, never a refusal;
  * the ladder (:data:`BATCH_QUANTA`): the batch size snaps down and
    the spectra block's row count snaps up to a rung.  The JAX package
    quantizes to bound its compile signatures; the port keeps the same
    schedule so both packages search the same rows in the same
    batches.  The last dispatch is CLAMPED to re-cover earlier rows
    (``starts``) at the same batch size;
  * the dispatch schedule itself (:class:`BatchPlan`).

Pad rows (those >= ndms of a quantized block) are never inside any
:class:`BatchPlan` start, so they are never correlated and never
surface as candidates.

Pure host arithmetic: planning and its tests touch no device.
"""

from __future__ import annotations

import dataclasses

#: the ladder: 2^k and 1.5 * 2^k rungs, ratio <= 2 between neighbours
BATCH_QUANTA: tuple[int, ...] = (
    1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
    384, 512)


def quantize_batch(n: int) -> int:
    """Largest ladder rung <= n (n >= 1): the batch size a budget of n
    rows dispatches at."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    best = BATCH_QUANTA[0]
    for q in BATCH_QUANTA:
        if q > n:
            break
        best = q
    return best


def quantize_rows_up(n: int) -> int:
    """Smallest ladder rung >= n: the padded row count a spectra block
    of n DM trials is shaped to.  Above the top rung the count passes
    through unquantized."""
    if n < 1:
        raise ValueError(f"row count must be >= 1, got {n}")
    for q in BATCH_QUANTA:
        if q >= n:
            return q
    return n


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """The dispatch schedule for one DM block.

    ``b`` is the batch size every dispatch uses; ``starts`` the row
    offsets, the final one CLAMPED to ``ndms - b`` so the ragged tail
    re-covers already-searched rows at the same batch size.
    ``padded_rows`` is the row count the spectra block is zero-padded
    to (its rows ``>= ndms`` are never inside any start's window)."""

    ndms: int
    b: int
    starts: tuple[int, ...]
    padded_rows: int

    @property
    def nbatches(self) -> int:
        return len(self.starts)

    def rows_of(self, s0: int) -> range:
        """The real DM rows batch ``s0`` resolves (a clamped tail
        re-covers rows an earlier batch already filled)."""
        return range(s0, s0 + self.b)


def _clamped_starts(ndms: int, b: int) -> tuple[int, ...]:
    return tuple(min(c0, ndms - b) for c0 in range(0, ndms, b))


def plan_batches(ndms: int, budget_rows: int) -> BatchPlan:
    """Schedule ``ndms`` DM trials under a ``budget_rows`` batch-size
    budget (from ``accel.plane_dm_chunk``): quantized batch size,
    clamped tail, quantized padded block shape."""
    if ndms < 1:
        raise ValueError(f"ndms must be >= 1, got {ndms}")
    b = quantize_batch(max(1, min(budget_rows, ndms)))
    return BatchPlan(ndms=ndms, b=b, starts=_clamped_starts(ndms, b),
                     padded_rows=quantize_rows_up(ndms))


def plan_batches_explicit(ndms: int, b: int) -> BatchPlan:
    """Schedule with an EXPLICIT batch size (a test control): ``b`` is
    honoured exactly, only the padded block shape still snaps; same
    clamped-tail starts as :func:`plan_batches`."""
    if ndms < 1:
        raise ValueError(f"ndms must be >= 1, got {ndms}")
    b = max(1, min(b, ndms))
    return BatchPlan(ndms=ndms, b=b, starts=_clamped_starts(ndms, b),
                     padded_rows=quantize_rows_up(ndms))


def batch_rows(rows: int, nbins: int, nz: int, device="cpu") -> int:
    """The quantized batch size a ``rows``-trial block at this plane
    geometry dispatches with on `device` (the plane dtype and z chunk,
    hence the budget, depend on the device type)."""
    from tpulsar_torch.kernels import accel as ak

    return quantize_batch(max(1, min(ak.plane_dm_chunk(nbins, nz,
                                                       device=device),
                                     rows)))
