"""Host rescue: recompute refused hi-accel work with the same row
program — counterpart of tpulsar/resilience/rescue.py.

When a DM row of the hi stage is refused twice (an injected refusal, a
dispatch past its watchdog deadline, a poisoned fault session), the row
is not zero-filled at once: the same row program
(kernels/accel.accel_row_topk) runs again on a host copy of the
spectra, so a refused row becomes a slower row and the beam stays
complete.

The rescue runs only for spectra that are already on the CPU (a
``--device cpu`` run, the fault-injection reproductions).  It never
moves work off the card: for spectra on a CUDA device ``available``
is False, the ladder ends on the card (refused rows are zero-filled
and recorded as lost, and a chunk whose every row is lost is skipped
loudly by the executor), exactly as with ``TPULSAR_HOST_RESCUE=0``.

On the CPU the rescue runs the identical program on the identical
device, so rescued rows are bit-identical to a clean run of the per-DM
path.

Only a refusal (kernels/accel.REFUSED) is caught here, on the fetch
and on each row: any other error propagates to the caller.

TPULSAR_HOST_RESCUE=0 disables the layer (refused rows zero-fill, as
before the rescue existed).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def enabled() -> bool:
    return os.environ.get("TPULSAR_HOST_RESCUE", "").strip() != "0"


def available(device) -> bool:
    """Whether refused rows of spectra on `device` are rescued: the
    layer is enabled and the spectra already lie on the CPU."""
    return enabled() and torch.device(device).type == "cpu"


def cpu_device() -> torch.device:
    """The host device the rescue recomputes on."""
    return torch.device("cpu")


def _off_host(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _fetch_deadline_s() -> float:
    """The accel dispatch watchdog deadline also bounds the rescue's
    fetches: a wedged fetch hangs rather than raises.  0 = no
    deadline."""
    try:
        return float(os.environ.get(
            "TPULSAR_ACCEL_DISPATCH_DEADLINE_S", "0"))
    except ValueError:
        return 0.0


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _fetch_host(x) -> np.ndarray | None:
    """Host tensor or array -> ndarray; None when the fetch is refused
    or outlives the watchdog deadline.  Any other error propagates."""
    from tpulsar_torch.kernels.accel import REFUSED
    from tpulsar_torch.resilience.policy import run_with_deadline
    try:
        return run_with_deadline(lambda: _to_host(x), _fetch_deadline_s(),
                                 label="host-rescue fetch")
    except REFUSED:
        return None


def rescue_accel_rows(spectra, bank, rows, *, max_numharm: int,
                      topk: int) -> tuple[dict[int, tuple], bool]:
    """Recompute refused accel rows with the same row program on the
    host CPU.

    spectra: the (ndms, nbins) complex spectra block (a CPU tensor or
    an array; a tensor on the card is never rescued).  bank: the
    TemplateBank the refused dispatches used.  rows: row indices
    refused twice.

    Returns ``(rescued, recompute_ran)``: {row: (vals[nstages, topk],
    rbins, zidx)} for the rows that rescued (missing rows are lost —
    the caller zero-fills and records them), and whether the host
    recompute loop actually RAN.  recompute_ran=False means the rescue
    never got to compute (disabled, spectra on the card, or the fetch
    refused) — a later retry with a fresh fetch is a genuine second
    chance, whereas a recompute that ran and recovered nothing is
    exhausted.  A refusal of one row leaves it lost; any other error
    propagates."""
    if not rows or not enabled() or _off_host(spectra):
        return {}, False
    host = _fetch_host(spectra)
    if host is None:
        return {}, False
    from tpulsar_torch.kernels import accel as ak

    bank_host = _fetch_host(bank.bank_fft)
    if bank_host is None:
        return {}, False
    cpu = cpu_device()
    block = torch.as_tensor(host, device=cpu)
    bank_fft = torch.as_tensor(bank_host, device=cpu)
    out: dict[int, tuple] = {}
    for i in rows:
        try:
            tup = ak.accel_row_topk(
                block, bank_fft, int(i), seg=bank.seg, step=bank.step,
                width=bank.width, nz=len(bank.zs),
                max_numharm=max_numharm, topk=topk)
        except ak.REFUSED:
            continue        # this row stays lost; others may rescue
        out[int(i)] = tuple(t.numpy() for t in tup)
    return out, True


def rescue_accel_chunk(spectra, bank, *, max_numharm: int, topk: int):
    """Whole-chunk host rescue for the executor's refused-chunk path
    (AccelStageRefused: every dispatch of the chunk was refused).
    Recomputes the rows on the host and returns ``(stages_dict,
    lost_rows)``: the {stage: (powers, rbins, zvals)} dict
    accel_search_batch would have returned, and the indices whose own
    recompute was refused — zero-filled (zero power sifts below every
    threshold) for the caller to record as lost.  Returns None when
    the rescue is disabled, the spectra lie on the card, the fetch is
    refused or nothing was recovered; the caller then skips the chunk
    loudly."""
    if not enabled() or _off_host(spectra):
        return None
    host = _fetch_host(spectra)
    if host is None:
        return None
    from tpulsar_torch.kernels.fourier import harmonic_stages

    ndms = host.shape[0]
    per_row, _ = rescue_accel_rows(host, bank, list(range(ndms)),
                                   max_numharm=max_numharm, topk=topk)
    if not per_row:
        return None
    stages = harmonic_stages(max_numharm)
    nstages = len(stages)
    vals = np.zeros((ndms, nstages, topk), np.float32)
    rbins = np.zeros((ndms, nstages, topk), np.int32)
    zidx = np.zeros((ndms, nstages, topk), np.int32)
    for i, tup in per_row.items():
        vals[i], rbins[i], zidx[i] = tup
    lost_rows = sorted(set(range(ndms)) - set(per_row))
    zs = np.asarray(bank.zs)
    return ({h: (vals[:, si, :], rbins[:, si, :], zs[zidx[:, si, :]])
             for si, h in enumerate(stages)}, lost_rows)
