"""Bounded-latency single-pulse trigger over emitted spans —
counterpart of tpulsar/stream/trigger.py.

Completed dedispersed samples (stream/dedisp_state.py) accumulate
into SPANS of ``span_chunks * chunk_len`` samples; each completed
span is searched with the batch single-pulse stage (the detrend/
normalize + boxcar ladder of kernels/singlepulse) on the device the
session runs on.  The final partial span is searched at its own
length at session close.

THE PARITY CONTRACT: the trigger set is a pure function of the
dedispersed series and the span partition — independent of
chunk_len, arrival timing, gaps vs zeros, kills and resumes.  The
batch equivalent is the batch SP stage applied over the same spans
of the batch-dedispersed series.  Span-local normalization is what
bounded latency means here: a full-series baseline needs samples
that have not arrived.

Trigger records are plain dicts (session, span, dm, sigma, time_s,
sample, width), published to the session's triggers.jsonl and the
journal; ``trigger_digest`` is the order-insensitive sha256 that
compares a killed-and-resumed session with an uninterrupted control
run.  The numpy backend implements the same detrend (block medians, a
short tail normalized by its own length) + cumsum boxcar ladder on
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulsar_torch import resolve_device
from tpulsar_torch.checkpoint import hashing
from tpulsar_torch.stream.dedisp_state import (geometry_freqs_dms,
                                               resolve_backend)

#: matches kernels/singlepulse DEFAULT_WIDTHS (restated for the numpy
#: backend)
DEFAULT_WIDTHS = (1, 2, 3, 4, 6, 9, 14, 20, 30)
DEFAULT_THRESHOLD = 6.0
DETREND_BLOCK = 1000

#: mirrors kernels/singlepulse.SP_EVENT_DTYPE
TRIGGER_DTYPE = np.dtype([("dm", "f8"), ("sigma", "f8"),
                          ("time_s", "f8"), ("sample", "i8"),
                          ("downfact", "i4")])


def _sp_numpy(span: np.ndarray, dms: np.ndarray, dt: float,
              threshold: float, widths=DEFAULT_WIDTHS) -> np.ndarray:
    """numpy single-pulse search of one span: per-block median
    detrend (tail normalized by its own length), global span std,
    cumsum boxcars, threshold + 32-sample cluster dedup."""
    ndms, T = span.shape
    blk = min(DETREND_BLOCK, T)
    nblk = max(1, T // blk)
    usable = nblk * blk
    med = np.median(span[:, :usable].reshape(ndms, nblk, blk), axis=-1)
    baseline = np.repeat(med, blk, axis=-1)
    if T > usable:
        tail_med = np.median(span[:, usable:], axis=-1)
        baseline = np.concatenate(
            [baseline, np.repeat(tail_med[:, None], T - usable,
                                 axis=-1)], axis=-1)
    det = span - baseline
    std = np.maximum(det.std(axis=-1, keepdims=True), 1e-9)
    norm = det / std
    cs = np.concatenate([np.zeros((ndms, 1)), np.cumsum(norm, axis=-1)],
                        axis=-1)
    rows = []
    for w in widths:
        if w > T:
            continue
        snr = (cs[:, w:] - cs[:, :-w]) / np.sqrt(float(w))
        di, ti = np.nonzero(snr >= threshold)
        if len(di):
            rows.append((snr[di, ti], di, ti,
                         np.full(len(di), w, np.int32)))
    if not rows:
        return np.empty(0, dtype=TRIGGER_DTYPE)
    snr_f = np.concatenate([r[0] for r in rows])
    di_f = np.concatenate([r[1] for r in rows])
    samp_f = np.concatenate([r[2] for r in rows]).astype(np.int64)
    w_f = np.concatenate([r[3] for r in rows])
    cluster = samp_f // 32
    combo = di_f * (int(cluster.max()) + 1) + cluster
    order = np.lexsort((-snr_f, combo))
    combo_sorted = combo[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = combo_sorted[1:] != combo_sorted[:-1]
    sel = order[first]
    out = np.empty(len(sel), dtype=TRIGGER_DTYPE)
    out["dm"] = np.atleast_1d(dms)[di_f[sel]]
    out["sigma"] = snr_f[sel]
    out["time_s"] = samp_f[sel] * dt
    out["sample"] = samp_f[sel]
    out["downfact"] = w_f[sel]
    return np.sort(out, order="sigma")[::-1]


def search_span(span: np.ndarray, dms: np.ndarray, dt: float,
                threshold: float = DEFAULT_THRESHOLD,
                backend: str = "auto", device=None) -> np.ndarray:
    """One (ndms, T) span -> TRIGGER_DTYPE events (span-local sample
    indices).  The torch path is the batch SP stage
    (kernels/singlepulse.single_pulse_search) on ``device``; the numpy
    path is the host equivalent."""
    if resolve_backend(backend) == "torch":
        from tpulsar_torch.kernels import singlepulse as sp

        block = torch.from_numpy(np.ascontiguousarray(span, np.float32))
        ev = sp.single_pulse_search(block.to(resolve_device(device)),
                                    dms, dt, threshold=threshold)
        return ev.astype(TRIGGER_DTYPE)
    return _sp_numpy(span, dms, dt, threshold)


def events_to_records(events: np.ndarray, session: str, span: int,
                      start_sample: int, dt: float) -> list[dict]:
    """Span-local events -> absolute-time trigger records (the
    published form)."""
    recs = []
    for ev in events:
        samp = int(ev["sample"]) + start_sample
        recs.append({"session": session, "span": int(span),
                     "dm": round(float(ev["dm"]), 6),
                     "sigma": round(float(ev["sigma"]), 4),
                     "sample": samp,
                     "time_s": round(samp * dt, 9),
                     "width": int(ev["downfact"])})
    return recs


def trigger_digest(records: list[dict]) -> str:
    """Order-insensitive sha256 over a session's trigger records —
    the identity a kill/resume run is compared with a control run
    by (the reference's digest, value for value)."""
    keys = sorted(
        (r["span"], r["sample"], r["dm"], r["width"], r["sigma"])
        for r in records)
    return hashing.sha256_bytes(repr(keys).encode())


class SpanTrigger:
    """Accumulate emitted blocks into spans; search each completed
    span.  ``feed``/``flush`` return lists of (span_index, records)
    pairs.  The pending samples stay on the host (they are the
    checkpointed ``sp_pend``); each completed span is copied to
    ``device`` for its search."""

    def __init__(self, geom: dict, *, session: str = "",
                 threshold: float = DEFAULT_THRESHOLD,
                 backend: str = "auto", device=None):
        _, self.dms = geometry_freqs_dms(geom)
        self.dt = float(geom["dt"])
        self.span_len = (int(geom.get("span_chunks", 4))
                         * int(geom["chunk_len"]))
        self.session = session
        self.threshold = float(threshold)
        self.backend = resolve_backend(backend)
        self.device = resolve_device(device)
        ndms = int(geom["ndms"])
        self.pend = np.zeros((ndms, 0), np.float32)
        self.next_span = 0

    def _search(self, span_block: np.ndarray) -> list[dict]:
        ev = search_span(span_block, self.dms, self.dt,
                         self.threshold, self.backend, self.device)
        start = self.next_span * self.span_len
        recs = events_to_records(ev, self.session, self.next_span,
                                 start, self.dt)
        self.next_span += 1
        return recs

    def feed(self, block: np.ndarray) -> list[tuple[int, list[dict]]]:
        self.pend = np.concatenate(
            [self.pend, np.asarray(block, np.float32)], axis=1)
        out = []
        while self.pend.shape[1] >= self.span_len:
            span_idx = self.next_span
            out.append((span_idx,
                        self._search(self.pend[:, :self.span_len])))
            self.pend = self.pend[:, self.span_len:]
        return out

    def flush(self) -> list[tuple[int, list[dict]]]:
        """Search the final partial span at its own length."""
        out = []
        if self.pend.shape[1] > 0:
            span_idx = self.next_span
            out.append((span_idx, self._search(self.pend)))
            self.pend = self.pend[:, :0]
        return out

    # ---------------------------------------------------- carry state
    def state_arrays(self) -> dict:
        return {"sp_pend": self.pend,
                "sp_next_span": np.int64(self.next_span)}

    def restore(self, arrays: dict) -> None:
        self.pend = np.ascontiguousarray(
            np.asarray(arrays["sp_pend"], np.float32))
        self.next_span = int(arrays["sp_next_span"])
