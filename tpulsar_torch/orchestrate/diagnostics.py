"""Per-beam diagnostics computed from a results directory — counterpart of
tpulsar/orchestrate/diagnostics.py (a copy).

Capability parity with the reference's diagnostics layer
(lib/python/diagnostics.py: FloatDiagnostic/PlotDiagnostic subclasses
and the DIAGNOSTIC_TYPES list at :667-681): each diagnostic is derived
from the search artifacts and uploaded with verify-after-write.
"""

from __future__ import annotations

import glob
import os
import tarfile

import numpy as np

from tpulsar_torch.io import accelcands
from tpulsar_torch.orchestrate.uploadables import (
    FloatDiagnosticUpload,
    PlotDiagnosticUpload,
    UploadError,
)


def _read_search_params(resultsdir: str) -> dict:
    """search_params.txt is 'key = python-literal' lines.  Parsed with
    ast.literal_eval per line — NOT exec'd: a results directory can
    come from elsewhere (restore/sync), and one unparseable line must
    not silently drop the rest (the reference execfile()s it,
    candidates.py:362-367; we deliberately do not)."""
    import ast

    path = os.path.join(resultsdir, "search_params.txt")
    ns: dict = {}
    if not os.path.exists(path):
        return ns
    with open(path) as fh:
        for line in fh:
            key, eq, value = line.partition("=")
            if not eq:
                continue
            try:
                ns[key.strip()] = ast.literal_eval(value.strip())
            except (ValueError, SyntaxError):
                continue
    return ns


def _union_length(lo: np.ndarray, hi: np.ndarray) -> float:
    """Total length of the union of [lo_i, hi_i] intervals
    (overlapping birdies must not be double-counted)."""
    order = np.argsort(lo)
    total, cur_lo, cur_hi = 0.0, None, None
    for a, b in zip(lo[order], hi[order]):
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return float(total)


def get_diagnostics(resultsdir: str, basenm: str):
    """Compute the per-beam diagnostic set (reference
    diagnostics.py:632-681)."""
    diags = []

    params = _read_search_params(resultsdir)

    # RFI masked fraction + the mask artifact blob (reference
    # RFIPercentageDiagnostic + RFIPlotDiagnostic)
    mask_file = os.path.join(resultsdir, f"{basenm}_rfifind.npz")
    if os.path.exists(mask_file):
        from tpulsar_torch.kernels.rfi import RFIMask
        mask = RFIMask.load(mask_file)
        diags.append(FloatDiagnosticUpload(
            "RFI mask percentage", 100.0 * mask.masked_fraction))
        diags.append(FloatDiagnosticUpload(
            "Num bad channels", float(mask.bad_channels.sum())))
        diags.append(PlotDiagnosticUpload("RFI mask", mask_file))

    # Candidate statistics from the sifted list (+ the list itself as
    # a blob: reference AccelCandsDiagnostic)
    candfile = os.path.join(resultsdir, f"{basenm}.accelcands")
    nfolded = len(glob.glob(os.path.join(resultsdir,
                                         f"{basenm}_cand*.pfd.npz")))
    if os.path.exists(candfile):
        cands = accelcands.parse_candlist(candfile)
        diags.append(PlotDiagnosticUpload("Accel cands", candfile))
        diags.append(FloatDiagnosticUpload(
            "Num candidates sifted", float(len(cands))))
        if cands:
            sigmas = [c.sigma for c in cands]
            diags.append(FloatDiagnosticUpload("Max sigma", max(sigmas)))
            diags.append(FloatDiagnosticUpload("Min sigma", min(sigmas)))
            thresh = params.get("to_prepfold_sigma", 6.0)
            # stable name (the reference's NumAboveThreshDiagnostic);
            # the threshold itself is uploaded separately
            diags.append(FloatDiagnosticUpload(
                "Num cands above threshold",
                float(sum(1 for s in sigmas if s >= thresh))))
            # folded candidates are the head of the sifted list, so
            # the weakest folded sigma is sigmas[nfolded-1]
            # (reference MinSigmaFoldedDiagnostic)
            if nfolded:
                diags.append(FloatDiagnosticUpload(
                    "Min sigma folded",
                    float(min(sigmas[:nfolded]))))

    # Folded candidates
    diags.append(FloatDiagnosticUpload("Num cands folded", float(nfolded)))

    # Search-configuration floats (reference SigmaThreshold /
    # MaxCandsToFold)
    sift = params.get("sifting", {})
    if "sigma_threshold" in sift:
        diags.append(FloatDiagnosticUpload(
            "Sigma threshold", float(sift["sigma_threshold"])))
    if "max_cands_to_fold" in params:
        diags.append(FloatDiagnosticUpload(
            "Max cands allowed to fold",
            float(params["max_cands_to_fold"])))

    # Zaplist used + zapped-bandwidth percentages (reference
    # ZaplistUsed + PercentZapped{Total,Below10Hz,Below1Hz},
    # diagnostics.py:452-520).  NB the percentages here normalize each
    # sub-range by ITS OWN searchable bandwidth; the reference divides
    # the below-N-Hz zapped span by the above-N-Hz bandwidth, which
    # reads like a bug we choose not to reproduce.
    zapfile = os.path.join(resultsdir, f"{basenm}.zaplist")
    if os.path.exists(zapfile):
        from tpulsar_torch.kernels.fourier import parse_zaplist

        diags.append(PlotDiagnosticUpload("Zaplist used", zapfile))
        lo_f = 1.0 / sift.get("long_period_s", 15.0)
        hi_f = 1.0 / sift.get("short_period_s", 0.0005)
        zap = parse_zaplist(zapfile)
        for label, hi in (("total", hi_f), ("below 10 Hz", 10.0),
                          ("below 1 Hz", 1.0)):
            lo1 = np.clip(zap[:, 0] - 0.5 * zap[:, 1], lo_f, hi)
            hi1 = np.clip(zap[:, 0] + 0.5 * zap[:, 1], lo_f, hi)
            covered = _union_length(lo1, hi1)
            pct = 100.0 * covered / max(hi - lo_f, 1e-12)
            diags.append(FloatDiagnosticUpload(
                f"Percent zapped {label}", pct))

    # Single-pulse statistics
    sp_npz = os.path.join(resultsdir, f"{basenm}_sp.npz")
    if os.path.exists(sp_npz):
        events = np.load(sp_npz, allow_pickle=False)["events"]
        diags.append(FloatDiagnosticUpload(
            "Num single-pulse events", float(len(events))))
        if len(events):
            diags.append(FloatDiagnosticUpload(
                "Max single-pulse sigma", float(events["sigma"].max())))

    # Timing report + params as blob diagnostics
    for name, fn in (("Timing report", f"{basenm}.report"),
                     ("Search parameters", "search_params.txt")):
        path = os.path.join(resultsdir, fn)
        if os.path.exists(path):
            diags.append(PlotDiagnosticUpload(name, path))

    # Per-beam single-pulse plots, one per reference DM window
    # (sp_candidates.py:293-311)
    for path in sorted(glob.glob(os.path.join(
            resultsdir, f"{basenm}_singlepulse_DMs*.png"))):
        tag = os.path.basename(path).split("_singlepulse_")[1]
        tag = tag.rsplit(".", 1)[0]
        diags.append(PlotDiagnosticUpload(
            f"Single-pulse plot {tag}", path))

    # Folded-candidate plots (reference PeriodicityCandidatePNG)
    for path in sorted(glob.glob(os.path.join(
            resultsdir, f"{basenm}_cand*.png"))):
        diags.append(PlotDiagnosticUpload(
            os.path.basename(path).rsplit(".", 1)[0], path))

    if not diags:
        raise UploadError(f"no diagnostics derivable from {resultsdir}")
    return diags
