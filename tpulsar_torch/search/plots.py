"""Result plotting: fold-candidate plots and single-pulse DM-range
plots — counterpart of tpulsar/search/plots.py (the same figures and
PNG names; matplotlib is imported only when a plot is drawn).

The reference generates candidate plots through PRESTO's prepfold
(PostScript) and converts them with ImageMagick + gzip
(lib/python/PALFA2_presto_search.py:683-688), and single-pulse plots
via single_pulse_search.py over three DM ranges 0-110 / 100-310 / 300+
(lib/python/PALFA2_presto_search.py:617-641, upload naming at
lib/python/sp_candidates.py:293-311).  Here both are produced directly
as PNGs with matplotlib — no external converters.
"""

from __future__ import annotations

import os

import numpy as np

# Reference DM windows for the per-beam single-pulse plots
SP_DM_RANGES = ((0.0, 110.0), (100.0, 310.0), (300.0, 1100.0))


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def prepfold_plot(res, path: str, source: str = "",
                  extra_title: str = "") -> str:
    """Diagnostic plot for one folded candidate: optimized profile
    (two periods), phase-time waterfall, and the fold metadata."""
    plt = _mpl()
    fig = plt.figure(figsize=(8, 6))
    gs = fig.add_gridspec(2, 2, height_ratios=[1, 2],
                          width_ratios=[3, 1], hspace=0.3, wspace=0.25)

    prof = np.asarray(res.profile, dtype=np.float64)
    prof2 = np.concatenate([prof, prof])
    ax = fig.add_subplot(gs[0, 0])
    ax.plot(np.linspace(0, 2, len(prof2), endpoint=False), prof2,
            drawstyle="steps-mid", lw=1.0)
    ax.set_xlabel("Phase")
    ax.set_ylabel("Flux")
    ax.set_xlim(0, 2)
    ax.set_title(extra_title or source or "folded profile", fontsize=10)

    sub = np.asarray(res.subints, dtype=np.float64)
    sub2 = np.concatenate([sub, sub], axis=1)
    ax2 = fig.add_subplot(gs[1, 0])
    ax2.imshow(sub2, aspect="auto", origin="lower",
               extent=[0, 2, 0, sub.shape[0]], cmap="viridis",
               interpolation="nearest")
    ax2.set_xlabel("Phase")
    ax2.set_ylabel("Sub-integration")

    ax3 = fig.add_subplot(gs[:, 1])
    ax3.axis("off")
    lines = [
        f"P = {res.period_s * 1e3:.6f} ms",
        f"Pdot = {res.pdot:.3e}",
        f"DM = {res.dm:.2f} pc/cc",
        f"Reduced chi2 = {res.reduced_chi2:.2f}",
        f"dP (opt) = {res.delta_p:.3e} s",
        f"dPdot (opt) = {res.delta_pdot:.3e}",
        f"nbin = {res.nbin}  npart = {res.npart}",
    ]
    ax3.text(0.0, 0.98, "\n".join(lines), va="top", family="monospace",
             fontsize=9, transform=ax3.transAxes)

    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def single_pulse_plots(events: np.ndarray, resultsdir: str,
                       basenm: str, t_obs: float) -> list[str]:
    """The three per-beam single-pulse summary plots over the
    reference DM windows.  Each figure: sigma-vs-DM, event-count
    histogram vs DM, and the time-DM scatter sized by sigma."""
    plt = _mpl()
    paths = []
    for lo, hi in SP_DM_RANGES:
        tag = f"DMs{lo:.0f}-{hi:.0f}"
        path = os.path.join(resultsdir,
                            f"{basenm}_singlepulse_{tag}.png")
        sel = events[(events["dm"] >= lo) & (events["dm"] < hi)] \
            if len(events) else events
        fig, axes = plt.subplots(
            2, 2, figsize=(8, 6),
            gridspec_kw={"height_ratios": [1, 2]})
        (ax_sig, ax_hist), (ax_scat, ax_void) = axes
        ax_void.axis("off")
        if len(sel):
            ax_sig.plot(sel["dm"], sel["sigma"], "k.", ms=2)
            ax_hist.hist(sel["dm"], bins=min(50, max(5, len(sel) // 5)),
                         color="0.4")
            ax_scat.scatter(sel["time_s"], sel["dm"],
                            s=np.clip((sel["sigma"] - 4.0) * 6, 2, 60),
                            facecolors="none", edgecolors="k", lw=0.5)
            ax_scat.set_xlim(0, max(t_obs, float(sel["time_s"].max())))
        else:
            ax_scat.set_xlim(0, t_obs or 1.0)
        ax_sig.set_xlabel("DM (pc/cc)")
        ax_sig.set_ylabel("Sigma")
        ax_hist.set_xlabel("DM (pc/cc)")
        ax_hist.set_ylabel("N events")
        ax_scat.set_xlabel("Time (s)")
        ax_scat.set_ylabel("DM (pc/cc)")
        ax_scat.set_ylim(lo, hi)
        fig.suptitle(f"{basenm}  single pulses  {tag}  "
                     f"({len(sel)} events)", fontsize=10)
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
        paths.append(path)
    return paths
