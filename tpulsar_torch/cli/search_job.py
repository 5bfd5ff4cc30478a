"""Per-beam worker entry point (reference: bin/search.py) — counterpart
of tpulsar/cli/search_job.py.

    python -m tpulsar_torch.cli.search_job [files ...] [--outdir DIR]
        [--device cuda|cpu] [--no-accel] [--qid ID]

Invoked by every queue backend with the DATAFILES/OUTDIR environment
contract (schedulers pass no argv — reference bin/search.py:27-31):
set up a scratch workspace, stage the data locally, preprocess (Mock
subband merge), pick the zaplist, run the search with checkpoints in
the durable output directory, copy results to the output directory,
and clean up the workspace even on failure (reference
bin/search.py:205-223 try/finally).

The search runs on the GPU (``--device cuda``, the default); without
one the job fails unless ``--device cpu`` asks for the CPU.  The
configuration comes from TPULSAR_CONFIG (config/); the workspace base
is --workdir-base, else the configuration's
processing.base_working_directory, else TPULSAR_WORKDIR_BASE.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import sys
import tempfile
import warnings

import numpy as np

from tpulsar_torch import checkpoint as ckpt
from tpulsar_torch import resolve_device
from tpulsar_torch.io import datafile
from tpulsar_torch.kernels.fourier import parse_zaplist
from tpulsar_torch.search import executor


def get_datafns(args) -> list[str]:
    if args.files:
        return args.files
    env = os.environ.get("DATAFILES", "")
    # strip whitespace around each entry: schedulers that template the
    # env var from a file list can leave "a.fits; b.fits" — the space
    # must not become part of the filename
    fns = [f.strip() for f in env.split(";") if f.strip()]
    if not fns:
        raise SystemExit("no data files: pass paths or set DATAFILES")
    return fns


def install_signal_handlers() -> None:
    """Convert SIGTERM/SIGINT into SystemExit so ``try/finally``
    workspace cleanup actually runs.

    Queue managers kill jobs with a plain TERM; the default
    disposition terminates the process without unwinding the stack,
    leaking the ``tpulsar_*`` scratch directory on every operator
    kill.  128+signum matches the shell's exit-code convention so the
    queue still sees a nonzero return code."""
    def _raise_exit(signum, frame):
        raise SystemExit(128 + signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _raise_exit)


def get_outdir(args) -> str:
    outdir = args.outdir or os.environ.get("OUTDIR", "")
    if not outdir:
        raise SystemExit("no output dir: pass --outdir or set OUTDIR")
    return outdir


def init_workspace(base: str | None) -> str:
    base = base or os.environ.get("TPULSAR_WORKDIR_BASE",
                                  tempfile.gettempdir())
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="tpulsar_", dir=base)


def stage_in(fns: list[str], workdir: str) -> list[str]:
    """Copy raw data into the node-local workspace (reference uses
    rsync -auvl, bin/search.py:123)."""
    staged = []
    for fn in fns:
        dst = os.path.join(workdir, os.path.basename(fn))
        shutil.copy2(fn, dst)
        staged.append(dst)
    return staged


def choose_zaplist(fns: list[str], zapdir: str | None,
                   default: str | None) -> np.ndarray | None:
    """Per-file > per-beam > per-MJD custom zaplist, else the default
    (reference fallback chain: bin/search.py:151-183)."""
    candidates = []
    if zapdir and os.path.isdir(zapdir):
        base = os.path.basename(fns[0])
        stem = os.path.splitext(base)[0]
        m = datafile.MergedMockPsrfitsData.fnmatch(base) \
            or datafile.MockPsrfitsData.fnmatch(base)
        candidates.append(os.path.join(zapdir, stem + ".zaplist"))
        if m:
            gd = m.groupdict()
            candidates.append(os.path.join(
                zapdir, f"{gd['projid']}.{gd['date']}."
                        f"b{gd['beam']}.zaplist"))
            candidates.append(os.path.join(
                zapdir, f"{gd['projid']}.{gd['date']}.all.zaplist"))
    if default:
        candidates.append(default)
    for c in candidates:
        if c and os.path.exists(c):
            return parse_zaplist(c)
    if default:
        # no custom list matched and the configured default is
        # missing: operator error — do not silently search with the
        # packaged birdie list instead
        raise SystemExit(f"configured default zaplist missing: {default}")
    # packaged default birdie list as the last resort (the reference
    # ships lib/zaplists/PALFA.zaplist as its default)
    packaged = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "default.zaplist")
    return parse_zaplist(packaged) if os.path.exists(packaged) else None


def prepare_inputs(fns: list[str], workdir: str,
                   zaplist_dir: str | None = None,
                   default_zaplist: str | None = None,
                   cfg=None) -> tuple[list[str], np.ndarray | None]:
    """The host-side half of a beam job: stage raw files into the
    workspace, preprocess (Mock subband merge), refresh the custom
    zaplist cache from ``processing.zaplist_url``, and pick the
    zaplist.  Device-free, so the resident server's prefetch thread
    (serve/stagein.py) runs it while the device searches another
    beam."""
    if cfg is None:
        from tpulsar_torch.config import settings
        cfg = settings()
    staged = stage_in(fns, workdir)
    ppfns = datafile.preprocess(staged)
    zapdir = zaplist_dir or cfg.processing.zaplistdir or None
    if zapdir and cfg.processing.zaplist_url:
        # refresh the custom-zaplist cache when the remote tarball is
        # newer; a refresh failure must not fail the search — the
        # cached lists (or the default) still apply
        from tpulsar_torch.orchestrate.zaplists import refresh_zaplists
        try:
            refresh_zaplists(zapdir, cfg.processing.zaplist_url)
        except Exception as e:
            warnings.warn(f"zaplist refresh from "
                          f"{cfg.processing.zaplist_url} failed: {e}")
    zap = choose_zaplist(
        ppfns, zapdir,
        default_zaplist or cfg.processing.default_zaplist or None)
    return ppfns, zap


def run_search(ppfns: list[str], workdir: str, outdir: str,
               params: "executor.SearchParams",
               zap: np.ndarray | None,
               log=print,
               journal=None,
               device=None) -> "executor.SearchOutcome | None":
    """Search a prepared beam and make the results durable in outdir
    (the device-owning half of a beam job).

    Checkpoints (checkpoint/) live in the durable output dir, so a
    retried job verifies the manifest and resumes at the first
    incomplete artifact instead of recomputing the beam from zero;
    ``journal`` receives the resume evidence (``resume`` /
    ``pass_complete`` / ``checkpoint_invalid``).  A permanently-short
    observation is a clean skip (None return + a skipped.txt marker),
    not a failure the scheduler retries forever.  Returns the
    SearchOutcome, or None for a skip — both mean job success.
    device: as search_beam's (the GPU unless the caller asks for the
    CPU)."""
    ckdir = ckpt.default_root(outdir)
    try:
        outcome = executor.search_beam(
            ppfns, workdir, os.path.join(workdir, "results"),
            params=params, zaplist=zap, checkpoint_dir=ckdir,
            checkpoint_journal=journal, device=device)
    except executor.TooShortToSearchError as e:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "skipped.txt"), "w") as fh:
            fh.write(str(e) + "\n")
        log(f"skipped: {e}")
        return None
    os.makedirs(outdir, exist_ok=True)
    for name in os.listdir(outcome.resultsdir):
        shutil.copy2(os.path.join(outcome.resultsdir, name),
                     os.path.join(outdir, name))
    # only after results are durable is resume state disposable
    ckpt.clean(ckdir)
    log(f"search complete: {len(outcome.candidates)} candidates, "
        f"{outcome.num_dm_trials} DM trials")
    return outcome


def run_search_batch(jobs: list[dict], params: "executor.SearchParams",
                     log=print, cap: int = 0,
                     device=None) -> list[tuple]:
    """Search a batch of prepared beams through the coalesced
    batch-of-beams executor entry and make each beam's results
    durable in ITS outdir — the batch analogue of :func:`run_search`,
    with identical per-beam results discipline (checkpoints in the
    durable outdir, results copied only on success, resume state
    cleaned only after results are durable, TooShort = clean skip).

    ``jobs``: dicts of ``{ppfns, workdir, outdir, zap, journal,
    label}``.  Returns one ``(status, payload, path)`` tuple per job,
    aligned: ``("done", SearchOutcome, "batched"|"solo")``,
    ``("skipped", None, path)``, or ``("failed", error, path)`` — a
    beam's failure never fails its batchmates.  device: as
    run_search's."""
    specs = [executor.BeamSpec(
        fns=j["ppfns"], workdir=j["workdir"],
        resultsdir=os.path.join(j["workdir"], "results"),
        zaplist=j.get("zap"),
        checkpoint_dir=ckpt.default_root(j["outdir"]),
        checkpoint_journal=j.get("journal"),
        label=j.get("label", "")) for j in jobs]
    results = executor.search_beam_batch(specs, params, cap=cap,
                                         device=device)
    out: list[tuple] = []
    for j, r in zip(jobs, results):
        label = j.get("label", "?")
        if r.error is not None:
            if isinstance(r.error, executor.TooShortToSearchError):
                os.makedirs(j["outdir"], exist_ok=True)
                with open(os.path.join(j["outdir"], "skipped.txt"),
                          "w") as fh:
                    fh.write(str(r.error) + "\n")
                log(f"[{label}] skipped: {r.error}")
                out.append(("skipped", None, r.path))
            else:
                log(f"[{label}] failed: {r.error}")
                out.append(("failed", r.error, r.path))
            continue
        outcome = r.outcome
        os.makedirs(j["outdir"], exist_ok=True)
        for name in os.listdir(outcome.resultsdir):
            shutil.copy2(os.path.join(outcome.resultsdir, name),
                         os.path.join(j["outdir"], name))
        # only after results are durable is resume state disposable
        ckpt.clean(ckpt.default_root(j["outdir"]))
        log(f"[{label}] {r.path} (group {r.group_size}"
            f"{', ' + r.fallout if r.fallout else ''}): "
            f"{len(outcome.candidates)} candidates, "
            f"{outcome.num_dm_trials} DM trials")
        out.append(("done", outcome, r.path))
    return out


def _keep_stderr_clean() -> None:
    """Route warnings and log chatter to stdout.

    Queue backends detect job failure from a non-empty stderr file
    (reference pbs.py:209-230), so only genuine errors may reach
    stderr — a UserWarning must not fail the job."""
    warnings.showwarning = lambda msg, cat, fn, lineno, *a, **k: print(
        warnings.formatwarning(msg, cat, fn, lineno), end="",
        file=sys.stdout)
    logging.basicConfig(stream=sys.stdout)
    for h in logging.getLogger().handlers:
        if isinstance(h, logging.StreamHandler) \
                and getattr(h, "stream", None) is sys.stderr:
            h.stream = sys.stdout
    if logging.lastResort is not None:
        logging.lastResort = logging.StreamHandler(sys.stdout)


def main(argv=None) -> int:
    _keep_stderr_clean()
    # a queue manager's kill is a plain TERM: without a handler the
    # try/finally below never runs and the tpulsar_* scratch dir leaks
    install_signal_handlers()
    p = argparse.ArgumentParser(
        prog="python -m tpulsar_torch.cli.search_job",
        description="Search one beam (DATAFILES/OUTDIR contract).")
    p.add_argument("files", nargs="*", help="raw data files")
    p.add_argument("--outdir", default=None)
    p.add_argument("--workdir-base", default=None)
    p.add_argument("--zaplist-dir", default=None)
    p.add_argument("--default-zaplist", default=None)
    p.add_argument("--no-accel", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the search runs: cuda (default) or cpu; "
                        "the job never moves to the CPU by itself")
    p.add_argument("--qid", default=None,
                   help="queue id stamp (identification only: lets a "
                        "scheduler kill this job by its command line)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from tpulsar_torch.config import settings
    cfg = settings()

    fns = get_datafns(args)
    outdir = get_outdir(args)
    workdir = init_workspace(args.workdir_base
                             or cfg.processing.base_working_directory)
    try:
        ppfns, zap = prepare_inputs(
            fns, workdir, zaplist_dir=args.zaplist_dir,
            default_zaplist=args.default_zaplist, cfg=cfg)
        params = executor.SearchParams.from_config(cfg.searching)
        if args.no_accel:
            params.run_hi_accel = False
        run_search(ppfns, workdir, outdir, params, zap, device=device)
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
