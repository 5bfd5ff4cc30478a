#!/usr/bin/env python3
"""Smoke run of tpulsar_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from tpulsar_torch/csrc and the native library
from tpulsar_torch/native through the AOT gate (aot_phase:
tpulsar_torch.aot.warmstart.run_gate in process writes the build
directory's manifest, `python -m tpulsar_torch aot verify` in a fresh
process finds both libraries with 0 misses, `aot ls` marks both; the
registers come from the manifest's ptxas report) and runs these
phases:

  1. kernels: each kernel against its plain PyTorch version on the
     card, exact, at every shape of the main path (stage 1 at each
     downsample, stage 2 at each DM chunk and at the one row that
     refinement dedisperses), with times and bounds; then at phase
     7's shapes (two BATCH_NSAMP beams): the coalesced and the solo
     stage 1 at each downsample, stage 2's beam axis at B = 2 at each
     DM chunk of the plan at that length, also against two B = 1
     launches, timed, and refinement's one row; and which stages after dedispersion give a row the same
     bits inside a two-beam batch of rows as alone (the reason the
     batch path runs them per beam); dedisperse.dedisperse_pass, the
     kernel module's whole pass, on the first ds-1 pass of the block,
     bit-identical to its own form_subbands -> dedisperse_subbands
     composition and one launch of each; the library it launched is
     the manifest's;
  row statistics (row_stats_phase): the plan's first pass of a
     BATCH_NSAMP slice of phase 1's block, dedispersed by the kernels;
     the SP detrend's and the whitening's clipped estimators and
     fourier.pad_series's mean in one 76-row call and in calls of 8,
     16 and 19 rows: no row may differ;
  2. hi stage: the FDAS stage on one full-width ds-1 DM chunk of
     whitened spectra (dedispersed noise with a drifting pulse train):
     the bf16 plane against the f32 plane on the card, the card against
     the CPU's plain f32 on one row, the time a DM row (correlation and
     the stage kernel with its top-k split) against its bound, and peak
     memory; the stage kernel (csrc/accel_stage.cu) on one planned
     batch's pieces in bf16 and in f32, exactly equal to its plain
     version, timed against its bound;
  config 3 (cfg3_phase, after the ladder): BASELINE config 3 as
     bench.py runs it, on phase 1's block: dedisperse_pass of 32 DM
     trials (0-62, subdm 140, nsub 96, ds 1; both kernels also exact
     against their plain versions at these shapes), a drifting train
     at z 150 added, the whitened spectrum, accel_search_batch at zmax
     200 (nz 201), 16 harmonics, topk 64: bf16 against f32, the train
     stage 1's top cell in every row, the default zmax-50 search
     weaker near it, the card against the CPU on 2^18 bins of a row, no
     refusal on the ladder; the batch rows, peak memory and the time a
     DM row against its bound; the stage kernel at these shapes, bf16
     and f32, exactly equal to its plain version and timed;
  ladder: the hi stage's degradation ladder on that chunk
     (ladder_phase): (a) forced per-DM (TPULSAR_ACCEL_BATCH=0) against
     the batched run; (b) a ballast tensor that leaves room for one row
     but not for one planned batch, so every batch raises a real
     OutOfMemoryError, is retried once and degrades, its rows searched
     per-DM on the card (a one-row batch through the stage kernel,
     which needs less than the planned batch) equal to (a), the batch
     breaker pinning the per-DM path; (c) TPULSAR_FAULTS
     accel.row_dispatch:unimplemented:
     count=4, two rows refused twice and the ladder ending on the card
     (no host rescue for spectra on the card): the two rows zero-filled
     and recorded as lost, the rest equal to (a); (d) a poisoned
     session on a 2-row slice through executor._hi_accel_pass: the
     chunk's hi stage skipped loudly, its rows counted as lost;
  tree: the tree stage-2 family (TPULSAR_DD_FAMILY=tree) on the
     plan's first pass at full width (ds 1, all 76 DM rows), at the
     default level budget and at 16 GiB, against the CUDA direct
     kernel on the same subbands (series and fused-detrend norms at
     rtol 2e-6 / atol 2e-5), with both times and peak memory;
  3. small parity: the zero-accel configuration and the default
     configuration (with an accelerated pulsar) on a small block, on
     the card and on the CPU;
  read (run beside phase 7's server, on phase 7's shorter beam, which
     keeps the smoke inside its time limit): the beam read by
     read_all_uint8
     through the native unpack and through the NumPy unpack,
     byte-identical, with the read times;
  4. the main path: one full-geometry PALFA Mock beam (960 channels,
     65.476 us, 3,932,160 samples, 4-bit, the 57-pass Mock survey
     plan) with one injected pulsar, written to a temporary directory
     and searched by search_beam at the JAX package's default
     configuration (SearchParams(make_plots=False): hi-accel stage,
     refinement and folding on) with a checkpoint directory.  It
     checks that the pulsar is recovered and folded, that every trial
     went through the hi stage, and that every kernel was launched as
     often as the plan and the outcome require, and reports what the
     checkpoint cost (artifacts, bytes, seconds in store.save,
     manifest size); then config 3 through search_beam on the same
     beam files (cfg3_search_phase: SearchParams.from_config of a
     SearchingConfig with hi_accel_zmax 200 and hi_accel_numharm 16,
     plots off, one DDplan step of its 32 trials): the pulsar
     recovered and folded, all 32 trials through the hi stage, the
     kernels' launches as the plan and outcome require, peak memory
     under 80 GiB, the .report's stages.  Both searches record the hi
     stage's kernel launches by shape (StageShapes; every batched row
     through the kernel), and after phase 8 the kernel is held to its
     plain version exactly at each of those shapes, timed there
     (stage_kernel_shapes), and once at its largest z-row count;
  5. resume (run beside phase 7's server, on phase 7's shorter beam,
     which keeps the smoke inside its time limit): phase 7's solo
     search's
     checkpoint cut back to the state a kill after
     pass K_RESUME - 1 leaves (pass artifacts >= K_RESUME, the sifted
     list and the folds dropped) in a new output directory, and the
     same beam searched again through the job's run_search.  It checks
     that only passes K_RESUME..56 were computed (metrics.json and the
     kernels' launch counts), that every results file equals the solo
     search's (tools/torch_results_diff.py: timing-bearing files by presence,
     .npz by arrays, tarballs by members), that the pulsar is
     recovered and folded, and that the checkpoint is gone;
  6. serve (run after phase 7, on phase 7's shorter beam, which keeps
     the smoke inside its time limit; held against its solo search),
     through the front door and the blob data plane: a token'd
     gateway (`python -m tpulsar_torch gateway`) on a sqlite: queue
     with a content-addressed store; the beam uploaded by
     `python -m tpulsar_torch blob put` (its seconds printed); the
     resident server (`serve --queue sqlite:...` in a subprocess on
     the card, TPULSAR_DATA_URL at the gateway; default device, warm
     boot on; the smoke's wrapper turns plots off, as in phase 4, and
     counts the kernels' launches after boot) started, and once it
     advertises capacity the beam submitted by digest
     (client.submit_beam with blobs=) and a poisoned ticket (a
     datafile truncated mid-header) by path; both answered over HTTP,
     then the server drained by SIGTERM.  It checks that the server
     exits 0, that the beam is done and warm (no compile) and the
     poisoned one failed in its stage-in, the final 'stopped'
     heartbeat, each ticket's journal chain (the stage-in by digest
     and the artifact push included), that the results directory
     equals the solo search's, the pulsar, the candidate index's rows,
     /v1/candidates answered from the index with the pulsar in it,
     every artifact fetched by `blob get` byte-identical to the
     outdir's copy, and that the served beam launched each kernel
     exactly as often as the solo search; it prints the blob PUT, the
     stage-in and beam_seconds.
  7. batch, on a shorter beam of its own (the cut that keeps the
     smoke inside its time limit): the Mock geometry at a quarter of
     NSAMP (983,040 samples; 960 channels, the 57-pass Mock survey
     plan), searched solo by search_beam with a checkpoint directory,
     then two tickets for it into two output directories, answered by
     `python -m tpulsar_torch serve --once --batch 2` in a subprocess
     on the card (the same wrapper), while the read and phase 5 run in
     this process beside it.  It checks that both are done on
     the batched path in one batch_dispatch event, warm, that both
     results directories and both checkpoints' artifacts equal the
     solo search's, the pulsar in both, and that stage 1 launched once
     a pass for the group and stage 2's beam axis once a chunk.
  8. stream: the streaming plane (tpulsar_torch/stream/) on a Mock
     real-time session (960 channels, 65.476 us, 1024 DMs over 0-1000,
     8 chunks of 16384 samples, spans of 4 chunks; seeded noise and
     one dispersed pulse at DM 300).  In process: the chunks through
     StreamDedisp on the card, the concatenated series torch.equal to
     dedisperse_stream_batch and to the plain stage 2 over the block,
     one stage-2 launch an emission, the streamed trigger set equal to
     the batch series' spans and holding the pulse; one emission timed
     against its bound and its plain version, with the window's H2D
     copy, the block's D2H copy and one span search.  Served: the
     session fed at the real-time rate with seq 5 left out, answered by
     `python -m tpulsar_torch serve --stream --once` in a subprocess
     (the same wrapper): done with one gap, the journal chain, the
     triggers' digest equal to an in-process control's, the chunk
     latencies against the ticket's slo_s, one launch an emission
     after boot; then a second session, opened and fed over HTTP
     through a token'd gateway over the server's spool
     (`POST /v1/stream/<s>/open|chunks|close`), its server SIGKILLed
     after three acknowledged chunks and a new one resuming it: the
     control's digest, at most one chunk replayed, the checkpoint
     cleaned, the triggers read back through
     `GET /v1/stream/<s>/triggers` with the control's digest.

  9. pipeline (run after phase 11, beside phase 12's `search`, on
     phase 7's shorter beam, which keeps the smoke inside its time
     limit; held against its solo search): the
     orchestration daemons, each a `python -m tpulsar_torch`
     subprocess under one configuration file (TPULSAR_CONFIG: the
     tracker DB, download.datadir, the results directory and DB, the
     local queue backend with one job at a time and two attempts, and
     PIPELINE_JOB, the port's job with plots off and its launches
     counted, as jobpooler.submit_script).  `downloader --once` fetches
     the beam from a local archive (restore request, location and
     fetch, size check; the fetch's seconds printed); `jobpool --once`
     makes one job and submits it into {base}/{mjd}/{obs_name}/{beam}/
     {yymmdd}; once its checkpoint holds passes 0..K_RESUME-1,
     `kill-jobs --fail` kills its process group (submit stopped, job
     failed, no workspace left); `jobpool --once` retries it into the
     same directory, where it resumes from the checkpoint: the passes
     it computes (metrics.json) and its launches are those the
     checkpoint lacked (expected_launches), its stderr file empty;
     `jobpool --once` marks it processed; the results equal phase 7's
     solo search's (the backend's stderr files aside), the pulsar folded, the
     checkpoint cleaned; `uploader --once` uploads it (one headers
     row, a pdm_candidates row per .accelcands row with the pulsar
     among them, the single-pulse rows, >= 5 diagnostics; the seconds
     by tpulsar_upload_seconds category), a second upload inserts
     nothing, `status` and `show uploading` print the tracker's state,
     and `remove-files` drops the downloaded copy.

  10. fleet: folded into phase 11, whose storm runs the same
     FleetController of two `serve` workers on phase 7's beam, SIGKILLs
     w0 mid-beam and lets the janitor requeue its claim; phase 11 holds
     every check this phase made.

  11. chaos (run after phase 6, on phase 7's beam, held against its
     solo search): the port's chaos harness conducts a storm with
     worker_kind "serve" (CHAOS_SCENARIO, through scenario.from_dict):
     ChaosRunner in this process runs a FleetController with two
     `python -m tpulsar_torch serve` workers on the card (the runner's
     own command line through the smoke's wrapper) behind the gateway
     on a sqlite queue in the spool, one ticket for the beam under a
     tenant cap, a spool.io fault window on w1 (t = 2-40 s), a gateway
     restart (8 s), w0 SIGKILLed (20 s) and a janitor pause (30 s).
     w1 is held after its boot until w0 has claimed the ticket.
     It checks that the storm quiesced, the port's invariant verifier
     (no violation) in process and as `chaos verify` (exit 0), `chaos
     report`'s MTTR of the kill, each ticket done once, a takeover of
     w0's claim and the resume of its beam from the checkpoint, every
     results directory equal to phase 7's solo search's with the pulsar
     folded, tpulsar_chaos_actions_total, and the surviving workers'
     launches (each beam whole less its resumed passes); it prints the
     boots, each ticket's beam_seconds and attempts, kill -> takeover
     and -> re-claim, the storm's wall and the card's peak memory in
     use.  The fleet's own records and its hosted doctor are held
     after the storm (fleet_checks): fleet.json (stopped, every beam
     done, w0 restarted after its SIGKILL, rc -9 in its worker_exit),
     fleet.prom (the beam_e2e SLO from 2 workers, the active alert),
     the doctor's alert_fired for takeover_rate and alerts.json, GET
     /v1/alerts through a token'd gateway, `doctor --queue` (exit 1,
     naming the rule), `fleet --status` and the node probe `doctor`'s
     device probe (run beside the storm: it reads nothing of it);
     every results directory's checkpoint cleaned.  Then
     the packaged ci_smoke scenario (stub workers) through `chaos run`
     and `chaos verify` as subprocesses.

  12. operator surface (its `search` started after phase 11 and run
     beside phase 9, the rest after phase 9; on phase 7's beam, held
     against its solo search): `python -m tpulsar_torch search <beam>
     --outdir D` in a subprocess on the card with TPULSAR_TRACE=1 and
     TPULSAR_PROFILE=<tmp>/ops_profile (through the same wrapper: plots
     off, the cleaned checkpoint kept, launches counted from the
     process start), D holding phase 7's solo search's checkpoint cut
     back to pass K_RESUME as phase 5 cuts it (the job resumes there,
     and the profile records the passes it computes): exit 0, passes
     K_RESUME..56 computed, the results equal to phase 7's solo
     search's with the trace file set aside, the pulsar folded, both
     kernels launched as expected_launches gives; one torch profiler
     trace in
     the profile directory, holding the search_block range and as many
     dedisperse_kernel and form_subbands_kernel events as the wrappers
     counted (check_profile).  Then
     in this process, through the CLI's main: `trace D` (the span
     table) and tools/torch_trace_summarize.py --compare-report (5%,
     50 ms), `plan <beam>` (the 57-pass Mock survey plan of the
     header), `checkpoint` of the kept checkpoint (every artifact
     listed, `--verify` exit 0; a copy with one byte of a pass flipped:
     exit 1 naming it), and `obs timeline` of the ticket phase 11 took
     over from w0 (claimed by w0, the takeover from w0, a claim, one
     result), `obs top --once` (w0 and w1 named) and `obs tail --lines
     5` over phase 11's sqlite queue.  It prints the search's wall,
     its .report stages, the trace's top spans, the profile's size,
     event count and parse time, and the phase's seconds.

  13. mesh (run after phase 12, on phase 7's beam, held against its
     solo search): the parallel layer (tpulsar_torch/parallel/) on a
     mesh of MESH_SHARDS logical shards of the card
     (make_mesh(1, 4, devices=[cuda] * 4)), in this process.  (a)
     search_beam(mesh=) at the default configuration with the
     packaged zaplist and a checkpoint directory: the solo search's
     sifted candidates (r and z to
     2 decimals, numharm, DM to 3; sigma within rel 1e-3), SP event
     set and trial count, the pulsar folded, no degraded flag (the hi
     stage ran sharded), each kernel launched as often as the plan
     gives (mesh_launches), peak memory within 10% of the solo's;
     (b) search_block over the first MESH_SEQ_PASSES (8) passes of the
     plan's first step (ds 1) with seq_shard "on" (time shards, ring
     halo, all_to_all) and a checkpoint directory, their artifacts
     equal by that rule to (a)'s, which are DM-sharded ("auto" shards
     no pass of this beam by
     time), every chunk through the seq route (seq_dedisperse, no
     _dd_local, no fallback warning), and seq_dedisperse of pass 0
     torch.equal to one solo stage-2 launch; (c) _dd_local, the
     stage-2 kernel in each shard, at the shapes the mesh path
     launches it: the first pass of each plan step, its table padded
     and cut by the executor's chunk rule, each chunk split over the
     shards; every launch torch.equal to the plain version and to the
     solo launch's rows, each pass's launches timed with the bound and
     summed over the beam; (d) dist_fft_natural of 2^21 points within 1e-4 (relative
     max norm) of torch.fft.fft, and seq_dist_search (through the
     executor's sharded pass, with a spectral budget one byte below a
     trial's tail) on the ds-1 pass of the pulsar's DM: the fundamental
     within one Fourier bin among its candidates.  Each part's wall is
     printed.

Phases 4-7, 9 and 11-13 search with the zaplist the job picks
under the default configuration (the packaged default.zaplist), as
the server does.

A plain version's time is that of the one call its exact comparison
makes (no warm-up, no repeats): it is reported, not a yardstick.

Output: progress lines, then the card's name and power limit, one JSON
line {"aot": ...} (the gate's and the verify's seconds, the verify's
hits and misses, each library's path, build seconds and fingerprint,
the row statistics), one JSON line with every kernel's numbers, and as
the last line
{"ok": true, "device": {...}}.  Any failure raises (non-zero exit, no
result line).  It needs a CUDA device and the rest of the repository;
it imports nothing of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gzip
import inspect
import io
import json
import math
import os
import re
import shutil
import signal
import sqlite3
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time
import warnings

import threading
import types

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
             "false); nothing was run")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpulsar_torch import checkpoint as ckpt  # noqa: E402
from tpulsar_torch import native  # noqa: E402
from tpulsar_torch.aot import warmstart  # noqa: E402
from tpulsar_torch.cli import search_job  # noqa: E402
from tpulsar_torch.config import core as config_core  # noqa: E402
from tpulsar_torch.io import accelcands, psrfits, synth  # noqa: E402
from tpulsar_torch.kernels import accel  # noqa: E402
from tpulsar_torch.kernels import accel_batch  # noqa: E402
from tpulsar_torch.kernels import cuda_dd  # noqa: E402
from tpulsar_torch.kernels import dedisperse as dd  # noqa: E402
from tpulsar_torch.kernels import fold_batch  # noqa: E402
from tpulsar_torch.kernels import fourier as fr  # noqa: E402
from tpulsar_torch.kernels import singlepulse as sp_k  # noqa: E402
from tpulsar_torch.kernels import tree_dd  # noqa: E402
from tpulsar_torch.obs import telemetry  # noqa: E402
from tpulsar_torch.plan import ddplan  # noqa: E402
from tpulsar_torch.resilience import faults  # noqa: E402
from tpulsar_torch.search import degraded, executor  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores

#: the full Mock beam (bench.py geometry)
NCHAN, TSAMP, NSAMP = 960, 65.476e-6, 3_932_160
PSR_PERIOD, PSR_DM = 0.25, 50.0
#: phase 7's beam: the Mock geometry (960 channels, 65.476 us, 4-bit,
#: the 57-pass Mock survey plan) at a quarter of NSAMP, so that the
#: smoke stays inside its time limit (phase 4 holds the full beam).
#: An eighth (32 s of data) is too short for the pulsar check: the
#: strongest candidate near the pulsar was 0.8% off in period.
BATCH_NSAMP = NSAMP // 4
#: the configuration of the main path: the JAX package's default search
PARAMS = executor.SearchParams(make_plots=False)
#: phase 5 resumes the beam at this pass of the 57-pass plan
K_RESUME = 40
#: the zaplist of phases 4-7: the one the job (and the server) picks
#: for a beam under the default configuration
ZAPLIST = search_job.choose_zaplist(["beam.fits"], None, None)
#: the kernels a solo beam launches (the beam axis is the batch path's)
SOLO_KERNELS = ("form_subbands", "dedisperse_subbands")


def log(msg: str) -> None:
    print(msg, flush=True)


#: the smoke's start, for the phase marks
T_START = time.time()


def mark(phase: str) -> None:
    """A progress line with the seconds since the smoke started (the
    budget each phase takes of the time limit)."""
    log(f"[{time.time() - T_START:.1f} s] {phase}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 5) -> float:
    """Median of `runs` single-call CUDA-event timings, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def once_ms(fn) -> tuple:
    """fn's result and the milliseconds of that ONE call between CUDA
    events, with no warm-up: the time of a plain version, taken on the
    call that the exact comparison makes anyway (it is reported, not a
    yardstick, so it pays for no runs of its own)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                       "operations")


def mock_spec(nsamp: int) -> synth.BeamSpec:
    return synth.BeamSpec(nchan=NCHAN, nsamp=nsamp, tsamp_s=TSAMP,
                          fctr_mhz=1375.5, bw_mhz=322.617, nbits=4,
                          nsblk=64, backend="pdev", seed=20261016)


def ptxas_report(build_log: str) -> dict:
    """Registers a thread and spill bytes of every kernel, from nvcc's
    -Xptxas -v report, printed one line each; returns name ->
    registers (form_subbands<u8|f32>, dedisperse_subbands<R rows>,
    accel_stage<f32|bf16, H harmonics>)."""
    names = {"form_subbands_kernelIhE": "form_subbands<u8>",
             "form_subbands_kernelIfE": "form_subbands<f32>"}
    out, name, spill = {}, None, ""
    for line in build_log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            r = re.search(r"dedisperse_kernelILi(\d+)EE", m.group(1))
            a = re.search(r"accel_stage_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                          m.group(1))
            name = (f"dedisperse_subbands<{r.group(1)} rows>" if r else
                    f"accel_stage<{'f32' if a.group(1) == 'f' else 'bf16'}"
                    f", {a.group(2)} harmonics>" if a else
                    next((v for k, v in names.items() if k in m.group(1)),
                         m.group(1)))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            n = int(re.search(r"Used (\d+) registers", line).group(1))
            out[name] = n
            log(f"  ptxas: {name}: {n} registers; {spill}")
            name = None
    return out


def aot_cli(*args) -> tuple[subprocess.CompletedProcess, float]:
    """`python -m tpulsar_torch aot ARGS` in a fresh process: the result
    and its wall seconds."""
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "tpulsar_torch", "aot", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ,
                 PYTHONPATH=os.path.dirname(os.path.abspath(__file__))))
    return res, time.time() - t0


def aot_phase() -> dict:
    """The build step is the AOT gate (tpulsar_torch/aot/):
    warmstart.run_gate in this process builds and loads g++'s native
    library and nvcc's CUDA kernels into the build directory and
    writes the manifest, and the kernels' registers come from the
    manifest's ptxas report.  Then `python -m tpulsar_torch aot verify`
    in a fresh process must find both libraries (0 misses) and `aot
    ls` must mark both."""
    t0 = time.time()
    rc = warmstart.run_gate(echo=lambda s: log(f"  aot: {s}"))
    build_s = time.time() - t0
    if rc != 0:
        raise AssertionError(f"the AOT gate exited {rc}")
    progs = warmstart.load_manifest()["programs"]
    if sorted(progs) != ["cuda_dd", "native"] or \
            progs["cuda_dd"]["ptxas"] is None:
        raise AssertionError(f"the AOT manifest: {progs}")
    with open(progs["cuda_dd"]["ptxas"]) as fh:
        regs = ptxas_report(fh.read())
    ver, verify_s = aot_cli("verify")
    m = re.search(r"manifest verify: (\d+)/(\d+) hits, (\d+) misses",
                  ver.stdout)
    if ver.returncode != 0 or not m or m.groups() != ("2", "2", "0"):
        raise AssertionError(f"aot verify exited {ver.returncode}:\n"
                             f"{ver.stdout[-2000:]}{ver.stderr[-2000:]}")
    ls, ls_s = aot_cli("ls")
    marked = sorted(re.findall(r"^  \* (\S+)", ls.stdout, re.M))
    if ls.returncode != 0 or marked != ["cuda_dd", "native"]:
        raise AssertionError(f"aot ls exited {ls.returncode}, marked "
                             f"{marked}:\n{ls.stdout[-2000:]}")
    log(f"aot: gate {build_s:.2f} s ("
        + ", ".join(f"{n} {os.path.relpath(r['library'])} built in "
                    f"{r['build_s']} s" for n, r in progs.items())
        + f"); `aot verify` in a fresh process {verify_s:.2f} s: "
        f"{m.group(0)}; `aot ls` {ls_s:.2f} s marks {marked}")
    return dict(build_s=build_s, verify_s=verify_s,
                verify_hits=int(m.group(1)),
                verify_misses=int(m.group(3)), ls_s=ls_s,
                programs={n: {k: r[k] for k in ("library", "build_s",
                                                "fingerprint")}
                          for n, r in progs.items()},
                regs=regs)


#: the row-count-independence check: calls of these row counts against
#: one call of a pass's 76 rows, at the first row of each call (8-row
#: mesh shards, the last clamped to the end, as the mesh path cuts them)
ROW_CALLS = {8: (0, 8, 16, 24, 32, 40, 48, 56, 64, 68),
             16: (0, 16, 32, 48, 60), 19: (0, 19, 38, 57)}


def row_stats_phase(data, freqs: np.ndarray) -> dict:
    """One pass on the card: the plan's first pass (ds 1, 76 DMs) over
    the first BATCH_NSAMP samples of phase 1's block, dedispersed by
    the kernels.  Its SP detrend with the clipped estimator
    (clipped_mean), fourier.pad_series's mean (to the next power of
    two) and the whitening of its spectrum's powers with the clipped
    estimator run in one 76-row call and in calls of 8, 16 and 19 rows
    (ROW_CALLS); no row may differ from the 76-row call."""
    ppass = ddplan.survey_plan("pdev")[0].passes()[0]
    dms = np.asarray(ppass.dms)
    ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm, dms,
                                        TSAMP, 1)
    block = data[:, :BATCH_NSAMP].contiguous()
    series = cuda_dd.dedisperse_subbands(
        cuda_dd.form_subbands(block, ch_sh, 96, 1), sub_sh)
    del block
    nrows, T = series.shape
    nfft = 1 << (T - 1).bit_length()
    powers = fr.complex_spectrum(series).abs() ** 2
    # (function, its input): the whitening is held on one set of
    # powers, so that only its own statistics can move a row
    fns = {
        "sp_detrend_clipped_mean": (lambda x: sp_k.detrend_normalize(
            x, 1000, "clipped_mean"), series),
        "pad_series_mean": (lambda x: fr.pad_series(x, nfft), series),
        "whiten_clipped_mean": (lambda x: fr.whiten(
            x, estimator="clipped_mean"), powers)}
    t0 = time.time()
    differ = {}
    for name, (fn, x) in fns.items():
        whole = fn(x)
        for rows, starts in ROW_CALLS.items():
            bad = set()
            for s0 in starts:
                got = fn(x[s0:s0 + rows].contiguous())
                diff = (got != whole[s0:s0 + rows]).any(dim=-1)
                bad.update(s0 + int(i) for i in torch.nonzero(diff))
            differ[f"{name}/{rows}"] = len(bad)
        del whole
    torch.cuda.synchronize()
    wall = time.time() - t0
    log(f"row statistics: pass 0 ({nrows} rows x {T} samples, ds 1; "
        f"pad to {nfft}) in calls of 8, 16, 19 rows against one "
        f"{nrows}-row call: rows differing {json.dumps(differ)} "
        f"({wall:.2f} s)")
    if any(differ.values()):
        raise AssertionError(f"row statistics depend on the call's row "
                             f"count: {differ}")
    return dict(rows=nrows, nsamp=T, nfft=nfft, differ=differ, s=wall)


def plan_shapes(plan, nsamp: int, params,
                first_pass: int = 0) -> tuple[dict, dict]:
    """Launches per beam at each search shape of the passes from
    first_pass on: stage 1 by downsample, stage 2 by (DM rows,
    downsample), one stage-2 launch per DM chunk."""
    s1: dict = {}
    s2: dict = {}
    pass_idx = -1
    for step in plan:
        ds = step.downsamp
        nfft = ddplan.choose_n(nsamp // ds)
        for ppass in step.passes():
            pass_idx += 1
            if pass_idx < first_pass:
                continue
            s1[ds] = s1.get(ds, 0) + 1
            ndms = len(ppass.dms)
            chunk = executor.pass_chunk_size(ndms, nfft, params)
            for lo in range(0, ndms, chunk):
                key = (min(chunk, ndms - lo), ds)
                s2[key] = s2.get(key, 0) + 1
    return s1, s2


def _check_stage2(subb, rows_sh, what: str
                  ) -> tuple[torch.Tensor, float, float]:
    """The stage-2 kernel against its plain version, exact: the
    kernel's output, the max |err| and the plain call's ms."""
    got = cuda_dd.dedisperse_subbands(subb, rows_sh)
    want, plain_ms = once_ms(
        lambda: cuda_dd.dedisperse_subbands_plain(subb, rows_sh))
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"stage-2 kernel differs from its plain "
                             f"version at {what}: max |err| {err}")
    return got, err, plain_ms


def _stage2_entry(subb, rows_sh, regs, ds: int, launches: int | None,
                  role: str) -> dict:
    """Stage 2 at one shift table: exact check, time, bound."""
    nrows = rows_sh.shape[0]
    launch = cuda_dd.stage2_launch(rows_sh)
    occ, smem = cuda_dd.stage2_occupancy(rows_sh)
    nreg = regs[f"dedisperse_subbands<{launch.rows} rows>"]
    got2, err, plain = _check_stage2(subb, rows_sh,
                                     f"{nrows} rows, ds={ds}")
    del got2
    ms = time_ms(lambda: cuda_dd.dedisperse_subbands(subb, rows_sh))
    T = subb.shape[1]
    nbytes = (96 + nrows) * T * 4 + rows_sh.size * 4
    b, by = bound_ms(nbytes, nrows * 96 * T)
    log(f"kernel dedisperse_subbands {nrows} rows x {T} (ds={ds}, "
        f"{role}): exact (max|err| {err}), span {launch.span}, {ms:.4f} "
        f"ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}), share "
        f"{b / ms:.3f}; {launch.groups} groups of {launch.rows} rows, "
        f"{nreg} registers, {smem} B shared, {occ} blocks/SM")
    return dict(rows=nrows, ds=ds, role=role, span=launch.span,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, groups=launch.groups,
                group_rows=launch.rows, registers=nreg, smem_bytes=smem,
                blocks_per_sm=occ)


def _stage2_beams_entry(sub3, rows_sh, regs, ds: int,
                        launches: int) -> dict:
    """Stage 2's beam axis at B = 2 on one shift table: exact against
    its plain version and against two B = 1 launches; time, bound.
    The two beams' subbands come from different data (phase 1's block
    and that block rolled along time), so a launch that ignored the
    beam axis would not pass."""
    nrows, T = rows_sh.shape[0], sub3.shape[2]
    launch = cuda_dd.stage2_launch(rows_sh)
    got = cuda_dd.dedisperse_subbands_beams(sub3, rows_sh)
    want, plain = once_ms(
        lambda: cuda_dd.dedisperse_subbands_beams_plain(sub3, rows_sh))
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"stage-2 beam axis differs from its plain "
                             f"version at {nrows} rows, ds={ds}: max "
                             f"|err| {err}")
    del want
    for b in range(2):
        if not torch.equal(got[b], cuda_dd.dedisperse_subbands(
                sub3[b], rows_sh)):
            raise AssertionError(f"stage-2 beam axis: beam {b} differs "
                                 f"from its B = 1 launch ({nrows} rows, "
                                 f"ds={ds})")
    del got
    ms = time_ms(lambda: cuda_dd.dedisperse_subbands_beams(sub3, rows_sh))
    nbytes = 2 * (96 + nrows) * T * 4 + rows_sh.size * 4
    b, by = bound_ms(nbytes, 2 * nrows * 96 * T)
    nreg = regs[f"dedisperse_subbands<{launch.rows} rows>"]
    log(f"kernel dedisperse_subbands_beams B=2 x {nrows} rows x {T} "
        f"(ds={ds}): exact vs plain and vs two B=1 launches (max|err| "
        f"{err}), {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms "
        f"({by}), share {b / ms:.3f}, {launches} launches a group")
    return dict(beams=2, rows=nrows, ds=ds, role="batch chunk",
                span=launch.span, launches=launches, max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                groups=launch.groups, group_rows=launch.rows,
                registers=nreg)


def _batch_shapes_entries(data, freqs: np.ndarray, plan, regs: dict
                          ) -> list[dict]:
    """Phase 7's kernel shapes, exact against the plain versions: two
    BATCH_NSAMP beams (data's first BATCH_NSAMP samples, and those
    rolled along time) stacked as the batch path stacks them.  Per
    plan step, the coalesced stage 1 on (2 x NCHAN, BATCH_NSAMP) and
    the solo stage 1 on one beam (its launch bit-equal to the first
    half of the coalesced one); per DM-chunk shape of the plan at
    BATCH_NSAMP, the beam axis (_stage2_beams_entry, which also holds
    the solo B = 1 launches at that shape); and refinement's one row
    at ds 1.  Returns the beam axis's entries, each with its launches
    for a group of two from the plan."""
    nsamp = BATCH_NSAMP
    _, nb2 = plan_shapes(plan, nsamp, PARAMS)
    stacked = torch.cat([data[:, :nsamp],
                         torch.roll(data[:, :nsamp], 4099, dims=1)])
    one = stacked[:NCHAN]
    s2b = []
    for step in plan:
        ds = step.downsamp
        ppass = step.passes()[-1]
        dms = np.asarray(ppass.dms)
        ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm, dms,
                                            TSAMP, ds)
        tiled = np.tile(np.asarray(ch_sh), 2)
        got = cuda_dd.form_subbands(stacked, tiled, 2 * 96, ds)
        want = cuda_dd.form_subbands_plain(stacked, tiled, 2 * 96, ds)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"stage-1 kernel differs from its plain version on two "
                f"stacked beams of {nsamp} samples at ds={ds}: max |err| "
                f"{float((got - want).abs().max())}")
        del want
        if not torch.equal(cuda_dd.form_subbands(one, ch_sh, 96, ds),
                           got[:96]):
            raise AssertionError(f"stage 1 on one beam of {nsamp} "
                                 f"samples differs from the coalesced "
                                 f"launch's first beam at ds={ds}")
        sub3 = got.reshape(2, 96, got.shape[1])
        shapes = [k for k in nb2 if k[1] == ds]
        for nrows, _ in shapes:
            s2b.append(_stage2_beams_entry(sub3, sub_sh[-nrows:], regs,
                                           ds, nb2[(nrows, ds)]))
        log(f"phase 7's shapes at ds={ds}: stage 1 on 2 x {NCHAN} x "
            f"{nsamp} (coalesced) and {NCHAN} x {nsamp} (solo) exact; "
            f"beam axis at {[k[0] for k in shapes]} rows")
        del got, sub3
    ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, PSR_DM, [PSR_DM],
                                        TSAMP, 1)
    subb = cuda_dd.form_subbands(one, ch_sh, 96, 1)
    _check_stage2(subb, sub_sh, f"refinement's one row at {nsamp} "
                                f"samples")
    del subb, stacked, one
    if sum(x["launches"] for x in s2b) != sum(nb2.values()):
        raise AssertionError(f"beam-axis shapes {[x['rows'] for x in s2b]}"
                             f" miss chunks of the plan {nb2}")
    return s2b


def batch_rows_report(subb, rows_sh, ds: int) -> dict:
    """Which stages after dedispersion give a row the same bits inside
    a two-beam batch of rows (B x chunk, the reference's batch path)
    as in the chunk alone (the solo path): one row's rfft, the SP
    detrend and boxcar, the whitened spectrum and the lo stage.  A
    report, not a check: the batch path runs these stages per beam,
    at the solo shapes."""
    nrows = rows_sh.shape[0]
    one = cuda_dd.dedisperse_subbands(subb, rows_sh)
    two = torch.cat([one, torch.roll(one, 977, dims=1)])
    nfft = ddplan.choose_n(one.shape[1])
    same = {"rfft of one row": torch.equal(
        torch.fft.rfft(two, dim=-1)[0], torch.fft.rfft(one[:1], dim=-1)[0])}
    n1, n2 = (sp_k.detrend_normalize(x) for x in (one, two))
    same["SP detrend"] = torch.equal(n1, n2[:nrows])
    b1, b2 = (sp_k.boxcar_search(x) for x in (n1, n1.repeat(2, 1)))
    same["SP boxcar top-k"] = all(torch.equal(a, b[:, :nrows])
                                  for a, b in zip(b1, b2))
    w1, w2 = (fr.whitened_spectrum(x, nfft=nfft) for x in (one, two))
    same["whitened spectrum"] = torch.equal(w1, w2[:nrows])
    stages = tuple(fr.harmonic_stages(PARAMS.lo_accel_numharm))
    l1 = fr.lo_stage_candidates(w1, stages, PARAMS.topk_per_stage)
    l2 = fr.lo_stage_candidates(w1.repeat(2, 1), stages,
                                PARAMS.topk_per_stage)
    same["lo stage"] = all(torch.equal(l1[h][k], l2[h][k][:nrows])
                           for h in l1 for k in range(2))
    log(f"batch rows ({nrows} rows alone vs inside {2 * nrows}, ds={ds}): "
        + ", ".join(f"{k} {'same bits' if v else 'DIFFERENT bits'}"
                    for k, v in same.items()))
    return same


def kernel_phase(data, freqs: np.ndarray, regs: dict):
    """Each kernel against its plain version at every shape the Mock
    plan launches, and stage 2 at the one row refinement dedisperses
    (ds 1, the pulsar's DM), exact; per shape the time, bound and
    share of the bound; then phase 7's shapes (_batch_shapes_entries),
    stage 2's beam axis timed at each.  Returns the per-shape lists (stage 1, stage 2, stage
    2 at B = 2) and the batch-rows report; their per-beam launch counts
    are completed from the main path's outcome."""
    plan = ddplan.survey_plan("pdev")
    n1, n2 = plan_shapes(plan, NSAMP, PARAMS)
    s1, s2, rows_report = [], [], {}
    for step in plan:
        # the step's last pass: its widest shifts (shifts > 0 reach the
        # edge clamp at the series' end)
        ds = step.downsamp
        ppass = step.passes()[-1]
        dms = np.asarray(ppass.dms)
        ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm, dms,
                                            TSAMP, ds)
        got = cuda_dd.form_subbands(data, ch_sh, 96, ds)
        want, plain = once_ms(
            lambda: cuda_dd.form_subbands_plain(data, ch_sh, 96, ds))
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"stage-1 kernel differs from its plain "
                                 f"version at ds={ds}: max |err| {err}")
        del want
        ms = time_ms(lambda: cuda_dd.form_subbands(data, ch_sh, 96, ds))
        nbytes = NCHAN * NSAMP + 96 * (NSAMP // ds) * 4 + NCHAN * 4
        b, by = bound_ms(nbytes, NCHAN * NSAMP)
        occ, smem = cuda_dd.stage1_occupancy(NCHAN, 96, ds, torch.uint8)
        log(f"kernel form_subbands ds={ds}: exact (max|err| {err}), "
            f"max shift {int(ch_sh.max())}, {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by}), share "
            f"{b / ms:.3f}, {n1[ds]} search launches a beam; "
            f"{regs['form_subbands<u8>']} registers, {smem} B shared, "
            f"{occ} blocks/SM")
        s1.append(dict(ds=ds, launches=n1[ds], max_abs_err=err, ms=ms,
                       plain_ms=plain, bound_ms=b, bound_by=by,
                       registers=regs["form_subbands<u8>"],
                       smem_bytes=smem, blocks_per_sm=occ))
        # stage 2 on this pass's subbands: the pass's last DM chunk
        (nrows, _), = [k for k in n2 if k[1] == ds]
        s2.append(_stage2_entry(got, sub_sh[-nrows:], regs, ds,
                                n2[(nrows, ds)], "search chunk"))
        if ds in (1, 5):
            rows_report[ds] = batch_rows_report(got, sub_sh[-nrows:], ds)
        del got

    # refinement's shape: stage 1 at ds 1 (the per-step shape above),
    # then stage 2 at ONE row of one DM's shifts (span 0)
    ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, PSR_DM, [PSR_DM],
                                        TSAMP, 1)
    subb = cuda_dd.form_subbands(data, ch_sh, 96, 1)
    s2.append(_stage2_entry(subb, sub_sh, regs, 1, None,
                            "refinement, one row"))
    del subb
    s2b = _batch_shapes_entries(data, freqs, plan, regs)
    dedisperse_pass_check(data, freqs, plan)
    return s1, s2, s2b, rows_report


def dedisperse_pass_check(data, freqs: np.ndarray, plan) -> None:
    """dedisperse.dedisperse_pass, the kernel module's whole two-stage
    pass, on the block at full width for the plan's first ds-1 pass:
    one launch of each kernel, and the series bit-identical to its own
    form_subbands -> dedisperse_subbands composition."""
    ppass = next(s for s in plan if s.downsamp == 1).passes()[0]
    dms = np.asarray(ppass.dms)
    before = dict(cuda_dd.LAUNCHES)
    got = dd.dedisperse_pass(data, freqs, 96, ppass.subdm, dms, TSAMP, 1,
                             device=DEV)
    launched = {k: cuda_dd.LAUNCHES[k] - before[k] for k in SOLO_KERNELS}
    ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm, dms,
                                        TSAMP, 1)
    want = cuda_dd.dedisperse_subbands(
        cuda_dd.form_subbands(data, ch_sh, 96, 1), sub_sh)
    torch.cuda.synchronize()
    if launched != {k: 1 for k in SOLO_KERNELS}:
        raise AssertionError(f"dedisperse_pass launched {launched}, not "
                             f"one of each kernel")
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(
            f"dedisperse_pass differs from form_subbands -> "
            f"dedisperse_subbands: {tuple(got.shape)} vs "
            f"{tuple(want.shape)}, max |err| "
            f"{float((got - want).abs().max())}")
    log(f"phase 1: dedisperse_pass of the first ds-1 pass (subdm "
        f"{ppass.subdm}, {len(dms)} DMs, {NCHAN} x {data.shape[1]} uint8) "
        f"bit-identical to its form_subbands -> dedisperse_subbands "
        f"composition; launches {launched}")


def _inject_drifting_train(series: torch.Tensor, nfft: int, r0: int,
                           z: float, amp: float, nharm: int) -> None:
    """Add a drifting pulse train (harmonic h of amplitude amp/h) whose
    fundamental's MEAN frequency sits on spectrum bin r0 and whose
    drift is z bins over the padded length: on a grid cell of the hi
    stage's (r, z) plane, the fundamental the top cell of every
    stage."""
    T_s = nfft * TSAMP
    f0 = (r0 - z / 2) / T_s
    fdot = z / T_s ** 2
    t = torch.arange(series.shape[1], device=series.device,
                     dtype=torch.float64) * TSAMP
    phase = f0 * t + 0.5 * fdot * t * t
    sig = sum(torch.cos(2 * math.pi * h * phase) / h
              for h in range(1, nharm + 1))
    series += (amp * sig).to(series.dtype)[None, :]


def hi_phase(data, freqs: np.ndarray) -> dict:
    """The hi-accel stage on one full-width ds-1 DM chunk (38 trials of
    the plan's first pass), whitened spectra of dedispersed noise with
    a drifting pulse train added: bf16 plane vs f32 plane on the card,
    the card's f32 vs the CPU's plain f32 on one row, and times."""
    step = ddplan.survey_plan("pdev")[0]
    ppass = step.passes()[0]
    ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm,
                                        np.asarray(ppass.dms), TSAMP, 1)
    nrows = executor.pass_chunk_size(len(ppass.dms), ddplan.choose_n(
        NSAMP), PARAMS)
    subb = cuda_dd.form_subbands(data, ch_sh, 96, 1)
    series = cuda_dd.dedisperse_subbands(subb, sub_sh[:nrows])
    del subb
    nfft = ddplan.choose_n(NSAMP)
    noise = float(series[0].std())
    # ~300 in whitened power a harmonic: A^2 T / (4 sigma^2)
    amp = noise * math.sqrt(1200.0 / NSAMP)
    r0, z_inj = 20000, 14.0
    _inject_drifting_train(series, nfft, r0, z_inj, amp, nharm=2)
    wspec = fr.whitened_spectrum(series, nfft=nfft)
    del series
    nbins = wspec.shape[1]
    bank = executor._get_bank(PARAMS.hi_accel_zmax)
    nz = len(bank.zs)
    mh, topk = PARAMS.hi_accel_numharm, PARAMS.topk_per_stage

    def search(specs):
        return accel.accel_search_batch(specs, bank, max_numharm=mh,
                                        topk=topk)

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res_bf = search(wspec)
    peak = torch.cuda.max_memory_allocated()
    os.environ["TPULSAR_ACCEL_PLANE_DTYPE"] = "f32"
    try:
        res_f32 = search(wspec)
        res_f32_row = search(wspec[:1])
    finally:
        del os.environ["TPULSAR_ACCEL_PLANE_DTYPE"]
    res_cpu = search(wspec[:1].cpu())

    # bf16 vs f32 on the card: the same top (r bin, z) per stage and
    # row, powers within 1%
    worst = 0.0
    for h in res_f32:
        vf, rf, zf = res_f32[h]
        vb, rb, zb = res_bf[h]
        for d in range(nrows):
            i, j = int(np.argmax(vf[d])), int(np.argmax(vb[d]))
            if (rf[d, i], zf[d, i]) != (rb[d, j], zb[d, j]):
                raise AssertionError(
                    f"hi stage bf16 vs f32: stage {h} row {d} top cell "
                    f"({rb[d, j]}, {zb[d, j]}) vs ({rf[d, i]}, "
                    f"{zf[d, i]})")
            rel = abs(vb[d, j] / vf[d, i] - 1.0)
            worst = max(worst, rel)
            if rel > 0.01:
                raise AssertionError(f"hi stage bf16 vs f32: stage {h} "
                                     f"row {d} power off by {rel:.4f}")
    top_r, top_z = res_f32[1][1][0, 0], res_f32[1][2][0, 0]
    if abs(0.5 * top_r - r0) > 0.5 or top_z != z_inj:
        raise AssertionError(f"hi stage: the injected train (bin {r0}, "
                             f"z {z_inj}) is not the top cell: "
                             f"({0.5 * top_r}, {top_z})")
    log(f"hi stage bf16 vs f32 ({nrows} rows x {nbins} bins, nz {nz}): "
        f"the same top (r, z) in every stage and row, top powers within "
        f"{worst:.5f} (limit 0.01); injected train at bin {r0}, z "
        f"{z_inj} is the top cell")

    # the card's f32 against the CPU's plain f32, one row: the same
    # (r bin, z) cells, powers at the tests' rtol 2e-4
    worst = 0.0
    for h in res_cpu:
        a = sorted(zip(res_f32_row[h][1][0], res_f32_row[h][2][0],
                       res_f32_row[h][0][0]))
        b = sorted(zip(res_cpu[h][1][0], res_cpu[h][2][0],
                       res_cpu[h][0][0]))
        for (ra, za, va), (rb_, zb_, vb_) in zip(a, b):
            if (ra, za) != (rb_, zb_):
                raise AssertionError(f"hi stage card vs CPU: stage {h} "
                                     f"cells differ: {(ra, za)} vs "
                                     f"{(rb_, zb_)}")
            worst = max(worst, abs(va / vb_ - 1.0))
    if worst > 2e-4:
        raise AssertionError(f"hi stage card vs CPU: powers off by "
                             f"{worst}")
    log(f"hi stage card f32 vs CPU plain f32 (1 row): the same {topk} "
        f"cells in every stage, powers within {worst:.2e} (limit 2e-4)")

    # time a DM row: the whole stage, then its two parts on one batch
    # of each plane dtype, the stage kernel checked exactly there (the
    # default cell's ds-1 shape in f32, production's in bf16)
    t_chunk = time_ms(lambda: search(wspec), runs=3)
    stage = {}
    for dt in ("bf16", "f32"):
        os.environ["TPULSAR_ACCEL_PLANE_DTYPE"] = dt
        try:
            stage[dt] = stage_kernel_entry(
                wspec, bank, mh, topk,
                accel.plane_dm_chunk(nbins, nz, device=DEV),
                "hi stage (default configuration, ds 1)")
        finally:
            del os.environ["TPULSAR_ACCEL_PLANE_DTYPE"]
    b, e = stage["bf16"]["rows"], stage["bf16"]
    row_ms = t_chunk / nrows
    bnd, by = hi_row_bound_ms(nbins, nz, bank)
    log(f"hi stage time: {t_chunk:.3f} ms a {nrows}-row chunk, "
        f"{row_ms:.4f} ms a DM row (median of 3); batch of {b} rows: "
        f"correlation {e['corr_ms']:.4f} ms a row, stage kernel + top-k "
        f"{e['kernel_topk_ms']:.4f} ms a row; bound {bnd:.4f} ms a row "
        f"({by}), share {bnd / row_ms:.4f}; peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
        f"the {base / 2**30:.3f} GiB held before the call)")
    return dict(row_ms=row_ms, corr_row_ms=e["corr_ms"],
                harm_row_ms=e["kernel_topk_ms"], bound_row_ms=bnd,
                bound_by=by, stage_kernel=stage,
                batch_rows=b, peak_bytes=peak, peak_above_bytes=peak - base,
                wspec=wspec, res_bf=res_bf,
                dms=[float(d) for d in ppass.dms[:nrows]],
                T_s=nfft * TSAMP)


def stage_kernel_entry(wspec, bank, numharm: int, topk: int, rows: int,
                       what: str) -> dict:
    """The hi stage's stage kernel (cuda_dd.accel_stage_blocks) on the
    correlation's pieces of the first `rows` spectra, in the plane
    dtype set: one launch, whose block maxima, columns, z indices and
    column 0's z index equal the plain version's exactly, and so does
    the top-k the hi stage takes from them.  Times a row: the kernel
    (median of 5), the kernel with its top-k, the correlation that
    makes the pieces (median of 3) and the plain version (the exact
    comparison's one call), against the bound: the pieces read once,
    or the adds and compares of every column at every z."""
    nz, nr = len(bank.zs), 2 * wspec.shape[1]
    bank_fft = torch.from_numpy(bank.bank_fft).to(DEV)
    block = wspec[:rows]
    stages = tuple(fr.harmonic_stages(numharm))

    def pieces_of():
        return accel._corr_piece_list(block, bank_fft, bank.seg,
                                      bank.step, bank.width, nz)

    def kernel(p):
        return cuda_dd.accel_stage_blocks(p, bank.width, nr, stages,
                                          fr.BLOCK_R)

    pieces = pieces_of()
    before = cuda_dd.LAUNCHES["accel_stage"]
    got = kernel(pieces)
    torch.cuda.synchronize()
    if cuda_dd.LAUNCHES["accel_stage"] != before + 1:
        raise AssertionError(f"{what}: the stage kernel launched "
                             f"{cuda_dd.LAUNCHES['accel_stage'] - before} "
                             f"times, not once")
    want, plain_ms = once_ms(lambda: accel._stage_blocks_plain(
        pieces, bank.width, nr, stages, fr.BLOCK_R))
    dtype = str(pieces[0].dtype).replace("torch.", "")
    for name, x, y in zip(("bmax", "bcol", "bz", "zarg0"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}, {dtype}: the stage kernel's "
                                 f"{name} differs from the plain "
                                 f"version's")
    for x, y in zip(accel._blocks_topk(got, stages, nr, topk),
                    accel._stage_topk(accel._harmonic_stage_maxes(
                        accel._assemble_plane(pieces, bank.width, nr),
                        stages, nz), stages, topk)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}, {dtype}: the top-k of the "
                                 f"stage kernel differs from the torch "
                                 f"consumer's")
    del want
    k_ms = time_ms(lambda: kernel(pieces))
    kt_ms = time_ms(lambda: accel._blocks_topk(kernel(pieces), stages, nr,
                                               topk), runs=3)
    corr_ms = time_ms(pieces_of, runs=3)
    nbytes = sum(p.numel() * p.element_size() for p in pieces)
    # adds and compares: column c takes the harmonics 1 .. top(c)
    nops = nz * sum((nr // h) * (h - (h // 2 if h > 1 else 0))
                    for h in stages)
    bnd, by = bound_ms(nbytes / rows, nops / rows)
    entry = dict(dtype=dtype, rows=rows, nz=nz, nbins=wspec.shape[1],
                 stages=list(stages), kernel_ms=k_ms / rows,
                 kernel_topk_ms=kt_ms / rows, corr_ms=corr_ms / rows,
                 plain_ms=plain_ms / rows, bound_ms=bnd, bound_by=by,
                 pieces_bytes=nbytes)
    log(f"{what}, {dtype} pieces ({rows} row(s) x {nz} z x {nr} columns, "
        f"stages {list(stages)}): the stage kernel equals the plain "
        f"version exactly (blocks and top-k); a row: kernel "
        f"{entry['kernel_ms']:.4f} ms, with its top-k "
        f"{entry['kernel_topk_ms']:.4f} ms, bound {bnd:.4f} ms ({by}), "
        f"share {bnd / entry['kernel_ms']:.4f}; correlation "
        f"{entry['corr_ms']:.4f} ms; plain version {entry['plain_ms']:.4f} "
        f"ms (one call)")
    return entry


def stage_kernel_shapes(shapes: dict, zmax: float, numharm: int,
                        topk: int, ds_of: dict, what: str) -> list[dict]:
    """Phase 1's check for the hi stage's kernel, at every shape a
    search launched it (StageShapes.counts): at each (spectrum bins,
    DM rows, plane dtype) the kernel on the correlation's pieces of
    that many random spectra equals its plain version exactly
    (stage_kernel_entry); per shape the search's launches there and,
    per launch, the kernel's time, its plain version's and its
    bound."""
    bank = executor._get_bank(zmax)
    nz, top = len(bank.zs), fr.harmonic_stages(numharm)[-1]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(24)
    out = []
    for (nbins, rows, dtype, knz, ktop), n in sorted(shapes.items()):
        if (knz, ktop) != (nz, top):
            raise AssertionError(f"{what}: the kernel ran at {knz} z rows "
                                 f"and top stage {ktop}, not {nz} and "
                                 f"{top}")
        specs = torch.randn((rows, nbins), dtype=torch.complex64,
                            device=DEV, generator=gen)
        os.environ["TPULSAR_ACCEL_PLANE_DTYPE"] = \
            {"bfloat16": "bf16", "float32": "f32"}[dtype]
        try:
            e = stage_kernel_entry(specs, bank, numharm, topk, rows,
                                   f"{what}: hi stage at ds "
                                   f"{ds_of.get(nbins)}")
        finally:
            del os.environ["TPULSAR_ACCEL_PLANE_DTYPE"]
        del specs
        out.append(dict(
            ds=ds_of.get(nbins), nbins=nbins, rows=rows, dtype=dtype,
            nz=nz, stages=e["stages"], launches=n, max_abs_err=0.0,
            ms=e["kernel_ms"] * rows, plain_ms=e["plain_ms"] * rows,
            bound_ms=e["bound_ms"] * rows, bound_by=e["bound_by"],
            kernel_topk_ms=e["kernel_topk_ms"] * rows,
            corr_ms=e["corr_ms"] * rows))
    return out


def stage_kernel_limit_check() -> None:
    """The hi stage's kernel at its largest z-row count
    (cuda_dd.ACCEL_STAGE_MAX_NZ, a shared table past the 48 KB a block
    has without opting in), f32 and bf16: the launch runs and equals
    its plain version exactly."""
    nz, zc, width, nr, stages = cuda_dd.ACCEL_STAGE_MAX_NZ, 1000, 40, \
        600, (1, 2, 4)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(nz)
    for dtype in (torch.float32, torch.bfloat16):
        pieces = [torch.rand((2, 3, min(zc, nz - z0), 200), generator=gen,
                             device=DEV).to(dtype)
                  for z0 in range(0, nz, zc)]
        got = cuda_dd.accel_stage_blocks(pieces, width, nr, stages,
                                         fr.BLOCK_R)
        want = accel._stage_blocks_plain(pieces, width, nr, stages,
                                         fr.BLOCK_R)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"the stage kernel at {nz} z rows "
                                 f"({dtype}) differs from its plain "
                                 f"version")
    log(f"the stage kernel at its limit of {nz} z rows (f32, bf16): "
        f"equal to its plain version")


#: the hi stage's bf16-vs-f32 rule (hi_phase): the same top (r, z)
#: cell of each stage and row, the top power within 1%
BF16_RULE = 0.01


def _top_cells(res: dict, rows) -> dict:
    """{(stage, row): (r bin, z, power)} of each row's top cell."""
    out = {}
    for h, (v, r, z) in res.items():
        for d in rows:
            i = int(np.argmax(v[d]))
            out[h, d] = (int(r[d, i]), float(z[d, i]), float(v[d, i]))
    return out


def _rule_worst(got: dict, want: dict, rows, what: str) -> float:
    """Hold rows of `got` to `want` by the bf16-vs-f32 rule; the worst
    relative power difference of the top cells."""
    a, b = _top_cells(got, rows), _top_cells(want, rows)
    worst = 0.0
    for key in a:
        if a[key][:2] != b[key][:2]:
            raise AssertionError(f"{what}: stage {key[0]} row {key[1]} "
                                 f"top cell {a[key][:2]} vs {b[key][:2]}")
        worst = max(worst, abs(a[key][2] / b[key][2] - 1.0))
    if worst > BF16_RULE:
        raise AssertionError(f"{what}: top power off by {worst:.5f} "
                             f"(limit {BF16_RULE})")
    return worst


def _rows_equal(got: dict, want: dict, rows) -> bool:
    rows = list(rows)
    return all(np.array_equal(np.asarray(x)[rows], np.asarray(y)[rows])
               for h in want for x, y in zip(got[h], want[h]))


def _ladder_counts() -> dict:
    out = {f"trials_{p}": telemetry.accel_batch_trials_total().value(path=p)
           for p in ("batched", "per_dm", "rescued")}
    for o in ("rescued", "lost"):
        out[f"rows_{o}"] = telemetry.rescue_rows_total().value(outcome=o)
    out["ooms"] = torch.cuda.memory_stats().get("num_ooms", 0)
    return out


def _delta(before: dict) -> dict:
    now = _ladder_counts()
    return {k: now[k] - before[k] for k in now}


def ladder_phase(hi: dict) -> dict:
    """The hi stage's degradation ladder at full width, on hi_phase's
    38-row ds-1 chunk: (a) the forced per-DM path against the batched
    run; (b) a real out-of-memory refusal of every batch (a ballast
    tensor leaves room for one row but not for one planned batch),
    degraded to per-DM rows on the card equal to (a); (c) two rows
    refused twice by an injected fault: the ladder ends on the card,
    the rows are zero-filled and recorded as lost; (d) a poisoned
    session on a 2-row slice through the executor's _hi_accel_pass:
    the chunk's hi stage is skipped loudly.  No work moves to the CPU:
    the host rescue runs only for spectra already there."""
    t_phase = time.time()
    wspec, res_b = hi["wspec"], hi["res_bf"]
    nrows, nbins = wspec.shape
    bank = executor._get_bank(PARAMS.hi_accel_zmax)
    nz = len(bank.zs)
    mh, topk = PARAMS.hi_accel_numharm, PARAMS.topk_per_stage
    rows = range(nrows)

    def search(specs):
        out = accel.accel_search_batch(specs, bank, max_numharm=mh,
                                       topk=topk)
        torch.cuda.synchronize()
        return out

    # ---- (a) clean, forced per-DM
    accel._reset_batch_state()
    degraded.reset()
    os.environ["TPULSAR_ACCEL_BATCH"] = "0"
    try:
        c0 = _ladder_counts()
        t0 = time.time()
        res_a = search(wspec)
        t_a = time.time() - t0
        d_a = _delta(c0)
    finally:
        del os.environ["TPULSAR_ACCEL_BATCH"]
        accel._reset_batch_state()
    if degraded.snapshot() != {"accel_batch_pinned": "TPULSAR_ACCEL_BATCH"
                               "=0 (per-DM accel path)"} or \
            degraded.provenance_snapshot() or d_a["trials_per_dm"] != nrows:
        raise AssertionError(f"ladder (a): ledgers {degraded.snapshot()} "
                             f"{degraded.provenance_snapshot()}, counts "
                             f"{d_a}")
    worst_a = _rule_worst(res_a, res_b, rows, "ladder (a) per-DM vs "
                          "batched")
    same_a = _rows_equal(res_a, res_b, rows)
    perdm_row_ms = t_a / nrows * 1e3
    log(f"ladder (a): forced per-DM ({nrows} rows x {nbins} bins): the "
        f"batched run's top (r, z) cell in every stage and row, top "
        f"powers within {worst_a:.2e} (limit {BF16_RULE}; top-k arrays "
        f"{'identical' if same_a else 'not identical'} to the batched "
        f"run's); {perdm_row_ms:.3f} ms a per-DM row on the card "
        f"(batched {hi['row_ms']:.3f} ms a row); ledger: only the pin's "
        f"own note")

    # ---- (b) a real out-of-memory refusal of every batch
    b = accel.plane_dm_chunk(nbins, nz, device=DEV)
    plan = accel_batch.plan_batches(nrows, b)

    def need_of(forced: str | None) -> tuple[int, int]:
        """A whole search of the chunk from the same allocator state,
        by the planned batches or (forced "0") by the per-DM row
        program: the device memory the allocator had to add at its
        peak (the cached free blocks that live tensors keep in their
        segments serve first, so they are counted as they are used),
        and the bytes allocated above the start."""
        if forced:
            os.environ["TPULSAR_ACCEL_BATCH"] = forced
        accel._reset_batch_state()
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            res0 = torch.cuda.memory_reserved()
            alloc0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            search(wspec)
            return (torch.cuda.max_memory_reserved() - res0,
                    torch.cuda.max_memory_allocated() - alloc0)
        finally:
            if forced:
                del os.environ["TPULSAR_ACCEL_BATCH"]
            accel._reset_batch_state()

    batch_need, batch_peak = need_of(None)
    row_need, row_peak = need_of("0")
    slack = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    log(f"ladder (b): a search of the chunk by planned batches of "
        f"{plan.b} rows adds {batch_need} B to the device memory held "
        f"({batch_peak} B allocated at its peak), by per-DM rows "
        f"{row_need} B ({row_peak} B); {slack} B cached and free in "
        f"segments that live tensors hold")
    if not (row_peak < batch_peak and row_need < batch_need):
        raise AssertionError(f"ladder (b): a row ({row_need} B, "
                             f"{row_peak} B) does not need less than a "
                             f"batch ({batch_need} B, {batch_peak} B)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info()[0]
    # room for the per-DM rows, not for a planned batch
    room = (row_need + batch_need) // 2
    ballast = torch.empty(free0 - room, dtype=torch.uint8, device=DEV)
    accel._reset_batch_state()
    degraded.reset()
    try:
        c0 = _ladder_counts()
        t0 = time.time()
        res_oom = search(wspec)
        t_b = time.time() - t0
        d_b = _delta(c0)
        snap = degraded.snapshot()
        pinned = accel._BATCH_OK is False
    finally:
        del ballast
        torch.cuda.empty_cache()
        accel._reset_batch_state()
    thresh = accel._batch_breaker_threshold()
    refused = min(thresh, plan.nbatches)
    if not snap.get("accel_batches_refused", "").startswith(
            f"{refused}/{plan.nbatches} ") or \
            pinned != (refused >= thresh) or \
            ("accel_batch_downgraded" in snap) != pinned or \
            "accel_rows_zero_filled" in snap or \
            d_b["ooms"] != 2 * refused or \
            d_b["trials_per_dm"] != nrows or d_b["trials_batched"] != 0 \
            or d_b["rows_rescued"] or d_b["rows_lost"]:
        raise AssertionError(f"ladder (b): ledger {snap}, pinned {pinned}, "
                             f"counts {d_b} (expected {refused} refused "
                             f"batches, {2 * refused} OOMs)")
    if not _rows_equal(res_oom, res_a, rows):
        raise AssertionError("ladder (b): the degraded rows differ from "
                             "the forced per-DM run (a)")
    log(f"ladder (b): a search's peaks above the allocation: by batches "
        f"of {plan.b} rows {batch_peak / 2**30:.3f} GiB, by per-DM rows "
        f"{row_peak / 2**30:.3f} GiB; ballast "
        f"{(free0 - room) / 2**30:.3f} GiB left {room / 2**30:.3f} GiB "
        f"free; {d_b['ooms']} OutOfMemoryErrors "
        f"({refused} batches each refused on dispatch and on its "
        f"retry), the batched path "
        f"{'pinned' if pinned else 'not pinned'} (breaker {thresh}, "
        f"TPULSAR_ACCEL_BATCH_BREAKER), all {nrows} rows per-DM on the "
        f"card, np.array_equal to (a); {t_b:.3f} s ({t_a:.3f} s in (a)); "
        f"ledger {json.dumps({k: v.split(';')[0] for k, v in snap.items()})}")

    # ---- (c) two rows refused twice: the ladder ends on the card
    degraded.reset()
    faults.configure("accel.row_dispatch:unimplemented:count=4")
    try:
        c0 = _ladder_counts()
        t0 = time.time()
        res_c = search(wspec)
        t_c = time.time() - t0
        d_c = _delta(c0)
        fired = faults.fired("accel.row_dispatch")
    finally:
        faults.reset()
        accel._reset_batch_state()
    lost_c = degraded.counts().get("accel_rows_zero_filled", (0, 0, 0))
    if fired != 4 or d_c["rows_lost"] != 2 or d_c["rows_rescued"] or \
            tuple(lost_c[:2]) != (2, nrows) or \
            degraded.provenance_snapshot() or d_c["trials_rescued"] or \
            d_c["trials_per_dm"] != nrows - 2:
        raise AssertionError(f"ladder (c): fired {fired}, counts {d_c}, "
                             f"loss ledger {lost_c}, provenance "
                             f"{degraded.provenance_snapshot()}")
    if not _rows_equal(res_c, res_a, range(2, nrows)):
        raise AssertionError("ladder (c): the rows not refused differ "
                             "from (a)")
    if any(np.asarray(res_c[h][0])[:2].any() for h in res_c):
        raise AssertionError("ladder (c): the lost rows are not "
                             "zero-filled")
    log(f"ladder (c): 4 injected refusals = rows 0 and 1 refused twice; "
        f"the ladder ended on the card (no host rescue for spectra on "
        f"the card): both rows zero-filled, loss ledger "
        f"accel_rows_zero_filled {lost_c[0]}/{lost_c[1]}, "
        f"rescue_rows_total{{outcome=lost}} +{d_c['rows_lost']}; rows "
        f"2..{nrows - 1} np.array_equal to (a); call {t_c:.3f} s")

    # ---- (d) a poisoned session on a 2-row slice, through the executor
    sl = wspec[:2]
    dms = hi["dms"][:2]
    degraded.reset()
    faults.configure("accel.row_dispatch:poison")
    try:
        c0 = _ladder_counts()
        t0 = time.time()
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            cands_d = executor._hi_accel_pass(sl, dms, hi["T_s"], PARAMS)
        t_d = time.time() - t0
        d_d = _delta(c0)
    finally:
        faults.reset()
        accel._reset_batch_state()
    skipped = degraded.counts().get("accel_hi_chunk_skipped", (0, 0, 0))
    if cands_d or tuple(skipped[:2]) != (2, 2) or \
            d_d["rows_lost"] != 2 or d_d["rows_rescued"] or \
            d_d["trials_rescued"] or degraded.provenance_snapshot() or \
            not any("hi-accel chunk skipped" in str(w.message)
                    for w in warned):
        raise AssertionError(f"ladder (d): {len(cands_d)} candidates; "
                             f"counts {d_d}; ledger "
                             f"{degraded.snapshot()} "
                             f"{degraded.provenance_snapshot()}")
    log(f"ladder (d): a poisoned session refused every dispatch of a "
        f"2-row slice; AccelStageRefused reached _hi_accel_pass, which "
        f"skipped the chunk's hi stage loudly on the card "
        f"(accel_hi_chunk_skipped {skipped[0]}/{skipped[1]}, "
        f"rescue_rows_total{{outcome=lost}} +{d_d['rows_lost']}, no "
        f"host recompute); {t_d:.3f} s")
    wall = time.time() - t_phase
    log(f"ladder phase wall {wall:.1f} s")
    return dict(perdm_row_ms=perdm_row_ms, batched_row_ms=hi["row_ms"],
                perdm_vs_batched_worst=worst_a,
                perdm_equals_batched=same_a,
                batch_peak_bytes=batch_peak, row_peak_bytes=row_peak,
                oom_refused_batches=refused, ooms=d_b["ooms"],
                oom_call_s=t_b, lost_rows_call_s=t_c,
                chunk_skip_s=t_d, wall_s=wall)


def hi_row_bound_ms(nbins: int, nz: int, bank) -> tuple[float, str]:
    """The least time the card could take for one DM row of the hi
    stage: read the spectrum (8 B a bin), write the bf16 plane once
    and read it once; operations: the forward FFT of every segment and
    the inverse FFT of every (segment, z) pair, 5 N log2 N each for
    N = 2*seg points."""
    nsegs = -(-nbins // bank.step)
    n = 2 * bank.seg
    nbytes = nbins * 8 + 2 * nz * 2 * nbins * 2
    nops = (nsegs + nsegs * nz) * 5 * n * math.log2(n)
    return bound_ms(nbytes, nops)


def hi_beam_bound_ms(plan, nsamp: int) -> float:
    """hi_row_bound_ms summed over every trial of the plan."""
    bank = executor._get_bank(PARAMS.hi_accel_zmax)
    total = 0.0
    for step in plan:
        nbins = ddplan.choose_n(nsamp // step.downsamp) // 2 + 1
        total += (step.dms_per_pass * step.numpasses
                  * hi_row_bound_ms(nbins, len(bank.zs), bank)[0])
    return total


#: BASELINE config 3, "accelsearch zmax=200 numharm=16", as bench.py
#: runs it: 32 DM trials from 0 at step 2 (subdm 140, nsub 96, ds 1)
#: at full length and width, the hi stage at zmax 200 (nz 201) with 16
#: harmonics and the top 64 cells a stage
CFG3_DMS = np.arange(32) * 2.0
CFG3_SUBDM, CFG3_ZMAX, CFG3_NUMHARM, CFG3_TOPK = 140.0, 200.0, 16, 64
#: the drifting train injected into config 3's series: spectrum bin
#: 40000 at z 150, which zmax 50 cannot reach
CFG3_TRAIN = (40000, 150.0)
#: the card-vs-CPU row of config 3: its first 2^18 bins (the train
#: among them).  A whole row (1,966,081 bins, nz 201) took the H100
#: machine's host 8.1 and 10.0 s on the CPU, more than the smoke can
#: spend on it (PERF.md, config 3's finding).
CFG3_CPU_BINS = 1 << 18
#: config 3's search through search_beam: one DDplan step with its
#: trials (DedispStep(lodm, dmstep, dms_per_pass, numpasses, numsub,
#: downsamp)) and the operator's SearchingConfig fields
CFG3_PLAN = [ddplan.DedispStep(0.0, 2.0, 32, 1, 96, 1)]
CFG3_SEARCHING = dict(hi_accel_zmax=200, hi_accel_numharm=16)


def _near_train(res: dict, h: int, row: int, r0: int,
                span: float = 200.0) -> float:
    """The best power of stage h's top-k cells of one row within span
    bins of spectrum bin r0 (0 when none is that close)."""
    v, r, _z = res[h]
    return max((float(x) for x, y in zip(v[row], r[row])
                if abs(0.5 * float(y) - r0) <= span), default=0.0)


def cfg3_kernel_entries(data, ch_sh, sub_sh, regs: dict) -> list[dict]:
    """Both kernels at config 3's shapes (stage 1 on the whole block at
    ds 1 and subdm 140's shifts, stage 2 at 32 rows), exact against
    their plain versions (each timed by its one comparison call), the
    kernels timed, with their bounds."""
    got, plain1 = once_ms(lambda: cuda_dd.form_subbands_plain(
        data, ch_sh, 96, 1))
    subb = cuda_dd.form_subbands(data, ch_sh, 96, 1)
    if not torch.equal(subb, got):
        raise AssertionError(f"config 3: stage-1 kernel differs from its "
                             f"plain version: max |err| "
                             f"{float((subb - got).abs().max())}")
    del got
    ms1 = time_ms(lambda: cuda_dd.form_subbands(data, ch_sh, 96, 1))
    b1, by1 = bound_ms(NCHAN * NSAMP + 96 * NSAMP * 4 + NCHAN * 4,
                       NCHAN * NSAMP)
    series, err2, plain2 = _check_stage2(subb, sub_sh, "config 3's 32 rows")
    del series
    nrows = sub_sh.shape[0]
    ms2 = time_ms(lambda: cuda_dd.dedisperse_subbands(subb, sub_sh))
    b2, by2 = bound_ms((96 + nrows) * NSAMP * 4 + sub_sh.size * 4,
                       nrows * 96 * NSAMP)
    del subb
    launch = cuda_dd.stage2_launch(sub_sh)
    log(f"config 3 kernels: form_subbands ds=1 (subdm {CFG3_SUBDM}, max "
        f"shift {int(ch_sh.max())}) exact, {ms1:.4f} ms, plain "
        f"{plain1:.4f} ms (one call), bound {b1:.4f} ms ({by1}), share "
        f"{b1 / ms1:.3f}; dedisperse_subbands {nrows} rows exact (max|err| "
        f"{err2}), span {launch.span}, {ms2:.4f} ms, plain {plain2:.4f} ms "
        f"(one call), bound {b2:.4f} ms ({by2}), share {b2 / ms2:.3f}, "
        f"{regs[f'dedisperse_subbands<{launch.rows} rows>']} registers")
    return [dict(name="form_subbands", ds=1, max_abs_err=0.0, ms=ms1,
                 plain_ms=plain1, bound_ms=b1, bound_by=by1),
            dict(name="dedisperse_subbands", rows=nrows, ds=1,
                 max_abs_err=err2, ms=ms2, plain_ms=plain2, bound_ms=b2,
                 bound_by=by2, span=launch.span)]


def cfg3_phase(data, freqs: np.ndarray, regs: dict) -> dict:
    """BASELINE config 3 on the card at the size bench.py gives it, on
    phase 1's block: dedisperse_pass (both kernels, one launch each) of
    its 32 trials at full length, a drifting train at z 150 added to
    the series, the whitened spectrum (complex_spectrum ->
    whitened_powers -> scale_spectrum, bench.py's composition), and
    accel_search_batch at zmax 200, 16 harmonics, topk 64.  Checks:
    the kernels exact at config 3's shapes; the bf16 plane against the
    f32 plane (BF16_RULE) in every stage and row; the train stage 1's
    top cell in every row (z 150, r within 0.5 bin); the default
    configuration's search (zmax 50, 8 harmonics) on the same spectra
    weaker within 200 bins of the train at stage 1; the card's f32
    against the CPU's plain f32 on row 0's first CFG3_CPU_BINS bins,
    the same cells, powers within 2e-4; no ladder counter of a refusal
    moved and no degraded flag.  Reports the batch rows
    plane_dm_chunk chose, peak memory, ms a DM row and its halves
    against hi_row_bound_ms."""
    t_phase = time.time()
    ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, CFG3_SUBDM, CFG3_DMS,
                                        TSAMP, 1)
    kernels = cfg3_kernel_entries(data, ch_sh, sub_sh, regs)
    before = dict(cuda_dd.LAUNCHES)
    series = dd.dedisperse_pass(data, freqs, 96, CFG3_SUBDM, CFG3_DMS,
                                TSAMP, 1, device=DEV)
    launched = {k: cuda_dd.LAUNCHES[k] - before[k] for k in SOLO_KERNELS}
    if launched != {k: 1 for k in SOLO_KERNELS}:
        raise AssertionError(f"config 3: dedisperse_pass launched "
                             f"{launched}, not one of each kernel")
    nrows = series.shape[0]
    noise = float(series[0].std())
    r0, z0 = CFG3_TRAIN
    # ~300 in whitened power: A^2 T / (4 sigma^2)
    _inject_drifting_train(series, NSAMP, r0, z0,
                           noise * math.sqrt(1200.0 / NSAMP), nharm=1)
    spec = fr.complex_spectrum(series)
    del series
    powers, wpow = fr.whitened_powers(spec)
    wspec = fr.scale_spectrum(spec, powers, wpow)
    del spec, powers, wpow
    nbins = wspec.shape[1]
    bank = accel.build_template_bank(CFG3_ZMAX)
    nz = len(bank.zs)

    def search(specs, b=bank, mh=CFG3_NUMHARM, topk=CFG3_TOPK):
        return accel.accel_search_batch(specs, b, max_numharm=mh,
                                        topk=topk)

    accel._reset_batch_state()
    degraded.reset()
    c0 = _ladder_counts()
    rows_bf = accel.plane_dm_chunk(nbins, nz, device=DEV)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res_bf, t_bf = once_ms(lambda: search(wspec))
    peak = torch.cuda.max_memory_allocated()
    os.environ["TPULSAR_ACCEL_PLANE_DTYPE"] = "f32"
    try:
        rows_f32 = accel.plane_dm_chunk(nbins, nz, device=DEV)
        res_f32, t_f32 = once_ms(lambda: search(wspec))
        row = wspec[:1, :CFG3_CPU_BINS].contiguous()
        res_row = search(row)
        t0 = time.perf_counter()
        res_cpu = search(row.cpu())
        cpu_s = time.perf_counter() - t0
    finally:
        del os.environ["TPULSAR_ACCEL_PLANE_DTYPE"]
    bank50 = executor._get_bank(PARAMS.hi_accel_zmax)
    res_50 = search(wspec, bank50, PARAMS.hi_accel_numharm,
                    PARAMS.topk_per_stage)
    moved = _delta(c0)
    snap = (degraded.snapshot(), degraded.provenance_snapshot())

    rows = range(nrows)
    bf_worst = _rule_worst(res_bf, res_f32, rows, "config 3 bf16 vs f32")
    tops = _top_cells(res_f32, rows)
    for d in rows:
        r, z, _v = tops[1, d]
        if abs(0.5 * r - r0) > 0.5 or z != z0:
            raise AssertionError(f"config 3: row {d}'s stage-1 top cell "
                                 f"({0.5 * r}, {z}) is not the train "
                                 f"({r0}, {z0})")
    ratio = 0.0
    for d in rows:
        near50 = _near_train(res_50, 1, d, r0)
        if near50 >= tops[1, d][2]:
            raise AssertionError(f"config 3: the zmax-50 search holds "
                                 f"{near50} within 200 bins of the train "
                                 f"in row {d}, config 3 {tops[1, d][2]}")
        ratio = max(ratio, near50 / tops[1, d][2])
    near_stages = {h: round(_near_train(res_50, h, 0, r0), 3)
                   for h in res_50}
    cpu_worst = 0.0
    for h in res_cpu:
        a = sorted(zip(res_row[h][1][0], res_row[h][2][0],
                       res_row[h][0][0]))
        b = sorted(zip(res_cpu[h][1][0], res_cpu[h][2][0],
                       res_cpu[h][0][0]))
        for (ra, za, va), (rb, zb, vb) in zip(a, b):
            if (ra, za) != (rb, zb):
                raise AssertionError(f"config 3 card vs CPU: stage {h} "
                                     f"cells differ: {(ra, za)} vs "
                                     f"{(rb, zb)}")
            cpu_worst = max(cpu_worst, abs(float(va) / float(vb) - 1.0))
    if cpu_worst > 2e-4:
        raise AssertionError(f"config 3 card vs CPU: powers off by "
                             f"{cpu_worst}")
    refused = {k: v for k, v in moved.items() if k != "trials_batched"}
    if any(refused.values()) or snap != ({}, {}):
        raise AssertionError(f"config 3: the ladder moved {moved}, "
                             f"degraded {snap}")

    # the two parts of a DM row, on one batch of each plane dtype, the
    # stage kernel checked exactly there
    stage = {}
    for dt in ("bf16", "f32"):
        os.environ["TPULSAR_ACCEL_PLANE_DTYPE"] = dt
        try:
            stage[dt] = stage_kernel_entry(
                wspec, bank, CFG3_NUMHARM, CFG3_TOPK,
                accel.plane_dm_chunk(nbins, nz, device=DEV), "config 3")
        finally:
            del os.environ["TPULSAR_ACCEL_PLANE_DTYPE"]
    stages = tuple(fr.harmonic_stages(CFG3_NUMHARM))
    del wspec
    row_ms = t_bf / nrows
    bnd, by = hi_row_bound_ms(nbins, nz, bank)
    log(f"config 3 ({nrows} trials x {nbins} bins, nz {nz}, template "
        f"width {bank.width}, stages {list(stages)}, topk {CFG3_TOPK}): "
        f"dedisperse_pass launches {launched}; the train (bin {r0}, z "
        f"{z0}) is stage 1's top cell in every row; bf16 vs f32 the same "
        f"top cells, top powers within {bf_worst:.5f} (limit "
        f"{BF16_RULE}); the zmax-50 / {PARAMS.hi_accel_numharm}-harmonic "
        f"search's best stage-1 power within 200 bins of the train at "
        f"most {ratio:.4f} of config 3's (row 0, each stage: "
        f"{near_stages}; config 3's row-0 tops "
        f"{ {h: round(tops[h, 0][2], 3) for h in stages} })")
    log(f"config 3 card f32 vs CPU plain f32 (row 0's first "
        f"{CFG3_CPU_BINS} bins, a cut of the {nbins}): the same "
        f"{CFG3_TOPK} cells in every stage, powers within "
        f"{cpu_worst:.2e} (limit 2e-4); the CPU's cut row {cpu_s:.3f} s")
    log(f"config 3 time: bf16 {t_bf:.3f} ms for {nrows} rows (the "
        f"checked call), {row_ms:.4f} ms a DM row; f32 {t_f32:.3f} ms; "
        f"plane_dm_chunk {rows_bf} row(s) a batch (bf16), {rows_f32} "
        f"(f32); one batch: correlation {stage['bf16']['corr_ms']:.4f} "
        f"ms a row, stage kernel + top-k "
        f"{stage['bf16']['kernel_topk_ms']:.4f} ms a row; bound "
        f"{bnd:.4f} ms a row ({by}), share {bnd / row_ms:.4f}; peak "
        f"memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
        f"above the {base / 2**30:.3f} GiB held before); ladder "
        f"{moved}, no refusal; {card_line()}; phase "
        f"{time.time() - t_phase:.1f} s")
    return dict(row_ms=row_ms, corr_row_ms=stage["bf16"]["corr_ms"],
                harm_row_ms=stage["bf16"]["kernel_topk_ms"],
                stage_kernel=stage, f32_ms=t_f32, bf16_ms=t_bf,
                bound_row_ms=bnd, bound_by=by, batch_rows=rows_bf,
                batch_rows_f32=rows_f32, peak_bytes=peak,
                peak_above_bytes=peak - base, bf16_worst=bf_worst,
                cpu_worst=cpu_worst, cpu_row_s=cpu_s,
                zmax50_ratio=ratio, launches=launched, kernels=kernels,
                wall_s=time.time() - t_phase)


def cfg3_search_phase(fns: list[str], tmp: str, nsamp: int) -> dict:
    """Config 3 through search_beam, the entry point a user calls, on
    phase 4's beam files: SearchParams.from_config of a SearchingConfig
    with hi_accel_zmax 200 and hi_accel_numharm 16 (plots off), one
    DDplan step of config 3's 32 trials.  Checks the pulsar recovered
    and folded, every trial through the hi stage with no degraded flag,
    each kernel launched as often as the plan and the outcome require
    (at least once), peak memory below 80 GiB; prints the wall and the
    .report's stages."""
    params = dataclasses.replace(
        executor.SearchParams.from_config(
            config_core.SearchingConfig(**CFG3_SEARCHING)),
        make_plots=False)
    torch.cuda.reset_peak_memory_stats()
    cuda_dd.reset_counts()
    rows0 = _kernel_rows()
    t0 = time.time()
    with StageShapes() as shapes:
        out = executor.search_beam(
            fns, os.path.join(tmp, "cfg3_work"),
            os.path.join(tmp, "cfg3_results"), params, zaplist=ZAPLIST,
            plan=CFG3_PLAN, device="cuda")
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: cuda_dd.LAUNCHES[k]
                for k in SOLO_KERNELS + ("accel_stage",)}
    peak = torch.cuda.max_memory_allocated()
    n1, n2 = expected_launches(CFG3_PLAN, nsamp, out, params)
    want = {"form_subbands": sum(n1.values()),
            "dedisperse_subbands": sum(n2.values())}
    solo = {k: launches[k] for k in SOLO_KERNELS}
    if solo != want or min(solo.values()) < 1:
        raise AssertionError(f"config 3 search: launches {launches}, "
                             f"expected {want}")
    check_stage_launches(launches["accel_stage"], shapes.counts, rows0,
                         "config 3 search")
    chunk = executor.pass_chunk_size(32, ddplan.choose_n(nsamp), params)
    check_hi_stage(32)
    check_pulsar(out.resultsdir, out.basenm, "config 3 search")
    if peak >= 80 * 2**30:
        raise AssertionError(f"config 3 search: peak device memory "
                             f"{peak / 2**30:.3f} GiB")
    stages = report_stages(os.path.join(out.resultsdir,
                                        f"{out.basenm}.report"))
    log(f"config 3 search: search_beam (SearchingConfig "
        f"{CFG3_SEARCHING}, plots off; plan {CFG3_PLAN[0]}) wall "
        f"{wall:.3f} s on {nsamp} samples; {out.num_dm_trials} trials in "
        f"chunks of {chunk}; launches {launches} (expected: stage 1 "
        f"{dict(n1)}, stage 2 {dict(n2)}); peak device memory "
        f"{peak / 2**30:.3f} GiB; {len(out.candidates)} candidates, "
        f"{len(out.folded)} folded, {len(out.refined_dms)} DM groups "
        f"refined")
    log("config 3 search .report stages: " + json.dumps(stages))
    return dict(wall_s=wall, launches=launches, n1=n1, n2=n2,
                peak_bytes=peak, stages=stages, chunk=chunk,
                nsamp=nsamp, accel_shapes=shapes.counts)


#: the tree phase's level budgets: the default (TPULSAR_TREE_BUDGET
#: unset) and one that lets the full-width tree keep its levels
TREE_BUDGETS = (None, 16 << 30)


def tree_phase(data, freqs: np.ndarray) -> list[dict]:
    """The tree stage-2 family on the plan's first pass at full width
    (ds 1, all its DM rows) with TPULSAR_DD_FAMILY=tree, against the
    CUDA direct kernel on the same subbands: series and the fused
    detrend's norms at rtol 2e-6 / atol 2e-5 (tests/test_tree_dd.py's
    summation-order tolerance), the plan, both times and peak memory,
    at each of TREE_BUDGETS."""
    step = ddplan.survey_plan("pdev")[0]
    ppass = step.passes()[0]
    dms = np.asarray(ppass.dms)
    ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm, dms,
                                        TSAMP, 1)
    subb = cuda_dd.form_subbands(data, ch_sh, 96, 1)
    T = subb.shape[1]
    direct = cuda_dd.dedisperse_subbands(subb, sub_sh)
    direct_norm = sp_k.detrend_normalize(direct)
    direct_ms = time_ms(lambda: cuda_dd.dedisperse_subbands(subb, sub_sh))
    # what the tree's fused residual replaces on the direct path
    direct_sp_ms = time_ms(lambda: sp_k.detrend_normalize(
        cuda_dd.dedisperse_subbands(subb, sub_sh)), runs=3)
    out = []
    family = os.environ.get("TPULSAR_DD_FAMILY")
    os.environ["TPULSAR_DD_FAMILY"] = "tree"
    try:
        for budget in TREE_BUDGETS:
            plan = tree_dd.plan_for_pass(sub_sh, T=T, budget=budget,
                                         device=DEV)
            if plan is None:
                raise AssertionError("TPULSAR_DD_FAMILY=tree: no tree plan")

            def run():
                parts = tree_dd.tree_levels(subb, plan)
                return tree_dd.residual_series(parts, plan, 0, len(dms), T,
                                               fuse=True)

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            series, norm = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            errs = []
            for what, got, want in (("series", series, direct),
                                    ("fused-detrend norms", norm,
                                     direct_norm)):
                err = float((got - want).abs().max())
                errs.append(err)
                if not torch.allclose(got, want, rtol=2e-6, atol=2e-5):
                    raise AssertionError(
                        f"tree (budget {budget}): {what} differ from the "
                        f"direct kernel's beyond rtol 2e-6 / atol 2e-5: "
                        f"max |err| {err}")
            exact = torch.equal(series, direct)
            del series, norm
            tree_ms = time_ms(run, runs=3)
            log(f"tree pass 0 (ds 1, {len(dms)} DM rows x {T}, budget "
                f"{budget or tree_dd.level_budget()} B): depth "
                f"{plan.depth}, cost_rows {plan.cost_rows} (direct "
                f"{len(dms) * 96}), residual fraction "
                f"{plan.residual_fraction:.4f}; series max|err| "
                f"{errs[0]} ({'bit-identical' if exact else 'within tol'}), "
                f"norms max|err| {errs[1]}; levels + residual + fused "
                f"detrend {tree_ms:.3f} ms vs direct kernel + detrend "
                f"{direct_sp_ms:.3f} ms ({tree_ms / direct_sp_ms:.2f}x; "
                f"the kernel alone {direct_ms:.3f} ms); peak memory "
                f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
                f"above the inputs)")
            out.append(dict(budget=budget or tree_dd.level_budget(),
                            depth=plan.depth, cost_rows=plan.cost_rows,
                            residual_fraction=plan.residual_fraction,
                            tree_ms=tree_ms, direct_ms=direct_ms,
                            direct_detrend_ms=direct_sp_ms,
                            peak_bytes=peak, series_err=errs[0],
                            norm_err=errs[1]))
    finally:
        if family is None:
            del os.environ["TPULSAR_DD_FAMILY"]
        else:
            os.environ["TPULSAR_DD_FAMILY"] = family
    del subb, direct, direct_norm
    torch.cuda.empty_cache()
    return out


def _small_pulsar_block(seed: int, period: float, dm: float, amp: float,
                        width: float, z: float = 0.0):
    """32 channels x 32768 samples at 0.5 ms with one dispersed pulse
    train whose frequency drifts z bins over the observation."""
    rng = np.random.default_rng(seed)
    nchan, T, dt = 32, 1 << 15, 5e-4
    freqs = np.linspace(1214.0, 1536.0, nchan)
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    t = np.arange(T) * dt
    f0, fdot = 1.0 / period, z / (T * dt) ** 2
    delays = 4148.808 * dm * (freqs ** -2.0 - freqs[-1] ** -2.0)
    for c in range(nchan):
        tc = t - delays[c]
        data[c] += (((f0 * tc + 0.5 * fdot * tc * tc) % 1.0)
                    < width) * amp
    return data, freqs, dt


def small_parity_phase() -> None:
    """The search on a small block, on the card and through the plain
    versions on the CPU: the zero-accel configuration, then the
    default configuration with an accelerated pulsar (z = 15)."""
    data, freqs, dt = _small_pulsar_block(2024, 0.25, 60.0, 1.2, 0.1)
    plan = [ddplan.DedispStep(10.0, 5.0, 12, 1, 16, 1),
            ddplan.DedispStep(70.0, 10.0, 6, 1, 16, 2)]
    params = executor.SearchParams.slice_defaults(
        nsub=16, lo_accel_numharm=8, topk_per_stage=16)
    out = {dev: executor.search_block(data, freqs, dt, plan, params,
                                      device=dev)
           for dev in ("cuda", "cpu")}
    g, c = out["cuda"], out["cpu"]
    if g[3] != c[3] or not g[0] or not c[0]:
        raise AssertionError(f"small parity: trials {g[3]} vs {c[3]}, "
                             f"{len(g[0])} vs {len(c[0])} candidates")
    a, b = g[0][0], c[0][0]
    if (a.dm != b.dm or a.numharm != b.numharm
            or not math.isclose(a.freq_hz, b.freq_hz, rel_tol=1e-4)
            or not math.isclose(a.sigma, b.sigma, rel_tol=1e-2)):
        raise AssertionError(f"small parity: top candidate {a} vs {b}")
    if abs(a.freq_hz - 4.0) > 0.01:
        raise AssertionError(f"small parity: pulsar not recovered: {a}")
    log(f"small parity, zero-accel (cuda vs cpu plain): {len(g[0])} vs "
        f"{len(c[0])} candidates, top {a.freq_hz:.6f} Hz DM {a.dm} "
        f"sigma {a.sigma:.3f} vs {b.sigma:.3f}; {len(g[2])} vs "
        f"{len(c[2])} SP events")

    z_inj, p_inj = 15.0, 0.05
    data, freqs, dt = _small_pulsar_block(2025, p_inj, 40.0, 0.9, 0.2,
                                          z=z_inj)
    plan = [ddplan.DedispStep(20.0, 5.0, 10, 1, 16, 1)]
    out = {dev: executor.search_block(data, freqs, dt, plan, PARAMS,
                                      device=dev)
           for dev in ("cuda", "cpu")}
    g, c = out["cuda"], out["cpu"]
    if g[3] != c[3] or not g[1] or not c[1]:
        raise AssertionError(f"small accel parity: trials {g[3]} vs "
                             f"{c[3]}, {len(g[1])} vs {len(c[1])} folds")
    a, b = g[0][0], c[0][0]
    if (a.dm != b.dm or a.numharm != b.numharm
            or not math.isclose(a.freq_hz, b.freq_hz, rel_tol=1e-4)
            or abs(a.z - b.z) > 0.1
            or not math.isclose(a.sigma, b.sigma, rel_tol=1e-2)):
        raise AssertionError(f"small accel parity: top candidate {a} vs "
                             f"{b}")
    f_mean = 1.0 / p_inj + z_inj / (2 * (1 << 15) * dt)
    if abs(a.z - z_inj) > accel.DZ or abs(a.freq_hz / f_mean - 1) > 1e-3:
        raise AssertionError(f"small accel parity: the accelerated "
                             f"pulsar (z {z_inj}, mean f {f_mean:.5f} Hz) "
                             f"is not the top candidate: {a}")
    fa, fb = g[1][0], c[1][0]
    if abs(fa.period_s / fb.period_s - 1) > 1e-3 or \
            abs(fa.period_s / a.period_s - 1) > 1e-2 or \
            min(fa.reduced_chi2, fb.reduced_chi2) < 5:
        raise AssertionError(f"small accel parity: top fold {fa} vs {fb}")
    log(f"small parity, default configuration (cuda vs cpu plain): "
        f"{len(g[0])} vs {len(c[0])} candidates, top {a.freq_hz:.6f} vs "
        f"{b.freq_hz:.6f} Hz, z {a.z:.4f} vs {b.z:.4f} (injected "
        f"{z_inj}), sigma {a.sigma:.3f} vs {b.sigma:.3f}; top fold P "
        f"{fa.period_s:.9f} vs {fb.period_s:.9f} s, chi2 "
        f"{fa.reduced_chi2:.3f} vs {fb.reduced_chi2:.3f}; {len(g[1])} "
        f"vs {len(c[1])} folds")


def expected_launches(plan, nsamp: int, out, params=None,
                      first_pass: int = 0) -> tuple[dict, dict]:
    """Stage-1 launches by downsample and stage-2 launches by shape
    that a search computing the passes from first_pass on must make:
    the search's (plan_shapes), one stage 1 at ds 1 and one stage 2 at
    one row per DM group refined, and one stage 1 per originating pass
    of the folded candidates (folded[k] is the fold of
    candidates[k])."""
    n1, n2 = plan_shapes(plan, nsamp, params or PARAMS, first_pass)
    n1 = dict(n1)
    nref = len(out.refined_dms)
    n1[1] = n1.get(1, 0) + nref
    n2 = dict(n2)
    n2[(1, 1)] = n2.get((1, 1), 0) + nref
    passes = {fold_batch.pass_of(plan, c.dm)
              for c in out.candidates[:len(out.folded)]}
    for si, _pi in passes:
        ds = plan[si].downsamp
        n1[ds] = n1.get(ds, 0) + 1
    return n1, n2


def _bestprof_hits(path: str) -> list[tuple[str, float, float]]:
    """(member, period s, reduced chi2) of every .bestprof in a
    _bestprof.tgz."""
    hits = []
    with tarfile.open(path) as tf:
        for m in tf.getmembers():
            text = tf.extractfile(m).read().decode()
            p = float(re.search(r"P_topo \(ms\) = (\S+)", text).group(1))
            chi = float(re.search(r"Reduced chi-sqr = (\S+)",
                                  text).group(1))
            hits.append((m.name, p * 1e-3, chi))
    return hits


def check_pulsar(resultsdir: str, basenm: str, what: str) -> None:
    """The injected pulsar is in the .accelcands rows and folded by a
    .bestprof (period within 1e-3, reduced chi2 > 5)."""
    cands = accelcands.parse_candlist(os.path.join(
        resultsdir, f"{basenm}.accelcands"))
    hits = [c for c in cands
            if abs(c.period_s - PSR_PERIOD) / PSR_PERIOD < 1e-3
            and abs(c.dm - PSR_DM) < 5.0]
    if not hits:
        raise AssertionError(
            f"{what}: injected pulsar (P={PSR_PERIOD} s, DM={PSR_DM}) "
            f"not in the {len(cands)} .accelcands rows: "
            f"{[(c.period_s, c.dm, c.sigma) for c in cands[:5]]}")
    best = max(hits, key=lambda c: c.sigma)
    log(f"{what}: recovered the pulsar: P={best.period_s:.9f} s DM "
        f"{best.dm} z {best.z} sigma {best.sigma:.2f} numharm "
        f"{best.numharm} ({len(cands)} candidates)")
    folds = [h for h in _bestprof_hits(os.path.join(
        resultsdir, f"{basenm}_bestprof.tgz"))
        if abs(h[1] - PSR_PERIOD) / PSR_PERIOD < 1e-3 and h[2] > 5]
    if not folds:
        raise AssertionError(f"{what}: no .bestprof folds the pulsar "
                             f"within 1e-3 in period with reduced chi2 "
                             f"> 5")
    name, p, chi = max(folds, key=lambda h: h[2])
    log(f"{what}: folded the pulsar: {name} P={p:.12f} s reduced chi2 "
        f"{chi:.3f} ({len(folds)} .bestprof files fold it)")


class CallClock:
    """Seconds and calls spent in owner.name while active (a checkpoint
    step's cost on the search's wall clock)."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.seconds, self.calls = 0.0, 0
        self._orig = orig = getattr(self.owner, self.name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._orig)
        return False


class StageShapes:
    """The hi stage's kernel launches by shape while active: (spectrum
    bins, DM rows, plane dtype, z rows, top stage) -> launches, counted
    by a wrapper of cuda_dd.accel_stage_blocks (kernels/accel.py calls
    it through the module, so every batch and per-DM row is seen)."""

    def __enter__(self):
        self.counts: dict = {}
        self._orig = orig = cuda_dd.accel_stage_blocks

        def counted(pieces, width, nr, stages, block_r):
            key = (nr // 2, pieces[0].shape[0],
                   str(pieces[0].dtype).replace("torch.", ""),
                   sum(p.shape[2] for p in pieces), int(stages[-1]))
            self.counts[key] = self.counts.get(key, 0) + 1
            return orig(pieces, width, nr, stages, block_r)

        cuda_dd.accel_stage_blocks = counted
        return self

    def __exit__(self, *exc):
        cuda_dd.accel_stage_blocks = self._orig
        return False


def checkpoint_cost(ckdir: str, clock: CallClock,
                    what: str = "phase 4") -> dict:
    """Artifacts and bytes the manifest records, by kind, and the
    manifest's own size."""
    doc = ckpt.read_manifest(ckdir)
    if doc is None:
        raise AssertionError(f"no readable checkpoint manifest in {ckdir}")
    kinds: dict = {}
    for entry in doc["entries"].values():
        n, b = kinds.get(entry["kind"], (0, 0))
        kinds[entry["kind"]] = (n + 1, b + entry["bytes"])
    cost = dict(artifacts=len(doc["entries"]),
                bytes=sum(b for _n, b in kinds.values()),
                by_kind={k: dict(artifacts=n, bytes=b)
                         for k, (n, b) in sorted(kinds.items())},
                manifest_bytes=os.path.getsize(ckpt.manifest_path(ckdir)),
                save_s=clock.seconds, save_calls=clock.calls)
    if not ckpt.verify_root(ckdir)["ok"]:
        raise AssertionError(f"{what}: the checkpoint does not verify")
    return cost


def main_path_phase(fns: list[str], tmp: str, nsamp: int, plan,
                    what: str = "phase 4") -> dict:
    """Phase 4: search_beam at the default configuration with a
    checkpoint directory (and phase 7's solo search of its shorter
    beam, labelled `what`)."""
    ck4 = os.path.join(tmp, "ck4")
    torch.cuda.reset_peak_memory_stats()
    cuda_dd.reset_counts()
    rows0 = _kernel_rows()
    t0 = time.time()
    with CallClock(ckpt.CheckpointStore, "save") as clock, \
            StageShapes() as shapes:
        out = executor.search_beam(
            fns, os.path.join(tmp, "work"), os.path.join(tmp, "results"),
            PARAMS, zaplist=ZAPLIST, checkpoint_dir=ck4, device="cuda")
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cuda_dd.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: search_beam (SearchParams(make_plots=False), "
        f"checkpoint_dir set) wall {wall:.3f} s; {out.num_dm_trials} DM "
        f"trials; peak device memory {peak / 2**30:.3f} GiB; masked "
        f"fraction "
        f"{out.masked_fraction:.4f}")
    stages = dict(out.timers.times)
    stages["other"] = wall - sum(stages.values())
    log("stage seconds: " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))
    cost = checkpoint_cost(ck4, clock, what)
    log(f"checkpoint: {cost['artifacts']} artifacts, {cost['bytes']} "
        f"bytes ({json.dumps(cost['by_kind'])}); {cost['save_s']:.3f} s "
        f"in store.save over {cost['save_calls']} calls "
        f"({100 * cost['save_s'] / wall:.2f}% of the wall time); "
        f"manifest {cost['manifest_bytes']} bytes")

    n1, n2 = expected_launches(plan, nsamp, out)
    exp1, exp2 = sum(n1.values()), sum(n2.values())
    s1, s2 = (sum(n.values()) for n in plan_shapes(plan, nsamp, PARAMS))
    log(f"launches: {launches} (expected form_subbands {exp1} = {s1} "
        f"search + {len(out.refined_dms)} refinement + "
        f"{exp1 - s1 - len(out.refined_dms)} fold passes; "
        f"dedisperse_subbands {exp2} = {s2} search chunks + "
        f"{len(out.refined_dms)} refinement rows)")
    if launches["form_subbands"] != exp1 or \
            launches["dedisperse_subbands"] != exp2:
        raise AssertionError(f"launch counts {launches} != expected "
                             f"({exp1}, {exp2})")
    check_stage_launches(launches["accel_stage"], shapes.counts, rows0,
                         what)
    if not 0.0 <= out.masked_fraction < 0.2:
        raise AssertionError(f"masked fraction {out.masked_fraction} "
                             f"on a beam of clean noise")
    ntrials = ddplan.total_dm_trials(plan)
    if out.num_dm_trials != ntrials:
        raise AssertionError("DM trial count differs from the plan")
    check_hi_stage(ntrials)
    check_pulsar(out.resultsdir, out.basenm, what)
    log(f"{what}: {len(out.folded)} folded, {len(out.refined_dms)} DM "
        f"groups refined, {len(out.sp_events)} SP events")
    hi_bound = hi_beam_bound_ms(plan, nsamp)
    hi_s = stages["hi-accelsearch"]
    log(f"hi stage a beam: {hi_s:.3f} s for {ntrials} trials, bound "
        f"{hi_bound / 1e3:.4f} s, share {hi_bound / 1e3 / hi_s:.4f}")
    # the fold's host part: float64 phase bins of one candidate at
    # full resolution (fold_batch.fold_subbands_batch's loop body)
    t64 = np.arange(nsamp, dtype=np.float64) * TSAMP
    t0 = time.perf_counter()
    np.minimum((np.mod(t64 / PSR_PERIOD, 1.0) * 100).astype(np.int32),
               99)
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"folding: {stages['folding']:.3f} s for {len(out.folded)} "
        f"candidates; the host's float64 phase bins take {host_ms:.2f} "
        f"ms a full-resolution candidate (x {len(out.folded)} = "
        f"{host_ms * len(out.folded) / 1e3:.3f} s)")
    return dict(launches=launches, n1=n1, n2=n2, wall_s=wall,
                peak_bytes=peak, stages=stages, checkpoint=cost,
                resultsdir=out.resultsdir, ckdir=ck4, basenm=out.basenm,
                outcome=out, accel_shapes=shapes.counts)


def _kernel_rows() -> tuple[float, float]:
    """(DM rows the hi stage's kernel summed, trials the batched hi
    stage delivered) so far in this process."""
    return (telemetry.accel_kernel_rows_total().value(),
            telemetry.accel_batch_trials_total().value(path="batched"))


def check_stage_launches(launched: int, shapes: dict, rows0,
                         what: str) -> None:
    """A search on the card launched the hi stage's kernel at least
    once, each launch seen by its StageShapes, and every batched DM row
    went through it (kernel rows over batched rows 1.0, counted from
    rows0 = _kernel_rows() before the search)."""
    krows, brows = (b - a for a, b in zip(rows0, _kernel_rows()))
    if launched < 1 or sum(shapes.values()) != launched or \
            krows != brows:
        raise AssertionError(f"{what}: the hi stage's kernel launched "
                             f"{launched} times ({shapes} by shape) over "
                             f"{krows} DM rows of {brows} batched")
    by_shape = {str(k): v for k, v in sorted(shapes.items())}
    log(f"{what}: the hi stage's kernel launched {launched} times, by "
        f"(bins, rows, dtype, nz, top stage) {by_shape}; kernel rows "
        f"over batched rows {krows}/{brows} = {krows / brows:.4f}")


def check_hi_stage(ntrials: int) -> None:
    """Every trial the search computed went through the hi stage, and
    no degraded flag was raised."""
    hi = degraded.counts().get("accel_hi_chunk_skipped")
    if hi is None or hi[:2] != (0, ntrials):
        raise AssertionError(f"hi stage: (skipped, searched, calls) "
                             f"{hi}, expected (0, {ntrials}, ...)")
    if degraded.snapshot() or degraded.provenance_snapshot():
        raise AssertionError(f"degraded flags raised: "
                             f"{degraded.snapshot()} "
                             f"{degraded.provenance_snapshot()}")
    log(f"hi stage: all {hi[1]} trials searched in {hi[2]} DM chunks, "
        f"none skipped; no degraded flag")


def truncate_checkpoint(ckdir: str, keep_passes: int) -> list[str]:
    """Cut a checkpoint back to the state a kill after pass
    keep_passes - 1 leaves: every later pass artifact, the sifted list
    and the folds dropped from the manifest and the disk.  Returns the
    dropped keys."""
    path = ckpt.manifest_path(ckdir)
    with open(path) as fh:
        doc = json.load(fh)
    dropped = sorted(
        k for k in doc["entries"]
        if k == "sifted" or k.startswith("fold_")
        or (k.startswith("pass_") and int(k[5:]) >= keep_passes))
    for k in dropped:
        os.unlink(os.path.join(ckdir, doc["entries"].pop(k)["file"]))
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return dropped


def tool(name: str):
    """tools/<name>.py of this checkout, loaded by path."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def results_diff():
    """tools/torch_results_diff.py of this checkout."""
    return tool("torch_results_diff")


def resume_phase(fns: list[str], tmp: str, nsamp: int, plan,
                 ref: dict) -> dict:
    """Phase 5, on phase 7's beam (`fns`): its solo search's checkpoint
    (`ref`, main_path_phase's record) cut back to pass K_RESUME in a
    new output directory, the beam searched again through the job's
    run_search on the card."""
    out5 = os.path.join(tmp, "out5")
    ck5 = ckpt.default_root(out5)
    shutil.copytree(ref["ckdir"], ck5)
    dropped = truncate_checkpoint(ck5, K_RESUME)
    kept = ckpt.read_manifest(ck5)["entries"]
    log(f"phase 5: checkpoint cut back to passes 0..{K_RESUME - 1} "
        f"({len(kept)} artifacts kept, {len(dropped)} dropped)")
    cuda_dd.reset_counts()
    t0 = time.time()
    with CallClock(executor, "_load_decoded") as loads, \
            CallClock(ckpt.CheckpointStore, "save") as saves:
        out = search_job.run_search(fns, os.path.join(tmp, "work5"),
                                    out5, PARAMS, ZAPLIST, log=log,
                                    device="cuda")
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cuda_dd.LAUNCHES)
    log(f"phase 5 checkpoint: {loads.seconds:.3f} s loading and "
        f"decoding {loads.calls} pass/sifted artifacts, "
        f"{saves.seconds:.3f} s in store.save over {saves.calls} calls")
    if out is None:
        raise AssertionError("phase 5: run_search skipped the beam")
    npass = sum(s.numpasses for s in plan)
    with open(os.path.join(out5, "metrics.json")) as fh:
        metrics = json.load(fh)
    passes = metrics["tpulsar_passes_total"]["series"][""]
    if passes != npass - K_RESUME:
        raise AssertionError(f"phase 5 computed {passes} passes, "
                             f"expected {npass - K_RESUME}")
    trials = sum(len(pp.dms) for pp in _passes(plan)[K_RESUME:])
    if metrics["tpulsar_dm_trials_total"]["series"][""] != trials:
        raise AssertionError("phase 5 searched another trial count")
    check_hi_stage(trials)
    n1, n2 = expected_launches(plan, nsamp, out, first_pass=K_RESUME)
    exp1, exp2 = sum(n1.values()), sum(n2.values())
    s1, s2 = (sum(n.values())
              for n in plan_shapes(plan, nsamp, PARAMS, K_RESUME))
    log(f"phase 5 launches: {launches} (expected form_subbands {exp1} = "
        f"{s1} passes >= {K_RESUME} + {len(out.refined_dms)} refinement "
        f"+ {exp1 - s1 - len(out.refined_dms)} fold passes; "
        f"dedisperse_subbands {exp2} = {s2} search chunks + "
        f"{len(out.refined_dms)} refinement rows)")
    if launches["form_subbands"] != exp1 or \
            launches["dedisperse_subbands"] != exp2:
        raise AssertionError(f"phase 5 launch counts {launches} != "
                             f"expected ({exp1}, {exp2})")
    if min(launches[k] for k in SOLO_KERNELS) < 1:
        raise AssertionError(f"phase 5: a kernel never launched: "
                             f"{launches}")
    problems = results_diff().diff_results(ref["resultsdir"], out5)
    if problems:
        raise AssertionError("phase 5 results differ from the solo "
                             "search's: " + "; ".join(problems[:10]))
    log(f"phase 5: all {len(os.listdir(out5))} results files equal the "
        f"solo search's (timing-bearing files by presence, .npz by "
        f"arrays, tarballs by members)")
    check_pulsar(out5, out.basenm, "phase 5")
    if os.path.exists(ck5):
        raise AssertionError("phase 5: the checkpoint was not cleaned")
    stages = dict(out.timers.times)
    stages["other"] = wall - sum(stages.values())
    log(f"phase 5 run_search wall {wall:.3f} s (the solo search "
        f"{ref['wall_s']:.3f} s); stage seconds, phase 5 vs the solo: "
        + json.dumps({k: [round(v, 3), round(ref["stages"].get(k, 0.0),
                                             3)]
                      for k, v in stages.items()}))
    resumed = metrics["tpulsar_checkpoint_events_total"]["series"]
    log(f"phase 5 checkpoint events: {resumed}")
    return dict(launches=launches, n1=n1, n2=n2, wall_s=wall,
                stages=stages, passes=passes, load_s=loads.seconds,
                save_s=saves.seconds)


#: runs `python -m tpulsar_torch ARGS` (the package as __main__, as -m
#: does) with plots off, as phase 4 searches (the card's machine has
#: no matplotlib); resets the kernels' launch counts and the peak
#: device memory right after the server's boot and writes them, with
#: the boot's own counts, to $SMOKE_COUNTS at exit (a command without a
#: boot, phase 12's `search`, counts from the process start), with its
#: start and end times; keeps a copy of each checkpoint the job cleans,
#: beside its output directory, as <outdir>.checkpoint.  With
#: $SMOKE_HOLD set (phase 11's w1) it also writes the boot's
#: counts to $SMOKE_COUNTS.booted and claims nothing until the file
#: $SMOKE_HOLD exists
SERVE_WRAPPER = r"""
import time
t_start = time.time()
import dataclasses, json, os, runpy, shutil, sys
import torch
from tpulsar_torch import checkpoint
from tpulsar_torch.kernels import cuda_dd
from tpulsar_torch.search import executor
from tpulsar_torch.serve import server

clean = checkpoint.clean


def kept_clean(root):
    shutil.copytree(root, os.path.dirname(root) + ".checkpoint")
    clean(root)


checkpoint.clean = kept_clean

from_config = executor.SearchParams.from_config
executor.SearchParams.from_config = classmethod(
    lambda cls, s: dataclasses.replace(from_config(s), make_plots=False))
counts = {}
boot = server.SearchServer.boot


def counted_boot(self):
    boot(self)
    counts["boot"] = dict(cuda_dd.LAUNCHES)
    counts["boot_seconds"] = self.boot_seconds
    cuda_dd.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    hold = os.environ.get("SMOKE_HOLD")
    if hold:
        with open(os.environ["SMOKE_COUNTS"] + ".booted", "w") as fh:
            json.dump(counts, fh)
        while not os.path.exists(hold):
            time.sleep(0.001)


server.SearchServer.boot = counted_boot
sys.argv = ["tpulsar_torch"] + sys.argv[1:]
try:
    runpy.run_module("tpulsar_torch", run_name="__main__", alter_sys=True)
finally:
    counts["served"] = dict(cuda_dd.LAUNCHES)
    counts["peak_bytes"] = torch.cuda.max_memory_allocated()
    counts["t_start"], counts["t_end"] = t_start, time.time()
    with open(os.environ["SMOKE_COUNTS"], "w") as fh:
        json.dump(counts, fh)
"""


def start_server(tmp: str, name: str, tickets: dict, args=()) -> dict:
    """Write the tickets ({tid: (files, outdir)}, in order) to a spool
    and start `python -m tpulsar_torch serve --once ARGS` on them in a
    subprocess on the card, through SERVE_WRAPPER, with the default
    configuration and every path under tmp; finish_server waits for
    it."""
    from tpulsar_torch.serve import protocol

    srv = server_setup(tmp, name)
    for tid, (files, outdir) in tickets.items():
        protocol.write_ticket(srv["spool"], tid, files, outdir)
        time.sleep(0.01)                  # FIFO by submission time
    torch.cuda.empty_cache()
    logf = open(srv["log"], "w")
    proc = subprocess.Popen(srv["cmd"] + list(args), env=srv["env"],
                            stdout=logf, stderr=subprocess.STDOUT)
    return dict(srv=srv, proc=proc, logf=logf, t0=time.time(),
                tickets=list(tickets))


def finish_server(run: dict) -> dict:
    """Wait for start_server's server (900 s at most from its start).
    Returns the spool, the result records, the wrapper's counts, the
    server process's wall time and its log."""
    from tpulsar_torch.serve import protocol

    srv, proc = run["srv"], run["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, run["t0"] + 900 - time.time()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        run["logf"].close()
    wall = time.time() - run["t0"]
    counts = server_counts(srv, rc)
    with open(srv["hb"]) as fh:
        beat = json.load(fh)
    return dict(spool=srv["spool"], wall_s=wall, counts=counts, beat=beat,
                recs={t: protocol.read_result(srv["spool"], t)
                      for t in run["tickets"]})


def server_setup(tmp: str, name: str) -> dict:
    """A server's spool, configuration (the default one with every
    path under tmp, as a python file: the card's machine may have no
    YAML parser), environment, log and counts files, and its command:
    `python -m tpulsar_torch serve --once` through SERVE_WRAPPER."""
    spool = os.path.join(tmp, f"{name}_spool")
    cfg = os.path.join(tmp, f"{name}_cfg.py")
    paths = {"processing": {"base_working_directory": "work",
                            "base_results_directory": "res"},
             "basic": {"log_dir": "logs"},
             "download": {"datadir": "raw"},
             "background": {"jobtracker_db": "jt.db"},
             "resultsdb": {"url": "results.db"}}
    with open(cfg, "w") as fh:
        for dom, kv in paths.items():
            fh.write(f"{dom} = " + repr({k: os.path.join(tmp, f"{name}_{v}")
                                         for k, v in kv.items()}) + "\n")
    counts_path = os.path.join(tmp, f"{name}_counts.json")
    hb_path = os.path.join(tmp, f"{name}_stage_heartbeat.json")
    env = dict(os.environ, SMOKE_COUNTS=counts_path,
               TPULSAR_STAGE_HEARTBEAT=hb_path,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    return dict(spool=spool, counts=counts_path, hb=hb_path, env=env,
                log=os.path.join(tmp, f"{name}.log"), name=name, cfg=cfg,
                cmd=[sys.executable, "-c", SERVE_WRAPPER, "--config", cfg,
                     "serve", "--once", "--spool", spool])


def server_counts(srv: dict, rc: int) -> dict:
    """Print a finished server's notable log lines; raise unless it
    exited 0; return the wrapper's counts."""
    with open(srv["log"]) as fh:
        text = fh.read()
    for line in text.splitlines():
        if re.search(r"serve: |boot took|gate: |ticket .* -> |"
                     r"stage-in failed|server stopped|\[batch\]|Error|"
                     r"Traceback", line):
            log(f"  {srv['name']}: {line[:300]}")
    if rc != 0:
        raise AssertionError(f"{srv['name']}: the server exited {rc}:\n"
                             f"{text[-4000:]}")
    with open(srv["counts"]) as fh:
        return json.load(fh)


def check_journal(spool: str, tid: str, want: list[str], what: str
                  ) -> list[str]:
    """A ticket's journal chain is well formed and holds the events of
    `want` in that order; returns its events, repeats folded."""
    from tpulsar_torch.obs import journal

    evs = journal.read_events(spool, ticket=tid)
    names = [e["event"] for e in evs]
    problems = journal.validate_chain(evs)
    if problems or [n for n in names if n in want] != want:
        raise AssertionError(f"{what}: {tid}'s journal chain {names}: "
                             f"{problems}")
    return [f"{n} x{names.count(n)}" if names.count(n) > 1 else n
            for i, n in enumerate(names) if n not in names[:i]]


def stagein_seconds(spool: str, tid: str):
    from tpulsar_torch.obs import journal

    return next((e.get("seconds") for e in journal.read_events(
        spool, ticket=tid) if e["event"] == "stagein_done"), None)


#: the bearer token of the smoke's gateways (phases 6 and 8)
GATEWAY_TOKEN = "chip-smoke"


def start_gateway(srv: dict, queue_url: str, *args) -> tuple:
    """`python -m tpulsar_torch gateway --queue QUEUE_URL --port 0`
    in a subprocess with srv's configuration and a bearer token; its
    output goes to a log file, from which its URL is read.  Returns
    (process, url, log path)."""
    log_path = os.path.join(os.path.dirname(srv["log"]),
                            f"{srv['name']}_gateway.log")
    fh = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpulsar_torch", "--config", srv["cfg"],
         "gateway", "--queue", queue_url, "--port", "0", *args],
        env=dict(srv["env"], TPULSAR_GATEWAY_TOKEN=GATEWAY_TOKEN),
        stdout=fh, stderr=subprocess.STDOUT)
    fh.close()
    deadline = time.time() + 120
    while True:
        with open(log_path) as lf:
            m = re.search(r"^gateway: (http://\S+) ", lf.read(), re.M)
        if m:
            return proc, m.group(1), log_path
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            with open(log_path) as lf:
                raise AssertionError(f"{srv['name']}: the gateway did not "
                                     f"start:\n{lf.read()[-4000:]}")
        time.sleep(0.1)


def stop_gateway(proc, log_path: str, what: str) -> None:
    """SIGTERM a gateway; it must stop with exit 0."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        with open(log_path) as fh:
            raise AssertionError(f"{what}: the gateway exited "
                                 f"{proc.returncode}:\n{fh.read()[-4000:]}")


def http(method: str, url: str, data: bytes | None = None,
         token: str = GATEWAY_TOKEN) -> tuple[int, dict]:
    """One gateway request with the bearer token: (status, JSON
    body); an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Authorization": f"Bearer {token}"} if token else {})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def serve_phase(fns: list[str], tmp: str, ref: dict) -> dict:
    """Phase 6, on phase 7's beam (`fns`), held against its solo
    search (`ref`, main_path_phase's record): the front door and the
    blob data plane.  A token'd
    gateway (`python -m tpulsar_torch gateway`) on a sqlite queue with
    a CAS; the beam uploaded by `python -m tpulsar_torch blob put`;
    the resident server (`serve --queue sqlite:...`, TPULSAR_DATA_URL
    at the gateway) started, and once it advertises capacity the beam
    submitted by digest (client.submit_beam with blobs=) and a
    poisoned ticket by path; both answered over HTTP, then the server
    drained by SIGTERM."""
    from tpulsar_torch.dataplane import index as dp_index
    from tpulsar_torch.frontdoor import client
    from tpulsar_torch.frontdoor import queue as fq

    du = shutil.disk_usage(tmp)
    log(f"phase 6: disk {du.free / 1e9:.1f} GB free of "
        f"{du.total / 1e9:.1f} GB before the blob path (the beam is "
        f"{os.path.getsize(fns[0]) / 1e9:.3f} GB; the CAS and the "
        f"workspace each take a copy)")
    srv = server_setup(tmp, "serve")
    gwdir = os.path.join(tmp, "serve_gateway")
    os.makedirs(gwdir)
    db, cas = os.path.join(gwdir, "queue.db"), os.path.join(gwdir, "cas")
    queue_url = f"sqlite:{db}"
    outs = {t: os.path.join(tmp, f"served_{t}") for t in ("t0", "t2")}
    poison = os.path.join(tmp, "poison", os.path.basename(fns[0]))
    os.makedirs(os.path.dirname(poison))
    with open(fns[0], "rb") as src, open(poison, "wb") as dst:
        dst.write(src.read(1500))         # FITS headers are 2880 bytes
    os.environ["TPULSAR_GATEWAY_TOKEN"] = GATEWAY_TOKEN
    gw, url, gw_log = start_gateway(srv, queue_url, "--blob-root", cas)
    proc = None
    try:
        log(f"phase 6: gateway {url} on {queue_url}, CAS {cas}")
        t0 = time.time()
        ckpt.sha256_file(fns[0])
        hash_s = time.time() - t0
        t0 = time.time()
        put = subprocess.run(
            [sys.executable, "-m", "tpulsar_torch", "--config",
             srv["cfg"], "blob", "put", fns[0], "--url", url,
             "--token", GATEWAY_TOKEN],
            env=srv["env"], capture_output=True, text=True, timeout=900)
        put_s = time.time() - t0
        if put.returncode != 0:
            raise AssertionError(f"phase 6: blob put exited "
                                 f"{put.returncode}: {put.stderr[-2000:]}")
        digest = put.stdout.split()[0]
        name = os.path.basename(fns[0])
        log(f"phase 6: blob put {name} -> {digest[:16]}.. in {put_s:.3f} s "
            f"({os.path.getsize(fns[0]) / 1e9 / put_s:.3f} GB/s: client "
            f"hash, localhost stream, gateway re-hash)")

        torch.cuda.empty_cache()
        env = dict(srv["env"], TPULSAR_DATA_URL=url,
                   TPULSAR_GATEWAY_TOKEN=GATEWAY_TOKEN)
        t_start = time.time()
        with open(srv["log"], "w") as logf:
            # not --once: the gateway admits a beam only while a
            # worker advertises capacity (it load-sheds otherwise)
            proc = subprocess.Popen(
                [c for c in srv["cmd"] if c != "--once"]
                + ["--queue", queue_url],
                env=env, stdout=logf, stderr=subprocess.STDOUT)
        deadline = time.time() + 300
        while client.capacity(url)["capacity"] <= 0:
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError(
                    f"phase 6: the server never advertised capacity "
                    f"(exit {proc.poll()})")
            time.sleep(0.2)
        t_ready = time.time() - t_start
        tids = {
            "t0": client.submit_beam(url, [name], outdir=outs["t0"],
                                     blobs={name: digest},
                                     job_id=0)["ticket"],
            "t2": client.submit_beam(url, [poison], outdir=outs["t2"],
                                     job_id=2)["ticket"]}
        recs = {t: client.wait_for_result(url, tid, timeout_s=900,
                                          poll_s=1.0)
                for t, tid in tids.items()}
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        wall = time.time() - t_start
        counts = server_counts(srv, rc)
        with open(srv["log"]) as fh:
            boot_log = fh.read()
        if "gate: manifest verify: 2/2 hits, 0 misses" not in boot_log:
            raise AssertionError("phase 6: the server's boot did not "
                                 "verify both libraries against the "
                                 "manifest with 0 misses")
        r = recs["t0"]
        if r["status"] != "done":
            raise AssertionError(f"phase 6: t0 not done: {r}")
        if not r["warm"] or r["compile_misses"] != 0:
            raise AssertionError(f"phase 6: t0 paid a compile: {r}")
        bad = recs["t2"]
        if bad["status"] != "failed" \
                or "stage-in failed" not in bad["error"]:
            raise AssertionError(f"phase 6: the poisoned ticket: {bad}")
        q = fq.get_ticket_queue(queue_url)
        hb = q.read_heartbeat("")
        if hb["status"] != "stopped" or hb["beams"] != {
                "done": 1, "failed": 1, "skipped": 0}:
            raise AssertionError(f"phase 6: final heartbeat {hb}")
        chains = {
            "t0": check_journal(gwdir, tids["t0"], [
                "received", "submitted", "claimed", "stagein_done",
                "search_start", "artifact_push", "result"], "phase 6"),
            "t2": check_journal(gwdir, tids["t2"], [
                "received", "claimed", "stagein_failed", "result"],
                "phase 6")}
        problems = results_diff().diff_results(outs["t0"],
                                               ref["resultsdir"])
        if problems:
            raise AssertionError("phase 6: t0's results differ from the "
                                 "solo search's: "
                                 + "; ".join(problems[:10]))
        log(f"phase 6: t0's results directory equals the solo search's "
            f"({len(os.listdir(outs['t0']))} files)")
        check_pulsar(outs["t0"], ref["basenm"], "phase 6 t0")
        stages = report_stages(os.path.join(outs["t0"],
                                            f"{ref['basenm']}.report"))
        idx = dp_index.CandidateIndex(dp_index.index_path(gwdir))
        rows = idx.candidate_rows(tids["t0"])
        if not rows or rows != dp_index.candidate_rows(outs["t0"]):
            raise AssertionError("phase 6: t0's index rows do not match "
                                 "its .accelcands")
        if idx.tickets() != [tids["t0"]]:
            raise AssertionError(f"phase 6: index tickets {idx.tickets()}")
        cands = client.query_candidates(url, ticket=tids["t0"], limit=200)
        hits = [c for c in cands["candidates"]
                if abs(c["period_s"] - PSR_PERIOD) / PSR_PERIOD < 1e-3
                and abs(c["dm"] - PSR_DM) < 5.0]
        if cands["source"] != "index" or not hits or cands["total"] != \
                sum(row["sigma"] >= 0.0 for row in rows):
            head = {k: v for k, v in cands.items() if k != "candidates"}
            raise AssertionError(f"phase 6: /v1/candidates {head}, "
                                 f"{len(hits)} rows of the pulsar")
        arts = r.get("artifacts") or {}
        if sorted(arts) != sorted(n for n in os.listdir(outs["t0"])
                                  if n.endswith(".accelcands")):
            raise AssertionError(f"phase 6: artifacts {arts}")
        for aname, adigest in arts.items():
            dest = os.path.join(tmp, f"fetched_{aname}")
            got = subprocess.run(
                [sys.executable, "-m", "tpulsar_torch", "--config",
                 srv["cfg"], "blob", "get", adigest, "--url", url,
                 "--out", dest], env=srv["env"], capture_output=True,
                text=True, timeout=120)
            with open(dest, "rb") as fa, \
                    open(os.path.join(outs["t0"], aname), "rb") as fb:
                same = fa.read() == fb.read()
            if got.returncode != 0 or not same:
                raise AssertionError(f"phase 6: blob get {aname}: rc "
                                     f"{got.returncode}, identical {same}")
        served = counts["served"]
        if served != ref["launches"]:
            raise AssertionError(f"phase 6: served launches {served} != "
                                 f"the solo search's {ref['launches']}")
        stagein = stagein_seconds(gwdir, tids["t0"])
        log(f"phase 6: /v1/candidates from the index ({cands['total']} "
            f"rows, {len(hits)} of the pulsar, best sigma "
            f"{max(c['sigma'] for c in hits):.2f}); {len(arts)} artifact(s) "
            f"fetched by digest byte-identical to the outdir's")
        log(f"phase 6: blob put {put_s:.3f} s; stage-in t0 {stagein} s "
            f"(by digest over HTTP, verified, then staged); beam_seconds "
            f"t0 {r['beam_seconds']:.3f} s (the solo search_beam "
            f"{ref['wall_s']:.3f} s, served / solo "
            f"{r['beam_seconds'] / ref['wall_s']:.4f}); t2 "
            f"{bad['beam_seconds']:.3f} s; boot "
            f"{counts['boot_seconds']:.3f} s (boot launches "
            f"{counts['boot']}), capacity advertised {t_ready:.1f} s after "
            f"start; peak device memory after boot "
            f"{counts['peak_bytes'] / 2**30:.3f} GiB; server process "
            f"{wall:.3f} s")
        log(f"phase 6: served launches {served} (the solo search's); "
            f"journal chains "
            f"{json.dumps(chains)}")
        with open(srv["hb"]) as fh:
            log(f"phase 6: the stage heartbeat's last record: "
                f"{fh.read().strip()}")
        log("phase 6 stage seconds (the beam's .report), t0 / solo: "
            + json.dumps({k: [v, round(ref["stages"].get(k, 0.0), 2)]
                          for k, v in stages.items()}))
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        stop_gateway(gw, gw_log, "phase 6")
        os.environ.pop("TPULSAR_GATEWAY_TOKEN", None)
        # the CAS's and the workspace's copies of the beam
        shutil.rmtree(cas, ignore_errors=True)
        shutil.rmtree(os.path.join(tmp, "serve_work"), ignore_errors=True)
    # the gateway's side of the upload: its registry, exported on exit
    with open(os.path.join(tmp, "serve_logs", "metrics",
                           "gateway.prom")) as fh:
        m = re.search(r'^tpulsar_dataplane_transfer_seconds_sum'
                      r'\{op="put"\} (\S+)', fh.read(), re.M)
    ingest_s = float(m.group(1)) if m else float("nan")
    log(f"phase 6: the blob put's {put_s:.3f} s: the file's sha256 alone "
        f"{hash_s:.3f} s in this process (page cache warm); the gateway's "
        f"put_stream (receive, hash, write, fsync, re-hash off disk) "
        f"{ingest_s:.3f} s, the beam and the artifact")
    return dict(launches=served, boot=counts["boot"],
                boot_s=counts["boot_seconds"], wall_s=wall,
                beam_s={t: recs[t]["beam_seconds"] for t in outs},
                stagein_s=stagein, put_s=put_s, hash_s=hash_s,
                ingest_s=ingest_s, stages=stages,
                peak_bytes=counts["peak_bytes"])



def write_beam(outdir: str, nsamp: int) -> list[str]:
    """The smoke's synthesized Mock beam of nsamp samples (one pulsar),
    written on the card in slabs; logs its size and seconds."""
    t0 = time.time()
    fns = synth.synth_beam_slabs(
        outdir, mock_spec(nsamp),
        pulsars=[synth.PulsarSpec(period_s=PSR_PERIOD, dm=PSR_DM,
                                  width_frac=0.1, snr_per_sample=0.1)],
        device=DEV)
    log(f"wrote {os.path.basename(fns[0])}: {NCHAN} ch x {nsamp} "
        f"samples, 4-bit, {os.path.getsize(fns[0]) / 1e9:.3f} GB in "
        f"{time.time() - t0:.1f} s")
    return fns


def batch_start(tmp: str, plan) -> dict:
    """Phase 7's start: a beam of BATCH_NSAMP samples, its solo
    search_beam (with a checkpoint directory), then `serve --once
    --batch 2` started on two tickets for it (start_server);
    batch_finish waits for the server and holds its group against the
    solo search."""
    nsamp = BATCH_NSAMP
    qtmp = os.path.join(tmp, "batch")
    log(f"phase 7: a beam of {nsamp} samples (NSAMP / 4; channels, "
        f"nsub and plan unchanged)")
    fns = write_beam(os.path.join(qtmp, "beam"), nsamp)
    solo = main_path_phase(fns, qtmp, nsamp, plan, what="phase 7 solo")
    outs = {t: os.path.join(qtmp, f"batch_{t}") for t in ("b0", "b1")}
    server = start_server(qtmp, "batch",
                          {t: (fns, o) for t, o in outs.items()},
                          args=("--batch", "2"))
    return dict(nsamp=nsamp, fns=fns, solo=solo, outs=outs,
                server=server)


def batch_finish(p7: dict, plan) -> dict:
    """Phase 7: `serve --once --batch 2` (batch_start's server) answers
    the two tickets as one coalesced group in a subprocess on the
    card, held against the solo search_beam of the same beam."""
    from tpulsar_torch.obs import journal

    nsamp, fns, solo, outs = p7["nsamp"], p7["fns"], p7["solo"], p7["outs"]
    run = finish_server(p7["server"])
    spool, recs, counts = run["spool"], run["recs"], run["counts"]
    for t, r in recs.items():
        if r is None or r["status"] != "done":
            raise AssertionError(f"phase 7: {t} not done: {r}")
        if r.get("batch_path") != "batched" or r.get("batch_beams") != 2:
            raise AssertionError(f"phase 7: {t} was not searched in a "
                                 f"group of 2: {r}")
        if not r["warm"] or r["compile_misses"] != 0:
            raise AssertionError(f"phase 7: {t} paid a compile: {r}")
    dispatches = [e for e in journal.read_events(spool)
                  if e["event"] == "batch_dispatch"]
    if len(dispatches) != 1 or dispatches[0]["beams"] != 2 or \
            sorted(dispatches[0]["tickets"]) != ["b0", "b1"]:
        raise AssertionError(f"phase 7: batch_dispatch events "
                             f"{dispatches}")
    chains = {t: check_journal(spool, t, ["claimed", "search_start",
                                          "result"], "phase 7")
              for t in outs}
    diff = results_diff().diff_results
    solo_ck = ckpt.read_manifest(solo["ckdir"])["entries"]
    for t, out in outs.items():
        problems = diff(out, solo["resultsdir"])
        if problems:
            raise AssertionError(f"phase 7: {t}'s results differ from "
                                 f"the solo search's: "
                                 + "; ".join(problems[:10]))
        kept = ckpt.read_manifest(out + ".checkpoint")
        entries = kept["entries"] if kept else {}
        if {k: e["sha256"] for k, e in entries.items()} != \
                {k: e["sha256"] for k, e in solo_ck.items()}:
            raise AssertionError(
                f"phase 7: {t}'s checkpoint artifacts differ from the "
                f"solo search's: " + ", ".join(sorted(
                    k for k in set(entries) | set(solo_ck)
                    if entries.get(k, {}).get("sha256")
                    != solo_ck.get(k, {}).get("sha256")))[:500])
        check_pulsar(out, solo["basenm"], f"phase 7 {t}")
    npass = sum(1 for _ in _passes(plan))
    s1, s2 = (sum(n.values()) for n in plan_shapes(plan, nsamp, PARAMS))
    nref = solo["n2"].get((1, 1), 0) - plan_shapes(plan, nsamp, PARAMS)[1] \
        .get((1, 1), 0)
    per_beam1 = sum(solo["n1"].values()) - s1       # refinement + folds
    want = {"form_subbands": s1 + 2 * per_beam1,
            "dedisperse_subbands": 2 * nref,
            "dedisperse_subbands_beams": s2,
            "accel_stage": 2 * solo["launches"]["accel_stage"]}
    served = counts["served"]
    log(f"phase 7 launches: {served} (expected form_subbands "
        f"{want['form_subbands']} = {s1} coalesced passes ({npass} in the "
        f"plan) + 2 x {per_beam1} refinement and fold passes; "
        f"dedisperse_subbands {want['dedisperse_subbands']} = 2 x {nref} "
        f"refinement rows; dedisperse_subbands_beams "
        f"{want['dedisperse_subbands_beams']} = {s2} search chunks; "
        f"accel_stage {want['accel_stage']} = each beam's hi stage as "
        f"in its solo search)")
    if served != want:
        raise AssertionError(f"phase 7: launch counts {served} != "
                             f"expected {want}")
    log(f"phase 7: b0's and b1's results directories and checkpoint "
        f"artifacts ({len(solo_ck)}) equal the solo search's; journal "
        f"chains {json.dumps(chains)}")
    beam_s = {t: recs[t]["beam_seconds"] for t in outs}
    log(f"phase 7: boot {counts['boot_seconds']:.3f} s; beam_seconds b0 "
        f"{beam_s['b0']:.3f} s, b1 {beam_s['b1']:.3f} s (solo "
        f"search_beam {solo['wall_s']:.3f} s); stage-in b0 "
        f"{stagein_seconds(spool, 'b0')} s, b1 "
        f"{stagein_seconds(spool, 'b1')} s; peak device memory after boot "
        f"{counts['peak_bytes'] / 2**30:.3f} GiB; server process "
        f"{run['wall_s']:.3f} s")
    stages = report_stages(os.path.join(outs["b0"],
                                        f"{solo['basenm']}.report"))
    log("phase 7 stage seconds (b0's .report: the group's plan loop, "
        "then b0's own finish), b0 / solo: "
        + json.dumps({k: [v, round(solo["stages"].get(k, 0.0), 2)]
                      for k, v in stages.items()}))
    return dict(launches=served, want=want, beam_s=beam_s,
                wall_s=run["wall_s"], boot_s=counts["boot_seconds"],
                peak_bytes=counts["peak_bytes"], stages=stages,
                nsamp=nsamp, solo_wall_s=solo["wall_s"], fns=fns,
                solo=solo)


def _search_launches(plan, nsamp: int, first: int) -> dict:
    """The stage-1 and stage-2 launches of the search passes before
    `first` (what a resume from a checkpoint holding passes
    0..first-1 does not make)."""
    a1, a2 = plan_shapes(plan, nsamp, PARAMS)
    f1, f2 = plan_shapes(plan, nsamp, PARAMS, first)
    return {"form_subbands": sum(a1.values()) - sum(f1.values()),
            "dedisperse_subbands": sum(a2.values()) - sum(f2.values())}


class DeviceMemoryPeak:
    """The card's memory in use by every process (total minus free,
    torch.cuda.mem_get_info), sampled every 0.25 s while active."""

    def __enter__(self):
        self.peak, self._stop = 0, threading.Event()

        def sample():
            while not self._stop.is_set():
                free, total = torch.cuda.mem_get_info()
                self.peak = max(self.peak, total - free)
                self._stop.wait(0.25)
        self._th = threading.Thread(target=sample, daemon=True)
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()


#: phase 11's storm: the JAX package's serve worker kind, two workers
#: on a sqlite queue in the spool behind the gateway, a tenant cap,
#: one beam (phase 7's; cut from three, then two, to keep the smoke
#: inside its time limit: w0 claims it and is killed mid-beam, so it is
#: the takeover's victim), and the timeline's four failures.
#: duration_s and quiesce_timeout_s leave room for the beam on two
#: workers and w0's restart
CHAOS_SCENARIO = {
    "name": "serve-storm", "seed": 11, "duration_s": 600.0,
    "workers": 2, "worker_kind": "serve", "gateway": True,
    "queue_url": "sqlite", "max_attempts": 3,
    "tenants": {"survey": {"max_inflight": 3}},
    "workload": {"beams": 1, "via": "gateway", "tenant": "survey",
                 "interval_s": 0.25},
    "timeline": [
        {"t": 2.0, "action": "set_faults", "worker": "w1", "until": 40.0,
         "faults": "spool.io:unimplemented:count=2,errno=ENOSPC"},
        {"t": 8.0, "action": "restart_gateway"},
        {"t": 20.0, "action": "kill_worker", "worker": "w0",
         "signal": "KILL"},
        {"t": 30.0, "action": "pause_janitor", "seconds": 1.0}],
    "quiesce_timeout_s": 540.0}


def _pass_launches(plan, nsamp: int, passes) -> dict:
    """The stage-1 and stage-2 launches of the given search passes."""
    out = {"form_subbands": 0, "dedisperse_subbands": 0}
    for p in passes:
        a = _search_launches(plan, nsamp, p + 1)
        b = _search_launches(plan, nsamp, p)
        for k in out:
            out[k] += a[k] - b[k]
    return out


def fleet_cli(srv: dict, *args) -> tuple[subprocess.CompletedProcess,
                                          float]:
    """`python -m tpulsar_torch --config <phase 11's> ARGS` in a
    subprocess, and its seconds."""
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "tpulsar_torch", "--config", srv["cfg"],
         *args], env=srv["env"], capture_output=True, text=True,
        timeout=300)
    return res, time.time() - t0


def fleet_checks(srv: dict, spool: str, queue_url: str, t_kill: float,
                 beams: int, probe) -> dict:
    """The fleet's own records and its hosted health doctor after phase
    11's storm (these were phase 10's checks, folded into the storm):
    fleet.json (stopped, every beam done, w0 restarted after its
    SIGKILL, whose worker_exit says rc -9), fleet.prom (the beam_e2e
    SLO from 2 workers, the active takeover_rate alert), the doctor's
    alert_fired event and alerts.json, GET /v1/alerts through a
    token'd gateway, `doctor --queue` (exit 1, naming the rule),
    `fleet --status` and the node probe `doctor` (its device probe
    ok; `probe` is the future of its fleet_cli call, which reads
    nothing of the storm and runs beside it).  Returns the alert's
    latency after the kill and the CLI calls' seconds."""
    from tpulsar_torch.fleet import controller as fleet_ctl
    from tpulsar_torch.obs import health, journal

    with open(os.path.join(spool, fleet_ctl.FLEET_JSON)) as fh:
        fleet = json.load(fh)
    fw = {w["id"]: w for w in fleet["workers"]}
    exits = [e for e in journal.read_events(spool)
             if e["event"] == "worker_exit" and e.get("worker") == "w0"]
    if fleet["status"] != "stopped" or fleet["done"] != beams or \
            fw["w0"]["crash_restarts"] < 1 or fw["w0"]["gave_up"] or \
            -signal.SIGKILL not in [e.get("rc") for e in exits]:
        raise AssertionError(f"phase 11: fleet.json {fleet}; w0's exits "
                             f"{exits}")
    with open(os.path.join(spool, fleet_ctl.FLEET_PROM)) as fh:
        prom = fh.read()
    for line in ('tpulsar_fleet_slo_seconds{series="beam_e2e",'
                 'quantile="p95"}',
                 'tpulsar_fleet_slo_source_workers{series="beam_e2e"} 2',
                 'tpulsar_alerts_active{rule="takeover_rate",'
                 'severity="warn"} 1'):
        if line not in prom:
            raise AssertionError(f"phase 11: fleet.prom lacks {line!r}")
    e2e = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'tpulsar_fleet_slo_seconds\{series="beam_e2e",quantile="(p\d+)"\}'
        r' (\S+)', prom)}

    fired = [e for e in journal.read_events(spool)
             if e["event"] == "alert_fired"]
    doc = health.read_active_alerts(spool) or {}
    active = {a["rule"] for a in doc.get("alerts", [])}
    if "takeover_rate" not in {e["rule"] for e in fired} or \
            "takeover_rate" not in active:
        raise AssertionError(f"phase 11: the doctor fired "
                             f"{[e['rule'] for e in fired]}, "
                             f"alerts.json {sorted(active)}")
    t_alert = next(e["t"] for e in fired if e["rule"] == "takeover_rate")
    gw, url, gw_log = start_gateway(srv, queue_url)
    try:
        code, body = http("GET", url + "/v1/alerts")
    finally:
        stop_gateway(gw, gw_log, "phase 11")
    if code != 200 or body.get("doctor") != "ok" or "takeover_rate" not in \
            {a["rule"] for a in body.get("alerts", [])}:
        raise AssertionError(f"phase 11: GET /v1/alerts {code} {body}")

    res, doctor_s = fleet_cli(srv, "doctor", "--queue", queue_url)
    if res.returncode != 1 or "takeover_rate" not in res.stdout:
        raise AssertionError(f"phase 11: doctor --queue exited "
                             f"{res.returncode}: {res.stdout[-2000:]}"
                             f"{res.stderr[-2000:]}")
    res, status_s = fleet_cli(srv, "fleet", "--status", "--spool", spool,
                              "--queue", queue_url)
    if res.returncode != 0 or " stopped (fleet.json" not in res.stdout:
        raise AssertionError(f"phase 11: fleet --status exited "
                             f"{res.returncode}: {res.stdout[-2000:]}")
    for line in res.stdout.strip().splitlines():
        log(f"  fleet --status: {line}")
    res, probe_s = probe.result()
    probe = next((ln for ln in res.stdout.splitlines()
                  if "device probe" in ln), "")
    if "[ok] device probe" not in probe:
        raise AssertionError(f"phase 11: the node probe's device probe: "
                             f"{res.stdout[-3000:]}{res.stderr[-2000:]}")
    log(f"phase 11: takeover_rate fired {t_alert - t_kill:.3f} s after the "
        f"kill; beam_e2e {e2e}; doctor --queue {doctor_s:.3f} s, fleet "
        f"--status {status_s:.3f} s, doctor (node probe) {probe_s:.3f} s: "
        f"{probe.strip()}; its verdict: "
        f"{res.stdout.strip().splitlines()[-1]}")
    return dict(alert_s=t_alert - t_kill, e2e=e2e, doctor_s=doctor_s,
                status_s=status_s, probe_s=probe_s)


def chaos_phase(tmp: str, plan, p7: dict) -> dict:
    """Phase 11: a conducted storm of the port's chaos harness with
    worker_kind "serve" on phase 7's beam (CHAOS_SCENARIO, built with
    scenario.from_dict and used as is): ChaosRunner in this process
    runs a FleetController with two `python -m tpulsar_torch serve`
    workers on the card (its own command line, through SERVE_WRAPPER,
    which turns plots off and counts launches after boot), the
    gateway in process on a sqlite queue inside the spool, two
    tickets submitted through it, a spool.io window on w1, a gateway
    restart, w0 SIGKILLed at 20 s and a janitor pause.  w1 is held
    after its boot until w0 has claimed a ticket, so w0 holds one at
    the kill (a worker's prefetch may claim more than one).  It checks
    the manifest's quiescence, the port's verifier (no violation),
    `chaos verify` as a subprocess (exit 0), `chaos report` (the
    kill's MTTR), each ticket done once with a valid chain, a takeover
    of w0's claim and the resume of the beam w0 was searching from its
    checkpoint, every results directory equal to phase 7's solo search
    and folding the pulsar, tpulsar_chaos_actions_total and the
    schedule file, and the surviving workers' launches: each beam's
    whole count less the passes its finishing attempt resumed.  Then
    the packaged ci_smoke scenario (stub workers, no card) through
    `chaos run` and `chaos verify` as subprocesses."""
    from tpulsar_torch.chaos import invariants
    from tpulsar_torch.chaos import runner as chaos_runner
    from tpulsar_torch.chaos import scenario
    from tpulsar_torch.frontdoor import queue as fq
    from tpulsar_torch.obs import journal

    nsamp, fns, solo = p7["nsamp"], p7["fns"], p7["solo"]
    srv = server_setup(tmp, "chaos")
    spool = srv["spool"]
    wids = ("w0", "w1")
    counts = {w: os.path.join(tmp, f"chaos_{w}_counts.json") for w in wids}
    hold = os.path.join(tmp, "chaos_go_w1")
    doc = json.loads(json.dumps(CHAOS_SCENARIO))
    doc["workload"]["datafiles"] = list(fns)
    sc = scenario.from_dict(doc)
    log(f"phase 11: scenario {sc.name!r} ({sc.workers} {sc.worker_kind} "
        f"workers, {sc.workload.beams} beams via {sc.workload.via}, "
        f"duration_s {sc.duration_s:g}, quiesce_timeout_s "
        f"{sc.quiesce_timeout_s:g}): "
        + ", ".join(f"t={a.t:g} {a.action} {a.worker or ''}".strip()
                    for a in sc.timeline))

    class SmokeRunner(chaos_runner.ChaosRunner):
        def _worker_cmd(self, wid):
            argv = super()._worker_cmd(wid)
            i = argv.index("-m")
            if argv[i + 1] != "tpulsar_torch":
                raise AssertionError(f"phase 11: worker command {argv}")
            return [sys.executable, "-c", SERVE_WRAPPER] + argv[i + 2:]

        def _worker_env(self, wid):
            env = dict(super()._worker_env(wid), SMOKE_COUNTS=counts[wid],
                       PYTHONPATH=srv["env"]["PYTHONPATH"],
                       TPULSAR_STAGE_HEARTBEAT=f"{srv['hb']}.{wid}")
            if wid == "w1":
                env["SMOKE_HOLD"] = hold
            return env

    jpath = journal.journal_path(spool)
    done = threading.Event()

    def release_w1():
        while not done.is_set():
            if os.path.exists(jpath) and any(
                    e["event"] == "claimed" and e.get("worker") == "w0"
                    for e in journal.read_events(spool)):
                break
            done.wait(0.05)
        open(hold, "w").close()

    actions = telemetry.chaos_actions_total()
    before = {a: actions.value(action=a) for a in
              ("kill_worker", "restart_gateway", "pause_janitor")}
    old_cfg = os.environ.get("TPULSAR_CONFIG")
    os.environ["TPULSAR_CONFIG"] = srv["cfg"]
    torch.cuda.empty_cache()
    r = SmokeRunner(sc, spool)
    log(f"phase 11: worker command {r._worker_cmd('w0')[3:]}")
    t_phase = time.time()
    releaser = threading.Thread(target=release_w1, daemon=True)
    releaser.start()
    # the node probe `doctor` reads nothing of the storm: it runs beside
    # it, and fleet_checks reads its result
    pool = concurrent.futures.ThreadPoolExecutor(1)
    probe = pool.submit(fleet_cli, srv, "doctor")
    pool.shutdown(wait=False)
    try:
        with DeviceMemoryPeak() as mem:
            manifest = r.run()
    finally:
        done.set()
        releaser.join()
        if old_cfg is None:
            os.environ.pop("TPULSAR_CONFIG", None)
        else:
            os.environ["TPULSAR_CONFIG"] = old_cfg
        for w in (r._ctrl.workers if r._ctrl is not None else ()):
            if w.alive:
                w.proc.kill()
                w.proc.wait()
    phase_wall = time.time() - t_phase
    boots = {}
    for w in wids:
        with open(os.path.join(spool, "workers", f"{w}.log"),
                  errors="replace") as fh:
            text = fh.read()
        boots[w] = [float(x) for x in re.findall(r"boot took ([\d.]+) s",
                                                 text)]
        for line in text.splitlines():
            if re.search(r"Traceback|Error", line):
                log(f"  chaos {w}: {line[:300]}")
    if manifest["status"] != "quiesced" or not manifest["quiesced"]:
        raise AssertionError(f"phase 11: the storm did not quiesce: "
                             f"{manifest['status']}")
    queue_url = manifest["queue_url"]
    q = fq.get_ticket_queue(queue_url)
    tickets = manifest["tickets"]
    if len(tickets) != sc.workload.beams:
        raise AssertionError(f"phase 11: tickets {tickets}")

    # the verifier, in process and as the CLI
    report = invariants.verify(queue_url, tenants=sc.tenants,
                               max_attempts=sc.max_attempts)
    if not report["ok"] or any(report["invariants"].values()):
        raise AssertionError("phase 11: the verifier: "
                             + invariants.render_verify(report))

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "tpulsar_torch", *args],
            env=srv["env"], capture_output=True, text=True, timeout=300)
    res = cli("chaos", "verify", "--spool", spool)
    if res.returncode != 0 or "PASS: 0 invariant violations" not in \
            res.stdout:
        raise AssertionError(f"phase 11: chaos verify exited "
                             f"{res.returncode}: {res.stdout[-3000:]}"
                             f"{res.stderr[-2000:]}")
    res = cli("chaos", "report", "--spool", spool)
    m = re.search(r"kill w0: (\d+) victim beam\(s\), takeover latency "
                  r"(\S+) s, mttr ([\d.]+) s", res.stdout)
    if res.returncode != 0 or not m or int(m.group(1)) < 1:
        raise AssertionError(f"phase 11: chaos report exited "
                             f"{res.returncode}: {res.stdout[-3000:]}"
                             f"{res.stderr[-2000:]}")
    for line in res.stdout.splitlines()[:8]:
        log(f"  chaos report: {line}")

    # each ticket done once; w0's claims taken over; its beam resumed
    evs = journal.read_events(spool)
    kill = next(e for e in evs if e["event"] == "chaos_action"
                and e.get("action") == "kill_worker")
    t_kill = kill["t"]
    recs, chains, resumed = {}, {}, {}
    steals = [e for e in evs if e["event"] == "takeover"
              and e.get("from_worker") == "w0"]
    if not steals:
        raise AssertionError("phase 11: no takeover of a claim of w0's")
    fleet = fleet_checks(srv, spool, queue_url, t_kill, len(tickets),
                         probe)
    for t in tickets:
        rec = q.read_result(t)
        chain = [e for e in evs if e.get("ticket") == t]
        names = [e["event"] for e in chain]
        problems = journal.validate_chain(chain)
        if rec is None or rec["status"] != "done" or problems or \
                names.count(journal.TERMINAL_EVENT) != 1:
            raise AssertionError(f"phase 11: {t}: {rec}; chain {names}: "
                                 f"{problems}")
        recs[t] = rec
        chains[t] = [f"{n} x{names.count(n)}" if names.count(n) > 1 else n
                     for i, n in enumerate(names) if n not in names[:i]]
        final = [e for e in chain if e["event"] == "pass_complete"
                 and e.get("worker") == rec["worker"]
                 and e.get("attempt") == rec["attempts"]]
        computed = sorted({e["pass_idx"] for e in final})
        npass = sum(1 for _ in _passes(plan))
        res_ev = [e for e in chain if e["event"] == "resume"
                  and e.get("attempt") == rec["attempts"]]
        kept = sorted(set(range(npass)) - set(computed))
        if (kept and (not res_ev or res_ev[-1]["passes_done"] != len(kept)))\
                or (not kept and res_ev):
            raise AssertionError(f"phase 11: {t} computed passes "
                                 f"{computed}, resume events {res_ev}")
        resumed[t] = kept
        w0_search = [e for e in chain if e["event"] == "pass_complete"
                     and e.get("worker") == "w0" and e["t"] < t_kill]
        if w0_search and not kept:
            raise AssertionError(f"phase 11: {t} was searched by w0 before "
                                 f"the kill and not resumed")
    victims = [t for t in tickets if resumed[t]]
    if not victims:
        raise AssertionError("phase 11: no beam resumed from w0's "
                             "checkpoint")
    t_steal = min(e["t"] for e in steals)
    # the fleet's boot as the storm saw it: spawn -> both fresh
    fresh_s = manifest["t0"] - min(e["t"] for e in evs
                                   if e["event"] == "worker_spawn")
    t_reclaim = min(e["t"] for e in evs if e["event"] == "claimed"
                    and e.get("ticket") in {s["ticket"] for s in steals}
                    and e["t"] > t_steal)

    # the science: every results directory equals phase 7's solo search
    diff = results_diff().diff_results
    for t, rec in recs.items():
        problems = diff(rec["outdir"], solo["resultsdir"])
        if problems:
            raise AssertionError(f"phase 11: {t}'s results differ from "
                                 f"phase 7's solo search's: "
                                 + "; ".join(problems[:10]))
        check_pulsar(rec["outdir"], solo["basenm"], f"phase 11 {t}")
        if os.path.exists(ckpt.default_root(rec["outdir"])):
            raise AssertionError(f"phase 11: {t}'s checkpoint was not "
                                 f"cleaned")

    # the conductor's counters and the schedule file
    got_actions = {a: actions.value(action=a) - before[a] for a in before}
    with open(scenario.schedule_path(spool)) as fh:
        sched = json.load(fh)
    if got_actions != {a: 1 for a in before} or [
            e["faults"] for e in sched["entries"]] != [
            sc.fault_windows()[0].faults]:
        raise AssertionError(f"phase 11: tpulsar_chaos_actions_total "
                             f"{got_actions}, schedule {sched}")

    # the surviving workers' launches (w1 and w0's second incarnation;
    # the killed one writes none): each beam whole, less the passes
    # its finishing attempt resumed
    served = {}
    for w in wids:
        with open(counts[w]) as fh:
            for k, v in json.load(fh)["served"].items():
                served[k] = served.get(k, 0) + v
    whole = {"form_subbands": sum(solo["n1"].values()),
             "dedisperse_subbands": sum(solo["n2"].values())}
    want = {k: 0 for k in whole}
    for t in tickets:
        skip = _pass_launches(plan, nsamp, resumed[t])
        for k in want:
            want[k] += whole[k] - skip[k]
    got = {k: served.get(k, 0) for k in want}
    if got != want or served.get("dedisperse_subbands_beams"):
        raise AssertionError(f"phase 11: the surviving workers' launches "
                             f"{served} != expected {want}")
    log(f"phase 11 launches of the surviving workers after boot: {got} "
        f"(expected {want}: {len(tickets)} whole beams less the passes "
        f"resumed "
        f"{ {t: len(v) for t, v in resumed.items()} })")
    log(f"phase 11: boots {json.dumps(boots)} s (w0 twice: the killed "
        f"incarnation and its restart), both fresh {fresh_s:.3f} s after "
        f"the spawn; tickets "
        + json.dumps({t: {"worker": r["worker"], "attempts": r["attempts"],
                          "beam_seconds": round(r["beam_seconds"], 3)}
                      for t, r in recs.items()})
        + f"; kill -> takeover {t_steal - t_kill:.3f} s, -> re-claim "
        f"{t_reclaim - t_kill:.3f} s; mttr {m.group(3)} s; the storm "
        f"{manifest['wall_s']:.3f} s (the phase {phase_wall:.1f} s); peak "
        f"device memory in use (every process) {mem.peak / 2**30:.3f} GiB; "
        f"tpulsar_chaos_actions_total {got_actions}")
    log(f"phase 11 journal chains: {json.dumps(chains)}")

    # the packaged ci_smoke scenario: stub workers, no card
    ci_spool = os.path.join(tmp, "chaos_ci_spool")
    ci_path = os.path.join(os.path.dirname(scenario.__file__), "scenarios",
                           "ci_smoke.json")
    t0 = time.time()
    res = cli("chaos", "run", "--scenario", ci_path, "--spool", ci_spool)
    ci_run_s = time.time() - t0
    ver = cli("chaos", "verify", "--spool", ci_spool)
    if res.returncode != 0 or ver.returncode != 0 or \
            "PASS: 0 invariant violations" not in ver.stdout:
        raise AssertionError(f"phase 11: ci_smoke: run exited "
                             f"{res.returncode}, verify {ver.returncode}:"
                             f"\n{res.stdout[-2000:]}{res.stderr[-2000:]}"
                             f"\n{ver.stdout[-2000:]}")
    log(f"phase 11: the packaged ci_smoke storm (stub workers) "
        f"{ci_run_s:.1f} s; {ver.stdout.strip().splitlines()[1].strip()}")
    return dict(launches=served, want=want, boots=boots, fresh_s=fresh_s,
                beam_s={t: r["beam_seconds"] for t, r in recs.items()},
                attempts={t: r["attempts"] for t, r in recs.items()},
                takeover_s=t_steal - t_kill, reclaim_s=t_reclaim - t_kill,
                mttr_s=float(m.group(3)), storm_s=manifest["wall_s"],
                phase_s=phase_wall, peak_bytes=mem.peak,
                resumed={t: len(v) for t, v in resumed.items()},
                ci_run_s=ci_run_s, spool=spool, queue_url=queue_url,
                victim=steals[0]["ticket"], **fleet)


#: the per-beam job of phase 9 (its jobpooler.submit_script runs this
#: file): the port's job, `search_job.main()` with its defaults (the
#: card, the configuration of TPULSAR_CONFIG), with plots turned off as
#: phase 4 searches (the card's machine has no matplotlib).  Nothing
#: but a real error may reach stderr (the local backend reads a
#: non-empty stderr file as a failed job), so warnings go to stdout,
#: and stdout goes to a log beside the attempt's record.  At exit,
#: however the job ends (a kill's TERM unwinds it through SystemExit),
#: it writes the attempt's record to $SMOKE_ATTEMPTS/<pid>.json: start
#: and end times, exit code, the kernels' launch counts (from 0 at the
#: process start) and what expected_launches needs of the outcome.
PIPELINE_JOB = r"""
import os, sys, time, warnings
t_start = time.time()
attempts = os.environ["SMOKE_ATTEMPTS"]
log = open(os.path.join(attempts, "%d.log" % os.getpid()), "a")
os.dup2(log.fileno(), 1)
sys.stdout = os.fdopen(1, "w", buffering=1)
warnings.showwarning = lambda m, c, f, l, *a, **k: print(
    warnings.formatwarning(m, c, f, l), end="", file=sys.stdout)
import dataclasses, json
from tpulsar_torch.cli import search_job
from tpulsar_torch.kernels import cuda_dd
from tpulsar_torch.search import executor

from_config = executor.SearchParams.from_config
executor.SearchParams.from_config = classmethod(
    lambda cls, s: dataclasses.replace(from_config(s), make_plots=False))
run_search = search_job.run_search
seen = {}


def recorded(*a, **k):
    t0 = time.time()
    out = run_search(*a, **k)
    seen["run_search_s"] = time.time() - t0
    if out is not None:
        seen["refined_dms"] = [float(d) for d in out.refined_dms]
        seen["fold_dms"] = [float(c.dm) for c in
                            out.candidates[:len(out.folded)]]
    return out


search_job.run_search = recorded
rc = None
try:
    rc = search_job.main([])
except SystemExit as e:
    rc = e.code
    raise
finally:
    rec = dict(seen, pid=os.getpid(), rc=rc, t_start=t_start,
               t_end=time.time(), launches=dict(cuda_dd.LAUNCHES))
    with open(os.path.join(attempts, "%d.json" % os.getpid()), "w") as fh:
        json.dump(rec, fh)
sys.exit(rc)
"""


def pipeline_setup(tmp: str) -> dict:
    """Phase 9's configuration (python; the card's machine may have no
    YAML parser): every path under tmp, the local queue backend with
    one job at a time, two attempts, PIPELINE_JOB as the submit script;
    its environment, and the CLI as a command."""
    root = os.path.join(tmp, "pipe")
    attempts = os.path.join(root, "attempts")
    os.makedirs(attempts)
    job_py = os.path.join(root, "job.py")
    with open(job_py, "w") as fh:
        fh.write(PIPELINE_JOB)
    script = os.path.join(root, "job.sh")
    with open(script, "w") as fh:
        fh.write(f"#!/bin/sh\nexec {sys.executable} {job_py}\n")
    os.chmod(script, 0o755)
    cfg = os.path.join(root, "cfg.py")
    doms = {"processing": {"base_working_directory": f"{root}/work",
                           "base_results_directory": f"{root}/res"},
            "basic": {"log_dir": f"{root}/logs"},
            # the disk budget is the phase's business, not the card
            # machine's free space: no floor under it
            "download": {"datadir": f"{root}/raw", "min_free_space": 0},
            "background": {"jobtracker_db": f"{root}/jt.db"},
            "resultsdb": {"url": f"{root}/results.db"},
            "jobpooler": {"queue_manager": "local",
                          "max_jobs_running": 1, "max_attempts": 2,
                          "submit_script": script}}
    with open(cfg, "w") as fh:
        for dom, kv in doms.items():
            fh.write(f"{dom} = {kv!r}\n")
    env = dict(os.environ, TPULSAR_CONFIG=cfg, SMOKE_ATTEMPTS=attempts,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("TPULSAR_FAULTS", None)
    return dict(root=root, cfg=cfg, env=env, attempts=attempts,
                db=f"{root}/jt.db", results_db=f"{root}/results.db",
                archive=os.path.join(root, "archive"),
                localq=f"{root}/work/.localq")


def pipeline_cli(pipe: dict, *args, timeout: float = 300) -> tuple:
    """`python -m tpulsar_torch ARGS` under phase 9's configuration;
    raises unless it exits 0; returns (stdout, seconds)."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "tpulsar_torch", *args],
                         env=pipe["env"], capture_output=True, text=True,
                         timeout=timeout)
    dt = time.time() - t0
    if res.returncode != 0:
        raise AssertionError(f"phase 9: `{' '.join(args)}` exited "
                             f"{res.returncode}:\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-3000:]}")
    return res.stdout, dt


def _wait_for(pred, what: str, timeout_s: float, poll_s: float = 0.2):
    t0 = time.time()
    while not pred():
        if time.time() - t0 > timeout_s:
            raise AssertionError(f"phase 9: {what} (after {timeout_s} s)")
        time.sleep(poll_s)
    return time.time() - t0


def _group_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _attempt_records(attempts: str) -> list[dict]:
    recs = []
    for name in os.listdir(attempts):
        if name.endswith(".json"):
            with open(os.path.join(attempts, name)) as fh:
                recs.append(json.load(fh))
    return sorted(recs, key=lambda r: r["t_start"])


def _present_passes(ckdir: str) -> list[int]:
    doc = ckpt.read_manifest(ckdir) or {}
    return sorted(int(k[5:]) for k in (doc.get("entries") or {})
                  if k.startswith("pass_"))


def pipeline_phase(tmp: str, plan, p7: dict) -> dict:
    """Phase 9: phase 7's beam through the orchestration daemons, each a
    `python -m tpulsar_torch` subprocess under one configuration:
    `downloader --once` fetches it from a local archive; `jobpool
    --once` makes one job and submits the port's job (PIPELINE_JOB)
    through the local backend; once the job's checkpoint holds passes
    0..K_RESUME-1, `kill-jobs --fail` kills its process group;
    `jobpool --once` retries it into the same output directory, where
    it resumes from the checkpoint; `jobpool --once` marks it
    processed; `uploader --once` writes it to the results DB, and a
    second upload inserts nothing.  Held against phase 7's solo
    search."""
    from tpulsar_torch.io import datafile
    from tpulsar_torch.orchestrate.jobtracker import JobTracker

    fns, nsamp, ref = p7["fns"], p7["nsamp"], p7["solo"]

    pipe = pipeline_setup(tmp)
    du = shutil.disk_usage(tmp)
    log(f"phase 9: disk {du.free / 1e9:.1f} GB free of "
        f"{du.total / 1e9:.1f} GB before the pipeline (the download and "
        f"the job's workspace each take a copy of the "
        f"{os.path.getsize(fns[0]) / 1e9:.3f} GB beam)")
    # the archive: the beam hard-linked into <archive>/pool/ (the local
    # restore service hard-links it again into the request's directory)
    os.makedirs(os.path.join(pipe["archive"], "pool"))
    for fn in fns:
        os.link(fn, os.path.join(pipe["archive"], "pool",
                                 os.path.basename(fn)))
    torch.cuda.empty_cache()
    t_phase = time.time()

    # 1. fetch
    t = JobTracker(pipe["db"])
    iters = []
    for _ in range(5):
        out, dt = pipeline_cli(pipe, "downloader", "--once",
                               "--remote-root", pipe["archive"])
        iters.append(dt)
        if t.count("files", "downloaded") == len(fns):
            break
    if t.count("files", "downloaded") != len(fns):
        raise AssertionError(f"phase 9: not downloaded after "
                             f"{len(iters)} iterations: "
                             f"{[dict(r) for r in t.query('SELECT * FROM files')]}")
    files = t.query("SELECT * FROM files")
    att = t.query("SELECT details FROM download_attempts "
                  "WHERE status='complete'")
    fetch_s = [float(re.search(r"downloaded in ([\d.]+)s",
                               a["details"]).group(1)) for a in att]
    for row in files:
        if os.path.getsize(row["filename"]) != row["size"] or \
                row["size"] != os.path.getsize(fns[0]):
            raise AssertionError(f"phase 9: size of {row['filename']}")
    log(f"phase 9 fetch: {len(iters)} `downloader --once` iterations "
        f"({', '.join(f'{x:.3f}' for x in iters)} s: restore request, "
        f"location and fetch, size check); the "
        f"{files[0]['size'] / 1e9:.3f} GB fetch took "
        f"{', '.join(f'{x:.1f}' for x in fetch_s)} s (the download "
        f"attempt's own clock), size verified")

    # 2. submit
    out, dt = pipeline_cli(pipe, "jobpool", "--once")
    jobs = t.query("SELECT * FROM jobs")
    subs = t.query("SELECT * FROM job_submits")
    if len(jobs) != 1 or jobs[0]["status"] != "submitted" or \
            len(subs) != 1:
        raise AssertionError(f"phase 9: jobs {[dict(j) for j in jobs]}")
    job_id, sub1 = jobs[0]["id"], subs[0]
    outdir = sub1["output_dir"]
    obj = datafile.autogen_dataobj([r["filename"] for r in files])
    want_dir = os.path.join(f"{pipe['root']}/res",
                            str(int(obj.timestamp_mjd)), obj.obs_name,
                            str(obj.beam_id), time.strftime("%y%m%d"))
    if outdir != want_dir:
        raise AssertionError(f"phase 9: output dir {outdir} != "
                             f"{want_dir}")
    with open(os.path.join(pipe["localq"],
                           f"{sub1['queue_id']}.json")) as fh:
        q1 = json.load(fh)
    pgid = q1["pid"]                 # started in a session of its own
    log(f"phase 9: `jobpool --once` ({dt:.3f} s) made job {job_id} and "
        f"submitted it as {sub1['queue_id']} into "
        f"{os.path.relpath(outdir, pipe['root'])} "
        f"({{base}}/{{mjd}}/{{obs_name}}/{{beam}}/{{yymmdd}})")

    # 3. kill, once the checkpoint holds passes 0..K_RESUME-1
    ckdir = ckpt.default_root(outdir)
    mark = f"pass_{K_RESUME - 1:04d}"

    def ready():
        if os.path.exists(q1["rc_file"]):
            raise AssertionError("phase 9: the first attempt ended "
                                 "before the kill")
        doc = ckpt.read_manifest(ckdir) or {}
        return mark in (doc.get("entries") or {})

    waited = _wait_for(ready, f"the checkpoint never named {mark}", 900)
    t_kill = time.time()
    out, kill_s = pipeline_cli(pipe, "kill-jobs", "--fail", str(job_id))
    if f"job {job_id} -> failed" not in out:
        raise AssertionError(f"phase 9: kill-jobs said {out!r}")
    gone_s = _wait_for(lambda: not _group_alive(pgid),
                       "the killed job's process group lives on", 180)
    st = t.query("SELECT status FROM job_submits WHERE id=?",
                 [sub1["id"]], fetchone=True)["status"]
    js = t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                 fetchone=True)["status"]
    if (st, js) != ("stopped", "failed"):
        raise AssertionError(f"phase 9: after the kill submit {st}, "
                             f"job {js}")
    kept = _present_passes(ckdir)
    first = len(kept)
    if kept != list(range(first)) or first < K_RESUME:
        raise AssertionError(f"phase 9: checkpoint passes after the kill "
                             f"{kept}")
    leaks = [n for n in os.listdir(f"{pipe['root']}/work")
             if n.startswith("tpulsar_")]
    log(f"phase 9: {mark} durable {waited:.1f} s after the submit; "
        f"`kill-jobs --fail` ({kill_s:.3f} s); the process group gone "
        f"{gone_s:.1f} s after it; submit stopped, job failed; the "
        f"checkpoint holds passes 0..{first - 1}; workspaces left "
        f"{leaks}")
    if leaks:
        raise AssertionError(f"phase 9: the killed job left {leaks}")

    # 4. retry and resume
    out, dt = pipeline_cli(pipe, "jobpool", "--once")
    subs = t.query("SELECT * FROM job_submits ORDER BY id")
    if [s["status"] for s in subs] != ["stopped", "running"] or \
            subs[1]["output_dir"] != outdir:
        raise AssertionError(f"phase 9: submits after the retry "
                             f"{[dict(s) for s in subs]}")
    sub2 = subs[1]
    with open(os.path.join(pipe["localq"],
                           f"{sub2['queue_id']}.json")) as fh:
        q2 = json.load(fh)
    t_retry = time.time()
    _wait_for(lambda: os.path.exists(q2["rc_file"]),
              "the second attempt never finished", 900, poll_s=0.5)
    retry_wall = time.time() - t_retry
    polls = 0
    while t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                  fetchone=True)["status"] != "processed":
        polls += 1
        if polls > 3:
            raise AssertionError(
                "phase 9: not processed: " + str(dict(t.query(
                    "SELECT * FROM job_submits WHERE id=?", [sub2["id"]],
                    fetchone=True))))
        pipeline_cli(pipe, "jobpool", "--once")
    err2 = os.path.join(outdir, f"{sub2['queue_id']}.stderr")
    if os.path.getsize(err2) != 0:
        with open(err2) as fh:
            raise AssertionError(f"phase 9: the second attempt wrote to "
                                 f"stderr:\n{fh.read()[-3000:]}")
    recs = _attempt_records(pipe["attempts"])
    if len(recs) != 2 or recs[1]["rc"] != 0:
        raise AssertionError(f"phase 9: attempt records {recs}")
    a1, a2 = recs
    npass = sum(1 for _ in _passes(plan))
    with open(os.path.join(outdir, "metrics.json")) as fh:
        metrics = json.load(fh)
    passes = metrics["tpulsar_passes_total"]["series"][""]
    if passes != npass - first:
        raise AssertionError(f"phase 9: the retry computed {passes} "
                             f"passes, the checkpoint lacked "
                             f"{npass - first}")
    trials = sum(len(pp.dms) for pp in _passes(plan)[first:])
    if metrics["tpulsar_dm_trials_total"]["series"][""] != trials:
        raise AssertionError("phase 9: the retry searched another "
                             "trial count")
    outcome = types.SimpleNamespace(
        refined_dms=a2["refined_dms"],
        candidates=[types.SimpleNamespace(dm=d) for d in a2["fold_dms"]],
        folded=a2["fold_dms"])
    n1, n2 = expected_launches(plan, nsamp, outcome, first_pass=first)
    want = {"form_subbands": sum(n1.values()),
            "dedisperse_subbands": sum(n2.values())}
    got = {k: a2["launches"].get(k, 0) for k in want}
    if got != want or a2["launches"].get("dedisperse_subbands_beams"):
        raise AssertionError(f"phase 9: the retry's launches "
                             f"{a2['launches']} != expected {want}")
    log(f"phase 9: `jobpool --once` ({dt:.3f} s) resubmitted job "
        f"{job_id} as {sub2['queue_id']} into the same directory; it "
        f"resumed at pass {first} and computed {passes:.0f} passes "
        f"({trials} trials), launches {a2['launches']} as "
        f"expected_launches gives; its stderr file empty; processed "
        f"after {polls} more `jobpool --once`")
    log(f"phase 9 attempts: first {a1['t_end'] - a1['t_start']:.3f} s "
        f"(start to its exit, killed; rc {a1['rc']}; launches "
        f"{a1['launches']}), second {a2['t_end'] - a2['t_start']:.3f} s "
        f"(start to exit, run_search {a2['run_search_s']:.3f} s; rc 0; "
        f"the backend saw it end {retry_wall:.3f} s after the submit); "
        f"phase 7's solo search_beam {ref['wall_s']:.3f} s")

    # 5. results
    cmp_dir = os.path.join(pipe["root"], "searched")
    os.makedirs(cmp_dir)
    for name in os.listdir(outdir):
        if not name.endswith(".stderr"):
            os.link(os.path.join(outdir, name),
                    os.path.join(cmp_dir, name))
    problems = results_diff().diff_results(ref["resultsdir"], cmp_dir)
    if problems:
        raise AssertionError("phase 9 results differ from phase 7's solo "
                             "search's: " + "; ".join(problems[:10]))
    check_pulsar(outdir, ref["basenm"], "phase 9")
    if os.path.exists(ckdir):
        raise AssertionError("phase 9: the checkpoint was not cleaned")
    log(f"phase 9: the job's {len(os.listdir(cmp_dir))} results files "
        f"equal phase 7's solo search's; the checkpoint is cleaned")

    # 6. upload
    shown, _ = pipeline_cli(pipe, "show", "uploading")
    if f"\n{sub2['id']} | {job_id} | {outdir[:60]}" not in shown:
        raise AssertionError(f"phase 9: show uploading: {shown!r}")
    for line in shown.strip().splitlines():
        log(f"  show uploading: {line}")
    out, up_s = pipeline_cli(pipe, "uploader", "--once")
    js = t.query("SELECT status FROM jobs WHERE id=?", [job_id],
                 fetchone=True)["status"]
    if js != "uploaded":
        raise AssertionError(f"phase 9: after the upload the job is {js}: "
                             + str(dict(t.query(
                                 "SELECT * FROM job_submits WHERE id=?",
                                 [sub2["id"]], fetchone=True))))
    rows = results_db_rows(pipe["results_db"])
    with open(os.path.join(outdir, "header.json")) as fh:
        hdr = json.load(fh)
    cands = accelcands.parse_candlist(os.path.join(
        outdir, f"{ref['basenm']}.accelcands"))
    with np.load(os.path.join(outdir, f"{ref['basenm']}_sp.npz")) as z:
        nsp = len(z["events"])
    con = sqlite3.connect(pipe["results_db"])
    h = con.execute("SELECT source_name, beam_id, version_number "
                    "FROM headers").fetchall()
    psr = con.execute(
        "SELECT period_s, dm, sigma FROM pdm_candidates WHERE "
        "abs(period_s - ?) < ? AND abs(dm - ?) < 5",
        (PSR_PERIOD, 1e-3 * PSR_PERIOD, PSR_DM)).fetchall()
    con.close()
    if len(h) != 1 or h[0][0] != hdr["source_name"] or \
            h[0][1] != hdr["beam_id"] or not h[0][2]:
        raise AssertionError(f"phase 9: headers {h} vs {hdr}")
    if rows["pdm_candidates"] != len(cands) or not psr:
        raise AssertionError(f"phase 9: {rows['pdm_candidates']} "
                             f"candidate rows for {len(cands)} "
                             f"candidates, pulsar rows {psr}")
    if rows["sp_candidates"] != min(nsp, 10000) or \
            rows["diagnostics"] < 5:
        raise AssertionError(f"phase 9: rows {rows} ({nsp} SP events)")
    with open(os.path.join(pipe["root"], "logs", "metrics",
                           "uploader.jsonl")) as fh:
        snap = json.loads(fh.read().splitlines()[-1])["metrics"]
    by_cat = {k: v["sum"] for k, v in
              snap["tpulsar_upload_seconds"]["series"].items()}
    log(f"phase 9 upload: `uploader --once` {up_s:.3f} s; "
        f"tpulsar_upload_seconds by category "
        + json.dumps({k: round(v, 3) for k, v in by_cat.items()})
        + f"; rows per table {json.dumps(rows)}; header "
        f"{h[0]}; the pulsar's row(s) {psr}")
    out, up2_s = pipeline_cli(pipe, "uploader", "--once")
    if results_db_rows(pipe["results_db"]) != rows:
        raise AssertionError("phase 9: a second upload inserted rows")
    status, _ = pipeline_cli(pipe, "status")
    shown, _ = pipeline_cli(pipe, "show", "uploading")
    if "jobs: uploaded=1" not in status or \
            "job_submits: stopped=1, uploaded=1" not in status or \
            "nothing uploading" not in shown:
        raise AssertionError(f"phase 9: status {status!r} / show "
                             f"{shown!r}")
    for line in status.strip().splitlines():
        log(f"  status: {line}")
    # the downloaded copy is the pool's to drop: remove-files
    for row in files:
        pipeline_cli(pipe, "remove-files", str(row["id"]))
        if os.path.exists(row["filename"]):
            raise AssertionError("phase 9: remove-files kept the file")
    phase_s = time.time() - t_phase
    log(f"phase 9: a second `uploader --once` ({up2_s:.3f} s) inserted "
        f"nothing; the downloaded copy removed; the phase took "
        f"{phase_s:.1f} s")
    return dict(launches=a2["launches"], launches_first=a1["launches"],
                fetch_s=fetch_s, first_s=a1["t_end"] - a1["t_start"],
                second_s=a2["t_end"] - a2["t_start"], resumed_at=first,
                passes=passes, upload_s=up_s, upload_by_cat=by_cat,
                rows=rows, phase_s=phase_s)


def results_db_rows(path: str) -> dict:
    """Rows per table of a results DB."""
    con = sqlite3.connect(path)
    try:
        return {tb: con.execute(f"SELECT COUNT(*) FROM {tb}").fetchone()[0]
                for tb in ("headers", "pdm_candidates", "pdm_plots",
                           "sp_candidates", "sp_files", "diagnostics")}
    finally:
        con.close()


#: phase 8's session: the full Mock beam's geometry as a real-time
#: stream (the band runs from its first to its last channel centre),
#: 1024 DM trials over 0-1000, chunks of 16384 samples (1.07 s of
#: sky), spans of 4 chunks; the chunk count is not cut
STREAM_GEOM = {"nchan": NCHAN, "dt": TSAMP, "f_lo_mhz": 1214.36,
               "f_hi_mhz": 1536.64, "ndms": 1024, "dm_max": 1000.0,
               "chunk_len": 16384, "span_chunks": 4}
STREAM_CHUNKS = 8
#: the dispersed pulse of phase 8's chunks (sample of its arrival at
#: the top of the band, DM, amplitude a channel in noise units), and
#: the seq the served sessions leave out as a gap
STREAM_PULSE = dict(t=40_000, dm=300.0, amp=1.0)
STREAM_GAP = 5


def stream_chunks() -> np.ndarray:
    """(nchan, STREAM_CHUNKS * chunk_len) float32: seeded numpy noise
    plus one dispersed pulse of 3 samples."""
    from tpulsar_torch.constants import dispersion_delay_s
    from tpulsar_torch.stream.dedisp_state import geometry_freqs_dms

    g = STREAM_GEOM
    rng = np.random.default_rng(20261017)
    data = rng.standard_normal(
        (g["nchan"], STREAM_CHUNKS * g["chunk_len"]), dtype=np.float32)
    freqs, _ = geometry_freqs_dms(g)
    sh = np.round(dispersion_delay_s(STREAM_PULSE["dm"], freqs,
                                     float(freqs[-1])) / g["dt"])
    for c in range(g["nchan"]):
        t = STREAM_PULSE["t"] + int(sh[c])
        data[c, t:t + 3] += STREAM_PULSE["amp"]
    return data


def stream_control(chunks: list, device) -> tuple[str, list, list]:
    """The in-process run of a session's frames (None = a gap,
    zero-filled as the worker fills it) through StreamDedisp and
    SpanTrigger on the torch backend -> (digest, records, the emitted
    blocks)."""
    from tpulsar_torch.stream.dedisp_state import StreamDedisp
    from tpulsar_torch.stream.trigger import SpanTrigger, trigger_digest

    sd = StreamDedisp(STREAM_GEOM, backend="torch", device=device)
    tg = SpanTrigger(STREAM_GEOM, session="control", backend="torch",
                     device=device)
    recs, blocks = [], []
    for ch in chunks:
        if ch is None:
            ch = np.zeros((sd.nchan, sd.chunk_len), np.float32)
        blocks += sd.append(ch)
    blocks += sd.flush()
    for blk in blocks:
        for _, r in tg.feed(blk):
            recs += r
    for _, r in tg.flush():
        recs += r
    return trigger_digest(recs), recs, blocks


def _chunk(data: np.ndarray, k: int) -> np.ndarray:
    cl = STREAM_GEOM["chunk_len"]
    return data[:, k * cl:(k + 1) * cl]


def _feed_at_cadence(land, seqs, t0: float) -> None:
    """land(k) chunk k at t0 + k chunk durations (the real-time
    rate)."""
    chunk_s = STREAM_GEOM["chunk_len"] * STREAM_GEOM["dt"]
    for k in seqs:
        wait = t0 + k * chunk_s - time.time()
        if wait > 0:
            time.sleep(wait)
        land(k)


def _wait_events(spool: str, tid: str, event: str, n: int,
                 proc, limit_s: float) -> None:
    from tpulsar_torch.obs import journal

    deadline = time.time() + limit_s
    while sum(e["event"] == event for e in journal.read_events(
            spool, ticket=tid)) < n:
        if proc.poll() is not None:
            raise AssertionError(f"phase 8: the server exited "
                                 f"{proc.returncode} before {n} {event}")
        if time.time() > deadline:
            raise AssertionError(f"phase 8: no {n} {event} in "
                                 f"{limit_s:.0f} s")
        time.sleep(0.05)


def stage2_kernel_ms(subb: torch.Tensor, plan, ndms: int) -> float:
    """The stage-2 kernel alone on (nsub, T) subbands, its group
    tables on the card already (the wrapper computes and uploads them
    every call); these launches are not counted."""
    lib = cuda_dd._load()
    tables = torch.from_numpy(plan.tables).to(DEV)
    out = torch.empty((ndms, subb.shape[1]), dtype=torch.float32,
                      device=DEV)
    stream = torch.cuda.current_stream(DEV).cuda_stream
    return time_ms(lambda: cuda_dd._check(lib.dd_dedisperse(
        subb.data_ptr(), 1, subb.shape[0], subb.shape[1],
        tables.data_ptr(), ndms, plan.groups, plan.rows, plan.span,
        out.data_ptr(), stream), "dd_dedisperse"))


def stream_host_io(sd, data: np.ndarray) -> dict:
    """Host clock of the stream worker's per-chunk I/O at this
    geometry: one frame's verified read, and one carry checkpoint (the
    worker's npz: the carry and a span's worth of pending series less
    one chunk, through CheckpointStore.save)."""
    from tpulsar_torch.stream import ingest

    tmp = tempfile.mkdtemp(prefix="tpulsar_torch_stream_io_")
    try:
        ingest.open_session(tmp, "io", STREAM_GEOM)
        ingest.append_chunk(tmp, "io", 0, _chunk(data, 0))
        t0 = time.time()
        ingest.read_chunk(tmp, "io", 0)
        read_s = time.time() - t0
        cl = STREAM_GEOM["chunk_len"]
        pend = np.zeros((STREAM_GEOM["ndms"],
                         (STREAM_GEOM["span_chunks"] - 1) * cl), np.float32)
        carry = np.ascontiguousarray(data[:, :sd.maxshift])
        store = ckpt.CheckpointStore(os.path.join(tmp, "ck"), "io")
        t0 = time.time()
        buf = io.BytesIO()
        np.savez(buf, carry=carry, emitted=np.int64(0),
                 ack_next=np.int64(1), sp_pend=pend,
                 sp_next_span=np.int64(0))
        blob = buf.getvalue()
        store.save("stream_carry", blob, kind="stream", ext=".1.npz",
                   ack_next=1)
        ck_s = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(frame_read_s=read_s, checkpoint_s=ck_s,
                checkpoint_mb=len(blob) / 1e6)


def stream_served(tmp: str, name: str, data: np.ndarray,
                  kill_after: int = 0) -> dict:
    """A session fed at the real-time rate with seq STREAM_GAP left out,
    answered by `python -m tpulsar_torch serve --stream --once` in a
    subprocess on the card, its frames landed by
    stream/ingest.append_chunk.  With kill_after, the session is fed
    over HTTP instead, through a token'd gateway over the server's
    spool (`POST /v1/stream/<s>/open|chunks|close`), that server is
    SIGKILLed once kill_after chunks are acknowledged, the rest of the
    frames land at once, a second server resumes the session, and the
    triggers are read back through `GET /v1/stream/<s>/triggers`."""
    from tpulsar_torch.serve import protocol
    from tpulsar_torch.stream import ingest

    srv = server_setup(tmp, name)
    outdir = os.path.join(tmp, f"{name}_out")
    os.makedirs(outdir)
    session = f"{name}_session"
    slo_s = STREAM_GEOM["chunk_len"] * STREAM_GEOM["dt"]
    gw = None
    if kill_after:
        gw, url, gw_log = start_gateway(srv, f"spool:{srv['spool']}")
        su = f"{url}/v1/stream/{session}"
        code, rec = http("POST", su + "/open", json.dumps(
            {"geometry": STREAM_GEOM, "outdir": outdir,
             "slo_s": slo_s}).encode())
        if code != 201:
            raise AssertionError(f"phase 8: open over HTTP: {code} {rec}")
        tid, sroot = rec["ticket"], os.path.join(srv["spool"], "stream")

        def land(k):
            code, rec = http("POST", su + "/chunks", ingest.encode_frame(
                k, _chunk(data, k), time.time()))
            if code != 201 or rec["seq"] != k:
                raise AssertionError(f"phase 8: frame {k} over HTTP: "
                                     f"{code} {rec}")

        def close():
            code, rec = http("POST", su + "/close", json.dumps(
                {"n_chunks": STREAM_CHUNKS}).encode())
            if code != 200:
                raise AssertionError(f"phase 8: close over HTTP: {code} "
                                     f"{rec}")
    else:
        sroot = os.path.join(tmp, f"{name}_sessions")
        tid = f"{name}_ticket"
        ingest.open_session(sroot, session, STREAM_GEOM)
        protocol.write_ticket(srv["spool"], tid, [], outdir, kind="stream",
                              session=session, stream_root=sroot,
                              slo_s=slo_s)

        def land(k):
            ingest.append_chunk(sroot, session, k, _chunk(data, k))

        def close():
            ingest.close_session(sroot, session, STREAM_CHUNKS)
    seqs = [k for k in range(STREAM_CHUNKS) if k != STREAM_GAP]
    torch.cuda.empty_cache()

    logs = []

    def start(log_path: str):
        logs.append(open(log_path, "w"))
        return subprocess.Popen(srv["cmd"] + ["--stream"], env=srv["env"],
                                stdout=logs[-1], stderr=subprocess.STDOUT)

    resumed_log = os.path.join(tmp, f"{name}_resumed.log")
    t_start = time.time()
    proc = start(srv["log"])
    try:
        _wait_events(srv["spool"], tid, "stream_open", 1, proc, 300)
        t_open = time.time() - t_start
        if kill_after:
            feeder = threading.Thread(target=_feed_at_cadence, args=(
                land, seqs[:kill_after + 1], time.time()))
            feeder.start()
            _wait_events(srv["spool"], tid, "chunk_received", kill_after,
                         proc, 120)
            proc.kill()
            proc.wait(timeout=60)
            feeder.join()
            if protocol.read_result(srv["spool"], tid) is not None:
                raise AssertionError("phase 8: a killed server wrote a "
                                     "result")
            for k in seqs[kill_after + 1:]:
                land(k)
            close()
            proc = start(resumed_log)
        else:
            _feed_at_cadence(land, seqs, time.time())
            close()
        rc = proc.wait(timeout=600)
        triggers = None
        if gw is not None:
            code, triggers = http("GET", su + "/triggers", token="")
            if code != 200:
                raise AssertionError(f"phase 8: triggers over HTTP: "
                                     f"{code} {triggers}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        for fh in logs:
            fh.close()
        if gw is not None:
            stop_gateway(gw, gw_log, "phase 8")
    wall = time.time() - t_start
    counts = server_counts(srv, rc) if not kill_after else {}
    if kill_after:
        with open(resumed_log) as fh:
            text = fh.read()
        if rc != 0:
            raise AssertionError(f"{name}: the resumed server exited "
                                 f"{rc}:\n{text[-4000:]}")
    return dict(spool=srv["spool"], tid=tid, outdir=outdir, wall_s=wall,
                open_s=t_open, counts=counts, slo_s=slo_s, sroot=sroot,
                session=session, triggers=triggers,
                rec=protocol.read_result(srv["spool"], tid))


def stream_phase() -> dict:
    """Phase 8: the streaming plane on the 960-channel Mock session, in
    process (bit-identity with the batch and the plain version, the
    kernel's launches, triggers against the batch spans, times) and
    served by `serve --stream --once` (a gap, then a SIGKILL and a
    resume)."""
    from tpulsar_torch.obs import journal
    from tpulsar_torch.stream.dedisp_state import (StreamDedisp,
                                                   geometry_freqs_dms)
    from tpulsar_torch.stream.trigger import (events_to_records,
                                              search_span, trigger_digest)

    g = STREAM_GEOM
    cl, ndms, nchan = g["chunk_len"], g["ndms"], g["nchan"]
    _, dms = geometry_freqs_dms(g)
    t0 = time.time()
    data = stream_chunks()
    log(f"phase 8: {STREAM_CHUNKS} chunks of ({nchan}, {cl}) float32 "
        f"synthesized in {time.time() - t0:.1f} s (pulse {STREAM_PULSE})")

    # ---- in process: the stream against the batch and the plain
    sd = StreamDedisp(g, backend="torch", device=DEV)
    plan = cuda_dd.stage2_launch(sd.shifts)
    log(f"phase 8: maxshift {sd.maxshift}, window ({nchan}, "
        f"{sd.window_width}), stage-2 launch {plan.groups} groups x "
        f"{plan.rows} rows, span {plan.span}, {plan.smem_bytes} B shared")
    cuda_dd.reset_counts()
    blocks, per_chunk = [], []
    torch.cuda.synchronize()
    t0 = time.time()
    for k in range(STREAM_CHUNKS):
        t1 = time.time()
        blocks += sd.append(_chunk(data, k))
        per_chunk.append(time.time() - t1)
    blocks += sd.flush()
    stream_s = time.time() - t0
    launches = dict(cuda_dd.LAUNCHES)
    emissions = len(blocks)
    if launches["dedisperse_subbands"] != emissions or emissions != \
            STREAM_CHUNKS or sum(launches.values()) != emissions:
        raise AssertionError(f"phase 8: {emissions} emissions, launches "
                             f"{launches}")
    series = torch.from_numpy(np.concatenate(blocks, axis=1)).to(DEV)
    data_dev = torch.from_numpy(data).to(DEV)
    batch = dd.dedisperse_stream_batch(data_dev, sd.shifts)
    if not torch.equal(series, batch):
        raise AssertionError("phase 8: the streamed series differs from "
                             "dedisperse_stream_batch")
    del batch
    t0 = time.time()
    plain = cuda_dd.dedisperse_subbands_plain(data_dev, sd.shifts)
    torch.cuda.synchronize()
    plain_block_s = time.time() - t0
    if not torch.equal(series, plain):
        raise AssertionError("phase 8: the streamed series differs from "
                             "the plain stage 2 over the block")
    del plain, data_dev
    log(f"phase 8: {emissions} emissions, {emissions} stage-2 launches; "
        f"the streamed ({ndms}, {series.shape[1]}) series is torch.equal "
        f"to dedisperse_stream_batch and to the plain stage 2 over the "
        f"block on the card ({plain_block_s:.3f} s)")

    # ---- triggers: streamed spans against the batch series' spans
    t0 = time.time()
    digest, recs, _ = stream_control([_chunk(data, k) for k in
                                      range(STREAM_CHUNKS)], DEV)
    control_s = time.time() - t0
    span_len = g["span_chunks"] * cl
    host = series.cpu().numpy()
    brecs = []
    for i, s0 in enumerate(range(0, host.shape[1], span_len)):
        ev = search_span(host[:, s0:s0 + span_len], dms, g["dt"],
                         backend="torch", device=DEV)
        brecs += events_to_records(ev, "control", i, s0, g["dt"])
    if trigger_digest(brecs) != digest:
        raise AssertionError(f"phase 8: streamed triggers ({len(recs)}) "
                             f"!= the batch spans' ({len(brecs)})")
    step = float(dms[1] - dms[0])
    hits = [r for r in recs if abs(r["dm"] - STREAM_PULSE["dm"]) <= step
            and abs(r["sample"] - STREAM_PULSE["t"]) <= 32]
    if not hits:
        raise AssertionError(f"phase 8: the pulse was not triggered "
                             f"({len(recs)} triggers)")
    top = max(hits, key=lambda r: r["sigma"])
    log(f"phase 8: {len(recs)} triggers, equal to the batch spans'; the "
        f"pulse at DM {top['dm']} sample {top['sample']} width "
        f"{top['width']} sigma {top['sigma']}")

    # ---- times: one emission, its copies, one span search
    sd2 = StreamDedisp(g, backend="torch", device=DEV)
    window = np.zeros((nchan, sd2.window_width), np.float32)
    need = cl + sd2.maxshift
    window[:, :need] = data[:, :need]
    win = torch.from_numpy(window).to(DEV)
    out = dd.dedisperse_stream_step(win, sd2.shifts, cl)
    ref, plain_ms = once_ms(lambda: cuda_dd.dedisperse_subbands_plain(
        win, sd2.shifts)[:, :cl])
    err = float((out - ref).abs().max())
    if not torch.equal(out, ref):
        raise AssertionError(f"phase 8: an emission differs from its "
                             f"plain version by {err}")
    del ref
    ms = time_ms(lambda: dd.dedisperse_stream_step(win, sd2.shifts, cl))
    # the emission's function: chunk_len columns of ndms sums over
    # nchan channels (the kernel computes all W columns, twice that)
    nops = float(ndms) * nchan * cl
    nbytes = 4.0 * (nchan * need + ndms * cl)
    b_ms, b_by = bound_ms(nbytes, nops)
    # the call's parts: the launch arithmetic on the host (the group
    # tables, recomputed every call), and the kernel alone on tables
    # already on the card
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        plan = cuda_dd.stage2_launch(sd2.shifts)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    launch_host_ms = statistics.median(host_ms)
    kernel_ms = stage2_kernel_ms(win, plan, ndms)
    h2d_ms = time_ms(lambda: torch.from_numpy(window).to(DEV))
    d2h_ms = time_ms(lambda: out.cpu())
    span_dev = series[:, :span_len].contiguous()
    from tpulsar_torch.kernels import singlepulse as sp_mod
    span_ms = time_ms(lambda: sp_mod.single_pulse_search(
        span_dev, dms, g["dt"], threshold=6.0))
    del series, span_dev, win, out
    io_s = stream_host_io(sd2, data)
    log(f"phase 8 emission: {ms:.3f} ms (plain {plain_ms:.3f} ms), bound "
        f"{b_ms:.3f} ms by {b_by} ({nops:.3e} adds of the kept "
        f"{cl} columns; the kernel computes {sd2.window_width}), share "
        f"{b_ms / ms:.3f}; of which the host's launch arithmetic "
        f"{launch_host_ms:.3f} ms and the kernel alone {kernel_ms:.3f} ms "
        f"(share {b_ms / kernel_ms:.3f}); H2D of the window {h2d_ms:.3f} "
        f"ms, D2H of the "
        f"block {d2h_ms:.3f} ms; span search ({ndms}, {span_len}) "
        f"{span_ms:.3f} ms; in process {STREAM_CHUNKS} chunks "
        f"({cl * g['dt']:.4f} s of sky each) dedispersed in "
        f"{stream_s:.3f} s ({STREAM_CHUNKS / stream_s:.3f} chunks/s; "
        f"append p50 {statistics.median(per_chunk) * 1e3:.1f} ms, max "
        f"{max(per_chunk) * 1e3:.1f} ms), dedispersed and span-searched "
        f"in {control_s:.3f} s ({STREAM_CHUNKS / control_s:.3f} "
        f"chunks/s); the worker's host I/O a chunk: frame read and "
        f"verify {io_s['frame_read_s']:.3f} s, carry checkpoint "
        f"({io_s['checkpoint_mb']:.1f} MB npz) {io_s['checkpoint_s']:.3f} "
        f"s")

    tmp = tempfile.mkdtemp(prefix="tpulsar_torch_stream_")
    try:
        gapped = [None if k == STREAM_GAP else _chunk(data, k)
                  for k in range(STREAM_CHUNKS)]
        gdigest, grecs, _ = stream_control(gapped, DEV)
        # ---- served: a gap
        run = stream_served(tmp, "stream", data)
        r = run["rec"]
        want = dict(status="done", n_chunks=STREAM_CHUNKS,
                    chunks=STREAM_CHUNKS - 1, gaps=1, replayed=0,
                    emitted_samples=STREAM_CHUNKS * cl,
                    trigger_digest=gdigest)
        if r is None or any(r.get(k) != v for k, v in want.items()):
            raise AssertionError(f"phase 8: served result {r} (want "
                                 f"{want})")
        evs = journal.read_events(run["spool"], ticket=run["tid"])
        names = [e["event"] for e in evs if e["event"] in (
            "stream_open", "chunk_received", "chunk_gap", "stream_closed")]
        if names != ["stream_open"] + ["chunk_received"] * STREAM_GAP + [
                "chunk_gap"] + ["chunk_received"] * (
                STREAM_CHUNKS - STREAM_GAP - 1) + ["stream_closed"]:
            raise AssertionError(f"phase 8: journal chain {names}")
        chain = check_journal(run["spool"], run["tid"],
                              ["claimed", "stream_open", "stream_closed",
                               "result"], "phase 8")
        lat = sorted(e["latency_s"] for e in evs
                     if e["event"] == "chunk_received")
        proc_s = sorted(e["proc_s"] for e in evs
                        if e["event"] == "chunk_received")
        p50 = statistics.median(lat)
        p95 = lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)]
        served = run["counts"]["served"]
        if served["dedisperse_subbands"] != STREAM_CHUNKS or \
                sum(served.values()) != STREAM_CHUNKS:
            raise AssertionError(f"phase 8: served launches {served}")
        boot = run["counts"]["boot"]
        log(f"phase 8 served: {r['chunks']} chunks + {r['gaps']} gap, "
            f"{r['triggers']} triggers, digest equal to the in-process "
            f"control's; chain {json.dumps(chain)}; launches after boot "
            f"{served} (boot {boot}, {run['counts']['boot_seconds']:.3f} "
            f"s); chunk latency p50 {p50:.3f} s, p95 {p95:.3f} s, max "
            f"{lat[-1]:.3f} s against slo_s {run['slo_s']:.4f} s; "
            f"proc_s p50 {statistics.median(proc_s):.3f} s, max "
            f"{proc_s[-1]:.3f} s; session open {run['open_s']:.1f} s "
            f"after the server started, server process "
            f"{run['wall_s']:.1f} s")
        # ---- served: a SIGKILL after 3 acknowledged chunks, resumed
        kill = stream_served(tmp, "killed", data, kill_after=3)
        r2 = kill["rec"]
        if r2 is None or r2.get("status") != "done" or \
                r2.get("trigger_digest") != gdigest or \
                r2.get("replayed", 9) > 1 or r2.get("gaps") != 1 or \
                r2.get("chunks") != STREAM_CHUNKS - 1:
            raise AssertionError(f"phase 8: resumed result {r2}")
        kevs = journal.read_events(kill["spool"], ticket=kill["tid"])
        acked = sorted(e["seq"] for e in kevs
                       if e["event"] == "chunk_received")
        opens = [e for e in kevs if e["event"] == "stream_open"]
        if acked != [k for k in range(STREAM_CHUNKS) if k != STREAM_GAP] \
                or [e.get("resumed") for e in opens] != [0, 1]:
            raise AssertionError(f"phase 8: resumed chain acks {acked}, "
                                 f"opens {opens}")
        if os.path.isdir(ckpt.default_root(kill["outdir"])):
            raise AssertionError("phase 8: the checkpoint was not cleaned")
        got = kill["triggers"]
        if not got["closed"] or got["n"] != r2["triggers"] or \
                trigger_digest(got["triggers"]) != gdigest:
            raise AssertionError(f"phase 8: GET triggers: closed "
                                 f"{got['closed']}, {got['n']} records "
                                 f"(result {r2['triggers']})")
        log(f"phase 8 kill/resume: fed over HTTP (gateway over the spool), "
            f"SIGKILL after 3 acknowledged chunks, "
            f"resumed at seq {opens[1].get('ack')}, replayed "
            f"{r2['replayed']}, digest equal to the control's, every seq "
            f"acknowledged once, {got['n']} triggers read back over HTTP "
            f"with the control's digest, checkpoint cleaned (kept copy "
            f"{os.path.isdir(kill['outdir'] + '.checkpoint')})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(name="stream", emissions=emissions, launches=launches,
                launches_served=served, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                launch_host_ms=launch_host_ms, kernel_ms=kernel_ms,
                h2d_ms=h2d_ms, d2h_ms=d2h_ms, span_search_ms=span_ms,
                **io_s,
                plain_block_s=plain_block_s,
                chunks_per_s=STREAM_CHUNKS / stream_s,
                chunks_per_s_with_triggers=STREAM_CHUNKS / control_s,
                latency_p50_s=p50, latency_p95_s=p95,
                latency_max_s=lat[-1], slo_s=run["slo_s"],
                replayed=r2["replayed"], triggers=len(recs))


#: the seconds phase 12 allows its search subprocess (a quarter beam:
#: phase 7's solo search takes 32-35 s, a process start ~10 s)
OPS_SEARCH_TIMEOUT_S = 300


def ops_cli(*args) -> tuple[int, str]:
    """`python -m tpulsar_torch ARGS` in this process (cli.main.main,
    which the package's __main__ calls): its exit code, and its
    standard output followed by its standard error."""
    from tpulsar_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main.main([str(a) for a in args])
    return rc, out.getvalue() + err.getvalue()


def _check_cli(what: str, rc: int, text: str, want_rc: int = 0) -> str:
    if rc != want_rc:
        raise AssertionError(f"phase 12: `{what}` exited {rc} (expected "
                             f"{want_rc}):\n{text[-4000:]}")
    return text


def _timeline_rows(text: str) -> list[tuple[str, str, str]]:
    """(event, worker, detail) of each row of `obs timeline`."""
    rows = []
    for line in text.splitlines()[3:]:
        parts = line.split(None, 5)
        if len(parts) >= 4 and re.match(r"-?[\d.]+$", parts[0]):
            rows.append((parts[2], parts[3], line))
    return rows


def _check_takeover_chain(text: str, tid: str, what: str,
                          reclaim: str | None) -> list[str]:
    """The timeline holds, in order: claimed by w0, a takeover from w0,
    a claim by `reclaim` (any worker if None), and exactly one result;
    returns the chain's (event, worker) steps."""
    rows = _timeline_rows(text)
    steps, want = [], [("claimed", "w0"), ("takeover", "from_worker=w0"),
                       ("claimed", reclaim), ("result", None)]
    for ev, worker, line in rows:
        if not want:
            break
        w_ev, w_who = want[0]
        if ev == w_ev and (w_who is None or worker == w_who
                           or (w_ev == "takeover" and w_who in line)):
            steps.append(f"{ev} from w0" if ev == "takeover"
                         else f"{ev} {worker}")
            want.pop(0)
    results = [r for r in rows if r[0] == "result"]
    if want or len(results) != 1:
        raise AssertionError(f"phase 12: `obs timeline {tid}` ({what}) "
                             f"lacks {want} or has {len(results)} "
                             f"results:\n{text[-3000:]}")
    return steps


#: the profiler's names of the two kernels (a substring of each event's
#: demangled name), by their wrapper's launch counter
PROFILE_KERNELS = {"form_subbands": "form_subbands_kernel",
                   "dedisperse_subbands": "dedisperse_kernel"}


def check_profile(prof_dir: str, launches: dict, what: str) -> dict:
    """The TPULSAR_PROFILE directory of one search: exactly one gzipped
    Chrome trace, which parses (gzip + json), holds the search_block
    range and as many events of each kernel as its wrapper counted.
    Returns the trace's size, event count, kernel counts and parse
    seconds."""
    names = os.listdir(prof_dir)
    if len(names) != 1 or not names[0].endswith(".pt.trace.json.gz"):
        raise AssertionError(f"{what}: the profile directory holds "
                             f"{names}, not one .pt.trace.json.gz")
    path = os.path.join(prof_dir, names[0])
    t0 = time.time()
    with gzip.open(path, "rt") as fh:
        events = json.load(fh)["traceEvents"]
    parse_s = time.time() - t0
    roots = [e for e in events if e.get("name") == "search_block"
             and e.get("cat") == "user_annotation"]
    if len(roots) != 1:
        raise AssertionError(f"{what}: {len(roots)} search_block ranges "
                             f"in the profile")
    kernels = {k: sum(1 for e in events if e.get("cat") == "kernel"
                      and sub in e.get("name", ""))
               for k, sub in PROFILE_KERNELS.items()}
    want = {k: launches.get(k, 0) for k in PROFILE_KERNELS}
    if kernels != want:
        raise AssertionError(f"{what}: the profile holds kernel events "
                             f"{kernels}, the wrappers counted {want}")
    return dict(file=names[0], bytes=os.path.getsize(path),
                events=len(events), kernels=kernels,
                search_block_ms=roots[0]["dur"] / 1e3, parse_s=parse_s)


def start_profile_check(prof_dir: str, launches: dict, what: str):
    """check_profile in a subprocess (the parse of a quarter beam's
    trace takes ~10 s on one core), so that it runs beside the next
    phase; finish_profile_check collects it."""
    code = (f"import gzip, json, os, sys, time\n"
            f"PROFILE_KERNELS = {PROFILE_KERNELS!r}\n"
            + inspect.getsource(check_profile)
            + "print(json.dumps(check_profile(sys.argv[1], "
              "json.loads(sys.argv[2]), sys.argv[3])))\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, prof_dir, json.dumps(launches), what],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_profile_check(proc, what: str) -> dict:
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: the profile check did not end "
                             f"within 300 s") from None
    if proc.returncode != 0:
        raise AssertionError(f"{what}: the profile check exited "
                             f"{proc.returncode}:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def ops_search_start(tmp: str, p7: dict) -> dict:
    """Phase 12's `python -m tpulsar_torch search`, started in a
    subprocess on the card over phase 7's beam, with TPULSAR_TRACE=1
    and TPULSAR_PROFILE set to a directory
    outside the outdir, through SERVE_WRAPPER, into an output
    directory holding phase 7's solo search's checkpoint cut back to
    pass K_RESUME (truncate_checkpoint), so that the job resumes there
    and the profile records the passes it computes.  It reads the beam
    and that checkpoint only; ops_phase waits for it."""
    solo = p7["solo"]
    srv = server_setup(tmp, "ops")
    out = os.path.join(tmp, "ops_search")
    shutil.copytree(solo["ckdir"], ckpt.default_root(out))
    truncate_checkpoint(ckpt.default_root(out), K_RESUME)
    # the profile goes outside the results directory
    prof_dir = os.path.join(tmp, "ops_profile")
    env = dict(srv["env"], TPULSAR_TRACE="1", TPULSAR_PROFILE=prof_dir)
    cmd = [sys.executable, "-c", SERVE_WRAPPER, "--config", srv["cfg"],
           "search", *p7["fns"], "--outdir", out]
    torch.cuda.empty_cache()
    logs = [open(os.path.join(tmp, f"ops_search.{k}"), "w+")
            for k in ("out", "err")]
    proc = subprocess.Popen(cmd, env=env, stdout=logs[0], stderr=logs[1])
    return dict(srv=srv, out=out, prof_dir=prof_dir, proc=proc,
                logs=logs, t0=time.time())


def ops_phase(tmp: str, plan, p7: dict, chaos: dict, started: dict
              ) -> dict:
    """Phase 12: the operator surface.  The `search` ops_search_start
    started: exit 0, passes K_RESUME.. computed (metrics.json), results
    equal to phase 7's solo search's (the trace file set aside), the
    pulsar folded, both kernels launched as expected_launches gives for
    those passes; its profile directory's trace is checked by the
    returned profile_check (start_profile_check) beside phase 13.
    Then, in this process: `trace` and
    tools/torch_trace_summarize.py --compare-report over its output,
    `plan` of the beam (the 57-pass Mock survey plan), `checkpoint
    [--verify]` of the checkpoint the job cleaned (and of a copy with
    one byte flipped: exit 1, the artifact named), and `obs timeline |
    top | tail` over phase 11's sqlite queue (the timeline of the
    ticket the storm took over from w0)."""
    from tpulsar_torch.io import datafile
    from tpulsar_torch.obs import trace as trace_lib

    fns, solo = p7["fns"], p7["solo"]
    srv, out, proc = started["srv"], started["out"], started["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, started["t0"]
                                   + OPS_SEARCH_TIMEOUT_S - time.time()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    t_phase = time.time()
    text = []
    for fh in started["logs"]:
        fh.seek(0)
        text.append(fh.read()[-3000:])
        fh.close()
    if rc != 0:
        raise AssertionError(f"phase 12: `search` exited {rc} (None: not "
                             f"within {OPS_SEARCH_TIMEOUT_S} s):\n"
                             + "\n".join(text))
    with open(srv["counts"]) as fh:
        counts = json.load(fh)
    # the command's wall, from its start to the wrapper's exit record
    wall = counts["t_end"] - started["t0"]
    launches = counts["served"]
    base = solo["basenm"]
    trace_name = f"{base}_trace.json"
    names = sorted(os.listdir(out))
    if trace_name not in names:
        raise AssertionError(f"phase 12: no {trace_name} in {names}")
    cmp_dir = os.path.join(tmp, "ops_cmp")
    os.makedirs(cmp_dir)
    for name in names:
        if name != trace_name and not name.endswith(".stderr"):
            os.link(os.path.join(out, name), os.path.join(cmp_dir, name))
    problems = results_diff().diff_results(solo["resultsdir"], cmp_dir)
    if problems:
        raise AssertionError("phase 12: the search command's results "
                             "differ from phase 7's solo search's: "
                             + "; ".join(problems[:10]))
    check_pulsar(out, base, "phase 12")
    npass = sum(s.numpasses for s in plan)
    with open(os.path.join(out, "metrics.json")) as fh:
        passes = json.load(fh)["tpulsar_passes_total"]["series"][""]
    if passes != npass - K_RESUME:
        raise AssertionError(f"phase 12: `search` computed {passes} "
                             f"passes, expected {npass - K_RESUME}")
    n1, n2 = expected_launches(plan, p7["nsamp"], solo["outcome"],
                               first_pass=K_RESUME)
    want = {"form_subbands": sum(n1.values()),
            "dedisperse_subbands": sum(n2.values())}
    got = {k: launches.get(k, 0) for k in SOLO_KERNELS}
    if got != want or launches.get("dedisperse_subbands_beams"):
        raise AssertionError(f"phase 12: the search command's launches "
                             f"{launches} != expected {want}")
    stages = report_stages(os.path.join(out, f"{base}.report"))
    log(f"phase 12: `search` exited 0 in {wall:.3f} s (process "
        f"{counts['t_end'] - counts['t_start']:.3f} s from its first "
        f"line), resumed at pass {K_RESUME}: {passes} passes computed; "
        f"{len(names) - 1} results files equal phase 7's solo "
        f"search's (the trace file set aside); launches {got} "
        f"(expected_launches from pass {K_RESUME}); .report stages: "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))

    # (b) the trace: `trace`, and the summarize tool against the .report
    t_cmds = time.time()
    text = _check_cli("trace", *ops_cli("trace", out))
    if "search_block" not in text or "dm_chunk" not in text:
        raise AssertionError(f"phase 12: `trace` printed no span table:"
                             f"\n{text[-3000:]}")
    roll = trace_lib.summarize_file(os.path.join(out, trace_name))["rollup"]
    top = sorted(roll, key=lambda n: -roll[n]["seconds"])[:6]
    log("phase 12: trace top spans: " + ", ".join(
        f"{n} {roll[n]['seconds']:.3f} s x{roll[n]['count']}" for n in top))
    ts = tool("torch_trace_summarize")
    report = os.path.join(out, f"{base}.report")
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = ts.main([out, "--compare-report", report])
    _check_cli("tools/torch_trace_summarize.py --compare-report", rc,
               buf.getvalue() + err.getvalue())
    log(f"phase 12: {buf.getvalue().strip().splitlines()[-1]}")

    # (c) the plan of the beam's header: the 57-pass Mock survey plan
    text = _check_cli("plan", *ops_cli("plan", *fns))
    _steps, obs, _nsub = ddplan.plan_for(
        datafile.autogen_dataobj(fns).specinfo, 0.0, 1000.0, 96)
    survey = ddplan.survey_plan("pdev")
    npass = sum(s.numpasses for s in survey)
    if text.strip() != ddplan.describe_plan(survey, obs).strip() or \
            npass != 57:
        raise AssertionError(f"phase 12: `plan` printed another plan "
                             f"({npass} passes):\n{text}")

    # (d) the checkpoint the job cleaned (kept by the wrapper)
    kept = out + ".checkpoint"
    entries = (ckpt.read_manifest(kept) or {}).get("entries") or {}
    passes = sorted(k for k in entries if k.startswith("pass_"))
    text = _check_cli("checkpoint", *ops_cli("checkpoint", kept))
    missing = [k for k in entries if f"  {k} " not in text]
    if len(passes) != npass or missing:
        raise AssertionError(f"phase 12: `checkpoint` of {len(entries)} "
                             f"artifacts ({len(passes)} passes) lacks "
                             f"{missing}:\n{text[-3000:]}")
    _check_cli("checkpoint --verify", *ops_cli("checkpoint", kept,
                                               "--verify"))
    bad = kept + ".flipped"
    shutil.copytree(kept, bad)
    victim = passes[len(passes) // 2]
    with open(os.path.join(bad, entries[victim]["file"]), "r+b") as fh:
        b = fh.read(1)
        fh.seek(0)
        fh.write(bytes([b[0] ^ 0xFF]))
    text = _check_cli("checkpoint --verify (one byte flipped)",
                      *ops_cli("checkpoint", bad, "--verify"), want_rc=1)
    flagged = re.findall(r"INVALID (\S+):", text)
    if flagged != [victim]:
        raise AssertionError(f"phase 12: `checkpoint --verify` flagged "
                             f"{flagged}, not {victim}:\n{text[-2000:]}")

    # (e) the ops console over phase 11's sqlite queue: the timeline of
    # the ticket the storm took over from w0, top and tail
    fq_args = ("--queue", chaos["queue_url"], "--spool", chaos["spool"])
    ct = chaos["victim"]
    text = _check_cli(f"obs timeline {ct}",
                      *ops_cli("obs", "timeline", ct, *fq_args))
    chaos_chain = _check_takeover_chain(text, ct, "phase 11", None)
    text = _check_cli("obs top --once",
                      *ops_cli("obs", "top", "--once", *fq_args))
    if not re.search(r"^w0 ", text, re.M) or \
            not re.search(r"^w1 ", text, re.M):
        raise AssertionError(f"phase 12: `obs top --once` does not name "
                             f"w0 and w1:\n{text}")
    text = _check_cli("obs tail --lines 5",
                      *ops_cli("obs", "tail", "--lines", 5, *fq_args))
    if len([ln for ln in text.splitlines() if ln.startswith("{")]) != 5:
        raise AssertionError(f"phase 12: `obs tail --lines 5`:\n{text}")
    cmds_s = time.time() - t_cmds
    # the command's wall, then this process's part after it
    phase_s = wall + time.time() - t_phase
    log(f"phase 12: `trace`, the summarize tool, `plan` ({npass} passes), "
        f"`checkpoint` of {len(entries)} artifacts, `--verify` (clean, "
        f"then {victim} flagged), `obs timeline|top|tail` in "
        f"{cmds_s:.3f} s; the timeline of {ct}: {chaos_chain}; the "
        f"phase {phase_s:.1f} s")
    return dict(launches=dict(got, accel_stage=launches.get("accel_stage",
                                                            0)),
                wall_s=wall, stages=stages, cmds_s=cmds_s,
                phase_s=phase_s, top_spans={n: roll[n]["seconds"]
                                            for n in top},
                # the profile's parse runs beside phase 13
                profile_check=start_profile_check(started["prof_dir"],
                                                  launches, "phase 12"))


#: phase 13's mesh: four logical shards of the one card
MESH_SHARDS = 4
#: phase 13 (b) searches this many passes of the plan's first step
#: (ds 1, 28 passes) on the seq route: each is held to (a)'s artifact
MESH_SEQ_PASSES = 8


def _cand_key(c) -> tuple:
    return (round(c.r, 2), round(c.z, 2), c.numharm, round(c.dm, 3))


def _event_set(ev) -> set:
    return {(round(float(e["dm"]), 3), int(e["sample"]), int(e["downfact"]))
            for e in ev}


def same_search(got: tuple, want: tuple, what: str) -> None:
    """The rule the reference holds its own mesh to
    (tests/test_parallel.py): the sifted candidates' keys (r and z to 2
    decimals, numharm, DM to 3) equal, each sigma within rel 1e-3, the
    SP event sets (DM, sample, downfact) equal, the trial count equal.
    got and want are (candidates, sp_events, num_dm_trials)."""
    (gc, ge, gn), (wc, we, wn) = got, want
    if gn != wn:
        raise AssertionError(f"{what}: {gn} DM trials against {wn}")
    gk, wk = {_cand_key(c) for c in gc}, {_cand_key(c) for c in wc}
    if gk != wk:
        raise AssertionError(f"{what}: candidate keys differ: only here "
                             f"{sorted(gk - wk)[:5]}, only there "
                             f"{sorted(wk - gk)[:5]}")
    by_key = {_cand_key(c): c.sigma for c in wc}
    worst = max((abs(c.sigma / by_key[_cand_key(c)] - 1.0) for c in gc),
                default=0.0)
    if worst > 1e-3:
        raise AssertionError(f"{what}: a sigma {worst:.2e} off (rel)")
    gs, ws = _event_set(ge), _event_set(we)
    if gs != ws:
        raise AssertionError(f"{what}: SP events differ: only here "
                             f"{sorted(gs - ws)[:5]}, only there "
                             f"{sorted(ws - gs)[:5]}")
    log(f"{what}: {len(gk)} candidate keys, {len(gs)} SP events and {gn} "
        f"trials equal; worst sigma {worst:.3e} (rel)")


def same_passes(ck_a: str, ck_b: str, npass: int, what: str) -> int:
    """Passes 0..npass-1 of two checkpoints held to each other by
    same_search's rule: a byte-identical pair of artifacts holds it
    outright; the passes whose bytes differ are decoded and compared
    together.  Returns the number of byte-identical passes."""
    ents = [ckpt.read_manifest(ck)["entries"] for ck in (ck_a, ck_b)]
    differ = [f"pass_{k:04d}" for k in range(npass)
              if ents[0][f"pass_{k:04d}"]["sha256"]
              != ents[1][f"pass_{k:04d}"]["sha256"]]

    def decoded(ck, entries) -> tuple:
        parts = []
        for key in differ:
            with open(os.path.join(ck, entries[key]["file"]), "rb") as fh:
                parts.append(executor._decode_pass(fh.read()))
        return ([c for cs, _e, _n in parts for c in cs],
                [e for _c, ev, _n in parts for e in ev],
                sum(n for _c, _e, n in parts))

    if differ:
        same_search(decoded(ck_a, ents[0]), decoded(ck_b, ents[1]),
                    f"{what}: the {len(differ)} passes whose artifacts "
                    f"differ in bytes")
    return npass - len(differ)


def mesh_chunks(plan, nsamp: int, n_dm: int) -> list[tuple]:
    """(step, pass, chunk, first trial of each chunk) for every pass of
    the mesh search of a beam of nsamp samples: the executor's own
    chunk rule (executor._sharded_chunks, the hi stage sharded) over
    each pass's trials padded to the dm axis."""
    nz = len(executor._get_bank(PARAMS.hi_accel_zmax).zs)
    out = []
    for step in plan:
        nbins = ddplan.choose_n(nsamp // step.downsamp) // 2 + 1
        for ppass in step.passes():
            ndms_pad = -(-len(ppass.dms) // n_dm) * n_dm
            chunk, starts = executor._sharded_chunks(
                PARAMS, n_dm, ndms_pad, nbins, nz, True, DEV)
            out.append((step, ppass, chunk, starts))
    return out


def mesh_launches(plan, nsamp: int, n_dm: int, out) -> dict:
    """The launches the mesh search of a beam of nsamp samples makes:
    stage 2 once a shard a DM chunk of each pass (mesh_chunks) plus
    one row a DM group refined; stage 1 once a pass, once a group
    refined and once an originating pass of the folds."""
    passes = mesh_chunks(plan, nsamp, n_dm)
    s2 = sum(n_dm * len(starts) for _s, _p, _c, starts in passes)
    nref = len(out.refined_dms)
    folds = len({fold_batch.pass_of(plan, c.dm)
                 for c in out.candidates[:len(out.folded)]})
    return {"form_subbands": len(passes) + nref + folds,
            "dedisperse_subbands": s2 + nref}


@contextlib.contextmanager
def _counting(mod, name: str, calls: dict):
    """Count the calls of mod.name in calls[name] while the block runs
    (callers that look the function up on its module at call time)."""
    fn = getattr(mod, name)
    calls[name] = 0

    def counted(*a, **kw):
        calls[name] += 1
        return fn(*a, **kw)

    setattr(mod, name, counted)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


def dd_local_entries(data, freqs, dt: float, nsub: int, plan,
                     nsamp: int) -> list[dict]:
    """Phase 13 (c): _dd_local at the shapes the mesh path launches it.
    For the first pass of each plan step: its stage-2 table padded to
    the dm axis (shard_dm_table), cut by the executor's chunk rule
    (mesh_chunks), each chunk's table split over the shards.  Every
    launch is torch.equal to the plain version and to the solo launch
    of the padded table at the same rows; the pass's launches are
    timed as one sequence against one solo launch of the pass's table
    and the bound (the subbands read once, every launched row written
    once), their plain versions by the comparison's own calls.  Each
    entry carries the launches of its step on the beam (its passes'
    chunks times the shards)."""
    from tpulsar_torch.parallel import mesh as pmesh

    entries = []
    for step in plan:
        per_pass = mesh_chunks([step], nsamp, MESH_SHARDS)
        _s, p, chunk, starts = per_pass[0]
        dms = np.asarray(p.dms)
        chan_shifts, sub_shifts = dd.plan_pass_shifts(
            freqs, nsub, p.subdm, dms, dt, step.downsamp)
        subb = dd.form_subbands(data, chan_shifts, nsub, step.downsamp)
        nsub_, T = subb.shape
        if T != nsamp // step.downsamp:
            raise AssertionError(f"phase 13 (c): ds {step.downsamp} "
                                 f"subbands of {T} samples")
        padded = pmesh.shard_dm_table(np.asarray(sub_shifts), MESH_SHARDS)
        rows = chunk // MESH_SHARDS
        tables = [t for s0 in starts
                  for t in np.split(padded[s0:s0 + chunk], MESH_SHARDS)]
        firsts = [s0 + i * rows for s0 in starts
                  for i in range(MESH_SHARDS)]
        solo = cuda_dd.dedisperse_subbands(subb, padded)
        n0 = cuda_dd.LAUNCHES["dedisperse_subbands"]
        got = [pmesh._dd_local(subb, t) for t in tables]
        n_c = cuda_dd.LAUNCHES["dedisperse_subbands"] - n0
        if n_c != len(tables):
            raise AssertionError(f"phase 13 (c): ds {step.downsamp}: "
                                 f"{n_c} launches for {len(tables)} "
                                 f"shard tables")
        plains, plain_ms = once_ms(lambda: [
            cuda_dd.dedisperse_subbands_plain(subb, t) for t in tables])
        for k, (out, want, f) in enumerate(zip(got, plains, firsts)):
            if not torch.equal(out, solo[f:f + rows]) or not torch.equal(
                    out, want):
                raise AssertionError(
                    f"phase 13 (c): ds {step.downsamp} launch {k} (rows "
                    f"{f}..{f + rows - 1}) differs from the solo launch "
                    f"or the plain version")
        del got, solo, plains
        ms = time_ms(lambda: [pmesh._dd_local(subb, t) for t in tables])
        solo_ms = time_ms(lambda: cuda_dd.dedisperse_subbands(subb,
                                                              sub_shifts))
        nrows = len(tables) * rows
        b_ms, b_by = bound_ms(4.0 * (nsub_ * T + nrows * T),
                              float(nrows) * nsub_ * T)
        launches = sum(MESH_SHARDS * len(st) for _s, _p, _c, st in per_pass)
        entries.append(dict(
            ds=step.downsamp, trials=len(dms), rows=rows,
            chunk_starts=list(starts), launches_a_pass=len(tables),
            launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            solo_ms=solo_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"phase 13 (c) ds {step.downsamp}: {len(dms)} trials as "
            f"{len(starts)} chunks (first trials {list(starts)}) x "
            f"{MESH_SHARDS} shards = {len(tables)} launches of {rows} rows, "
            f"each torch.equal to the plain version and to the solo "
            f"launch's rows; {ms:.3f} ms the pass's launches (one solo "
            f"launch of its {len(dms)} rows {solo_ms:.3f} ms), plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), share "
            f"{b_ms / ms:.3f}; {launches} launches a beam")
        del subb
    return entries


def mesh_phase(tmp: str, plan, p7: dict) -> dict:
    """Phase 13: the parallel layer on phase 7's beam, on a mesh of
    MESH_SHARDS logical shards of the card, held against phase 7's
    solo search.  (a) search_beam(mesh=) at the default configuration:
    the solo search's results by the reference's rule, the pulsar
    folded, the hi stage sharded, the launches the plan gives, peak
    memory beside the solo's; (b) search_block over the plan's first
    step (ds 1) with seq_shard "on", every chunk through the seq
    route, each pass's checkpoint artifact equal by that rule to (a)'s
    (DM-sharded: "auto" shards no pass of this beam by time), and
    seq_dedisperse of pass 0 torch.equal to one solo stage-2 launch;
    (c) _dd_local at the shapes the mesh path launches it
    (dd_local_entries), summed over the beam and held to (a)'s
    launches; (d) dist_fft_natural of 2^21 points against
    torch.fft.fft, and seq_dist_search (a spectral budget below one
    trial's tail) on the ds-1 pass of the pulsar's DM, whose
    candidates must hold the fundamental within one Fourier bin."""
    from tpulsar_torch.parallel import dist_fft
    from tpulsar_torch.parallel import mesh as pmesh
    from tpulsar_torch.parallel import seq_dedisperse as pseq
    from tpulsar_torch.search.report import StageTimers

    solo, fns, nsamp = p7["solo"], p7["fns"], p7["nsamp"]
    ref = solo["outcome"]
    mesh = pmesh.make_mesh(1, MESH_SHARDS, devices=[DEV] * MESH_SHARDS)
    log(f"phase 13: {mesh} on phase 7's beam ({nsamp} samples)")
    # an earlier phase may leave the batched hi path pinned or a fault
    # armed: either would send the mesh's hi stage to the fallback
    accel._reset_batch_state()
    faults.reset()
    os.environ.pop("TPULSAR_FAULTS", None)
    res: dict = {}

    # (a) the main path on the mesh, with a checkpoint directory as
    # phase 7's solo search: its pass artifacts are (b)'s DM-sharded
    # side.  seq_shard "auto" shards no pass of this beam by time (the
    # largest subband block is below seq_shard_min_bytes)
    sub_bytes = 4 * PARAMS.nsub * nsamp
    if sub_bytes > PARAMS.seq_shard_min_bytes:
        raise AssertionError(f"phase 13: {sub_bytes} B of ds-1 subbands "
                             f"would take the seq route under 'auto'")
    ck_mesh = os.path.join(tmp, "mesh_ck")
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    cuda_dd.reset_counts()
    out = executor.search_beam(
        fns, os.path.join(tmp, "mesh_work"),
        os.path.join(tmp, "mesh_results"), PARAMS, zaplist=ZAPLIST,
        checkpoint_dir=ck_mesh, mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: cuda_dd.LAUNCHES[k] for k in SOLO_KERNELS}
    stage_launches = cuda_dd.LAUNCHES["accel_stage"]
    peak = torch.cuda.max_memory_allocated()
    snap, prov = degraded.snapshot(), degraded.provenance_snapshot()
    if snap or prov:
        raise AssertionError(f"phase 13 (a): degraded flags {snap} {prov} "
                             f"(the hi stage must run sharded)")
    same_search((out.candidates, out.sp_events, out.num_dm_trials),
                (ref.candidates, ref.sp_events, ref.num_dm_trials),
                "phase 13 (a) mesh vs phase 7 solo")
    check_pulsar(out.resultsdir, out.basenm, "phase 13 (a)")
    want = mesh_launches(plan, nsamp, MESH_SHARDS, out)
    if launches != want or min(launches.values()) < 1:
        raise AssertionError(f"phase 13 (a): launches {launches} != "
                             f"expected {want}")
    log(f"phase 13 (a): launches {launches} (the plan's: stage 2 "
        f"{MESH_SHARDS} a DM chunk + {len(out.refined_dms)} refinement "
        f"rows; stage 1 passes + refinement + folds); peak device memory "
        f"{peak / 2**30:.3f} GiB against the solo's "
        f"{solo['peak_bytes'] / 2**30:.3f} GiB "
        f"({peak / solo['peak_bytes']:.3f}x)")
    if peak > 1.1 * solo["peak_bytes"]:
        raise AssertionError("phase 13 (a): the mesh's peak memory is "
                             "more than 10% above the solo search's")
    stages = dict(out.timers.times)
    log(f"phase 13 (a) wall {wall:.3f} s (search_beam; phase 7's solo "
        f"{solo['wall_s']:.3f} s); stage seconds "
        + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    res.update(launches=dict(launches, accel_stage=stage_launches),
               want=want, wall_a=wall, peak_bytes=peak, stages=stages)

    # the quarter beam's masked block, as search_beam reads it
    _obj, si, basenm, _plan, nsub, baryv, _id = executor._beam_geometry(
        fns, PARAMS, None, None)
    os.makedirs(os.path.join(tmp, "mesh_block"))
    data, _mask = executor._read_and_mask(
        si, PARAMS, basenm, os.path.join(tmp, "mesh_block"), None,
        StageTimers(), DEV)

    # (b) the sequence-parallel route against the DM-sharded one: the
    # first MESH_SEQ_PASSES passes of the plan's first step searched
    # with seq_shard "on", each pass's artifact against (a)'s pass (the
    # same passes, DM-sharded).  Every
    # chunk must take the seq route: a fallback to replication (only a
    # warning in the executor) is an error here, and seq_dedisperse is
    # called once a chunk while no shard calls _dd_local
    t0 = time.time()
    ck_seq = os.path.join(tmp, "mesh_seq_ck")
    seq_plan = [dataclasses.replace(plan[0], numpasses=MESH_SEQ_PASSES)]
    calls: dict = {}
    with warnings.catch_warnings(), \
            _counting(pseq, "seq_dedisperse", calls), \
            _counting(pmesh, "_dd_local", calls):
        warnings.filterwarnings("error", message=".*cannot be honoured")
        _c, _f, _ev, n = executor.search_block(
            data, si.freqs, si.dt, seq_plan, dataclasses.replace(
                PARAMS, refine_cands=False, max_cands_to_fold=0,
                seq_shard="on"), zaplist=ZAPLIST, baryv=baryv, nsub=nsub,
            checkpoint_dir=ck_seq, mesh=mesh, device="cuda")
    want_seq = sum(len(st) for _s, _p, _c, st
                   in mesh_chunks(seq_plan, nsamp, MESH_SHARDS))
    if calls != {"seq_dedisperse": want_seq, "_dd_local": 0}:
        raise AssertionError(f"phase 13 (b): calls {calls}: every one of "
                             f"the {want_seq} chunks must take the seq "
                             f"route")
    npass0 = MESH_SEQ_PASSES
    same_bytes = same_passes(
        ck_seq, ck_mesh, npass0, f"phase 13 (b) seq_shard on vs "
        f"DM-sharded (a), passes 0-{npass0 - 1} (ds 1)")
    if n != seq_plan[0].numdms:
        raise AssertionError(f"phase 13 (b): {n} trials")
    log(f"phase 13 (b): passes 0-{npass0 - 1} ({n} trials) with "
        f"seq_shard on: every one of the {want_seq} chunks through "
        f"seq_dedisperse (no _dd_local, no fallback); {same_bytes} of "
        f"{npass0} pass artifacts byte-identical to (a)'s, the rest equal "
        f"by the rule")
    p0 = plan[0].passes()[0]
    chan_shifts, sub_shifts = dd.plan_pass_shifts(
        si.freqs, nsub, p0.subdm, np.asarray(p0.dms), si.dt, 1)
    subb = dd.form_subbands(data, chan_shifts, nsub, 1)
    solo_rows = cuda_dd.dedisperse_subbands(subb, sub_shifts)
    n0 = cuda_dd.LAUNCHES["dedisperse_subbands"]
    seq_rows = torch.cat(pseq.seq_dedisperse(subb, sub_shifts, mesh),
                         dim=1)
    n_seq = cuda_dd.LAUNCHES["dedisperse_subbands"] - n0
    if not torch.equal(seq_rows, solo_rows) or n_seq != MESH_SHARDS:
        raise AssertionError(f"phase 13 (b): seq_dedisperse of pass 0 "
                             f"equal {torch.equal(seq_rows, solo_rows)}, "
                             f"{n_seq} launches")
    res["wall_b"] = time.time() - t0
    log(f"phase 13 (b): seq_dedisperse of pass 0 ({tuple(subb.shape)} "
        f"subbands, {len(p0.dms)} rows) torch.equal to one solo launch, "
        f"{n_seq} launches (a window a shard); wall {res['wall_b']:.3f} s")
    del seq_rows, solo_rows, subb

    # (c) the stage-2 kernel in its new caller, at the mesh path's shapes
    t0 = time.time()
    entries = dd_local_entries(data, si.freqs, si.dt, nsub, plan, nsamp)
    per_beam = {k: sum(e["launches"] * e[k] / e["launches_a_pass"]
                       for e in entries)
                for k in ("ms", "plain_ms", "bound_ms")}
    n_beam = sum(e["launches"] for e in entries)
    if n_beam + len(out.refined_dms) != launches["dedisperse_subbands"]:
        raise AssertionError(f"phase 13 (c): the shapes carry {n_beam} "
                             f"launches + {len(out.refined_dms)} refinement "
                             f"rows, (a) made "
                             f"{launches['dedisperse_subbands']}")
    by = {e["bound_by"] for e in entries}
    res["c"] = dict(per="beam", route="_dd_local", shards=MESH_SHARDS,
                    launches=n_beam, max_abs_err=0.0,
                    bound_by=by.pop() if len(by) == 1 else "bytes",
                    shapes=entries, **per_beam)
    res["wall_c"] = time.time() - t0
    log(f"phase 13 (c): per beam on the mesh, {n_beam} launches of "
        f"_dd_local: {per_beam['ms']:.3f} ms, plain "
        f"{per_beam['plain_ms']:.3f} ms, bound {per_beam['bound_ms']:.3f} "
        f"ms, share {per_beam['bound_ms'] / per_beam['ms']:.3f}; wall "
        f"{res['wall_c']:.3f} s")

    # (d) the distributed FFT and the distributed spectral pass
    t0 = time.time()
    gen = torch.Generator().manual_seed(21)
    N = 1 << 21
    x = torch.complex(torch.randn(N, generator=gen),
                      torch.randn(N, generator=gen)).numpy()
    td = time.perf_counter()
    got = dist_fft.dist_fft_natural(x, mesh)
    dist_s = time.perf_counter() - td
    xd = torch.from_numpy(x).to(DEV)
    full = torch.fft.fft(xd).cpu().numpy()
    fft_ms = time_ms(lambda: torch.fft.fft(xd))
    err = float(np.max(np.abs(got - full)) / np.max(np.abs(full)))
    if not err < 1e-4:
        raise AssertionError(f"phase 13 (d): dist_fft_natural's relative "
                             f"max-norm error {err:.3e} >= 1e-4")
    log(f"phase 13 (d): dist_fft_natural of 2^21 points on "
        f"{MESH_SHARDS} shards: relative max-norm error {err:.3e} "
        f"against torch.fft.fft (< 1e-4); {dist_s * 1e3:.3f} ms host in/out "
        f"against {fft_ms:.3f} ms for one torch.fft.fft on the card")
    # the ds-1 pass holding the pulsar's DM, through the executor's
    # sharded pass with a budget one byte below a trial's spectral tail
    p_psr = next(pp for pp in plan[0].passes() if pp.dms[-1] >= PSR_DM)
    dms = np.asarray(p_psr.dms)
    chan_shifts, sub_shifts = dd.plan_pass_shifts(
        si.freqs, nsub, p_psr.subdm, dms, si.dt, 1)
    subb = dd.form_subbands(data, chan_shifts, nsub, 1)
    nfft = ddplan.choose_n(subb.shape[1])
    budget = dist_fft.spectral_bytes_per_trial(nfft) - 1
    params = executor.SearchParams(
        make_plots=False, run_hi_accel=False, seq_shard="on",
        spectral_hbm_budget=budget)
    degraded.reset()
    td = time.time()
    cands, ev = executor._search_pass_sharded(
        mesh, subb, sub_shifts, dms, si.dt, params, None, 0.0)
    dist_pass_s = time.time() - td
    if "seq_dist_spectral" not in degraded.snapshot():
        raise AssertionError(f"phase 13 (d): the pass did not take the "
                             f"distributed spectral route: "
                             f"{degraded.snapshot()}")
    # its candidates before sifting (which drops the fundamental as a
    # subharmonic of the stronger second harmonic, unscalloped at an
    # integer bin)
    f_bin = 1.0 / (nfft * si.dt)
    hits = [c for c in cands if c.numharm == 1
            and abs(c.freq_hz - 1.0 / PSR_PERIOD) <= f_bin]
    if not hits:
        raise AssertionError(
            f"phase 13 (d): seq_dist_search: no candidate within one bin "
            f"({f_bin:.5f} Hz) of {1 / PSR_PERIOD} Hz: "
            f"{[(c.freq_hz, c.dm, c.sigma) for c in cands[:5]]}")
    best = max(hits, key=lambda c: c.sigma)
    res["wall_d"] = time.time() - t0
    log(f"phase 13 (d): seq_dist_search of DMs {dms[0]}-{dms[-1]} (budget "
        f"{budget} B, one below a trial's tail): the fundamental at "
        f"{best.freq_hz:.6f} Hz (DM {best.dm}, sigma {best.sigma:.2f}; "
        f"{abs(best.freq_hz - 1 / PSR_PERIOD) / f_bin:.3f} bins off), "
        f"{len(cands)} candidates, {len(ev)} SP events, "
        f"{dist_pass_s:.3f} s; wall {res['wall_d']:.3f} s")
    res.update(dist_fft_err=err, dist_fft_s=dist_s, fft_ms=fft_ms,
               dist_pass_s=dist_pass_s)
    return res


def report_stages(path: str) -> dict:
    """Stage seconds of a beam's .report (its 'Total time' as
    'total')."""
    out = {}
    with open(path) as fh:
        for line in fh:
            m = re.match(r"\s*(Total time|[\w-]+): +([\d.]+) s", line)
            if m:
                out["total" if m.group(1) == "Total time"
                    else m.group(1)] = float(m.group(2))
    return out


def read_phase(fns: list[str]) -> dict:
    """read_all_uint8 of the beam through the native unpack and through
    the NumPy unpack (the file just written is in the page cache for
    both): byte-identical blocks and affine maps, the unpack counter
    naming the path that ran, and each read's seconds."""
    reads = {}
    for unpack in ("native", "numpy"):
        psrfits.reset_counts()
        t0 = time.time()
        got = psrfits.SpectraInfo(fns, unpack=unpack).read_all_uint8()
        reads[unpack] = (time.time() - t0, got)
        other = "numpy" if unpack == "native" else "native"
        if psrfits.UNPACKS[unpack] < 1 or psrfits.UNPACKS[other] != 0:
            raise AssertionError(f"read ({unpack}): unpack counts "
                                 f"{psrfits.UNPACKS}")
    for name, a, b in zip(("block", "scale", "offset"),
                          reads["native"][1], reads["numpy"][1]):
        if not np.array_equal(a, b):
            raise AssertionError(f"read: the native and NumPy reads' "
                                 f"{name}s differ "
                                 f"({int(np.count_nonzero(a != b))} values)")
    nat, npy = reads["native"][0], reads["numpy"][0]
    del reads
    log(f"read_all_uint8 of the beam: native unpack {nat:.3f} s, NumPy "
        f"unpack {npy:.3f} s (NumPy / native {npy / nat:.2f}x); blocks, "
        f"scales and offsets byte-identical; unpack counts name the path")
    return dict(native_s=nat, numpy_s=npy)


def _passes(plan) -> list:
    return [pp for s in plan for pp in s.passes()]


def slice_phase(nsamp: int) -> dict:
    """Phase 4 on one synthesized beam, then phase 7 on a shorter one
    of its own, and the read phase and phases 5 (both beside phase 7's
    server), 6, 11 (which holds the fleet's checks), 9, 12 and 13 on
    that shorter beam."""
    tmp = tempfile.mkdtemp(prefix="tpulsar_torch_smoke_")
    p4: dict = {}
    try:
        fns = write_beam(os.path.join(tmp, "beam"), nsamp)
        plan = ddplan.survey_plan("pdev")
        mark("phase 4: the full beam")
        p4.update(main_path_phase(fns, tmp, nsamp, plan))
        mark("phase 4: config 3 search (phase 4's beam)")
        p4["cfg3"] = cfg3_search_phase(fns, tmp, nsamp)
        mark("phase 7: batch")
        p7 = batch_start(tmp, plan)
        try:
            # the read and phase 5 run in this process beside phase 7's
            # server: they read the beam and the solo's checkpoint only
            mark("read (phase 7's beam, beside phase 7's server)")
            p4["read"] = read_phase(p7["fns"])
            mark("phase 5: resume (phase 7's beam, beside phase 7's "
                 "server)")
            p4["resume"] = resume_phase(p7["fns"], tmp, p7["nsamp"],
                                        plan, p7["solo"])
        except BaseException:
            p7["server"]["proc"].kill()
            p7["server"]["proc"].wait()
            raise
        mark("phase 7: the batch's server and checks")
        p4["batch"] = p7 = batch_finish(p7, plan)
        mark("phase 6: serve through the front door")
        p4["serve"] = serve_phase(p7["fns"], tmp, p7["solo"])
        mark("phase 11: chaos (and the fleet's checks)")
        p4["chaos"] = chaos_phase(tmp, plan, p7)
        # phase 12's `search` reads phase 7's beam and solo checkpoint
        # only: it runs beside phase 9
        mark("phase 12: `search` started")
        ops = ops_search_start(tmp, p7)
        try:
            mark("phase 9: pipeline (beside phase 12's `search`)")
            p4["pipeline"] = pipeline_phase(tmp, plan, p7)
        except BaseException:
            ops["proc"].kill()
            ops["proc"].wait()
            raise
        mark("phase 12: operator surface")
        p4["ops"] = ops_phase(tmp, plan, p7, p4["chaos"], ops)
        mark("phase 13: mesh")
        p4["mesh"] = mesh_phase(tmp, plan, p7)
        ops = p4["ops"]
        ops["profile"] = prof = finish_profile_check(
            ops.pop("profile_check"), "phase 12")
        log(f"phase 12 (checked beside phase 13): the profile "
            f"{prof['file']} ({prof['bytes']} bytes, {prof['events']} "
            f"events, parsed in {prof['parse_s']:.3f} s) holds "
            f"search_block ({prof['search_block_ms']:.3f} ms) and kernel "
            f"events {prof['kernels']}, the wrappers' counts")
        return p4
    finally:
        proc = p4.get("ops", {}).get("profile_check")
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def kernel_rows(s1, s2, s2b, n1: dict, n2: dict,
                sk: list[dict]) -> list[dict]:
    """The kernels line: per shape the main path's launches at that
    shape, per beam the sums over those launches of each time (for
    the beam axis, per group of two BATCH_NSAMP beams at phase 7's
    shapes: its launches there are set by _batch_shapes_entries; for
    the hi stage's kernel, sk, the launches phase 4 made at each shape
    that stage_kernel_shapes checked)."""
    for x in s1:
        x["launches"] = n1.get(x["ds"], 0)
    for x in s2:
        x["launches"] = n2.get((x["rows"], x["ds"]), 0)
    rows = []
    for name, shapes, replaces in (
            ("form_subbands", s1,
             "tpulsar/kernels/pallas_dd.py:104 (_kernel_sb, pallas_call "
             "at :318)"),
            ("dedisperse_subbands", s2,
             "tpulsar/kernels/pallas_dd.py:68 (_kernel_roll, pallas_call "
             "at :205)"),
            ("dedisperse_subbands_beams", s2b,
             "tpulsar/kernels/pallas_dd.py:68 (_kernel_roll, pallas_call "
             "at :205), with the beam axis of "
             "tpulsar/kernels/beam_batch.py:248 (_dd_beams_scan_impl)"),
            ("accel_stage", sk,
             "no Pallas kernel: the hi stage's harmonic sums, z maxima "
             "and block maxima, XLA in the JAX package "
             "(tpulsar/kernels/accel.py::_harmonic_stage_maxes, the "
             "reduction half of tpulsar/kernels/fourier.py::"
             "blockmax_topk)")):
        tot = {k: sum(x["launches"] * x[k] for x in shapes)
               for k in ("ms", "plain_ms", "bound_ms")}
        by = {x["bound_by"] for x in shapes}
        log(f"per {'group of 2 beams' if shapes is s2b else 'beam'} "
            f"{name}: {tot['ms']:.3f} ms, plain "
            f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms, "
            f"share {tot['bound_ms'] / tot['ms']:.3f}")
        rows.append(dict(
            name=name, route="cuda",
            source=("tpulsar_torch/csrc/accel_stage.cu" if shapes is sk
                    else "tpulsar_torch/csrc/dedisperse.cu"),
            replaces=replaces,
            max_abs_err=max(x["max_abs_err"] for x in shapes),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=by.pop() if len(by) == 1 else "bytes",
            library_ms=None,
            per="2-beam group" if shapes is s2b else "beam",
            shapes=shapes))
    return rows


def main() -> None:
    t_smoke = time.time()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    aot = aot_phase()
    regs = aot.pop("regs")

    freqs = synth.channel_freqs(mock_spec(NSAMP))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    data = torch.randint(0, 256, (NCHAN, NSAMP), generator=gen,
                         device=DEV, dtype=torch.uint8)
    mark("phase 1: kernels")
    s1, s2, s2b, _rows_report = kernel_phase(data, freqs, regs)
    # the library phase 1 launched is the one the gate recorded
    if cuda_dd._lib._name != aot["programs"]["cuda_dd"]["library"]:
        raise AssertionError(f"phase 1 launched {cuda_dd._lib._name}, not "
                             f"the manifest's cuda_dd library "
                             f"{aot['programs']['cuda_dd']['library']}")
    mark("row statistics")
    aot["row_stats"] = row_stats_phase(data, freqs)
    mark("phase 2: hi stage")
    hi = hi_phase(data, freqs)
    mark("ladder")
    ladder = ladder_phase(hi)
    del hi
    log("ladder: " + json.dumps(ladder))
    mark("phase 2: config 3")
    cfg3 = cfg3_phase(data, freqs, regs)
    log("config 3: " + json.dumps(
        {k: v for k, v in cfg3.items() if k != "kernels"}))
    mark("tree")
    tree_phase(data, freqs)
    del data
    mark("phase 3: small parity")
    small_parity_phase()

    nsamp = int(os.environ.get("TPULSAR_SMOKE_NSAMP", NSAMP))
    if nsamp != NSAMP:
        log(f"NSAMP CUT: {nsamp} samples instead of {NSAMP} "
            f"(TPULSAR_SMOKE_NSAMP); channels, nsub and plan unchanged")
    mark("the beam")
    res = slice_phase(nsamp)
    mark("phase 8: stream")
    stream = stream_phase()
    mark("phase 4: the hi stage's kernel at the searches' shapes")
    plan = ddplan.survey_plan("pdev")
    ds_of = {ddplan.choose_n(nsamp // st.downsamp) // 2 + e: st.downsamp
             for st in plan for e in (0, 1)}
    sk = stage_kernel_shapes(res["accel_shapes"], PARAMS.hi_accel_zmax,
                             PARAMS.hi_accel_numharm, PARAMS.topk_per_stage,
                             ds_of, "phase 4")
    sk3 = stage_kernel_shapes(res["cfg3"]["accel_shapes"], CFG3_ZMAX,
                              CFG3_NUMHARM, CFG3_TOPK,
                              {ddplan.choose_n(nsamp) // 2 + e: 1
                               for e in (0, 1)}, "config 3 search")
    stage_kernel_limit_check()
    rows = kernel_rows(s1, s2, s2b, res["n1"], res["n2"], sk)
    for r in rows:
        # each path counted from 0: the full beam (phase 4), the
        # resumed search (phase 5), the served beam and the served
        # batch (phases 6 and 7, after each server's boot; on phase
        # 7's beam, BATCH_NSAMP long)
        name = r["name"]
        r["launches_resumed"] = res["resume"]["launches"].get(name, 0)
        r["launches_served"] = res["serve"]["launches"].get(name, 0)
        r["launches_batch"] = res["batch"]["launches"].get(name, 0)
        # the pipeline's job (phase 9): the retried attempt, counted
        # from its process start, and the killed first attempt's
        r["launches_pipeline"] = res["pipeline"]["launches"].get(name, 0)
        r["launches_pipeline_killed"] = res["pipeline"][
            "launches_first"].get(name, 0)
        # and the served stream session of phase 8 (after boot)
        r["launches_stream"] = stream["launches_served"].get(name, 0)
        # the mesh search of phase 13 (a): phase 7's beam on
        # MESH_SHARDS logical shards of the card
        r["launches_mesh"] = res["mesh"]["launches"].get(name, 0)
        # the fleet of the chaos storm: its surviving serve workers
        # (phase 11, after each boot), two quarter beams less the
        # resumed passes
        r["launches_chaos"] = res["chaos"]["launches"].get(name, 0)
        # `python -m tpulsar_torch search` (phase 12), from its process
        # start: phase 7's beam searched through the command
        r["launches_cli"] = res["ops"]["launches"].get(name, 0)
        solo_paths = ("launches", "launches_resumed", "launches_served",
                      "launches_batch", "launches_pipeline",
                      "launches_chaos", "launches_cli", "launches_mesh",
                      "launches_cfg3", "launches_cfg3_focused")
        if name in SOLO_KERNELS:
            # config 3: search_beam on phase 4's beam (phase 4's config
            # 3 search) and phase 2's dedisperse_pass of its 32 trials;
            # the kernel at config 3's shape with its launches there
            s3 = res["cfg3"]
            r["launches_cfg3"] = s3["launches"][name]
            r["launches_cfg3_focused"] = cfg3["launches"][name]
            entry, = [dict(k) for k in cfg3["kernels"] if k["name"] == name]
            entry["launches"] = (s3["n1"].get(1, 0)
                                 if name == "form_subbands" else
                                 s3["n2"].get((entry["rows"], 1), 0))
            r["cfg3"] = entry
        if name == "accel_stage":
            # every path that searches the hi stage on the card: not
            # the stream, which has none, nor the chaos storm's
            # survivors, whose takeover may find every search pass
            # done and run only the finishing (its count is reported);
            # config 3: phase 4's config 3 search, its shapes checked
            # as phase 4's
            r["launches"] = res["launches"][name]
            r["launches_cfg3"] = res["cfg3"]["launches"][name]
            r["cfg3"] = dict(shapes=sk3, launches=r["launches_cfg3"],
                             **{k: sum(x["launches"] * x[k] for x in sk3)
                                for k in ("ms", "plain_ms", "bound_ms")})
            paths = tuple(k for k in solo_paths if k not in (
                "launches_chaos", "launches_cfg3_focused"))
            per_shape = sum(x["launches"] for x in r["shapes"])
            if per_shape != r["launches"]:
                raise AssertionError(f"{name}: the checked shapes carry "
                                     f"{per_shape} launches, phase 4 "
                                     f"made {r['launches']}")
        elif name == "dedisperse_subbands":
            r["launches"] = res["launches"][name]
            paths = solo_paths + ("launches_stream",)
            # phase 13 (c): the kernel in its mesh caller, _dd_local,
            # at the mesh path's shapes, summed over the beam
            r["mesh"] = res["mesh"]["c"]
            r["stream"] = {k: v for k, v in stream.items()
                           if k not in ("launches", "launches_served")}
        elif name in SOLO_KERNELS:
            r["launches"] = res["launches"][name]
            paths = solo_paths
        else:
            r["launches"] = r["launches_batch"]
            r["batch_nsamp"] = res["batch"]["nsamp"]
            paths = ("launches_batch",)
            per_shape = sum(x["launches"] for x in r["shapes"])
            if per_shape != r["launches"]:
                raise AssertionError(f"{name}: phase 1's shapes carry "
                                     f"{per_shape} launches, phase 7 "
                                     f"made {r['launches']}")
        if min(r[k] for k in paths) < 1:
            raise AssertionError(f"{name} never launched on one of its "
                                 f"paths: {[(k, r[k]) for k in paths]}")
    log(f"smoke wall {time.time() - t_smoke:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"aot": aot}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
