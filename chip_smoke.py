#!/usr/bin/env python3
"""Smoke run of tpulsar_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from tpulsar_torch/csrc, holds each kernel
against its plain PyTorch version on the card at the shapes of the
main path, then searches one full-geometry PALFA Mock beam (960
channels, 65.476 us, 3,932,160 samples, 4-bit, the full 57-pass Mock
survey plan) written to a temporary directory with one injected
pulsar, through tpulsar_torch.search.executor.search_beam.  It checks
that the pulsar is recovered and that every kernel of the path was
launched as often as the plan requires.

Output: progress lines, then the card's name and power limit, one
JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}.  Any failure raises (non-zero exit,
no result line).  It needs a CUDA device and the rest of the
repository; it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
             "false); nothing was run")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpulsar_torch.io import accelcands, synth  # noqa: E402
from tpulsar_torch.kernels import cuda_dd  # noqa: E402
from tpulsar_torch.kernels import dedisperse as dd  # noqa: E402
from tpulsar_torch.plan import ddplan  # noqa: E402
from tpulsar_torch.search import executor  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores

#: the full Mock beam (bench.py geometry)
NCHAN, TSAMP, NSAMP = 960, 65.476e-6, 3_932_160
PSR_PERIOD, PSR_DM = 0.25, 50.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 7) -> float:
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
    registers (form_subbands<u8|f32>, dedisperse_subbands<R rows>)."""
    names = {"form_subbands_kernelIhE": "form_subbands<u8>",
             "form_subbands_kernelIfE": "form_subbands<f32>"}
    out, name, spill = {}, None, ""
    for line in build_log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            r = re.search(r"dedisperse_kernelILi(\d+)EE", m.group(1))
            name = (f"dedisperse_subbands<{r.group(1)} rows>" if r else
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


def plan_shapes(plan, nsamp: int, params) -> tuple[dict, dict]:
    """Launches per beam at each shape: stage 1 by downsample, stage 2
    by (DM rows, downsample), one stage-2 launch per DM chunk."""
    s1: dict = {}
    s2: dict = {}
    for step in plan:
        ds = step.downsamp
        nfft = ddplan.choose_n(nsamp // ds)
        for ppass in step.passes():
            s1[ds] = s1.get(ds, 0) + 1
            ndms = len(ppass.dms)
            chunk = executor.pass_chunk_size(ndms, nfft, params)
            for lo in range(0, ndms, chunk):
                key = (min(chunk, ndms - lo), ds)
                s2[key] = s2.get(key, 0) + 1
    return s1, s2


def kernel_phase(freqs: np.ndarray, regs: dict) -> list[dict]:
    """Each kernel against its plain version at every shape the Mock
    plan launches, exact; per shape the time, bound and share of the
    bound, and per beam the sums over the plan's launches."""
    plan = ddplan.survey_plan("pdev")
    n1, n2 = plan_shapes(plan, NSAMP, executor.SearchParams.slice_defaults())
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    data = torch.randint(0, 256, (NCHAN, NSAMP), generator=gen,
                         device=DEV, dtype=torch.uint8)
    s1, s2 = [], []
    for step in plan:
        # the step's last pass: its widest shifts (shifts > 0 reach the
        # edge clamp at the series' end)
        ds = step.downsamp
        ppass = step.passes()[-1]
        dms = np.asarray(ppass.dms)
        ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm, dms,
                                            TSAMP, ds)
        got = cuda_dd.form_subbands(data, ch_sh, 96, ds)
        want = cuda_dd.form_subbands_plain(data, ch_sh, 96, ds)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"stage-1 kernel differs from its plain "
                                 f"version at ds={ds}: max |err| {err}")
        del want
        ms = time_ms(lambda: cuda_dd.form_subbands(data, ch_sh, 96, ds))
        plain = time_ms(lambda: cuda_dd.form_subbands_plain(
            data, ch_sh, 96, ds), runs=3)
        nbytes = NCHAN * NSAMP + 96 * (NSAMP // ds) * 4 + NCHAN * 4
        b, by = bound_ms(nbytes, NCHAN * NSAMP)
        occ, smem = cuda_dd.stage1_occupancy(NCHAN, 96, ds, torch.uint8)
        log(f"kernel form_subbands ds={ds}: exact (max|err| {err}), "
            f"max shift {int(ch_sh.max())}, {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by}), share "
            f"{b / ms:.3f}, {n1[ds]} launches a beam; "
            f"{regs['form_subbands<u8>']} registers, {smem} B shared, "
            f"{occ} blocks/SM")
        s1.append(dict(ds=ds, launches=n1[ds], max_abs_err=err, ms=ms,
                       plain_ms=plain, bound_ms=b, bound_by=by,
                       registers=regs["form_subbands<u8>"],
                       smem_bytes=smem, blocks_per_sm=occ))

        # stage 2 on this pass's subbands: the pass's last DM chunk
        (nrows, _), = [k for k in n2 if k[1] == ds]
        rows_sh = sub_sh[-nrows:]
        launch = cuda_dd.stage2_launch(rows_sh)
        span = launch.span
        occ, smem = cuda_dd.stage2_occupancy(rows_sh)
        nreg = regs[f"dedisperse_subbands<{launch.rows} rows>"]
        got2 = cuda_dd.dedisperse_subbands(got, rows_sh)
        want2 = cuda_dd.dedisperse_subbands_plain(got, rows_sh)
        torch.cuda.synchronize()
        err = float((got2 - want2).abs().max())
        if not torch.equal(got2, want2):
            raise AssertionError(f"stage-2 kernel differs from its plain "
                                 f"version at {nrows} rows, ds={ds}: "
                                 f"max |err| {err}")
        del got2, want2
        ms = time_ms(lambda: cuda_dd.dedisperse_subbands(got, rows_sh))
        plain = time_ms(lambda: cuda_dd.dedisperse_subbands_plain(
            got, rows_sh), runs=3)
        T = got.shape[1]
        nbytes = (96 + nrows) * T * 4 + rows_sh.size * 4
        b, by = bound_ms(nbytes, nrows * 96 * T)
        log(f"kernel dedisperse_subbands {nrows} rows x {T} (ds={ds}): "
            f"exact (max|err| {err}), span {span}, {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by}), share "
            f"{b / ms:.3f}, {n2[(nrows, ds)]} launches a beam; "
            f"{launch.groups} groups of {launch.rows} rows, {nreg} "
            f"registers, {smem} B shared, {occ} blocks/SM")
        s2.append(dict(rows=nrows, ds=ds, span=span,
                       launches=n2[(nrows, ds)], max_abs_err=err, ms=ms,
                       plain_ms=plain, bound_ms=b, bound_by=by,
                       groups=launch.groups, group_rows=launch.rows,
                       registers=nreg, smem_bytes=smem, blocks_per_sm=occ))
        del got
    del data

    rows = []
    for name, shapes, replaces in (
            ("form_subbands", s1,
             "tpulsar/kernels/pallas_dd.py:104 (_kernel_sb, pallas_call "
             "at :318)"),
            ("dedisperse_subbands", s2,
             "tpulsar/kernels/pallas_dd.py:68 (_kernel_roll, pallas_call "
             "at :205)")):
        # per beam: sum over the plan's launches of each shape
        tot = {k: sum(x["launches"] * x[k] for x in shapes)
               for k in ("ms", "plain_ms", "bound_ms")}
        by = {x["bound_by"] for x in shapes}
        log(f"per beam {name}: {tot['ms']:.3f} ms, plain "
            f"{tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms, "
            f"share {tot['bound_ms'] / tot['ms']:.3f}")
        rows.append(dict(
            name=name, route="cuda",
            source="tpulsar_torch/csrc/dedisperse.cu", replaces=replaces,
            max_abs_err=max(x["max_abs_err"] for x in shapes),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=by.pop() if len(by) == 1 else "bytes",
            library_ms=None, per="beam", shapes=shapes))
    return rows


def small_parity_phase() -> None:
    """The whole slice on a small block, on the card and through the
    plain versions on the CPU: same trials, same top candidate."""
    rng = np.random.default_rng(2024)
    nchan, T, dt = 32, 1 << 15, 5e-4
    freqs = np.linspace(1214.0, 1536.0, nchan)
    data = rng.standard_normal((nchan, T)).astype(np.float32)
    t = np.arange(T) * dt
    delays = 4148.808 * 60.0 * (freqs ** -2.0 - freqs[-1] ** -2.0)
    for c in range(nchan):
        data[c] += ((((t - delays[c]) / 0.25) % 1.0) < 0.1) * 1.2
    plan = [ddplan.DedispStep(10.0, 5.0, 12, 1, 16, 1),
            ddplan.DedispStep(70.0, 10.0, 6, 1, 16, 2)]
    params = executor.SearchParams.slice_defaults(
        nsub=16, lo_accel_numharm=8, topk_per_stage=16)
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = executor.search_block(data, freqs, dt, plan, params,
                                         device=dev)
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
    log(f"small parity (cuda vs cpu plain): {len(g[0])} vs {len(c[0])} "
        f"candidates, top {a.freq_hz:.6f} Hz DM {a.dm} sigma "
        f"{a.sigma:.3f} vs {b.sigma:.3f}; {len(g[2])} vs {len(c[2])} "
        f"SP events")


def slice_phase(nsamp: int) -> dict:
    tmp = tempfile.mkdtemp(prefix="tpulsar_torch_smoke_")
    try:
        spec = mock_spec(nsamp)
        t0 = time.time()
        fns = synth.synth_beam_slabs(
            os.path.join(tmp, "beam"), spec,
            pulsars=[synth.PulsarSpec(period_s=PSR_PERIOD, dm=PSR_DM,
                                      width_frac=0.1,
                                      snr_per_sample=0.1)],
            device=DEV)
        t_write = time.time() - t0
        log(f"wrote {os.path.basename(fns[0])}: {NCHAN} ch x {nsamp} "
            f"samples, 4-bit, {os.path.getsize(fns[0]) / 1e9:.3f} GB in "
            f"{t_write:.1f} s")
        params = executor.SearchParams.slice_defaults()
        plan = ddplan.survey_plan("pdev")
        n1, n2 = plan_shapes(plan, nsamp, params)
        exp1, exp2 = sum(n1.values()), sum(n2.values())
        torch.cuda.reset_peak_memory_stats()
        cuda_dd.reset_counts()
        t0 = time.time()
        out = executor.search_beam(
            fns, os.path.join(tmp, "work"), os.path.join(tmp, "results"),
            params, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(cuda_dd.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        log(f"search_beam wall {wall:.3f} s; {out.num_dm_trials} DM "
            f"trials over {exp1} passes; peak device memory "
            f"{peak / 2**30:.3f} GiB; masked fraction "
            f"{out.masked_fraction:.4f}")
        stages = dict(out.timers.times)
        stages["other"] = wall - sum(stages.values())
        log("stage seconds: " + json.dumps(
            {k: round(v, 3) for k, v in stages.items()}))
        log(f"launches: {launches} (expected form_subbands {exp1}, "
            f"dedisperse_subbands {exp2})")
        if launches["form_subbands"] != exp1 or \
                launches["dedisperse_subbands"] != exp2:
            raise AssertionError(f"launch counts {launches} != expected "
                                 f"({exp1}, {exp2})")
        if not 0.0 <= out.masked_fraction < 0.2:
            raise AssertionError(f"masked fraction {out.masked_fraction} "
                                 f"on a beam of clean noise")
        if out.num_dm_trials != ddplan.total_dm_trials(plan):
            raise AssertionError("DM trial count differs from the plan")
        cands = accelcands.parse_candlist(os.path.join(
            out.resultsdir, f"{out.basenm}.accelcands"))
        hits = [c for c in cands
                if abs(c.period_s - PSR_PERIOD) / PSR_PERIOD < 1e-3
                and abs(c.dm - PSR_DM) < 5.0]
        if not hits:
            raise AssertionError(
                f"injected pulsar (P={PSR_PERIOD} s, DM={PSR_DM}) not in "
                f"the {len(cands)} .accelcands rows: "
                f"{[(c.period_s, c.dm, c.sigma) for c in cands[:5]]}")
        best = max(hits, key=lambda c: c.sigma)
        log(f"recovered the pulsar: P={best.period_s:.6f} s DM "
            f"{best.dm} sigma {best.sigma:.2f} numharm {best.numharm} "
            f"({len(cands)} candidates, {len(out.sp_events)} SP events)")
        return dict(launches=launches, wall_s=wall, peak_bytes=peak)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.time()
    path = cuda_dd.build(verbose_ptxas=True)
    log(f"built {os.path.relpath(path)} in {time.time() - t0:.2f} s")
    regs = ptxas_report(cuda_dd.BUILD_LOG)

    freqs = synth.channel_freqs(mock_spec(NSAMP))
    rows = kernel_phase(freqs, regs)
    small_parity_phase()

    nsamp = int(os.environ.get("TPULSAR_SMOKE_NSAMP", NSAMP))
    if nsamp != NSAMP:
        log(f"NSAMP CUT: {nsamp} samples instead of {NSAMP} "
            f"(TPULSAR_SMOKE_NSAMP); channels, nsub and plan unchanged")
    res = slice_phase(nsamp)
    for r in rows:
        r["launches"] = res["launches"][r["name"]]
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} never launched on the "
                                 f"main path")
    log(f"card: {card}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
