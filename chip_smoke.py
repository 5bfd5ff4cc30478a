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


def kernel_phase(freqs: np.ndarray) -> list[dict]:
    """Each kernel against its plain version at the main path's
    shapes, exact; times and bounds."""
    plan = ddplan.survey_plan("pdev")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    data = torch.randint(0, 256, (NCHAN, NSAMP), generator=gen,
                         device=DEV, dtype=torch.uint8)
    rows = []

    # stage 1 at downsample 1 and 10, with the widest shifts of each
    # step (shifts > 0 reach the edge clamp at the series' end)
    s1 = {}
    for step in (plan[0], plan[-1]):
        ppass = step.passes()[-1]
        ch_sh, _ = dd.plan_pass_shifts(freqs, 96, ppass.subdm,
                                       np.asarray(ppass.dms), TSAMP,
                                       step.downsamp)
        ds = step.downsamp
        got = cuda_dd.form_subbands(data, ch_sh, 96, ds)
        want = cuda_dd.form_subbands_plain(data, ch_sh, 96, ds)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"stage-1 kernel differs from its plain "
                                 f"version at ds={ds}: max |err| {err}")
        ms = time_ms(lambda: cuda_dd.form_subbands(data, ch_sh, 96, ds))
        plain = time_ms(lambda: cuda_dd.form_subbands_plain(
            data, ch_sh, 96, ds), runs=5)
        nbytes = NCHAN * NSAMP + 96 * (NSAMP // ds) * 4 + NCHAN * 4
        b, by = bound_ms(nbytes, NCHAN * NSAMP)
        log(f"kernel form_subbands ds={ds}: exact (max|err| {err}), "
            f"max shift {int(ch_sh.max())}, {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {b:.4f} ms ({by})")
        s1[ds] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                      bound_ms=b, bound_by=by)
    del got, want
    rows.append(dict(
        name="form_subbands", route="cuda",
        source="tpulsar_torch/csrc/dedisperse.cu",
        replaces="tpulsar/kernels/pallas_dd.py:104 (_kernel_sb, "
                 "pallas_call at :318)",
        max_abs_err=max(v["max_abs_err"] for v in s1.values()),
        library_ms=None, **{k: s1[1][k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by")},
        ds10_ms=s1[10]["ms"], ds10_plain_ms=s1[10]["plain_ms"],
        ds10_bound_ms=s1[10]["bound_ms"]))

    # stage 2: nsub 96, 32 DM rows of the widest full-rate pass
    step = plan[0]
    ppass = step.passes()[-1]
    _, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm,
                                    np.asarray(ppass.dms), TSAMP, 1)
    sub_sh = sub_sh[-32:]
    subb = cuda_dd.form_subbands(data, dd.plan_pass_shifts(
        freqs, 96, ppass.subdm, np.asarray(ppass.dms), TSAMP, 1)[0],
        96, 1)
    del data
    got = cuda_dd.dedisperse_subbands(subb, sub_sh)
    want = cuda_dd.dedisperse_subbands_plain(subb, sub_sh)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"stage-2 kernel differs from its plain "
                             f"version: max |err| {err}")
    ms = time_ms(lambda: cuda_dd.dedisperse_subbands(subb, sub_sh))
    plain = time_ms(lambda: cuda_dd.dedisperse_subbands_plain(
        subb, sub_sh), runs=5)
    T = subb.shape[1]
    nbytes = (96 + 32) * T * 4 + sub_sh.size * 4
    b, by = bound_ms(nbytes, 32 * 96 * T)
    log(f"kernel dedisperse_subbands 32 rows x {T}: exact (max|err| "
        f"{err}), shifts {int(sub_sh.min())}..{int(sub_sh.max())}, "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by})")
    rows.append(dict(
        name="dedisperse_subbands", route="cuda",
        source="tpulsar_torch/csrc/dedisperse.cu",
        replaces="tpulsar/kernels/pallas_dd.py:68 (_kernel_roll, "
                 "pallas_call at :205)",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None))
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


def expected_launches(plan, nsamp: int, params) -> tuple[int, int]:
    npass = sum(s.numpasses for s in plan)
    n2 = 0
    for step in plan:
        nfft = ddplan.choose_n(nsamp // step.downsamp)
        for ppass in step.passes():
            ndms = len(ppass.dms)
            chunk = executor.pass_chunk_size(ndms, nfft, params)
            for lo in range(0, ndms, chunk):
                n2 += -(-min(chunk, ndms - lo) // cuda_dd.DM_ROWS)
    return npass, n2


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
        exp1, exp2 = expected_launches(plan, nsamp, params)
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
    for line in cuda_dd.BUILD_LOG.splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas: " + line.split("info    :")[-1].strip())

    freqs = synth.channel_freqs(mock_spec(NSAMP))
    rows = kernel_phase(freqs)
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
