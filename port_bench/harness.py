"""The benchmark of tpulsar_torch: one cell's run, its check and its
metrics.

A run makes the cell's beam on the device from the seed, warms one
pass of each plan step, then calls
tpulsar_torch.search.executor.search_block on that resident beam over
the interleaved survey plan, one call after another, for the window's
seconds.  Each call has the configuration's SearchParams, the
packaged zaplist, a fresh checkpoint directory and a progress_cb that
timestamps each pass; the first pass (or call) to end after the
deadline closes the window, and a call that completes inside it
brings its sifting, refinement and folding in too.  The passes' checkpoint artifacts and each completed
call's sifted list are then held against the plain reference
(reference.py, compare.py), and the metrics the benchmark names for
the cell are read by the readers under metrics/.

Everything that belongs to one configuration, one traffic mix or one
metric is a file found by its name: configs/<config>.json,
traffic/<traffic>.json, metrics/<metric>.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench import beam as beam_mod
from port_bench import bounds, compare
from port_bench import plan as plan_mod
from port_bench import reference as ref

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpulsar")


# ------------------------------------------------------------- lookup

def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the workload `name`."""
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[0]
    cfgs = [c for c in bench["configs"] if c["name"] == cell["config"]]
    if len(cfgs) != 1:
        raise SystemExit(f"no configuration {cell['config']!r}")
    config = load_json(os.path.join(ROOT, cfgs[0]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, config, traffic


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones, or
    with trace the per-layer ones, that list the cell or list none."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    """metrics/<name>.py's read(ctx) -> number or None."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def parse_zaplist(path: str) -> np.ndarray:
    """(n, 2) rows of 'freq_Hz width_Hz'; '#' starts a comment."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#")[0].split()
            if line:
                rows.append((float(line[0]), float(line[1])))
    return np.asarray(rows, np.float64).reshape(-1, 2)


def packaged_zaplist(root: str = ROOT) -> np.ndarray:
    """The zaplist the per-beam job falls back to: the package's own."""
    return parse_zaplist(os.path.join(root, "tpulsar_torch", "data",
                                      "default.zaplist"))


def zap_keep(nbins: int, T_s: float, zaplist: np.ndarray) -> np.ndarray:
    """Keep-mask of rfft bins: each (freq, width) birdie drops bins
    floor((f - w/2) T) .. ceil((f + w/2) T) (baryv 0)."""
    keep = np.ones(nbins, bool)
    df = 1.0 / T_s
    for f, w in np.atleast_2d(zaplist):
        lo = max(int(np.floor((f - w / 2) / df)), 0)
        hi = min(int(np.ceil((f + w / 2) / df)) + 1, nbins)
        if hi > lo:
            keep[lo:hi] = False
    return keep


# ------------------------------------------------------- the program

def search_params(config: dict):
    """The configuration's SearchParams, every stated number passed."""
    from tpulsar_torch.search import executor, sifting

    s = config["search"]
    kw = dict(s["params"])
    kw["sp_widths"] = tuple(kw["sp_widths"])
    return executor.SearchParams(sifting=sifting.SiftParams(**s["sifting"]),
                                 **kw)


def program_plan(passes):
    from tpulsar_torch.plan import ddplan

    return [ddplan.DedispStep(*p.as_step_row()) for p in passes]


class WindowClosed(Exception):
    """Raised by progress_cb once the deadline has passed, and to end
    the traced slice's call after its passes."""


def _annotated_timers():
    """StageTimers whose every stage is also a profiler range, so a
    trace names the stage the host was in."""
    from tpulsar_torch.search.report import StageTimers

    class Annotated(StageTimers):
        @contextlib.contextmanager
        def timing(self, stage):
            with torch.profiler.record_function(stage), \
                    super().timing(stage):
                yield

    return Annotated()


@dataclasses.dataclass
class Call:
    ckdir: str
    passes: list = dataclasses.field(default_factory=list)  # (idx, t_end)
    final: list | None = None
    t_end: float | None = None
    counts: dict = dataclasses.field(default_factory=dict)
    raised: str = ""
    timers: object = None


class Slice:
    """The traced slice: once the window has closed, the first
    `npasses` passes of a fresh call under torch.profiler."""

    def __init__(self, npasses: int, device: torch.device):
        self.npasses = npasses
        self.device = device
        self.prof = None
        self.passes: list = []
        self.t0 = self.t1 = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is not None and self.t1 is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t1 = time.perf_counter()
            self.prof.stop()

    @property
    def done(self) -> bool:
        return self.t1 is not None


def run_window(block, freqs, dt, passes, params, zaplist, seconds,
               device, tmp, trace_passes: int = 0) -> dict:
    """The measured loop.  The window closes at the end of the first
    pass (or call) to end after the deadline: a call that completes
    inside it brings its sifting, refinement and folding in too.  With trace_passes, a
    fresh call then runs its first trace_passes passes under the
    profiler: the traced slice, outside the window.  Returns the
    calls, the window's bounds, the stage seconds at its close and the
    slice."""
    from tpulsar_torch.search import degraded, executor
    from tpulsar_torch.search.report import StageTimers

    plan = program_plan(passes)
    calls: list[Call] = []
    sl = Slice(trace_passes, device) if trace_passes else None
    win: dict = {"calls": calls, "slice": sl, "t1": None}
    t_w0 = time.perf_counter()
    win["t0"] = t_w0
    deadline = t_w0 + seconds

    def close(t: float) -> None:
        win["t1"] = t
        stage_s: dict = {}
        for c in calls:
            for k, v in c.timers.times.items():
                stage_s[k] = stage_s.get(k, 0.0) + v
        win["stage_s"] = stage_s

    while True:
        if win["t1"] is not None:
            if sl is None or sl.done:
                break
            if sl.prof is None:
                sl.start()
        call = Call(tempfile.mkdtemp(prefix="call", dir=tmp))
        call.timers = _annotated_timers() if sl else StageTimers()
        calls.append(call)

        def cb(info, call=call):
            t = time.perf_counter()
            idx = int(info["pass_idx"]) - 1
            if win["t1"] is None:
                call.passes.append((idx, t))
                call.counts = degraded.counts()
                if t >= deadline:
                    close(t)
                    raise WindowClosed
            else:
                sl.passes.append(idx)
                if len(sl.passes) >= sl.npasses:
                    sl.stop()
                    raise WindowClosed

        try:
            final, _folded, _sp, _n = executor.search_block(
                block, freqs, dt, plan, params, zaplist=zaplist,
                timers=call.timers, checkpoint_dir=call.ckdir,
                progress_cb=cb, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            if win["t1"] is None:
                call.final = final
                call.t_end = t
                call.counts = degraded.counts()
                if t >= deadline:
                    close(t)
        except WindowClosed:
            pass
        except Exception as exc:    # a pass that raised: its trials fail
            t = time.perf_counter()
            if win["t1"] is not None:
                raise
            call.raised = f"{type(exc).__name__}: {exc}"[:300]
            call.t_end = t
            if t >= deadline:
                close(t)
    return win


# -------------------------------------------------------------- check

def read_artifact(ckdir: str, pidx: int) -> dict | None:
    path = os.path.join(ckdir, f"pass_{pidx:04d}.npz")
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError):
        return None


def stated(config: dict) -> dict:
    s = config["search"]
    return {**s["params"], **s["stated"], "sifting": s["sifting"]}


@dataclasses.dataclass
class PassRef:
    p: plan_mod.Pass
    dms: np.ndarray
    nbins: int
    T_s: float
    sp: ref.SPRef
    wspec: torch.Tensor
    lo: dict


def reference_pass(block, freqs, dt, p, st, zaplist,
                   prec: ref.Prec = ref.F64) -> PassRef:
    """The reference's series, single-pulse and lo stage of pass p."""
    chan, sub = ref.pass_shifts(freqs, p.numsub, p.subdm, p.dms, dt,
                                p.downsamp)
    series = ref.dedisperse(block, chan, sub, p.numsub, p.downsamp)
    T = series.shape[1]
    nfft = bounds.choose_n(T)
    nbins = nfft // 2 + 1
    T_s = nfft * dt * p.downsamp
    keep = zap_keep(nbins, T_s, zaplist)
    spr = ref.sp_reference(series, st["sp_widths"], st["sp_topk"], prec)
    wspec = ref.whitened_spectrum(series, nfft, keep, prec)
    del series
    lo = ref.lo_reference(wspec, st["lo_accel_numharm"],
                          st["topk_per_stage"], prec)
    return PassRef(p, np.asarray(p.dms), nbins, T_s, spr, wspec, lo)


def _hi_on(st: dict) -> bool:
    return bool(st["run_hi_accel"]) and st["hi_accel_zmax"] > 0


def compare_pass(pr: PassRef, outputs: list[dict], st: dict,
                 hi_rows: list[int]) -> dict:
    """Gaps of each artifact of one pass against its reference."""
    thr = st["sifting"]["sigma_threshold"]
    out = {"sp_gap": 0.0, "lo_gap": 0.0, "compared": 0}
    hi = _hi_on(st)
    if hi:
        out["hi_gap"] = 0.0
    lo_ni = lambda h: ref.numindep_lo(pr.nbins, h)  # noqa: E731
    for art in outputs:
        g, n = compare.sp_gap(pr.sp, pr.dms, art["events"],
                              st["sp_threshold"])
        out["sp_gap"] = max(out["sp_gap"], g)
        out["compared"] += n
        cols = compare.cand_columns(art, pr.dms)
        if (cols["row"] < 0).any():
            out["lo_gap"] = float("inf")
            continue
        is_lo = cols["z"] == 0.0
        g, n = compare.cand_gap(pr.lo, np.arange(len(pr.dms)),
                                compare.select(cols, is_lo), lo_ni, thr)
        out["lo_gap"] = max(out["lo_gap"], g)
        out["compared"] += n
        if not hi and (~is_lo).any():
            out["lo_gap"] = float("inf")
    if hi:
        zs = ref.z_grid(st["hi_accel_zmax"])
        nz = len(zs)
        hi_ni = lambda h: ref.numindep_hi(pr.nbins, nz, h)  # noqa: E731
        for row in hi_rows:
            stages = ref.hi_reference(pr.wspec[row], st["hi_accel_zmax"],
                                      st["hi_accel_numharm"],
                                      st["topk_per_stage"])
            for art in outputs:
                cols = compare.cand_columns(art, pr.dms)
                m = (cols["z"] != 0.0) & (cols["row"] == row)
                g, n = compare.cand_gap(stages, np.asarray([row]),
                                        compare.select(cols, m), hi_ni,
                                        thr, hi=True, zs=zs)
                out["hi_gap"] = max(out["hi_gap"], g)
                out["compared"] += n
            del stages
    return out


def ref_outputs(pr: PassRef, st: dict, hi_rows: list[int],
                prec: ref.Prec) -> dict:
    """A reference's outputs of a pass in the artifact's layout: the
    control put in the program's place."""
    thr = st["sifting"]["sigma_threshold"]
    ev = ref.sp_events(pr.sp, st["sp_threshold"])
    events = np.zeros(len(ev), dtype=[("dm", "f8"), ("sigma", "f8"),
                                      ("time_s", "f8"), ("sample", "i8"),
                                      ("downfact", "i4")])
    for i, ((r, _b), (s, samp, w)) in enumerate(sorted(ev.items())):
        events[i] = (pr.dms[r], s, 0.0, samp, w)
    rows_, hs, bins, sig, zv = [], [], [], [], []

    def add(stages, row_ids, ni, hi):
        for h, stg in stages.items():
            p_thr = compare.power_for_sigma(thr, h, ni(h))
            rr, _bb, rb, pw = compare._ref_cands(stg, p_thr)
            z = np.zeros(len(rr))
            if hi and len(rr):
                za = stg.zarg[torch.as_tensor(rr, device=stg.zarg.device),
                              torch.as_tensor(rb, device=stg.zarg.device)]
                z = zs[za.cpu().numpy()]
                keep = np.abs(z) >= 1.0
                rr, rb, pw, z = rr[keep], rb[keep], pw[keep], z[keep]
            rows_.extend(np.asarray(row_ids)[rr])
            hs.extend([h] * len(rr))
            bins.extend(rb)
            sig.extend(ref.sigma_from_power(pw, h, ni(h)))
            zv.extend(z)

    add(pr.lo, np.arange(len(pr.dms)),
        lambda h: ref.numindep_lo(pr.nbins, h), False)
    if _hi_on(st):
        zs = ref.z_grid(st["hi_accel_zmax"])
        for row in hi_rows:
            stages = ref.hi_reference(pr.wspec[row], st["hi_accel_zmax"],
                                      st["hi_accel_numharm"],
                                      st["topk_per_stage"], prec)
            add(stages, [row], lambda h: ref.numindep_hi(
                pr.nbins, len(zs), h), True)
    r = np.asarray(bins, np.float64) * 0.5
    return {"events": events, "r": r, "z": np.asarray(zv, np.float64),
            "sigma": np.asarray(sig, np.float64),
            "numharm": np.asarray(hs, np.int64),
            "dm": pr.dms[np.asarray(rows_, np.int64)],
            "ntrials": np.int64(len(pr.dms))}


def choose_checks(passes, done: list[int], psr, seed: int,
                  npasses: int, strongest: int | None = None) -> list[int]:
    """The passes the reference recomputes, drawn from the seed among
    those completed: one of the longest series, the pulsar's pass when
    it completed, the pass `strongest` (the one with the window's
    strongest hi candidate), then others."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    done = sorted(set(done))
    if not done:
        return []
    ds_min = min(passes[i].downsamp for i in done)
    longest = [i for i in done if passes[i].downsamp == ds_min]
    pick = [int(rng.choice(longest))]
    for i in done:
        p = passes[i]
        if p.lodm <= psr.dm < p.lodm + p.dms_per_pass * p.dmstep \
                and i not in pick:
            pick.append(i)
    if strongest is not None and strongest in done \
            and strongest not in pick:
        pick.append(strongest)
    rest = [i for i in done if i not in pick]
    rng.shuffle(rest)
    return (pick + rest)[:max(npasses, len(pick))]


def pulsar_row(dms: np.ndarray, psr) -> list[int]:
    """The row nearest the pulsar's DM, where it lies within 1 of it."""
    near = int(np.abs(np.asarray(dms) - psr.dm).argmin())
    return [near] if abs(dms[near] - psr.dm) < 1.0 else []


def strongest_hi(by_pass: dict) -> tuple[float, int | None]:
    """(sigma, pass) of the strongest hi candidate (z != 0) the calls
    reported, over the passes of by_pass."""
    best = (-np.inf, None)
    for idx, arts in by_pass.items():
        for art in arts:
            m = np.asarray(art["z"]) != 0.0
            if m.any():
                s = float(np.asarray(art["sigma"])[m].max())
                if s > best[0]:
                    best = (s, idx)
    return best


def choose_hi_rows(pr: PassRef, outputs, rng, nrows: int,
                   psr=None) -> list[int]:
    """The row of the strongest hi candidate any call reported, the
    pulsar's row when the pass holds it, then rows drawn from the
    seed."""
    rows = []
    best = (-np.inf, None)
    for art in outputs:
        cols = compare.cand_columns(art, pr.dms)
        m = cols["z"] != 0.0
        if m.any():
            j = int(np.argmax(np.where(m, cols["sigma"], -np.inf)))
            if cols["sigma"][j] > best[0] and cols["row"][j] >= 0:
                best = (cols["sigma"][j], int(cols["row"][j]))
    if best[1] is not None:
        rows.append(best[1])
    if psr is not None:
        rows += [r for r in pulsar_row(pr.dms, psr) if r not in rows]
    others = [r for r in range(len(pr.dms)) if r not in rows]
    rng.shuffle(others)
    return rows + others[:nrows]


def candidates_of(arts: list[dict]) -> list[ref.Cand]:
    out = []
    for a in arts:
        cols = [a[f].tolist() for f in ("r", "z", "sigma", "power",
                                         "numharm", "dm", "period_s",
                                         "freq_hz")]
        for r, z, s, p, h, dm, per, f in zip(*cols):
            out.append(ref.Cand(float(r), float(z), float(s), float(p),
                                int(h), float(dm), float(per), float(f)))
    return out


def check(block, freqs, dt, passes, win, config, zaplist, psr,
          seed: int, counts: dict | None = None) -> dict:
    """Every number compared, over the passes the check draws.  counts,
    when given, receives what the window's passes reported."""
    st = stated(config)
    chk = config["check"]
    nums = {"outputs_missing": 0, "sp_gap": 0.0, "lo_gap": 0.0}
    if _hi_on(st):
        nums["hi_gap"] = 0.0
    by_pass: dict[int, list] = {}
    for c in win["calls"]:
        if c.raised:
            nums["outputs_missing"] += 1
        for idx, _t in c.passes:
            art = read_artifact(c.ckdir, idx)
            if art is None or int(art["ntrials"]) != passes[idx].ndms:
                nums["outputs_missing"] += 1
                continue
            by_pass.setdefault(idx, []).append(art)
            if counts is not None:
                counts["candidates"] = counts.get("candidates", 0) \
                    + len(art["r"])
                counts["events"] = counts.get("events", 0) \
                    + len(art["events"])
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    compared = 0
    strongest = strongest_hi(by_pass)[1] if _hi_on(st) else None
    for idx in choose_checks(passes, list(by_pass), psr, seed,
                             int(chk["passes"]), strongest):
        pr = reference_pass(block, freqs, dt, passes[idx], st, zaplist)
        rows = (choose_hi_rows(pr, by_pass[idx], rng, int(chk["hi_rows"]),
                               psr)
                if _hi_on(st) else [])
        g = compare_pass(pr, by_pass[idx], st, rows)
        compared += g.pop("compared")
        for k, v in g.items():
            nums[k] = max(nums[k], v)
        del pr
        if block.device.type == "cuda":
            torch.cuda.empty_cache()
    done = [c for c in win["calls"] if c.final is not None]
    if done:
        nums["sifted_mismatch"] = 0
        nfft = bounds.choose_n(block.shape[1])
        T_full = nfft * dt
        for c in done:
            arts = [read_artifact(c.ckdir, i) for i in range(len(passes))]
            if any(a is None for a in arts):
                nums["outputs_missing"] += 1
                continue
            want = ref.sift(candidates_of(arts), st["sifting"])
            for w in want:
                w.r = w.freq_hz * T_full
            nums["sifted_mismatch"] += compare.sifted_mismatch(
                c.final, want, bool(st["refine_cands"]))
    nums["compared"] = compared
    return nums


def verdict(nums: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]) — every number at or under its
    limit; a number with no limit fails."""
    rows, ok = [], True
    for k, v in nums.items():
        if k == "compared":
            continue
        lim = limits.get(k)
        good = lim is not None and np.isfinite(v) and v <= lim
        ok &= good
        rows.append((k, float(v), lim))
    return ok and nums.get("compared", 0) > 0, rows


# -------------------------------------------------------------- trace

def read_trace(sl: Slice, tmp: str) -> dict:
    """Device intervals and host ranges of the traced slice, from the
    profiler's Chrome trace."""
    path = os.path.join(tmp, "slice.pt.trace.json")
    sl.prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    os.remove(path)
    kern, ranges = [], []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kern.append((e["name"], float(e["ts"]), float(e["dur"])))
        elif cat == "user_annotation":
            ranges.append((e["name"], float(e["ts"]), float(e["dur"])))
    return {"kernels": kern, "ranges": ranges,
            "wall_s": sl.t1 - sl.t0, "passes": list(sl.passes)}


def busy_and_gaps(tr: dict) -> tuple[float, list]:
    """(seconds with a device op running, [(gap seconds, host range)])
    over the slice."""
    iv = sorted((ts, ts + d) for _n, ts, d in tr["kernels"])
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    gaps = []
    for (_a, b), (c, _d) in zip(merged, merged[1:]):
        mid = 0.5 * (b + c)
        inner = [(d_, n) for n, ts, d_ in tr["ranges"]
                 if ts <= mid <= ts + d_]
        name = min(inner)[1] if inner else "outside stages"
        gaps.append(((c - b) / 1e6, name))
    return busy, gaps


def breakdown(tr: dict, gaps: list) -> dict:
    ops: dict = {}
    for n, _ts, d in tr["kernels"]:
        ops[n[:96]] = ops.get(n[:96], 0.0) + d / 1e6
    idle: dict = {}
    for s, n in gaps:
        idle[n] = idle.get(n, 0.0) + s
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa
    return {"device_ops": [[k, v] for k, v in top(ops)],
            "idle_gaps": [[k, v] for k, v in top(idle)]}


# ----------------------------------------------------------------- run

def setup_caches(root: str = ROOT) -> None:
    """The program's build and kernel caches at fixed paths inside the
    checkout, so that only a checkout's first run builds."""
    base = os.path.join(root, ".port_bench_cache")
    for var, sub in (("TPULSAR_CACHE_DIR", "tpulsar"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             bench: dict | None = None) -> tuple[dict, list]:
    """One run of the cell `workload` of BENCHMARK.json."""
    bench = bench or load_benchmark()
    _cell, config, traffic = find_cell(bench, workload)
    return run(cell_metrics(bench, workload, trace), config, traffic, seed,
               seconds, trace, device, t_start)


def run(metric_list: list[dict], config: dict, traffic: dict, seed: int,
        seconds: float, trace: bool, device: torch.device,
        t_start: float) -> tuple[dict, list]:
    """One run of a configuration under a traffic mix.  Returns (the
    result line, the check's rows of (name, value, limit)).  The
    configuration's `environment` is set before the program runs."""
    phases = {"entry": time.perf_counter() - t_start}
    os.environ.update(config.get("environment", {}))
    from tpulsar_torch.kernels import cuda_dd
    from tpulsar_torch.search import executor

    phases["program_import"] = time.perf_counter() - t_start
    geom = beam_mod.Geometry.from_config(config)
    params = search_params(config)
    st = stated(config)
    passes = plan_mod.interleaved(config["plan"])
    zaplist = packaged_zaplist()
    freqs = geom.freqs()
    dt = geom.tsamp_s
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    try:
        if device.type == "cuda":
            torch.cuda.init()
            phases["cuda_init"] = time.perf_counter() - t_start
            cuda_dd.build()
            phases["library"] = time.perf_counter() - t_start
        block, psr = beam_mod.make_beam(geom, traffic, seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        phases["beam"] = time.perf_counter() - t_start
        warm = program_plan(plan_mod.warm_passes(config["plan"]))
        executor.search_block(block, freqs, dt, warm, params,
                              zaplist=zaplist,
                              checkpoint_dir=tempfile.mkdtemp(dir=tmp),
                              device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t_setup = time.perf_counter()
        phases["warm"] = t_setup - t_start
        win = run_window(block, freqs, dt, passes, params, zaplist,
                         seconds, device, tmp,
                         int(traffic["trace_passes"]) if trace else 0)
        window_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
        calls = win["calls"]
        done = [(i, c) for c in calls for i, _t in c.passes]
        trials = sum(passes[i].ndms for i, _c in done)
        failed = 0
        for c in calls:
            for flag in ("accel_rows_zero_filled", "accel_hi_chunk_skipped"):
                failed += int(c.counts.get(flag, (0,))[0])
            if c.raised:
                nxt = len(c.passes)
                failed += passes[nxt].ndms if nxt < len(passes) else 0
        attempted = trials + sum(
            passes[len(c.passes)].ndms for c in calls
            if c.raised and len(c.passes) < len(passes))
        stage_s = win["stage_s"]
        tr = None
        if win["slice"] is not None and win["slice"].prof is not None:
            tr = read_trace(win["slice"], tmp)
        ctx = {"setup_s": t_setup - t_start,
               "window_s": win["t1"] - win["t0"],
               "trials": trials, "passes": [passes[i] for i, _c in done],
               "stage_s": stage_s, "geom": geom, "stated": st,
               "plan": passes,
               "window_peak_bytes": window_peak, "trace": tr}
        device_info = {"platform": "gpu" if device.type == "cuda"
                       else device.type,
                       "kind": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                       "count": 1,
                       "memory_peak_bytes": int(max(
                           setup_peak, window_peak)
                           if device.type == "cuda" else 0)}
        gaps = []
        if tr is not None:
            busy, gaps = busy_and_gaps(tr)
            tr["busy_s"] = busy
            device_info["busy_s"] = busy
            device_info["window_s"] = tr["wall_s"]
        metrics = {}
        for m in metric_list:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        counts = {"passes": len(done), "calls_completed": sum(
            c.final is not None for c in calls)}
        # the program's state goes before the reference runs
        del calls
        if device.type == "cuda":
            torch.cuda.empty_cache()
        nums = check(block, freqs, dt, passes, win, config, zaplist, psr,
                     seed, counts)
        ok, rows = verdict(nums, config["check"]["limits"])
        ok = ok and failed == 0
        result = {"correct": bool(ok), "attempted": int(attempted),
                  "failed": int(failed), "metrics": metrics,
                  "device": device_info}
        if tr is not None:
            result["breakdown"] = breakdown(tr, gaps)
        result["setup_marks_s"] = phases
        result["window_counts"] = counts
        result["check"] = {k: {"value": v, "limit": lim}
                           for k, v, lim in rows}
        return result, rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def loaded_forbidden() -> list[str]:
    import sys

    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))

