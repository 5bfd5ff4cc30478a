#!/usr/bin/env python3
"""Time this checkout's dedispersion kernels against another
checkout's, in one process on one GPU.

    python3 tools/torch_dd_ab.py --baseline DIR [--reps 2]

DIR holds another commit's tree (for example unpacked with
`git archive <commit> | tar -x -C DIR`).  Its
tpulsar_torch/kernels/cuda_dd.py and tpulsar_torch/csrc/ are copied
to a temporary directory, built there with that commit's own flags
and loaded as a second module; both are called through the public
wrappers (cuda_dd.form_subbands, cuda_dd.dedisperse_subbands), whose
signatures have not changed.  At every shape the full PALFA Mock plan
launches (stage 1 at each downsample, stage 2 at each DM-chunk size,
on the widest pass of each step, as chip_smoke.py does) the two
outputs must be equal, and the two are timed in turns (baseline,
this, this, baseline, ... `--reps` times; each turn the median of 7
CUDA-event timings).  Prints one line per shape and, as the last
line, one JSON object with every time, the per-beam sums over the
plan's launches, and the card's name and power limit.  Needs a CUDA
device; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from tpulsar_torch.kernels import cuda_dd  # noqa: E402
from tpulsar_torch.kernels import dedisperse as dd  # noqa: E402
from tpulsar_torch.plan import ddplan  # noqa: E402
from tpulsar_torch.search import executor  # noqa: E402


def load_baseline(tree: str, tmp: str):
    """The other tree's cuda_dd module, built from its own sources in
    `tmp` (its build directory is relative to its own file)."""
    pkg = os.path.join(tmp, "pkg")
    os.makedirs(os.path.join(pkg, "kernels"))
    shutil.copy(os.path.join(tree, "tpulsar_torch", "kernels", "cuda_dd.py"),
                os.path.join(pkg, "kernels", "cuda_dd.py"))
    shutil.copytree(os.path.join(tree, "tpulsar_torch", "csrc"),
                    os.path.join(pkg, "csrc"))
    spec = importlib.util.spec_from_file_location(
        "cuda_dd_baseline", os.path.join(pkg, "kernels", "cuda_dd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="directory holding the other commit's tree")
    ap.add_argument("--reps", type=int, default=2,
                    help="turns of (baseline, this, this, baseline)")
    args = ap.parse_args()
    card = smoke.card_line()
    smoke.log(f"card: {card}")
    tmp = tempfile.mkdtemp(prefix="tpulsar_dd_ab_")
    try:
        base = load_baseline(os.path.abspath(args.baseline), tmp)
        cuda_dd.build()
        run(base, args.reps, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(base, reps: int, card: str) -> None:
    freqs = smoke.synth.channel_freqs(smoke.mock_spec(smoke.NSAMP))
    plan = ddplan.survey_plan("pdev")
    n1, n2 = smoke.plan_shapes(plan, smoke.NSAMP,
                               executor.SearchParams.slice_defaults())
    gen = torch.Generator(device=smoke.DEV)
    gen.manual_seed(7)
    data = torch.randint(0, 256, (smoke.NCHAN, smoke.NSAMP), generator=gen,
                         device=smoke.DEV, dtype=torch.uint8)

    def ab(name, new_fn, base_fn, launches):
        got, want = new_fn(), base_fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the two kernels disagree")
        del got, want
        t_new, t_base = [], []
        for _ in range(reps):
            t_base.append(smoke.time_ms(base_fn))
            t_new.append(smoke.time_ms(new_fn))
            t_new.append(smoke.time_ms(new_fn))
            t_base.append(smoke.time_ms(base_fn))
        row = dict(shape=name, launches=launches, ms=min(t_new),
                   base_ms=min(t_base), ms_all=t_new, base_ms_all=t_base)
        smoke.log(f"{name}: this {row['ms']:.4f} ms, baseline "
                  f"{row['base_ms']:.4f} ms (min of {2 * reps} turns), "
                  f"{launches} launches a beam")
        return row

    rows = []
    for step in plan:
        ds = step.downsamp
        ppass = step.passes()[-1]
        ch_sh, sub_sh = dd.plan_pass_shifts(freqs, 96, ppass.subdm,
                                            np.asarray(ppass.dms),
                                            smoke.TSAMP, ds)
        rows.append(dict(kernel="form_subbands", **ab(
            f"form_subbands ds={ds}",
            lambda: cuda_dd.form_subbands(data, ch_sh, 96, ds),
            lambda: base.form_subbands(data, ch_sh, 96, ds), n1[ds])))
        subb = cuda_dd.form_subbands(data, ch_sh, 96, ds)
        (nrows, _), = [k for k in n2 if k[1] == ds]
        rows_sh = sub_sh[-nrows:]
        rows.append(dict(kernel="dedisperse_subbands", **ab(
            f"dedisperse_subbands {nrows} rows ds={ds}",
            lambda: cuda_dd.dedisperse_subbands(subb, rows_sh),
            lambda: base.dedisperse_subbands(subb, rows_sh),
            n2[(nrows, ds)])))
        del subb
    beam = {}
    for k in ("form_subbands", "dedisperse_subbands"):
        sel = [r for r in rows if r["kernel"] == k]
        beam[k] = {m: sum(r["launches"] * r[m] for r in sel)
                   for m in ("ms", "base_ms")}
        smoke.log(f"per beam {k}: this {beam[k]['ms']:.3f} ms, baseline "
                  f"{beam[k]['base_ms']:.3f} ms")
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "shapes": rows, "per_beam": beam}), flush=True)


if __name__ == "__main__":
    main()
