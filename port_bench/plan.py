"""The survey dedispersion plan as the benchmark hands it to the program.

A configuration file carries the plan as its table of steps, the rows
of PALFA's Mock DDplan (PALFA2_presto_search.py:319-326):

    [lodm, dmstep, dms_per_pass, numpasses, numsub, downsamp]

Each pass of each step becomes a one-pass step of its own, and the
passes are interleaved so that every prefix of the order holds each
step's passes in proportion to the step's count of passes.  A window
that ends anywhere then samples the whole plan in proportion.

This module is the benchmark's own arithmetic; it imports nothing of
the program, so the reference can use it too.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Pass:
    """One dedispersion pass: subbands formed at `subdm`, then
    dedispersed to each DM of `dms` at downsampling `downsamp`."""
    step: int            # index of the step in the configuration's table
    index: int           # index of the pass within its step
    lodm: float          # the pass's first DM, unrounded
    dmstep: float
    dms_per_pass: int
    numsub: int
    downsamp: int

    @property
    def subdm(self) -> float:
        return round(self.lodm + 0.5 * (self.dms_per_pass * self.dmstep),
                     6)

    @property
    def dms(self) -> tuple[float, ...]:
        return tuple(round(self.lodm + k * self.dmstep, 6)
                     for k in range(self.dms_per_pass))

    @property
    def ndms(self) -> int:
        return self.dms_per_pass

    def as_step_row(self) -> tuple:
        """The pass as a one-pass table row (lodm, dmstep, dms/pass, 1,
        numsub, downsamp)."""
        return (self.lodm, self.dmstep, self.dms_per_pass, 1, self.numsub,
                self.downsamp)


def table_passes(table) -> list[Pass]:
    """Every pass of the plan table, in table order."""
    out = []
    for si, (lodm, dmstep, dpp, npasses, nsub, ds) in enumerate(table):
        sub_dmstep = dpp * dmstep
        for ii in range(int(npasses)):
            out.append(Pass(si, ii, lodm + ii * sub_dmstep, float(dmstep),
                            int(dpp), int(nsub), int(ds)))
    return out


def interleaved(table) -> list[Pass]:
    """The plan's passes in proportional order: at each position the
    step whose count lags its share most (m * n_s / N - c_s at
    position m, ties in table order) gives its next pass.  Every
    prefix of length m then holds m * n_s / N of each step's passes,
    to within one."""
    by_step = [[p for p in table_passes(table) if p.step == s]
               for s in range(len(table))]
    n = [len(b) for b in by_step]
    total = sum(n)
    taken = [0] * len(n)
    out = []
    for m in range(1, total + 1):
        s = max((k for k in range(len(n)) if taken[k] < n[k]),
                key=lambda k: (m * n[k] / total - taken[k], -k))
        out.append(by_step[s][taken[s]])
        taken[s] += 1
    return out


def total_trials(passes) -> int:
    return sum(p.ndms for p in passes)


def warm_passes(table) -> list[Pass]:
    """The first pass of each step: one pass of every shape the plan
    uses."""
    seen, out = set(), []
    for p in table_passes(table):
        if p.step not in seen:
            seen.add(p.step)
            out.append(p)
    return out
