#!/usr/bin/env python
"""Per-stage rollup table from a tpulsar_torch Chrome-trace file —
counterpart of tools/trace_summarize.py.

Usage:
    python tools/torch_trace_summarize.py <trace.json | results_dir |
        spool_dir> [--json] [--compare-report <path.report>]
        [--ticket T] [--queue URL]

Given a `<basenm>_trace.json` written by a `TPULSAR_TRACE=1` search
of the port (or a results directory containing one — the newest is
used), prints the per-span-name totals: seconds, share of the root
span, and scope count.  The find/summarize/render implementation is
shared with the `python -m tpulsar_torch trace` command
(tpulsar_torch/obs/trace.py) — this tool adds the `.report`
comparison: with ``--compare-report`` the rollup is checked against
the report's stage totals (the StageTimers view over the same spans)
and exits nonzero if any stage disagrees by more than 5% (with 50 ms
of absolute slack).  Given a serve spool (or ``--queue``), it
renders each ticket's journal transitions beside its beam's trace
rollup.  A trace holding library builds (a search that built nvcc's or
g++'s library at first use, or the AOT gate's
``<build dir>/aot_gate_trace.json``) also gets the compile rollup per
program, as the JAX tool's.

No torch and no numpy: runs on a host holding only the artifacts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from tpulsar_torch.obs import trace  # noqa: E402  (stdlib-only module)

# kept as module-level aliases: tests and other tools call these as
# torch_trace_summarize.find_trace_file / .summarize
find_trace_file = trace.find_trace_file
summarize = trace.summarize_file
render = trace.render_summary

#: rows of the .report that are not timing-scope stages: the total
#: line, and the synthetic unaccounted-time remainder.  Everything
#: else in the '<stage>: <secs> s  (pct%)' format is compared — no
#: hand-maintained stage list, so a stage added in a future PR is
#: gated automatically instead of silently skipped.
_NON_STAGE_ROWS = ("Total time", "other")

_STAGE_ROW = re.compile(
    r"^\s*([\w./ -]+?):\s+(\d+(?:\.\d+)?) s\s+\(\s*\d+(?:\.\d+)?%\)")

#: trace spans FOLDED into a .report stage when the report carries no
#: row of their own.  The tree dedispersion family fuses the SP
#: detrend into its residual program, so its wall time belongs to
#: the dedispersing stage; any path that times the detrend in a
#: standalone "detrend" span (an unfused A/B, a future split
#: program) while its report keeps the combined dedispersing row
#: would otherwise fail the 5% gate on a pure attribution
#: difference.  Spans that DO appear as report rows are never
#: folded (that would double-count them).
_FOLDED_SPANS = {"dedispersing": ("detrend",)}


def parse_report_stages(report_path: str) -> dict[str, float]:
    """Stage seconds out of a .report: every row in the
    '<stage>: <secs> s  (pct%)' shape except the non-stage rows."""
    stages: dict[str, float] = {}
    with open(report_path) as fh:
        for line in fh:
            m = _STAGE_ROW.match(line)
            if m is None:
                continue
            name = m.group(1).strip()
            if name in _NON_STAGE_ROWS:
                continue
            stages[name] = float(m.group(2))
    return stages


def compare(summary: dict, report_path: str,
            tolerance: float = 0.05) -> list[str]:
    """Mismatches between trace rollup and .report stage totals.
    Absolute slack of 50 ms absorbs sub-tick stages where a relative
    bound is meaningless."""
    roll = summary["rollup"]
    problems = []
    report_stages = parse_report_stages(report_path)
    for stage, rep_s in report_stages.items():
        got_s = roll.get(stage, {}).get("seconds", 0.0)
        for span in _FOLDED_SPANS.get(stage, ()):
            if span not in report_stages:
                got_s += roll.get(span, {}).get("seconds", 0.0)
        if abs(got_s - rep_s) > max(tolerance * rep_s, 0.05):
            problems.append(
                f"{stage}: trace {got_s:.2f} s vs report "
                f"{rep_s:.2f} s (> {100 * tolerance:.0f}%)")
    return problems


#: the compile-attributed trace events the AOT layer emits:
#: ``aot_compile`` spans from the gate (tpulsar_torch.aot.warmstart)
#: and retroactive ``backend_compile`` events of each library build —
#: an entry under any other program label than the registry's names
#: means a library was built in-line DURING the run
_COMPILE_EVENTS = ("aot_compile", "backend_compile")


def compile_rollup(trace: "str | list") -> dict[str, dict]:
    """Per-program compile-time rollup from the AOT compile spans:
    {program: {seconds, count, events: {event-name: count}}}.  A
    library built in-line shows up as an ``(inline)`` backend_compile
    row.

    Accepts a trace-file path or an already-loaded traceEvents list.
    A gated build emits BOTH events (the gate's ``aot_compile`` wall
    span encloses the build's retroactive ``backend_compile``), so
    seconds/count come from ``aot_compile`` alone when present —
    summing the pair would double every gated build; the per-event
    counts stay in ``events``."""
    if isinstance(trace, str):
        with open(trace) as fh:
            trace = json.load(fh).get("traceEvents", [])
    per: dict[str, dict] = {}
    for ev in trace:
        if ev.get("name") not in _COMPILE_EVENTS or ev.get("ph") != "X":
            continue
        prog = ev.get("args", {}).get("program", "?")
        rec = per.setdefault(prog, {n: {"seconds": 0.0, "count": 0}
                                    for n in _COMPILE_EVENTS})
        rec[ev["name"]]["seconds"] += ev.get("dur", 0.0) / 1e6
        rec[ev["name"]]["count"] += 1
    roll: dict[str, dict] = {}
    for prog, rec in per.items():
        primary = ("aot_compile" if rec["aot_compile"]["count"]
                   else "backend_compile")
        roll[prog] = {
            "seconds": round(rec[primary]["seconds"], 3),
            "count": rec[primary]["count"],
            "events": {n: r["count"] for n, r in rec.items()
                       if r["count"]},
        }
    return roll


def render_compile_rollup(roll: dict[str, dict]) -> str:
    lines = ["compile rollup (per program):",
             f"  {'program':40s} {'seconds':>9s} {'count':>6s}"]
    for prog, rec in sorted(roll.items(),
                            key=lambda kv: -kv[1]["seconds"]):
        lines.append(f"  {prog:40s} {rec['seconds']:9.2f} "
                     f"{rec['count']:6d}")
    return "\n".join(lines)


def summarize_spool(spool: str, ticket: str | None = None,
                    queue=None) -> dict:
    """Spool mode: the journal's per-ticket transition durations
    ALONGSIDE each beam's trace-span rollup (found via the outdir the
    ticket was submitted with) — one artifact answering both "what
    happened to this beam across the fleet" and "where did its
    device time go".  ``queue`` routes the journal read through a
    TicketQueue backend (the ``sqlite:`` fleet path)."""
    from tpulsar_torch.obs import journal as journal_lib

    data = journal_lib.summarize(spool, queue=queue)
    if ticket is not None:
        data["tickets"] = {tid: rec
                           for tid, rec in data["tickets"].items()
                           if tid == ticket}
    for tid, rec in data["tickets"].items():
        outdir = rec.get("outdir")
        if not outdir or not os.path.isdir(outdir):
            continue
        try:
            tf = trace.find_trace_file(outdir)
        except FileNotFoundError:
            continue
        rec["trace_file"] = tf
        rec["trace_rollup"] = trace.summarize_file(tf)["rollup"]
    return data


def render_spool_summary(data: dict) -> str:
    lines = [f"spool journal: {data['spool']} "
             f"({data['n_events']} events, statuses "
             f"{data['statuses']}, takeovers {data['takeovers']}, "
             f"quarantined {data['quarantined']})",
             f"{'ticket':16s} {'status':10s} {'workers':12s} "
             f"{'att':>3s} {'steal':>5s} {'q-wait':>8s} "
             f"{'to-start':>8s} {'e2e':>8s}"]

    def num(rec, key):
        v = rec.get(key)
        return f"{v:8.3f}" if v is not None else f"{'-':>8s}"

    for tid in sorted(data["tickets"]):
        rec = data["tickets"][tid]
        lines.append(
            f"{tid:16.16s} {rec['status'] or 'in-flight':10s} "
            f"{','.join(rec['workers']):12.12s} "
            f"{rec['attempts']:>3d} {rec['takeovers']:>5d} "
            f"{num(rec, 'queue_wait_s')} "
            f"{num(rec, 'claim_to_start_s')} {num(rec, 'e2e_s')}")
        roll = rec.get("trace_rollup")
        if roll:
            top = sorted(roll, key=lambda n: -roll[n]["seconds"])[:3]
            lines.append(
                "    trace: " + "  ".join(
                    f"{n}={roll[n]['seconds']:.2f}s" for n in top)
                + f"  ({rec['trace_file']})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="trace JSON file, results dir, or a "
                                 "serve SPOOL dir (detected by its "
                                 "events/ journal): spool mode "
                                 "renders the per-ticket transition "
                                 "durations table alongside each "
                                 "beam's trace rollup")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    ap.add_argument("--compare-report", default=None, metavar="REPORT",
                    help="check the rollup against this .report's "
                         "stage totals (5%% tolerance); nonzero exit "
                         "on mismatch")
    ap.add_argument("--ticket", default=None,
                    help="spool mode: restrict to one ticket")
    ap.add_argument("--queue", default="",
                    help="spool mode: route the journal read through "
                         "this ticket-queue backend URL "
                         "(sqlite:<path> / spool:<dir>); the bare "
                         "token 'sqlite' expands to "
                         "sqlite:<path>/queue.db")
    args = ap.parse_args(argv)
    queue = None
    if args.queue:
        from tpulsar_torch.frontdoor.queue import get_ticket_queue
        url = args.queue
        if url == "sqlite":
            url = f"sqlite:{os.path.join(args.path, 'queue.db')}"
        queue = get_ticket_queue(url)
    if queue is not None or (
            os.path.isdir(args.path) and
            os.path.isdir(os.path.join(args.path, "events"))):
        spool = (queue.journal_root or args.path) if queue is not None \
            else args.path
        data = summarize_spool(spool, ticket=args.ticket, queue=queue)
        if args.json:
            print(json.dumps(data, indent=1, sort_keys=True))
        else:
            print(render_spool_summary(data))
        return 0
    trace_file = find_trace_file(args.path)
    with open(trace_file) as fh:
        trace_events = json.load(fh).get("traceEvents", [])
    summary = trace.summarize_events(trace_events, trace_file=trace_file)
    compiles = compile_rollup(trace_events)
    if args.json:
        summary = dict(summary, compile_rollup=compiles)
        print(json.dumps(summary, indent=1, sort_keys=True))
    else:
        print(render(summary))
        if compiles:
            print(render_compile_rollup(compiles))
    if args.compare_report:
        problems = compare(summary, args.compare_report)
        if problems:
            for p in problems:
                print(f"MISMATCH {p}", file=sys.stderr)
            return 1
        # with --json, stdout must stay one parseable document
        print(f"rollup matches {args.compare_report} within 5%",
              file=sys.stderr if args.json else sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
