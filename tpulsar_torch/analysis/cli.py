"""The ``lint`` command: run the contract checkers, render findings,
map the verdict to an exit code — counterpart of
tpulsar/analysis/cli.py.

Exit codes:
  0  clean — every checker that ran passed (the banner says how many
     of the six ran)
  1  findings — at least one contract violation
  2  internal error — the linter itself failed (bad --checker id,
     unreadable root, a crashed checker); never silently green
"""

from __future__ import annotations

import argparse
import sys


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--root", default=".",
                    help="tree to lint (default: the current "
                         "checkout)")
    ap.add_argument("--checker", action="append", default=[],
                    metavar="ID",
                    help="run only this checker (repeatable); "
                         "default: all six")
    ap.add_argument("--list", action="store_true",
                    help="list checker ids and contracts and the "
                         "port's differences, then exit")
    ap.add_argument("--json", action="store_true",
                    help="emit the findings as one JSON document "
                         "(schema tpulsar-lint/v1)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpulsar_torch lint",
        description=__doc__.splitlines()[0])
    add_arguments(ap)
    return run(ap.parse_args(argv))


def run(args) -> int:
    from tpulsar_torch.analysis import (CHECKERS, PORT_DIFFERENCES, lint,
                                        render_json, render_text)

    if args.list:
        for c in CHECKERS:
            print(f"{c.id:16s} {c.doc}"
                  + (f" [not run: {c.not_run}]" if c.not_run else ""))
        print("port differences (excused findings):")
        for d in PORT_DIFFERENCES:
            print(f"  {d.checker:14s} {d.name}: {d.reason}; closed "
                  f"by: {d.closes}")
        return 0
    try:
        report = lint(args.root, checker_ids=args.checker or None)
    except Exception as e:     # noqa: BLE001 — rc 2 is the contract
        print(f"tpulsar_torch lint: internal error: "
              f"{e.__class__.__name__}: {e}", file=sys.stderr)
        return 2
    print(render_json(report.findings, report.excused, report.not_run)
          if args.json else
          render_text(report.findings, report.checkers_run,
                      report.excused, report.not_run))
    return 1 if report.findings else 0
