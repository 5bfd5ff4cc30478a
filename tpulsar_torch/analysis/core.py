"""The checker framework: file walker, AST contexts, findings,
suppressions, and the port's excusals — counterpart of
tpulsar/analysis/core.py.

Checkers are two-phase: ``visit(ctx)`` runs once per walked file
(local, line-anchored findings), ``finalize(repo)`` once at the end
(cross-file coverage: "every catalog entry is used somewhere",
"the docs table matches").  Each coverage judgment gates itself on
the specific artifact it audits existing under the lint root (the
port's ``faults.py``, a docs file, the knob registry) — a test
fixture holding one offending file gets per-site findings without
spurious "nothing fires fault point X" noise.

The walk covers ``tpulsar_torch/``, ``tools/torch_*.py`` and
``chip_smoke.py`` (harness scope, as ``bench.py`` is the JAX
linter's).  The docs tables are the repository's
``docs/operations.md`` and ``docs/configuration.md``, which describe
the JAX package; each way in which the port differs from it on
purpose is one entry of ``checkers.PORT_DIFFERENCES``, whose finding
is excused (and listed as such), and an entry that matches no
finding on the real tree is itself a finding.

Suppression is per line and per checker: ``# tpulsar:
lint-ok[<checker-id>]`` on the flagged line or the line directly
above it silences that checker there.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

#: the suppression comment: ``# tpulsar: lint-ok[spool-write]``
_SUPPRESS_RE = re.compile(r"tpulsar:\s*lint-ok\[([a-z0-9_\-, ]+)\]")

#: walked under the lint root (tests/ is excluded on purpose: tests
#: seed violations deliberately)
_PACKAGE = "tpulsar_torch"
_TOOLS_DIR, _TOOLS_PREFIX = "tools", "torch_"
_WALK_FILES = ("chip_smoke.py",)
_SKIP_PARTS = ("__pycache__", "tests", "_build")

#: the lint root holds the port's own tree (not a test fixture) when
#: this file is under it: only then is a PORT_DIFFERENCES entry that
#: excuses nothing judged stale
_SELF = f"{_PACKAGE}/analysis/checkers.py"


@dataclasses.dataclass
class Finding:
    """One lint violation: where, which contract, what to do."""
    checker: str
    path: str          # lint-root-relative
    line: int
    message: str
    hint: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: [{self.checker}] {self.message}"
        if self.hint:
            out += f"\n{'':4s}hint: {self.hint}"
        return out


class FileCtx:
    """One walked file: source, AST, and per-line suppressions."""

    def __init__(self, relpath: str, source: str):
        self.path = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        #: line number -> set of suppressed checker ids
        self.suppress: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                ids = {s.strip() for s in m.group(1).split(",")}
                self.suppress[i] = ids

    def suppressed(self, checker: str, line: int) -> bool:
        for ln in (line, line - 1):
            ids = self.suppress.get(ln)
            if ids and (checker in ids or "*" in ids):
                return True
        return False


class Repo:
    """The lint root plus cached doc/file access for finalize()."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._docs: dict[str, str | None] = {}

    def doc_text(self, relpath: str) -> str | None:
        if relpath not in self._docs:
            try:
                with open(os.path.join(self.root, relpath)) as fh:
                    self._docs[relpath] = fh.read()
            except OSError:
                self._docs[relpath] = None
        return self._docs[relpath]

    def doc_table_names(self, relpath: str, pattern: str) -> set[str]:
        """Backticked names matching ``pattern`` that appear in a
        markdown table row (a line starting with ``|``) of the doc."""
        text = self.doc_text(relpath)
        out: set[str] = set()
        if text is None:
            return out
        rx = re.compile(r"`(" + pattern + r")[`{]")
        for line in text.splitlines():
            if line.lstrip().startswith("|"):
                for m in rx.finditer(line):
                    out.add(m.group(1))
        return out


class Checker:
    """Base checker: subclasses set ``id``/``doc`` and override
    ``visit`` and/or ``finalize``.  A checker with ``not_run`` set (its
    reason) is not run, and the verdict says so."""

    id = "base"
    doc = ""
    not_run = ""

    def visit(self, ctx: FileCtx):
        return ()

    def finalize(self, repo: Repo):
        return ()


@dataclasses.dataclass
class Report:
    """One lint run: the findings that count, the findings excused by
    a PORT_DIFFERENCES entry (as ``(entry, finding)``), and how many
    of the selected checkers ran and why the others did not."""
    findings: list[Finding]
    excused: list[tuple]
    checkers_run: int
    not_run: dict[str, str]


def walk_files(root: str):
    """Lint-root-relative paths of every Python file in scope."""
    out: list[str] = []
    for fn in _WALK_FILES:
        if os.path.isfile(os.path.join(root, fn)):
            out.append(fn)
    top = os.path.join(root, _PACKAGE)
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [n for n in sorted(dirnames)
                       if n not in _SKIP_PARTS]
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           root))
    tools = os.path.join(root, _TOOLS_DIR)
    if os.path.isdir(tools):
        out += [os.path.join(_TOOLS_DIR, name)
                for name in sorted(os.listdir(tools))
                if name.startswith(_TOOLS_PREFIX)
                and name.endswith(".py")]
    # a bare fixture dir (tests) may hold loose .py files outside the
    # package layout — walk those too so one-file fixtures lint
    if not os.path.isdir(top):
        for name in sorted(os.listdir(root)):
            if name.endswith(".py") and name not in out:
                out.append(name)
    return out


def lint(root: str, checker_ids: list[str] | None = None) -> Report:
    """Run the (selected) checkers over ``root``, with suppressions
    applied and the port's differences excused.  Raises on internal
    errors (the CLI maps those to rc 2); an unparseable walked file
    is a finding, not a crash."""
    from tpulsar_torch.analysis import checkers as checkers_mod

    known = {c.id for c in checkers_mod.CHECKERS}
    if checker_ids is not None:
        bad = [i for i in checker_ids if i not in known]
        if bad:
            raise ValueError(
                f"unknown checker id(s) {bad}; known: "
                f"{sorted(known)}")
    selected = [c for c in checkers_mod.CHECKERS
                if checker_ids is None or c.id in checker_ids]
    not_run = {c.id: c.not_run for c in selected if c.not_run}
    checkers = [c() for c in selected if not c.not_run]
    repo = Repo(root)
    findings: list[Finding] = []
    for rel in walk_files(repo.root):
        try:
            with open(os.path.join(repo.root, rel),
                      encoding="utf-8") as fh:
                ctx = FileCtx(rel, fh.read())
        except (OSError, SyntaxError, ValueError) as e:
            findings.append(Finding(
                "parse", rel, getattr(e, "lineno", 0) or 0,
                f"cannot parse: {e}"))
            continue
        for checker in checkers:
            for f in checker.visit(ctx):
                if not ctx.suppressed(f.checker, f.line):
                    findings.append(f)
    for checker in checkers:
        findings.extend(checker.finalize(repo))
    kept, excused = _excuse(repo, findings, {c.id for c in checkers},
                            checkers_mod.PORT_DIFFERENCES)
    kept.sort(key=lambda f: (f.path, f.line, f.checker))
    return Report(kept, excused, len(checkers), not_run)


def _excuse(repo: Repo, findings: list[Finding], ran: set[str],
            differences) -> tuple[list[Finding], list[tuple]]:
    """Split the findings into those that count and those a
    PORT_DIFFERENCES entry excuses (the entry's checker, and the
    entry's name quoted in the message).  On the port's own tree an
    entry of a checker that ran and excused nothing is a finding:
    the difference it names is gone, so the entry must go too."""
    kept: list[Finding] = []
    excused: list[tuple] = []
    used: set[int] = set()
    for f in findings:
        hit = next((i for i, d in enumerate(differences)
                    if d.checker == f.checker
                    and repr(d.name) in f.message), None)
        if hit is None:
            kept.append(f)
        else:
            used.add(hit)
            excused.append((differences[hit], f))
    if os.path.isfile(os.path.join(repo.root, _SELF)):
        for i, d in enumerate(differences):
            if d.checker in ran and i not in used:
                kept.append(Finding(
                    d.checker, _SELF,
                    literal_line(os.path.join(repo.root, _SELF),
                                  d.name),
                    f"PORT_DIFFERENCES entry {d.name!r} excuses no "
                    f"finding: the port no longer differs there",
                    "remove the entry (and its ROADMAP line)"))
    return kept, excused


def literal_line(path: str, literal: str) -> int:
    """Line of a quoted literal inside a source file."""
    try:
        with open(path) as fh:
            for i, line in enumerate(fh, start=1):
                if f'"{literal}"' in line or f"'{literal}'" in line:
                    return i
    except OSError:
        pass
    return 1


def run_lint(root: str, checker_ids: list[str] | None = None
             ) -> list[Finding]:
    """The findings of :func:`lint` that count."""
    return lint(root, checker_ids).findings


def render_text(findings: list[Finding],
                checkers_run: int | None = None,
                excused: list[tuple] = (),
                not_run: dict[str, str] | None = None) -> str:
    """``checkers_run`` is how many checkers actually executed — a
    ``--checker``-restricted run, or one with a checker that cannot
    run yet, must not claim all six passed."""
    from tpulsar_torch.analysis.checkers import CHECKERS

    if checkers_run is None:
        checkers_run = len(CHECKERS)
    lines = [f.render() for f in findings]
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.checker] = counts.get(f.checker, 0) + 1
    lines.append(
        f"tpulsar_torch lint: {len(findings)} finding(s) across "
        f"{len(counts)} checker(s)" if findings else
        f"tpulsar_torch lint: clean ({checkers_run} of {len(CHECKERS)} "
        f"checkers run)")
    for cid, n in sorted(counts.items()):
        lines.append(f"  {cid}: {n}")
    for cid, why in sorted((not_run or {}).items()):
        lines.append(f"  not run: {cid} ({why})")
    if excused:
        lines.append(f"  excused: {len(excused)} port difference(s) "
                     f"(--list names them)")
    return "\n".join(lines)


def render_json(findings: list[Finding], excused: list[tuple] = (),
                not_run: dict[str, str] | None = None) -> str:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.checker] = counts.get(f.checker, 0) + 1
    return json.dumps(
        {"schema": "tpulsar-lint/v1",
         "ok": not findings,
         "counts": counts,
         "findings": [f.as_dict() for f in findings],
         "excused": [dict(d._asdict(), finding=f.as_dict())
                     for d, f in excused],
         "not_run": dict(not_run or {})},
        indent=1, sort_keys=True)
