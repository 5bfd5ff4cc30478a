"""The six contract checkers — counterpart of
tpulsar/analysis/checkers.py, over the port's tree and catalogs.

Each checker audits one hand-maintained contract against the code
that must honour it.  Catalogs (fault points, the journal event
vocabulary, the knob registry, the telemetry catalog) come from the
installed ``tpulsar_torch`` package — stdlib-only data modules; the
*scanned* files come from the lint root, so a test can seed a
violation into a fixture tree and lint it with the real catalogs.

Cross-file coverage judgments in ``finalize`` are individually gated
on the artifact they audit existing under the lint root (the port's
``faults.py``, a docs file, the knob registry), so a one-file test
fixture gets per-site findings without spurious coverage noise.

The docs tables the coverage judgments read are the repository's
``docs/operations.md`` and ``docs/configuration.md``, which describe
the JAX package.  ``PORT_DIFFERENCES`` names every way in which the
port differs from them on purpose; everything else is a finding.
The bench-keys checker keeps its id but does not run: the port has
no bench gate and no committed bench file yet.
"""

from __future__ import annotations

import ast
import collections
import os
import re

from tpulsar_torch.analysis.core import (Checker, FileCtx, Finding, Repo,
                                        literal_line)


# ------------------------------------------------------------ helpers

def _chain(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('os.environ.get'), or
    '' for anything more exotic."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _str_arg(call: ast.Call, idx: int = 0, kw: str = "") -> tuple:
    """(value, node) of a literal-str argument, or (None, None)."""
    node = None
    if len(call.args) > idx:
        node = call.args[idx]
    elif kw:
        node = next((k.value for k in call.keywords if k.arg == kw),
                    None)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, node
    return None, None


# ------------------------------------------------- 1. fault points

class FaultPointsChecker(Checker):
    id = "fault-points"
    doc = ("fault-layer literals exist in FAULT_POINTS; every "
           "catalog point is fired and documented")

    def __init__(self):
        from tpulsar_torch.resilience.faults import FAULT_POINTS
        self.points = tuple(FAULT_POINTS)
        self.fired: dict[str, str] = {}   # point -> first fire site

    def visit(self, ctx: FileCtx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and _chain(func).split(".")[-2:-1] == ["faults"]):
                continue
            val, lit = _str_arg(node)
            if val is None:
                continue
            if func.attr in ("fire", "targets", "fired"):
                if val not in self.points:
                    yield Finding(
                        self.id, ctx.path, lit.lineno,
                        f"unknown fault point {val!r} passed to "
                        f"faults.{func.attr}()",
                        "use a FAULT_POINTS name, or add the new "
                        "point to resilience/faults.py AND its "
                        "docs/operations.md table row")
                elif func.attr == "fire":
                    self.fired.setdefault(val,
                                          f"{ctx.path}:{lit.lineno}")
            elif func.attr == "targets_prefix":
                if not any(p.startswith(val) for p in self.points):
                    yield Finding(
                        self.id, ctx.path, lit.lineno,
                        f"fault-point prefix {val!r} matches "
                        f"nothing in FAULT_POINTS")

    def finalize(self, repo: Repo):
        cat = os.path.join(repo.root,
                           "tpulsar_torch/resilience/faults.py")
        if os.path.isfile(cat):
            for point in self.points:
                if point not in self.fired:
                    yield Finding(
                        self.id, "tpulsar_torch/resilience/faults.py",
                        literal_line(cat, point),
                        f"catalog fault point {point!r} is never "
                        f"fired anywhere in the tree",
                        "instrument a site with faults.fire() or "
                        "retire the catalog entry")
        doc = "docs/operations.md"
        if repo.doc_text(doc) is not None:
            rows = repo.doc_table_names(doc, r"[a-z_.]+")
            for point in self.points:
                if point not in rows:
                    yield Finding(
                        self.id, doc, 0,
                        f"fault point {point!r} has no row in the "
                        f"docs/operations.md fault-point table")


# ------------------------------------------------------ 2. metrics

_METRIC_CTORS = ("counter", "gauge", "histogram",
                 "Counter", "Gauge", "Histogram")
_CATALOG_FILE = "tpulsar_torch/obs/telemetry.py"
_METRIC_IMPL = (_CATALOG_FILE, "tpulsar_torch/obs/metrics.py")


def _telemetry_catalog() -> dict[str, int]:
    """Instrument names declared in the telemetry catalog (from the
    installed module's source), name -> line."""
    from tpulsar_torch.obs import telemetry
    with open(telemetry.__file__) as fh:
        tree = ast.parse(fh.read())
    out: dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("counter", "gauge",
                                       "histogram"):
            val, lit = _str_arg(node)
            if val is not None and val.startswith("tpulsar_"):
                out[val] = lit.lineno
    return out


class MetricsChecker(Checker):
    id = "metrics"
    doc = ("metric constructors live in the telemetry catalog; the "
           "docs metric table matches it both directions")

    def __init__(self):
        self.catalog = _telemetry_catalog()

    def visit(self, ctx: FileCtx):
        if ctx.path.replace(os.sep, "/") in _METRIC_IMPL:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_CTORS):
                continue
            val, lit = _str_arg(node)
            if val is None or not val.startswith("tpulsar_"):
                continue
            if val in self.catalog:
                msg = (f"metric {val!r} constructed outside the "
                       f"telemetry catalog (it already has a "
                       f"catalog getter)")
                hint = "call the obs/telemetry.py getter instead"
            else:
                msg = (f"ad-hoc metric constructor for {val!r} — "
                       f"not in the obs/telemetry.py instrument "
                       f"catalog")
                hint = ("declare the instrument as a catalog getter "
                        "in obs/telemetry.py (and its "
                        "docs/operations.md table row)")
            yield Finding(self.id, ctx.path, node.lineno, msg, hint)

    def finalize(self, repo: Repo):
        doc = "docs/operations.md"
        if repo.doc_text(doc) is None:
            return
        rows = repo.doc_table_names(doc, r"tpulsar_[a-z0-9_]+")
        for name, line in sorted(self.catalog.items()):
            if name not in rows:
                yield Finding(
                    self.id, doc, 0,
                    f"catalog metric {name!r} has no row in the "
                    f"docs/operations.md metric table")
        for name in sorted(rows - set(self.catalog)):
            yield Finding(
                self.id, doc, 0,
                f"documented metric {name!r} is not in the "
                f"obs/telemetry.py catalog",
                "retire the stale table row or add the instrument")


# ----------------------------------------------- 3. journal events

#: call shapes that append a journal event with the literal as the
#: event name: journal.record(spool, EVENT, ...), the serve/chaos
#: workers' bound helpers, the queue facade, and the checkpoint
#: store's journal hook
_EVENT_WRAPPERS = ("record_event", "_journal", "jr")


def _is_event_expr(node: ast.AST) -> bool:
    """Does this expression read an event name — ``X.get("event")``
    or ``X["event"]``?"""
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get":
        val, _ = _str_arg(node)
        return val == "event"
    if isinstance(node, ast.Subscript):
        sl = node.slice
        return isinstance(sl, ast.Constant) and sl.value == "event"
    return False


class JournalEventsChecker(Checker):
    id = "journal-events"
    doc = ("journal record() literals and verifier event "
           "comparisons are in the exported obs.journal.EVENTS "
           "vocabulary; every vocabulary entry is documented")

    def __init__(self):
        from tpulsar_torch.obs.journal import EVENTS
        self.vocab = dict(EVENTS)

    def _check_literal(self, ctx, node, what):
        if isinstance(node, ast.Constant) \
                and isinstance(node.value, str) \
                and node.value not in self.vocab:
            return Finding(
                self.id, ctx.path, node.lineno,
                f"event {node.value!r} {what} is not in the "
                f"obs.journal.EVENTS vocabulary",
                "add the event to EVENTS (with verifier + docs "
                "coverage) or fix the name")
        return None

    def visit(self, ctx: FileCtx):
        seen: set[tuple[int, str]] = set()

        def emit(f):
            if f is not None and (f.line, f.message) not in seen:
                seen.add((f.line, f.message))
                yield f

        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            ev_node = None
            if isinstance(func, ast.Attribute):
                base = _chain(func)
                if func.attr == "record" \
                        and base.split(".")[-2:-1] == ["journal"]:
                    ev_node = (node.args[1] if len(node.args) > 1
                               else None)
                elif func.attr == "journal" \
                        or func.attr in _EVENT_WRAPPERS:
                    # store.journal("pass_complete", ...) and the
                    # bound worker helpers
                    ev_node = node.args[0] if node.args else None
            elif isinstance(func, ast.Name) \
                    and func.id in _EVENT_WRAPPERS:
                ev_node = node.args[0] if node.args else None
            if ev_node is not None:
                yield from emit(self._check_literal(
                    ctx, ev_node, "appended to the journal"))

        # verifier-side coverage: event comparisons, including ones
        # routed through a local variable or comprehension.  Scoped
        # per function (a module-wide variable sweep would bleed one
        # function's `name = ev.get("event")` into another's
        # unrelated `name`), and to the package only (the harness
        # files compare other vocabularies)
        if not ctx.path.replace(os.sep, "/").startswith("tpulsar_torch/"):
            return
        scopes = [n for n in ast.walk(ctx.tree)
                  if isinstance(n, (ast.FunctionDef,
                                    ast.AsyncFunctionDef))]
        for scope in scopes:
            ev_vars: set[str] = set()
            for node in ast.walk(scope):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    value = node.value
                    if isinstance(value, (ast.ListComp, ast.SetComp,
                                          ast.GeneratorExp)):
                        value = value.elt
                    if _is_event_expr(value):
                        ev_vars.add(node.targets[0].id)

            def _eventish(expr):
                return _is_event_expr(expr) or (
                    isinstance(expr, ast.Name) and expr.id in ev_vars)

            for node in ast.walk(scope):
                if isinstance(node, ast.Compare):
                    sides = []
                    if _eventish(node.left):
                        sides = node.comparators
                    elif any(_eventish(c) for c in node.comparators):
                        sides = [node.left]
                    for side in sides:
                        if isinstance(side, (ast.Tuple, ast.List,
                                             ast.Set)):
                            for elt in side.elts:
                                yield from emit(self._check_literal(
                                    ctx, elt, "compared by a "
                                    "journal consumer"))
                        else:
                            yield from emit(self._check_literal(
                                ctx, side, "compared by a journal "
                                "consumer"))
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "count" \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id in ev_vars \
                        and node.args:
                    yield from emit(self._check_literal(
                        ctx, node.args[0],
                        "counted by a journal consumer"))

    def finalize(self, repo: Repo):
        doc = "docs/operations.md"
        if repo.doc_text(doc) is None:
            return
        rows = repo.doc_table_names(doc, r"[a-z_]+")
        for name in sorted(self.vocab):
            if name not in rows:
                yield Finding(
                    self.id, doc, 0,
                    f"journal event {name!r} has no row in the "
                    f"docs/operations.md event table")


# --------------------------------------------------- 4. env knobs

_ENV_BASES = ("os.environ", "environ")
_GETENV = ("os.getenv", "getenv")


class EnvKnobsChecker(Checker):
    id = "env-knobs"
    doc = ("TPULSAR_* env reads inside the package are declared in "
           "config.knobs.KNOBS, which renders the "
           "docs/configuration.md table")

    def __init__(self):
        from tpulsar_torch.config.knobs import KNOBS
        self.knobs = dict(KNOBS)
        self.read: dict[str, str] = {}   # name -> first read site

    def _reads(self, tree: ast.AST):
        """(name, node) for every TPULSAR_* env READ in the file."""
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                func = node.func
                chain = _chain(func)
                if (isinstance(func, ast.Attribute)
                        and func.attr == "get"
                        and chain.rsplit(".", 1)[0] in _ENV_BASES) \
                        or chain in _GETENV:
                    val, lit = _str_arg(node)
                    if val and val.startswith("TPULSAR_"):
                        yield val, lit
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and _chain(node.value) in _ENV_BASES:
                sl = node.slice
                if isinstance(sl, ast.Constant) \
                        and isinstance(sl.value, str) \
                        and sl.value.startswith("TPULSAR_"):
                    yield sl.value, node
            elif isinstance(node, ast.Compare) \
                    and isinstance(node.left, ast.Constant) \
                    and isinstance(node.left.value, str) \
                    and node.left.value.startswith("TPULSAR_") \
                    and any(isinstance(op, (ast.In, ast.NotIn))
                            for op in node.ops) \
                    and any(_chain(c) in _ENV_BASES
                            for c in node.comparators):
                yield node.left.value, node.left

    def visit(self, ctx: FileCtx):
        path = ctx.path.replace(os.sep, "/")
        if not path.startswith("tpulsar_torch/"):
            return   # chip_smoke.py and tools are harness scope, not
            #          deployment knobs
        for name, node in self._reads(ctx.tree):
            self.read.setdefault(name, f"{ctx.path}:{node.lineno}")
            if name not in self.knobs:
                yield Finding(
                    self.id, ctx.path, node.lineno,
                    f"undeclared env knob {name!r} read here",
                    "declare it in tpulsar_torch/config/knobs.py "
                    "(name, type, default, doc)")

    def finalize(self, repo: Repo):
        reg = os.path.join(repo.root, "tpulsar_torch/config/knobs.py")
        if os.path.isfile(reg):
            for name, knob in sorted(self.knobs.items()):
                if name not in self.read:
                    yield Finding(
                        self.id, "tpulsar_torch/config/knobs.py",
                        literal_line(reg, name),
                        f"declared knob {name!r} is never read "
                        f"inside the tpulsar_torch/ package",
                        "retire the registry entry or wire the knob")
        doc = "docs/configuration.md"
        if repo.doc_text(doc) is not None:
            rows = repo.doc_table_names(doc, r"TPULSAR_[A-Z0-9_]+")
            for name in sorted(self.knobs):
                if name not in rows:
                    yield Finding(
                        self.id, doc, 0,
                        f"knob {name!r} has no row in the "
                        f"docs/configuration.md knob table",
                        "the docs describe the JAX package: name "
                        "the difference in PORT_DIFFERENCES")
            for name in sorted(rows - set(self.knobs)):
                yield Finding(
                    self.id, doc, 0,
                    f"documented knob {name!r} is not declared in "
                    f"config/knobs.py")


# ------------------------------------------- 5. spool-write race

#: packages whose on-disk state carries the exactly-once proofs
_SPOOL_SCOPE = ("tpulsar_torch/serve/", "tpulsar_torch/fleet/",
                "tpulsar_torch/frontdoor/", "tpulsar_torch/chaos/",
                "tpulsar_torch/checkpoint/")
#: the modules that IMPLEMENT the discipline (the two-rename claim
#: protocol, _atomic_write_json, the checkpoint store's
#: tmp+fsync+rename) — raw calls inside them are the mechanism
_SPOOL_BLESSED = ("tpulsar_torch/serve/protocol.py",
                  "tpulsar_torch/checkpoint/store.py")
_WRITE_MODES = re.compile(r"[wx]")


class SpoolWriteChecker(Checker):
    id = "spool-write"
    doc = ("no bare open(.., 'w')/json.dump/os.rename/os.replace in "
           "the spool/checkpoint packages outside the blessed "
           "atomic-write helpers")

    def visit(self, ctx: FileCtx):
        path = ctx.path.replace(os.sep, "/")
        if not path.startswith(_SPOOL_SCOPE) \
                or path in _SPOOL_BLESSED:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _chain(node.func)
            bad = ""
            if chain in ("os.rename", "os.replace"):
                bad = chain
            elif chain == "json.dump":
                bad = "json.dump"
            elif chain == "open":
                mode, _ = _str_arg(node, idx=1, kw="mode")
                if mode and _WRITE_MODES.search(mode):
                    bad = f"open(.., {mode!r})"
            if bad:
                yield Finding(
                    self.id, ctx.path, node.lineno,
                    f"bare {bad} in a spool/checkpoint package — "
                    f"the write is outside the atomic-write/"
                    f"two-rename discipline",
                    "route it through serve/protocol."
                    "_atomic_write_json / _rename_held or the "
                    "checkpoint store; a justified exception takes "
                    "# tpulsar: lint-ok[spool-write]")


# --------------------------------------------- 6. bench-gate keys

class BenchKeysChecker(Checker):
    id = "bench-keys"
    doc = ("every bench_gate DEFAULT_KEYS path resolves in a "
           "committed BENCH_*.json baseline")
    #: the JAX package's tools/bench_gate.py and BENCH_*.json gate the
    #: JAX package's benchmark; the port's gate comes with its
    #: benchmark (ROADMAP item 26)
    not_run = ("the port has no bench gate and no committed bench "
               "file until ROADMAP item 26")


CHECKERS = (FaultPointsChecker, MetricsChecker, JournalEventsChecker,
            EnvKnobsChecker, SpoolWriteChecker, BenchKeysChecker)


# --------------------------------------------- the port's differences

#: One way in which the port differs from the JAX package, and so from
#: the docs tables, on purpose: the checker whose finding it excuses,
#: the name that finding quotes, why, and the ROADMAP item or rule of
#: the port that closes it.
PortDifference = collections.namedtuple(
    "PortDifference", ("checker", "name", "reason", "closes"))

_NO_FALLBACK = ("none: the port's rules (ROADMAP) let no fallback "
                "hide a hand kernel")

PORT_DIFFERENCES = (
    PortDifference(
        "fault-points", "dedisperse.pallas",
        "the catalog keeps the JAX package's point, but its site there "
        "is the Pallas kernel's fallback to XLA",
        _NO_FALLBACK),
    PortDifference(
        "env-knobs", "TPULSAR_ACCEL_NATIVE",
        "the JAX package's switch from its native CPU consumer to XLA; "
        "the port's CPU path has no XLA dispatch to switch to",
        "none: left out on purpose"),
    PortDifference(
        "env-knobs", "TPULSAR_BENCH_DTYPE",
        "the dtype of the JAX package's benchmark block, which its AOT "
        "program signatures assume; the port's libraries have no "
        "shapes",
        "ROADMAP item 26"),
    PortDifference(
        "env-knobs", "TPULSAR_DD_TREE",
        "the JAX package's second pin of the tree family",
        "none: TPULSAR_DD_FAMILY=tree is the port's one pin"),
    PortDifference(
        "env-knobs", "TPULSAR_PALLAS",
        "the Pallas kernels' switch and their XLA fallback",
        _NO_FALLBACK),
    PortDifference(
        "env-knobs", "TPULSAR_PALLAS_SB",
        "the stage-1 Pallas tier's switch",
        _NO_FALLBACK),
    PortDifference(
        "env-knobs", "TPULSAR_PALLAS_VARIANT",
        "the choice between two Pallas formulations of stage 2",
        "none: one CUDA kernel computes the function of both "
        "(ROADMAP Queue 2)"),
    PortDifference(
        "env-knobs", "TPULSAR_TRACE_SYNC",
        "the JAX package's opt-in fence of the traced chunk scopes; "
        "the port's device time per stage comes from CUDA events "
        "(search/report.py), which need no fence",
        "none: left out on purpose"),
    PortDifference(
        "metrics", "tpulsar_accel_kernel_rows_total",
        "the port's own family: the DM rows the hi stage's CUDA stage "
        "kernel (csrc/accel_stage.cu) consumed; the JAX package, which "
        "docs/operations.md describes, has no such kernel",
        "none: the port's own kernel"),
)
