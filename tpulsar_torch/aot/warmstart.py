"""The gate driver over the port's libraries, the build manifest, and
the build accounting — counterpart of tpulsar/aot/warmstart.py.

The gate (:func:`run_gate`) builds and loads every registered library
(tpulsar_torch.aot.registry) through the very calls the runtime makes
at first use, and records in the **manifest**
(``<build dir>/aot_manifest.json``) each library's path, a fingerprint
of what it was compiled from, its build seconds (null when it was
already on disk) and its ptxas report.  ``run_gate(verify=True)``
replays the same calls and reports a MISS for any library that had
to be built, is missing from the manifest or whose fingerprint
drifted — a worker that would compile in-line becomes a nonzero exit
instead of a slow first beam.

**Build accounting** (:func:`locked_build`, :func:`record_build`):
each library's build call is one lookup of the build directory.  It
finds the library (a hit) or compiles it (a miss, with its seconds),
and reports that through the telemetry catalog: ``tpulsar_compile_cache_hits_total`` /
``tpulsar_compile_cache_misses_total`` by ``program`` (the registered
library being gated, or ``(inline)`` for a build at first use), a
``tpulsar_backend_compile_seconds`` observation and, when tracing, a
retroactive ``backend_compile`` span and a ``compile_cache_miss``
instant.  :data:`COMPILES` is the per-process tally of the same
lookups (kernels/cuda_dd.COMPILES is this dict), which the executor
and the server read per beam.

Exit-code contract (the JAX package's): 0 = every library built and
loaded (and, with verify, zero misses); 1 = failures or misses; 3 =
the deadline elapsed between builds with libraries still pending — a
clean exit, re-run to resume.

stdlib at import time; the registered modules (torch, numpy) load
when a library is gated.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import threading
import time

from tpulsar_torch.aot import cachedir

#: manifest schema tag; distinct from the JAX package's, so each
#: package's load_manifest refuses the other's in a shared
#: TPULSAR_CACHE_DIR
MANIFEST_SCHEMA = "tpulsar-torch-aot-manifest/v1"

#: library lookups in this process: "hits" found a built library,
#: "misses" compiled one
COMPILES = {"hits": 0, "misses": 0}

# the program being gated, per thread (a build on any other thread,
# or outside the gate, is "(inline)"); and the outcome of the calling
# thread's last lookup, which the gate reads after each build call
_TLS = threading.local()
_COUNT_LOCK = threading.Lock()


def _program_label() -> str:
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else "(inline)"


@contextlib.contextmanager
def _current_program(name: str):
    stack = _TLS.__dict__.setdefault("stack", [])
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def record_build(seconds: float | None) -> None:
    """Account one library lookup: ``seconds`` of compiling (a miss),
    or None when the library was found built (a hit)."""
    from tpulsar_torch.obs import telemetry, trace

    label = _program_label()
    _TLS.last = seconds if seconds is not None else "hit"
    with _COUNT_LOCK:
        COMPILES["hits" if seconds is None else "misses"] += 1
    if seconds is None:
        telemetry.compile_cache_hits_total().inc(program=label)
        return
    telemetry.compile_cache_misses_total().inc(program=label)
    telemetry.backend_compile_seconds().observe(seconds, program=label)
    trace.complete("backend_compile", seconds, program=label)
    trace.instant("compile_cache_miss", program=label)


def locked_build(path: str, compile_fn) -> str:
    """The runtime's lookup of one library: ``path`` as it is when it
    exists, else ``compile_fn(path)`` builds it, under a file lock
    beside it (of two processes on a fresh build directory, one
    builds, the other waits and finds it).  The lookup is accounted
    as a hit or a miss (:func:`record_build`).  Returns ``path``."""
    import fcntl

    cachedir.ensured()
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            seconds = None
            if not os.path.exists(path):
                t0 = time.monotonic()
                compile_fn(path)
                seconds = time.monotonic() - t0
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    record_build(seconds)
    return path


# ------------------------------------------------------------------
# manifest
# ------------------------------------------------------------------

def _compiler_version(compiler: str) -> str:
    """The first line of ``<compiler> --version``."""
    res = subprocess.run([compiler, "--version"], capture_output=True,
                         text=True, timeout=60)
    lines = (res.stdout or res.stderr).strip().splitlines()
    return lines[0] if lines else ""


def fingerprint(prog) -> str:
    """What one library was compiled from: its sources, its flags, the
    compiler's version line and the program's context (the host tag
    of the native build; the CUDA runtime and the device's compute
    capability of the CUDA build).  A verify whose fingerprint differs
    from the manifest's would load a library built for something
    else."""
    from tpulsar_torch.aot import registry

    mod = registry.module(prog)
    h = hashlib.sha256(prog.name.encode())
    for src in mod.SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(repr(getattr(mod, prog.flags)).encode())
    h.update(_compiler_version(registry.compiler(prog)).encode())
    h.update(getattr(mod, prog.context)().encode())
    return h.hexdigest()[:32]


def load_manifest(path: str | None = None) -> dict | None:
    path = path or cachedir.manifest_path()
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(data, dict) or data.get("schema") != MANIFEST_SCHEMA:
        return None
    return data


def _save_manifest(manifest: dict, path: str | None = None) -> str:
    path = path or cachedir.manifest_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def _new_manifest(build_dir: str) -> dict:
    return {"schema": MANIFEST_SCHEMA, "created": time.time(),
            "build_dir": build_dir, "programs": {}}


@contextlib.contextmanager
def _manifest_lock(build_dir: str):
    """Serialize the manifest's read-modify-write between processes
    (two workers booting on one build directory)."""
    import fcntl

    with open(os.path.join(build_dir, ".manifest.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


# ------------------------------------------------------------------
# the gate driver
# ------------------------------------------------------------------

def _selected(prog, only: tuple[str, ...]) -> bool:
    return not only or any(pat in prog.name for pat in only)


def _gate_one(prog) -> tuple[str, float | None]:
    """Replay the runtime's calls for one library: its load call (which
    builds at first use), and, for a library this process already
    holds, its build call (the lookup the load skipped).  Returns the
    library path and the compile seconds (None on a hit)."""
    from tpulsar_torch.aot import registry

    mod = registry.module(prog)
    _TLS.last = None
    with _current_program(prog.name):
        getattr(mod, prog.load)()
        if _TLS.last is None:
            mod.build()
    last = _TLS.last
    return mod.library_path(), (None if last == "hit" else last)


def run_gate(only: tuple[str, ...] = (), deadline: float = 0.0,
             verify: bool = False, echo=print) -> int:
    """Build and load (or verify) the registered libraries.  See the
    module docstring for the exit-code contract; ``deadline`` is
    checked between builds (the first library always runs)."""
    t0 = time.monotonic()
    from tpulsar_torch.aot import registry
    from tpulsar_torch.obs import trace

    build_dir = cachedir.ensured()
    if trace.enabled():
        trace.start(clear=True)
    echo(f"build dir: {build_dir}")
    progs = [p for p in registry.PROGRAMS if _selected(p, only)]
    if not progs:
        # an --only pattern that matches nothing must not green-light
        # an unverified build directory with a vacuous rc 0
        echo("no gate programs matched"
             + (f" --only {','.join(only)}" if only else ""))
        return 1
    if verify and load_manifest() is None:
        echo(f"no manifest at {cachedir.manifest_path()} — run "
             "`python -m tpulsar_torch aot compile` first")
        return 1

    failures: list[str] = []
    deferred: list[str] = []
    done: dict[str, dict] = {}
    n_hit = n_miss = 0
    for prog in progs:
        if deadline and (done or failures) \
                and time.monotonic() - t0 > deadline:
            deferred.append(prog.name)
            echo(f"  [defer] {prog.name}: deadline reached; re-run to "
                 "resume")
            continue
        try:
            with trace.span("aot_compile", program=prog.name,
                            label=prog.name):
                path, built_s = _gate_one(prog)
            fp = fingerprint(prog)
        except Exception as e:
            # a library that does not build or load is a failure, with
            # the compiler's output, never a skip
            failures.append(prog.name)
            echo(f"  [FAIL] {prog.name}: {str(e).strip() or repr(e)}")
            continue
        report = path + ".ptxas.txt"
        done[prog.name] = {
            "library": path, "fingerprint": fp,
            "build_s": None if built_s is None else round(built_s, 3),
            "ptxas": report if os.path.exists(report) else None}
        if verify:
            rec = (load_manifest() or {}).get("programs", {}).get(
                prog.name)
            if built_s is not None:
                why = f"built ({built_s:.1f} s)"
            elif rec is None:
                why = "on disk but not in the manifest"
            elif rec.get("fingerprint") != fp or \
                    rec.get("library") != path:
                why = "fingerprint drifted since the manifest was written"
            else:
                why = ""
            if why:
                n_miss += 1
                echo(f"  [MISS] {prog.name}: {why}")
            else:
                n_hit += 1
                echo(f"  [hit] {prog.name}")
        else:
            n_miss += built_s is not None
            n_hit += built_s is None
            echo(f"  [ok] {prog.name}: {path} ("
                 + ("on disk" if built_s is None
                    else f"built in {built_s:.2f} s") + ")")

    if not verify and done:
        with _manifest_lock(build_dir):
            manifest = load_manifest()
            if manifest is None or manifest.get("build_dir") != build_dir:
                manifest = _new_manifest(build_dir)
            manifest["updated"] = time.time()
            manifest["programs"].update(done)
            _save_manifest(manifest)
    if trace.enabled():
        echo("trace: " + trace.save(
            os.path.join(build_dir, "aot_gate_trace.json")))
    return _finish(failures, deferred, echo=echo, verify=verify,
                   n_hit=n_hit, n_miss=n_miss, n_total=len(done))


def warm_boot(only: tuple[str, ...] = (), echo=print) -> int:
    """Boot-time gate for a resident worker (serve/server.py).

    Verify-first: when a manifest exists, replay the gate in verify
    mode — on a warm build directory an all-hits pass that only loads
    the libraries.  Only when the manifest is absent or the verify
    reports misses or failures does the compile gate run and rewrite
    the manifest.  Returns run_gate's rc contract."""
    if load_manifest() is not None:
        rc = run_gate(only=only, verify=True, echo=echo)
        if rc == 0:
            return 0
        echo("warm-start verify reported misses/failures; running the "
             "compile gate")
    return run_gate(only=only, echo=echo)


def _finish(failures: list[str], deferred: list[str], echo=print,
            verify: bool = False, n_hit: int = 0, n_miss: int = 0,
            n_total: int = 0) -> int:
    if failures:
        echo(f"{len(failures)} FAILED: {', '.join(failures)}")
        return 1
    if deferred:
        echo(f"{len(deferred)} deferred past deadline: "
             f"{', '.join(deferred)} — re-run to resume")
        return 3
    if verify:
        echo(f"manifest verify: {n_hit}/{n_total} hits, "
             f"{n_miss} misses")
        return 0 if n_miss == 0 else 1
    echo("all programs compiled")
    return 0
