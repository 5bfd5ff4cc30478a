"""Global debug-mode registry (reference: lib/python/debug.py:1-46)
— counterpart of tpulsar/obs/debugflags.py (a copy).

Named boolean modes toggled programmatically or via --debug-* CLI
flags; consumers check `debugflags.is_on("jobtracker")` etc.
"""

from __future__ import annotations

MODES = {
    "jobtracker": "log every job-tracker DB query",
    "upload": "print the per-category upload timing summary after "
              "each uploader iteration (the timings themselves are "
              "always aggregated into the tpulsar_upload_seconds "
              "metrics histogram; this flag only controls the print)",
    "download": "verbose downloader tracing",
    "syscalls": "echo every external command before execution",
    "qmanager": "verbose queue-manager tracing",
    "resultsdb": "log every results-DB statement",
}

_state: dict[str, bool] = {m: False for m in MODES}


def set_mode_on(*modes: str) -> None:
    for m in modes:
        if m.lower() not in _state:
            raise ValueError(f"unknown debug mode {m!r}")
        _state[m.lower()] = True


def set_mode_off(*modes: str) -> None:
    for m in modes:
        _state[m.lower()] = False


def set_allmodes_on() -> None:
    for m in _state:
        _state[m] = True


def set_allmodes_off() -> None:
    for m in _state:
        _state[m] = False


def is_on(mode: str) -> bool:
    return _state[mode.lower()]


def add_cli_flags(parser) -> None:
    """Add --debug and --debug-<mode> flags to an argparse parser
    (reference: pipeline_utils.PipelineOptions, :231-247)."""
    parser.add_argument("--debug", action="store_true",
                        help="enable all debug modes")
    for m, desc in MODES.items():
        parser.add_argument(f"--debug-{m}", action="store_true", help=desc)


def apply_cli_flags(args) -> None:
    if getattr(args, "debug", False):
        set_allmodes_on()
    for m in MODES:
        if getattr(args, f"debug_{m}", False):
            set_mode_on(m)
