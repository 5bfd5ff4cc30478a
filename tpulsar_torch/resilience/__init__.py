"""Resilience primitives — counterpart of tpulsar/resilience/.

  faults.py  — named fault points that deterministically raise
               refusal-shaped (DispatchRefused) or disk-shaped errors,
               simulate hangs, or poison the session, driven by
               TPULSAR_FAULTS.
  policy.py  — the shared retry / backoff / deadline / circuit-breaker
               engine (the hi stage's ladder and the server's per-beam
               deadline run through it).
  rescue.py  — recompute device-refused hi-accel rows on the host CPU
               (the same row program on a CPU copy of the spectra): a
               refused DM row becomes a slower row, not lost science.

faults and policy stay stdlib-only for the spool and journal code that
imports them; rescue (numpy, torch) loads on first attribute access
(PEP 562), and ``from tpulsar_torch.resilience import rescue`` works
either way."""

from tpulsar_torch.resilience import faults  # noqa: F401


def __getattr__(name: str):
    if name == "rescue":
        import importlib
        return importlib.import_module("tpulsar_torch.resilience.rescue")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
