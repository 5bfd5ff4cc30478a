"""Resilience primitives — counterpart of tpulsar/resilience/.

  faults.py  — named fault points that deterministically raise
               refusal-shaped or disk-shaped errors, simulate hangs,
               or poison the session, driven by TPULSAR_FAULTS.
  policy.py  — the shared retry / backoff / deadline / circuit-breaker
               engine (the server's per-beam deadline runs through
               run_with_deadline).

The host rescue of refused device work (rescue.py) is still to be
ported."""

from tpulsar_torch.resilience import faults  # noqa: F401
