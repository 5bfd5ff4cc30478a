"""Resilience primitives — counterpart of tpulsar/resilience/.

  faults.py  — named fault points that deterministically raise
               refusal-shaped or disk-shaped errors, simulate hangs,
               or poison the session, driven by TPULSAR_FAULTS.

The retry/deadline/circuit-breaker policy engine (policy.py) and the
host rescue of refused device work (rescue.py) are still to be
ported."""

from tpulsar_torch.resilience import faults  # noqa: F401
