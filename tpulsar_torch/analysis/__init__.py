"""Static contract analysis — counterpart of tpulsar/analysis/: the
port's hand-maintained contracts, machine-checked.

A new ``metrics.Counter`` outside the telemetry catalog, a journal
event the invariant verifier has never heard of, an undeclared
``TPULSAR_*`` env knob, or a bare ``json.dump`` onto a spool path
would ship silently — and the chaos verifier goes blind to exactly
the failure class it exists to catch.  ``python -m tpulsar_torch
lint`` walks ``tpulsar_torch/``, ``tools/torch_*.py`` and
``chip_smoke.py`` with stdlib-``ast`` visitors and fails instead.

Checkers (``--checker <id>`` runs a subset):

  fault-points    every literal passed to the faults layer is in
                  ``resilience.faults.FAULT_POINTS``; every catalog
                  point is fired somewhere and has a docs table row
  metrics         every metric constructor resolves to the
                  ``obs/telemetry.py`` instrument catalog; the
                  docs/operations.md metric table matches it both ways
  journal-events  every journal ``record()`` literal and every
                  verifier event comparison is in the exported
                  ``obs.journal.EVENTS`` vocabulary, and every
                  vocabulary entry has a docs table row
  env-knobs       every ``os.environ``/``os.getenv`` read of a
                  ``TPULSAR_*`` name inside the package is declared
                  in ``config.knobs.KNOBS``, every entry is read, and
                  the docs/configuration.md table matches both ways
  spool-write     inside serve/fleet/frontdoor/chaos/checkpoint, raw
                  ``open(.., "w")``/``json.dump``/``os.rename``/
                  ``os.replace`` must route through the blessed
                  atomic-write/two-rename helpers
  bench-keys      not run: the port has no bench gate until its
                  benchmark (ROADMAP item 26)

The docs are the JAX package's; ``checkers.PORT_DIFFERENCES`` names
each way in which the port differs from them on purpose, and ``lint
--list`` prints it.  A justified exception carries ``# tpulsar:
lint-ok[<checker>]`` on (or one line above) the flagged line.  Exit
codes: 0 clean, 1 findings, 2 internal error.  stdlib only: no torch,
no numpy.
"""

from tpulsar_torch.analysis.core import (Finding, lint, run_lint,  # noqa: F401
                                         render_text, render_json)
from tpulsar_torch.analysis.checkers import (CHECKERS,  # noqa: F401
                                             PORT_DIFFERENCES)
