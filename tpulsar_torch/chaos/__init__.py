"""The chaos harness: reproducible fleet-wide failure storms and a
journal-audited verifier of the serving stack's system invariants —
counterpart of tpulsar/chaos/ (a copy: the same scenarios, journal
events, result records and verdicts).

The resilience, serve, fleet, obs and frontdoor layers each test
their exactly-once/quota/trace guarantees in isolation; this package
is where those guarantees are proven to COMPOSE under correlated,
multi-process failure:

  scenario.py   — seeded, declarative chaos scenarios: a timeline of
                  coordinated actions (SIGKILL/SIGSTOP a worker,
                  restart the gateway, pause the janitor, open
                  per-worker fault windows) plus a beam workload,
                  serialized into ONE schedule file under
                  ``<spool>/chaos/`` that every process's faults
                  layer polls — one spec drives the whole fleet
                  deterministically; the seven packaged scenarios
                  are in ``scenarios/``;
  worker.py     — a protocol-complete, torch-free spool worker
                  (claims, heartbeats, journal, drain, crash/fault
                  points) so scenarios run dozens of beams in
                  seconds;
  runner.py     — the conductor: stand up a controller-supervised
                  fleet (optionally behind the HTTP gateway) of stub,
                  stream or real ``serve`` workers, submit the
                  workload, execute the schedule, quiesce/drain,
                  write the run manifest;
  invariants.py — the auditor: replay the ticket journal + spool
                  state + result store and assert the system-level
                  contract as NAMED, individually-reportable
                  invariants — the same list, texts and report as
                  the JAX package's, so either package's verifier
                  judges either package's storm.

Operator surface: ``python -m tpulsar_torch chaos run|verify|report``.
Control plane: nothing here imports torch; only the ``serve`` workers
a storm spawns touch the device.
"""

from tpulsar_torch.chaos import invariants, scenario  # noqa: F401
