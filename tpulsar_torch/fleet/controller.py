"""The fleet controller: spawn, supervise, and heal N spool workers —
counterpart of tpulsar/fleet/controller.py (a copy; the spool, the
journal, fleet.json, fleet.prom and fleet.ctl have the JAX package's
layout, so either package's ``fleet --status`` reads the other's
fleet).

One warm resident worker pays process start, kernel build and device
set-up once per boot; this layer provides the horizontal axis — N
worker processes pulling beams from ONE spool (the FAST drift-scan
pipeline's many-PRESTO-workers-one-queue shape), supervised by one
controller:

  * spawn/monitor/restart — each worker is ``python -m tpulsar_torch
    serve --worker-id wK`` on the shared spool (on the card, unless
    ``worker_args`` carries ``--device cpu``); a crashed worker is
    restarted under a resilience.policy backoff curve with a bounded
    restart budget (a crash-looping worker eventually stays down
    instead of thrashing the device);
  * the janitor — ``requeue_stale_claims`` runs every loop, so a
    ticket a dead worker held mid-beam returns to ``incoming`` within
    seconds and any surviving worker steals it (exactly-once: claims
    are exclusive renames, requeues take the claim file over
    atomically, and results are durable before claims release); the
    thief resumes the beam from the pass-level checkpoint under its
    outdir; beams that keep killing workers hit the ``attempts`` cap
    and are quarantined;
  * rolling drain-and-restart — workers are cycled ONE at a time
    (SIGTERM -> wait for drain -> respawn -> wait for a fresh
    heartbeat) so an upgrade never takes the whole fleet cold;
  * aggregation — fleet health (worker states, spool counts,
    aggregate capacity) is written each loop to ``<spool>/fleet.json``
    and ``<spool>/fleet.prom`` (the ``tpulsar_fleet_*`` catalog
    metrics), which is what ``fleet --status`` renders;
  * the hosted health doctor (obs/health.py) ticks in the loop,
    journaling alert transitions and persisting ``alerts.json``.

Operators talk to a running controller through a control file in the
spool (``fleet.ctl``): ``fleet --drain`` / ``--rolling-restart``
write it, the controller consumes it.  The controller itself drains on
SIGTERM/SIGINT like its workers.

``workers=0`` runs a pure janitor/aggregator over externally-launched
workers — useful when the worker processes are managed elsewhere (CI,
a cluster scheduler) but the spool still needs crash recovery.

The controller never imports torch: it is control plane, and only its
workers touch the device.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

from tpulsar_torch.fleet import autoscale as autoscale_mod
from tpulsar_torch.frontdoor import queue as queue_mod
from tpulsar_torch.obs import fleetview, health, journal, metrics, telemetry
from tpulsar_torch.obs.log import get_logger
from tpulsar_torch.resilience import policy
from tpulsar_torch.serve import protocol

CONTROL_FILE = "fleet.ctl"
FLEET_JSON = "fleet.json"
FLEET_PROM = "fleet.prom"


def write_control(spool: str, cmd: str) -> str:
    """Leave a command for the running controller (drain |
    rolling-restart).  Returns the control-file path."""
    assert cmd in ("drain", "rolling-restart"), cmd
    protocol.ensure_spool(spool)
    path = os.path.join(spool, CONTROL_FILE)
    protocol._atomic_write_json(path, {"cmd": cmd, "t": time.time(),
                                       "by": os.getpid()})
    return path


def read_control(spool: str, consume: bool = True) -> str | None:
    path = os.path.join(spool, CONTROL_FILE)
    rec = protocol._read_json(path)
    if rec is None:
        return None
    if consume:
        try:
            os.unlink(path)
        except OSError:
            pass
    return rec.get("cmd")


class _Worker:
    """One supervised worker slot (the process behind it comes and
    goes across restarts; the slot and its id persist)."""

    def __init__(self, worker_id: str, worker_class: str = "",
                 elastic: bool = False):
        self.worker_id = worker_id
        #: "" (on-demand) or "spot" — elastic slots the autoscaler
        #: adds carry the configured class; spot workers are
        #: SIGKILLed on scale-down instead of drained
        self.worker_class = worker_class
        #: True for slots the autoscaler may retire (above min, or
        #: added by a scale-up); base slots below min are NEVER
        #: scale-down candidates, independent of class
        self.elastic = elastic
        self.proc: subprocess.Popen | None = None
        self.pid: int | None = None
        self.incarnation = 0
        self.crash_restarts = 0
        self.next_restart_at: float | None = None
        self.spawned_at: float = 0.0
        self.gave_up = False
        self.done = False            # exited 0 in once mode
        self.last_rc: int | None = None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class FleetController:
    def __init__(self, spool: str, workers: int = 2, *,
                 worker_cmd=None, worker_env=None,
                 worker_args: tuple[str, ...] = (),
                 once: bool = False,
                 max_worker_restarts: int = 5,
                 restart_backoff_s: float = 1.0,
                 restart_decay_uptime_s: float = 300.0,
                 restart_policy: policy.RetryPolicy | None = None,
                 ticket_max_attempts: int =
                 protocol.DEFAULT_MAX_ATTEMPTS,
                 heartbeat_max_age_s: float | None = None,
                 autoscale: autoscale_mod.AutoscaleConfig
                 | None = None,
                 poll_s: float = 1.0,
                 drain_timeout_s: float = 120.0,
                 queue: queue_mod.TicketQueue | None = None,
                 logger=None, sleeper=time.sleep):
        self.spool = protocol.ensure_spool(spool)
        #: the ticket backend every queue-facing operation routes
        #: through (janitor requeues, counts, heartbeats, the
        #: elective-kill ledger).  Fleet PROCESS state — fleet.json,
        #: fleet.prom, fleet.ctl, worker logs — stays on the spool
        #: directory whatever the backend, so ``fleet``
        #: tooling keeps one place to look.
        self.q = queue if queue is not None \
            else queue_mod.FilesystemSpoolQueue(self.spool)
        #: journal root (== spool for the spool backend and for a
        #: queue.db living inside the run directory)
        self.jroot = self.q.journal_root or self.spool
        self.once = once
        #: callable(worker_id) -> argv; the default launches the real
        #: ``python -m tpulsar_torch serve`` worker (tests inject
        #: stubs)
        self.worker_cmd = worker_cmd or self._default_worker_cmd
        #: callable(worker_id) -> env-override dict (or None)
        self.worker_env = worker_env
        self.worker_args = tuple(worker_args)
        #: restart-backoff budget: should_retry() bounds how many
        #: crash restarts a worker slot gets, backoff_s() paces them
        self.restart_policy = restart_policy or policy.RetryPolicy(
            max_attempts=max(0, max_worker_restarts),
            backoff_base_s=restart_backoff_s, backoff_mult=2.0,
            backoff_max_s=60.0)
        #: restart-budget FAIRNESS: an incarnation that stayed up
        #: this long before crashing proves the slot is healthy, so
        #: its accumulated strikes decay to zero (the ticket side's
        #: attempts_at_progress watermark pattern, applied to the
        #: worker axis) — a long-lived fleet with rare unrelated
        #: crashes no longer exhausts a LIFETIME cap and abandons the
        #: slot forever.  0 disables the decay.
        self.restart_decay_uptime_s = restart_decay_uptime_s
        self.ticket_max_attempts = ticket_max_attempts
        self.heartbeat_max_age_s = heartbeat_max_age_s
        self.poll_s = poll_s
        self.drain_timeout_s = drain_timeout_s
        self.log = logger or get_logger("fleet")
        self.sleeper = sleeper
        #: elastic policy (None = the classic static fleet).  With it
        #: the initial worker count is clamped into [min, max] and
        #: slots past min_workers carry the elastic worker class.
        self.autoscale_cfg = autoscale
        self._as: autoscale_mod.Autoscaler | None = None
        if autoscale is not None:
            autoscale.validate()
            workers = max(autoscale.min_workers,
                          min(workers, autoscale.max_workers))
            self._as = autoscale_mod.Autoscaler(autoscale, self.spool,
                                                queue=self.q)
        self.workers = [
            _Worker(f"w{i}",
                    worker_class=(autoscale.worker_class
                                  if autoscale is not None
                                  and i >= autoscale.min_workers
                                  else ""),
                    elastic=(autoscale is not None
                             and i >= autoscale.min_workers))
            for i in range(workers)]
        self._next_wid = workers
        #: scale-down victims mid-retirement: worker -> SIGKILL
        #: escalation deadline (0 = already killed); their exit is
        #: elective, so _reap must not count it as a crash
        self._retiring: dict[_Worker, float] = {}
        self._cycling: _Worker | None = None
        #: chaos-harness hook: while set in the future, the janitor
        #: skips its recovery scan — models a slow/partitioned
        #: janitor so takeover latency becomes a scenario variable
        self._janitor_paused_until = 0.0
        self._drain = threading.Event()
        self._quarantined_seen: set[str] = set()
        #: merged-fleet.prom cadence: aggregation re-reads the ticket
        #: journal, so it must not run at poll_s frequency (no
        #: per-poll-second O(spool) work)
        self.prom_interval_s = 10.0
        self._prom_last = 0.0
        #: the hosted health doctor: every fleet gets the alert
        #: detector for free (TPULSAR_ALERT_INTERVAL_S <= 0 opts
        #: out); a doctor that cannot construct must not keep the
        #: fleet from serving
        self.alert_interval_s = health.alert_interval_s()
        self._doctor: health.HealthDetector | None = None
        self._doctor_last = 0.0
        if self.alert_interval_s > 0:
            try:
                self._doctor = health.HealthDetector(
                    self.jroot, queue=self.q, spool=self.spool,
                    extra_snapshots=lambda:
                        (metrics.REGISTRY.snapshot(),))
            except (OSError, ValueError) as e:
                self.log.error("health doctor disabled: %s", e)
        self.started_at = time.time()

    # ------------------------------------------------------------ control

    def install_signal_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return
        def _on_term(signum, frame):
            self.log.info("signal %d: draining the fleet", signum)
            self.request_drain()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_term)

    def request_drain(self) -> None:
        self._drain.set()

    @property
    def draining(self) -> bool:
        return self._drain.is_set()

    # ------------------------------------------------------------ workers

    def _default_worker_cmd(self, worker_id: str) -> list[str]:
        argv = [sys.executable, "-m", "tpulsar_torch"]
        cfgpath = os.environ.get("TPULSAR_CONFIG")
        if cfgpath:
            argv += ["--config", cfgpath]
        argv += ["serve", "--spool", self.spool,
                 "--worker-id", worker_id]
        if self.q.backend != "spool":
            # a non-spool backend rides the command line so worker
            # SUBPROCESSES claim from the same queue the controller
            # janitors (the spool stays their scratch/log root)
            argv += ["--queue", self.q.url]
        if self.once:
            argv.append("--once")
        argv += list(self.worker_args)
        return argv

    def _spawn(self, w: _Worker, kind: str = "start") -> None:
        argv = self.worker_cmd(w.worker_id)
        if w.worker_class:
            # the class rides the command line uniformly: both the
            # real serve worker and the chaos stub accept it, and an
            # injected worker_cmd needn't know elasticity exists
            argv = list(argv) + ["--worker-class", w.worker_class]
        env = dict(os.environ)
        if self.worker_env is not None:
            env.update(self.worker_env(w.worker_id) or {})
        logdir = os.path.join(self.spool, "workers")
        os.makedirs(logdir, exist_ok=True)
        logfh = open(os.path.join(logdir, f"{w.worker_id}.log"), "ab")
        try:
            w.proc = subprocess.Popen(argv, env=env, stdout=logfh,
                                      stderr=subprocess.STDOUT)
        finally:
            logfh.close()        # the child holds its own fd now
        w.pid = w.proc.pid
        w.incarnation += 1
        w.next_restart_at = None
        w.spawned_at = time.time()
        journal.record(self.jroot, "worker_spawn",
                       worker=w.worker_id, kind=kind, pid=w.pid,
                       incarnation=w.incarnation,
                       **({"worker_class": w.worker_class}
                          if w.worker_class else {}))
        self.log.info("%s worker %s (pid %d, incarnation %d%s)",
                      kind, w.worker_id, w.pid, w.incarnation,
                      f", class {w.worker_class}"
                      if w.worker_class else "")

    def _mark_worker_down(self, w: _Worker) -> None:
        """Stamp a dead incarnation's heartbeat 'stopped' so the warm
        backend's aggregate capacity stops counting it immediately
        (its file would otherwise read fresh for up to the heartbeat
        max age)."""
        hb = self.q.read_heartbeat(w.worker_id)
        if hb is not None and hb.get("pid") == w.pid \
                and hb.get("status") != "stopped":
            hb["status"] = "stopped"
            try:
                self.q.write_heartbeat_record(w.worker_id, hb)
            except OSError:
                pass     # the heartbeat ages out on its own

    def _reap(self) -> None:
        for w in list(self.workers):
            if w is self._cycling or w in self._retiring:
                continue     # mid-rolling-restart / mid-scale-down:
                             # its exit is the one we asked for, not
                             # a crash
            if w.proc is None or w.proc.poll() is None:
                continue
            rc = w.proc.returncode
            uptime = (time.time() - w.spawned_at
                      if w.spawned_at else 0.0)
            w.proc = None
            w.last_rc = rc
            self._mark_worker_down(w)
            journal.record(self.jroot, "worker_exit",
                           worker=w.worker_id, rc=rc, pid=w.pid,
                           incarnation=w.incarnation)
            if self.draining:
                continue
            if self.once and rc == 0:
                w.done = True
                self.log.info("worker %s finished (spool drained)",
                              w.worker_id)
                continue
            # restart-budget fairness: a crash after a HEALTHY uptime
            # window is not part of a crash loop — decay the strikes
            # so rare unrelated crashes over months cannot exhaust a
            # lifetime cap and abandon the slot (mirrors the ticket
            # side's attempts_at_progress watermark)
            if w.crash_restarts and self.restart_decay_uptime_s > 0 \
                    and uptime >= self.restart_decay_uptime_s:
                self.log.info(
                    "worker %s ran healthy for %.0f s (>= %.0f s): "
                    "restart budget reset (%d strike(s) decayed)",
                    w.worker_id, uptime, self.restart_decay_uptime_s,
                    w.crash_restarts)
                w.crash_restarts = 0
                w.gave_up = False
            if not self.restart_policy.should_retry(w.crash_restarts):
                if not w.gave_up:
                    w.gave_up = True
                    self.log.error(
                        "worker %s crashed (rc %s) with its restart "
                        "budget exhausted (%d restarts) — leaving it "
                        "down", w.worker_id, rc, w.crash_restarts)
                continue
            delay = self.restart_policy.backoff_s(w.crash_restarts)
            w.crash_restarts += 1
            w.next_restart_at = time.time() + delay
            telemetry.fleet_restarts_total().inc(
                worker=w.worker_id, kind="crash")
            self.log.warning(
                "worker %s crashed (rc %s); restart %d/%d in %.1f s",
                w.worker_id, rc, w.crash_restarts,
                self.restart_policy.max_attempts, delay)

    def _respawn_due(self) -> None:
        now = time.time()
        for w in self.workers:
            if (w.proc is None and not w.done and not w.gave_up
                    and not self.draining
                    and w.next_restart_at is not None
                    and now >= w.next_restart_at):
                self._spawn(w, kind="restart")

    # ------------------------------------------------------------ janitor

    def pause_janitor(self, seconds: float) -> None:
        """Suspend claim recovery for ``seconds`` (chaos scenarios:
        a janitor that lags is a recovery-latency experiment, not a
        correctness one — nothing else about supervision pauses)."""
        self._janitor_paused_until = time.time() + max(0.0, seconds)

    def _janitor(self) -> None:
        """Reclaim dead workers' orphaned claims (work stealing) and
        account newly quarantined beams."""
        if time.time() < self._janitor_paused_until:
            return
        try:
            requeued = self.q.requeue_stale_claims(
                self.ticket_max_attempts)
        except OSError as e:
            # a failing spool (ENOSPC burst, injected spool.io) must
            # not take the CONTROLLER down mid-loop: skip this beat,
            # the next one retries — recovery is delayed, never lost
            self.log.warning("janitor pass failed (%s); retrying "
                             "next loop", e)
            return
        if requeued:
            telemetry.fleet_requeued_total().inc(len(requeued))
            self.log.warning(
                "janitor requeued %d orphaned ticket(s): %s",
                len(requeued), ", ".join(requeued))
        for tid in self.q.list_tickets("quarantine"):
            if tid not in self._quarantined_seen:
                self._quarantined_seen.add(tid)
                telemetry.fleet_quarantined_total().inc()
                self.log.error(
                    "beam %s QUARANTINED: repeatedly killed its "
                    "worker (attempts cap %d)", tid,
                    self.ticket_max_attempts)

    # ---------------------------------------------------------- autoscale

    def _active_slots(self) -> list[_Worker]:
        """Slots that count toward capacity: not retiring, not done,
        not permanently given up (a crashed slot pending its paced
        restart still counts — it is coming back)."""
        return [w for w in self.workers
                if w not in self._retiring
                and not w.done and not w.gave_up]

    def _finalize_retiring(self) -> None:
        """Reap scale-down victims: SIGKILL those past their drain
        deadline, and retire the slots of those that exited (their
        exit is journaled ``kind=scale_down`` — elective, never a
        crash strike against the restart budget)."""
        now = time.time()
        for w in list(self._retiring):
            if w.proc is not None and w.proc.poll() is None:
                if now >= self._retiring[w]:
                    self.log.warning(
                        "scale-down victim %s still alive past its "
                        "%.0f s drain deadline; escalating to "
                        "SIGKILL (checkpoint resume makes this "
                        "cheap)", w.worker_id,
                        self.autoscale_cfg.drain_deadline_s)
                    try:
                        w.proc.kill()
                    except OSError:
                        pass
                    self._retiring[w] = now + 10.0   # re-checked
                continue
            rc = w.proc.returncode if w.proc is not None else None
            w.proc = None
            w.last_rc = rc
            self._mark_worker_down(w)
            journal.record(self.jroot, "worker_exit",
                           worker=w.worker_id, rc=rc, pid=w.pid,
                           incarnation=w.incarnation,
                           kind="scale_down")
            self.log.info("scale-down victim %s retired (rc %s)",
                          w.worker_id, rc)
            del self._retiring[w]
            try:
                self.workers.remove(w)
            except ValueError:
                pass
            # elastic slot ids are never reused, so a retired slot's
            # liveness/metrics records are permanently dead — remove
            # them, or a long-lived fleet leaks one heartbeat + one
            # metrics snapshot per scale cycle, all stat+parsed by
            # every freshness/capacity probe forever
            try:
                self.q.remove_heartbeat(w.worker_id)
            except OSError:
                pass
            try:
                os.unlink(fleetview.snapshot_path(self.spool,
                                                  w.worker_id))
            except OSError:
                pass

    def _pick_victim(self) -> _Worker | None:
        """Scale-down victim choice: ELASTIC slots only (a base slot
        below min is never retired, whatever decide() counted as
        live), spot class first (SIGKILL is routine for them), then
        the youngest.  Refuses entirely when retiring would leave
        fewer than min ALIVE workers — decide() counts crashed slots
        pending restart as live (they are coming back), but the
        fleet must not go dark through their backoff window."""
        alive = [w for w in self._active_slots()
                 if w is not self._cycling and w.alive]
        if len(alive) <= self.autoscale_cfg.min_workers:
            return None
        candidates = [w for w in alive if w.elastic]
        if not candidates:
            return None
        candidates.sort(key=lambda w: (
            0 if w.worker_class == "spot" else 1,
            -self.workers.index(w)))
        return candidates[0]

    def _autoscale_tick(self) -> None:
        if self._as is None:
            return
        self._finalize_retiring()
        if self.draining or self._cycling is not None:
            return
        cfg = self.autoscale_cfg
        sig = self._as.read_signals(len(self._active_slots()))
        decision = self._as.decide(sig)
        if decision is None:
            return
        before = len(self._active_slots())
        if decision.direction == "up":
            spawned = 0
            for _ in range(decision.n):
                w = _Worker(f"w{self._next_wid}",
                            worker_class=cfg.worker_class,
                            elastic=True)
                self._next_wid += 1
                self.workers.append(w)
                try:
                    self._spawn(w, kind="scale_up")
                except OSError as e:
                    # a failed elastic spawn costs the slot, never
                    # the controller: drop it and retry next trigger
                    self.log.error("scale-up spawn of %s failed: %s",
                                   w.worker_id, e)
                    self.workers.remove(w)
                    continue
                spawned += 1
            if not spawned:
                return
            telemetry.fleet_scale_total().inc(spawned,
                                              direction="up")
            if spawned != decision.n:
                # journal what actually HAPPENED: a partial spawn
                # (EAGAIN under the very load that triggered the
                # scale-up) must not make the event's arithmetic lie
                # to the scaling_bounded auditor
                import dataclasses as _dc
                decision = _dc.replace(decision, n=spawned)
            ev = autoscale_mod.journal_scale_event(
                self.jroot, decision, cfg, before, before + spawned,
                queue=self.q)
            # cooldown armed from the JOURNAL timestamp, not the
            # signal-read instant: the auditor measures gaps between
            # journaled events, and spawns on a loaded host can take
            # longer than any fixed audit slack
            self._as.note_action((ev or {}).get("t"))
            self.log.warning("scale UP %d -> %d worker(s): %s",
                             before, before + spawned,
                             decision.reason)
            return
        # ---- scale down: drain-or-preempt one victim
        w = self._pick_victim()
        if w is None:
            return
        spot = w.worker_class == "spot"
        mode = "kill" if spot else "drain"
        # ledger BEFORE the signal: by the instant the pid reads
        # dead, every janitor already knows the death was elective —
        # the ordering no_elastic_strike rests on
        try:
            self.q.record_elective_kill(w.worker_id, w.pid or 0)
        except OSError as e:
            # without the ledger a kill would charge the victim's
            # beams a crash strike — skip this scale-down entirely
            self.log.error("scale-down ledger write failed (%s); "
                           "keeping %s", e, w.worker_id)
            return
        ev = autoscale_mod.journal_scale_event(
            self.jroot, decision, cfg, before, before - 1,
            victims=[{"worker": w.worker_id, "pid": w.pid,
                      "worker_class": w.worker_class,
                      "mode": mode}], queue=self.q)
        try:
            if spot:
                # spot semantics: SIGKILL is routine — no drain, the
                # janitor reclaims its claims attempt-neutrally and
                # checkpoint resume salvages its durable passes
                w.proc.kill()
                self._retiring[w] = 0.0
            else:
                w.proc.send_signal(signal.SIGTERM)
                self._retiring[w] = time.time() \
                    + cfg.drain_deadline_s
        except OSError:
            self._retiring[w] = 0.0      # already dead: just retire
        telemetry.fleet_scale_total().inc(direction="down")
        self._as.note_action((ev or {}).get("t"))
        self.log.warning("scale DOWN %d -> %d: %s %s (%s)",
                         before, before - 1, mode, w.worker_id,
                         decision.reason)

    # ------------------------------------------------------------- doctor

    def _doctor_tick(self, force: bool = False) -> None:
        """One hosted health-doctor evaluation (throttled to
        alert_interval_s).  A detector tick failure costs that tick,
        never the fleet — the doctor is observational, like the
        journal it reads."""
        if self._doctor is None:
            return
        now = time.time()
        if not force and now - self._doctor_last \
                < self.alert_interval_s:
            return
        self._doctor_last = now
        try:
            self._doctor.tick()
        except Exception:
            self.log.warning("health doctor tick failed",
                             exc_info=True)

    # ---------------------------------------------------------- aggregate

    def _worker_state(self, w: _Worker) -> str:
        if not w.alive:
            return "dead"
        hb = self.q.read_heartbeat(w.worker_id)
        if hb is not None and hb.get("pid") == w.pid \
                and protocol._hb_fresh(hb, self.heartbeat_max_age_s):
            return "fresh"
        return "stale"

    def _aggregate(self, status: str = "running") -> dict:
        heartbeats = self.q.list_heartbeats()
        states = {w.worker_id: self._worker_state(w)
                  for w in self.workers}
        for st in ("fresh", "stale", "dead"):
            telemetry.fleet_workers().set(
                sum(1 for s in states.values() if s == st), state=st)
        # the spool backend's capacity() is the short-TTL cached
        # probe: _aggregate runs every poll second and the raw read
        # re-stats every heartbeat + the pending listing
        cap = self.q.capacity(self.heartbeat_max_age_s)
        # -1 = ZERO fresh workers (clients load-shed); 0 = fresh
        # workers but a full queue (backpressure) — a dashboard must
        # be able to tell a down fleet from a busy one
        telemetry.fleet_capacity().set(-1 if cap is None else cap)
        if self.autoscale_cfg is not None:
            telemetry.fleet_autoscale_workers().set(
                len(self._active_slots()))
        rec = {
            "t": time.time(),
            "controller_pid": os.getpid(),
            "status": status,
            "started_at": self.started_at,
            "workers": [{
                "id": w.worker_id, "pid": w.pid, "alive": w.alive,
                "state": states[w.worker_id],
                "class": w.worker_class,
                "retiring": w in self._retiring,
                "incarnation": w.incarnation,
                "crash_restarts": w.crash_restarts,
                "gave_up": w.gave_up, "last_rc": w.last_rc,
                "heartbeat": heartbeats.get(w.worker_id),
            } for w in self.workers],
            "autoscale": ({
                "min": self.autoscale_cfg.min_workers,
                "max": self.autoscale_cfg.max_workers,
                "active": len(self._active_slots()),
                "retiring": len(self._retiring),
                "cooldown_s": self.autoscale_cfg.cooldown_s,
            } if self.autoscale_cfg is not None else None),
            "external_workers": sorted(
                wid for wid in heartbeats
                if wid not in states and wid != ""),
            "queue": self.q.url,
            "pending": self.q.pending_count(),
            "claimed": self.q.claimed_count(),
            "done": self.q.state_count("done"),
            "quarantined": self.q.state_count("quarantine"),
            "capacity": cap,
        }
        try:
            protocol._atomic_write_json(
                os.path.join(self.spool, FLEET_JSON), rec)
            # the MERGED fleet export: every worker's snapshot + the
            # journal SLO series + this controller's own registry —
            # not just the controller's view (obs/fleetview.py).
            # Throttled to prom_interval_s: it re-reads the journal,
            # which must not happen every poll second.  A stopping
            # fleet always writes its final state.
            now = time.time()
            if status == "stopped" or \
                    now - self._prom_last >= self.prom_interval_s:
                self._prom_last = now
                extras = [metrics.REGISTRY.snapshot()]
                if self._doctor is not None:
                    # the doctor's active-alert gauge rides the
                    # merged export: tpulsar_alerts_active is
                    # scrape-able wherever fleet.prom already is
                    extras.append(self._doctor.metrics_snapshot())
                fleetview.write_fleet_prom(
                    self.spool,
                    extra_snapshots=tuple(extras),
                    path=os.path.join(self.spool, FLEET_PROM))
        except OSError:
            pass         # a full disk must not take the fleet down
        return rec

    # ------------------------------------------------------ rolling restart

    def _wait(self, pred, timeout: float, tick=None) -> bool:
        t0 = time.time()
        while time.time() - t0 < timeout:
            if pred():
                return True
            if tick is not None:
                tick()
            self.sleeper(min(0.2, self.poll_s))
        return pred()

    def _supervise_tick(self) -> None:
        """One supervision beat (reap crashes, respawn due workers,
        janitor the spool) — run INSIDE long waits so a slow rolling
        drain of one worker cannot starve a crashed co-worker's
        restart or leave its orphaned claim unrequeued for the whole
        cycle."""
        self._reap()
        self._respawn_due()
        self._janitor()
        if self._as is not None:
            # a rolling restart must still reap retirees and
            # escalate overdue drains; _autoscale_tick makes no new
            # decisions while _cycling is set
            self._finalize_retiring()

    def _rolling_restart(self) -> None:
        """Cycle workers ONE at a time so the fleet never goes fully
        cold: drain worker k, respawn it, wait for its fresh
        heartbeat, only then move to worker k+1.  Supervision of the
        OTHER workers keeps beating throughout (_supervise_tick); the
        cycled worker itself is excluded from crash-reaping while it
        drains (self._cycling)."""
        self.log.info("rolling restart: %d worker(s)",
                      len(self.workers))
        for w in self.workers:
            if self.draining:
                return
            # the reap exclusion covers ONLY the old incarnation's
            # drain (its exit is the drain we asked for, not a crash)
            self._cycling = w
            try:
                if w.alive:
                    w.proc.send_signal(signal.SIGTERM)
                    if not self._wait(lambda: not w.alive,
                                      self.drain_timeout_s,
                                      tick=self._supervise_tick):
                        self.log.warning(
                            "worker %s ignored SIGTERM for %.0f s; "
                            "killing it", w.worker_id,
                            self.drain_timeout_s)
                        w.proc.kill()
                        self._wait(lambda: not w.alive, 10.0)
                    w.last_rc = w.proc.returncode if w.proc else None
                    w.proc = None
                    self._mark_worker_down(w)
            finally:
                self._cycling = None
            if w.done or w.gave_up:
                continue
            self._spawn(w, kind="rolling-restart")
            telemetry.fleet_restarts_total().inc(
                worker=w.worker_id, kind="rolling")
            # the NEW incarnation is supervised normally while we wait
            # for its heartbeat: if the rolled-out binary crashes on
            # boot, the tick's reap counts it and paces a backoff
            # restart instead of spinning the full timeout unlogged
            self._wait(
                lambda: self._worker_state(w) == "fresh",
                self.drain_timeout_s, tick=self._supervise_tick)
            self._aggregate()

    # ----------------------------------------------------------- the loop

    def run(self) -> int:
        """Supervise until drained (daemon) or the spool is fully
        processed (once=True).  Returns 0 when every submitted beam
        reached a terminal state (done/quarantined), 1 when the fleet
        gave up with tickets still outstanding."""
        protocol.ensure_spool(self.spool)
        self.install_signal_handlers()
        rc = 0
        try:
            # inside the try: a spawn failure for worker k must still
            # run _shutdown so workers 0..k-1 are not leaked running
            # unsupervised (no janitor, no restarts, no drain)
            for w in self.workers:
                self._spawn(w)
            while not self.draining:
                self._reap()
                self._respawn_due()
                self._janitor()
                self._autoscale_tick()
                self._doctor_tick()
                cmd = read_control(self.spool)
                if cmd == "drain":
                    self.log.info("control file: drain")
                    self.request_drain()
                    break
                if cmd == "rolling-restart":
                    self._rolling_restart()
                self._aggregate()
                outstanding = (self.q.pending_count()
                               or self.q.claimed_count())
                if self.workers and all(
                        w.done or w.gave_up for w in self.workers):
                    if outstanding:
                        if self.once:
                            self.log.error(
                                "every worker is done or gave up "
                                "with tickets outstanding")
                            rc = 1
                            break
                        # daemon mode: stay up as janitor/aggregator —
                        # the operator may attach external workers
                    else:
                        break
                if self.once and not self.workers and not outstanding:
                    break        # pure-janitor once mode: spool drained
                self.sleeper(self.poll_s)
        finally:
            rc = self._shutdown(rc)
        return rc

    def _shutdown(self, rc: int) -> int:
        for w in self.workers:
            if w.alive:
                w.proc.send_signal(signal.SIGTERM)
        deadline = time.time() + self.drain_timeout_s
        for w in self.workers:
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=max(0.1,
                                        deadline - time.time()))
            except subprocess.TimeoutExpired:
                self.log.warning("worker %s ignored SIGTERM; killing",
                                 w.worker_id)
                w.proc.kill()
                try:
                    w.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    pass
            w.last_rc = w.proc.returncode
            w.proc = None
            self._mark_worker_down(w)
            # the drain exit belongs in the journal like every other
            # incarnation end: worker-seconds accounting (the
            # autoscale bench's cost-per-beam) pairs every
            # worker_spawn with a worker_exit
            journal.record(self.jroot, "worker_exit",
                           worker=w.worker_id, rc=w.last_rc,
                           pid=w.pid, incarnation=w.incarnation,
                           kind="drain")
        self._retiring.clear()
        # one last janitor pass: claims the TERM'd workers requeued
        # themselves are fine, but a worker that died ignoring the
        # drain leaves orphans this controller should not strand
        self._janitor()
        # ...and one last doctor pass over the final journal state:
        # a crash in the storm's last seconds must still make its
        # alert deadline (the alert_no_missed audit), and the
        # persisted alerts.json must reflect everything that happened
        self._doctor_tick(force=True)
        self._aggregate(status="stopped")
        self.log.info(
            "fleet stopped after %.0f s: pending=%d claimed=%d "
            "done=%d quarantined=%d",
            time.time() - self.started_at,
            self.q.pending_count(), self.q.claimed_count(),
            self.q.state_count("done"),
            self.q.state_count("quarantine"))
        return rc


# ---------------------------------------------------------------- status

def status_rc(spool: str,
              max_age_s: float | None = None) -> int:
    """Health exit code for ``fleet --status`` (cron/CI
    scripting): 1 when a RUNNING controller's fleet.json has gone
    stale past the heartbeat grace — the controller died without
    stamping the fleet stopped.  0 otherwise: a fresh file, a
    deliberately stopped fleet, or no fleet.json at all (nothing to
    judge — workers may be launched externally)."""
    if max_age_s is None:
        max_age_s = protocol.heartbeat_max_age()
    rec = protocol._read_json(os.path.join(spool, FLEET_JSON))
    if rec is None or rec.get("status") == "stopped":
        return 0
    return 1 if time.time() - rec.get("t", 0.0) > max_age_s else 0


def render_status(spool: str,
                  max_age_s: float | None = None,
                  queue: queue_mod.TicketQueue | None = None) -> str:
    """Human-readable fleet status from the fleet's shared state (no
    controller required: heartbeats + fleet.json are on disk) —
    including the autoscaler's decision trail, so the operator can
    audit from the journal alone why the fleet is its current size.
    ``queue`` routes ticket/liveness reads through a non-spool
    backend (``--queue sqlite:...``); fleet.json stays on the
    spool."""
    if max_age_s is None:
        max_age_s = protocol.heartbeat_max_age()
    q = queue if queue is not None \
        else queue_mod.FilesystemSpoolQueue(spool)
    lines = [f"fleet spool: {spool}"]
    if q.backend != "spool":
        lines.append(f"ticket queue: {q.url}")
    rec = protocol._read_json(os.path.join(spool, FLEET_JSON))
    if rec is not None:
        age = time.time() - rec.get("t", 0.0)
        stale = (" — STALE past the heartbeat grace "
                 f"({max_age_s:.0f} s): controller presumed dead"
                 if status_rc(spool, max_age_s) else "")
        lines.append(
            f"controller: pid {rec.get('controller_pid')} "
            f"{rec.get('status', '?')} (fleet.json {age:.0f} s old"
            f"{stale})")
    else:
        lines.append("controller: no fleet.json (not running, or "
                     "workers launched externally)")
    heartbeats = q.list_heartbeats()
    if heartbeats:
        lines.append(f"{len(heartbeats)} worker heartbeat(s):")
        for wid, hb in heartbeats.items():
            age = time.time() - hb.get("t", 0.0)
            fresh = protocol._hb_fresh(hb, max_age_s)
            beams = hb.get("beams") or {}
            lines.append(
                f"  [{'fresh' if fresh else 'STALE'}] "
                f"{wid or '(single server)'}"
                f"{' (' + hb['worker_class'] + ')' if hb.get('worker_class') else ''}"
                f": pid {hb.get('pid')} "
                f"{hb.get('status', '?')}, heartbeat {age:.0f} s ago, "
                f"depth {hb.get('queue_depth', '?')}/"
                f"{hb.get('max_queue_depth', '?')}, beams "
                f"done={beams.get('done', 0)} "
                f"failed={beams.get('failed', 0)} "
                f"skipped={beams.get('skipped', 0)}")
    else:
        lines.append("no worker heartbeats")
    cap = q.capacity(max_age_s)
    lines.append(
        f"queue: pending={q.pending_count()} "
        f"claimed={q.claimed_count()} "
        f"done={q.state_count('done')} "
        f"quarantined={q.state_count('quarantine')}"
        f" capacity={'none (0 fresh workers)' if cap is None else cap}")
    asc = (rec or {}).get("autoscale")
    trail = autoscale_mod.decision_trail(q.journal_root or spool)
    if asc or trail:
        head = "autoscaler"
        if asc:
            head += (f": {asc.get('active', '?')} active worker(s) "
                     f"in [{asc.get('min', '?')}, "
                     f"{asc.get('max', '?')}]"
                     + (f", {asc['retiring']} retiring"
                        if asc.get("retiring") else "")
                     + f", cooldown {asc.get('cooldown_s', '?')} s")
        lines.append(head)
        if trail:
            lines.append(f"last {len(trail)} scaling decision(s) "
                         f"(journal):")
            lines.extend(autoscale_mod.render_trail(trail))
        else:
            lines.append("  (no journaled scaling decisions yet)")
    return "\n".join(lines)
