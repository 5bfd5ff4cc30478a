"""The chaos conductor: one scenario in, one auditable run out —
counterpart of tpulsar/chaos/runner.py (a copy, spawning this
package's processes: the stub worker, the stream worker on its host
backend, and ``python -m tpulsar_torch serve``, which runs on the card
unless ``worker_extra_args`` carries ``--device cpu``).

``ChaosRunner.run()`` stands up a controller-supervised fleet on a
spool (optionally fronted by the HTTP gateway), submits the
scenario's synthetic beam workload, executes the timeline — kills,
SIGSTOPs, gateway restarts, janitor pauses, while the schedule file
opens the per-worker fault windows inside the workers themselves —
then quiesces (every submitted beam terminal, or the timeout),
drains the fleet, and writes the run manifest to
``<spool>/chaos/run.json``.

Everything the conductor DOES is journaled as ``chaos_action``
events, bracketed by ``chaos_run_start``/``chaos_run_end``: the
run's own violence is part of the same evidence stream the
invariant auditor replays, which is how MTTR ("kill at t, victim
terminal at t+x") falls out of the journal with no side channel.

The conductor's faults layer is NOT armed: fault windows address
workers (the processes under test); the conductor must keep
observing and submitting through the storm it causes.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time

from tpulsar_torch.chaos import scenario as scenario_mod
from tpulsar_torch.frontdoor.queue import get_ticket_queue
from tpulsar_torch.obs import journal, telemetry
from tpulsar_torch.obs.log import get_logger
from tpulsar_torch.serve import protocol

_SIGNALS = {"KILL": signal.SIGKILL, "TERM": signal.SIGTERM,
            "STOP": signal.SIGSTOP, "CONT": signal.SIGCONT}


def beam_payload(name: str, seed: int, i: int,
                 size: int = 16384) -> bytes:
    """One dataplane beam's synthetic input bytes — a pure function
    of (scenario, seed, beam index), so a requeued/retried beam
    fetches byte-identical inputs and the run is reproducible from
    the scenario file alone."""
    import hashlib
    block = hashlib.sha256(f"{name}:{seed}:beam{i}".encode()).digest()
    reps = size // len(block) + 1
    return (block * reps)[:size]


def stream_chunk_payload(name: str, seed: int, i: int, seq: int,
                         nchan: int, chunk_len: int):
    """One streaming session chunk — like :func:`beam_payload`, a
    pure function of (scenario, seed, session index, seq), so a
    killed-and-resumed session and the timeline-stripped control run
    dedisperse byte-identical samples and must publish identical
    trigger digests.  Every few chunks carry a bright broadband
    pulse so the storm's trigger plane has something real to find."""
    import hashlib

    import numpy as np
    block = hashlib.sha256(
        f"{name}:{seed}:session{i}:chunk{seq}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(block[:8], "little"))
    arr = rng.standard_normal((nchan, chunk_len)).astype(np.float32)
    if seq % 4 == 1:
        arr[:, chunk_len // 3] += 6.0
    return arr


class ChaosRunner:
    def __init__(self, sc: scenario_mod.Scenario, spool: str, *,
                 queue_url: str = "",
                 worker_extra_args: tuple[str, ...] = (),
                 logger=None, sleeper=time.sleep):
        self.sc = sc
        self.spool = protocol.ensure_spool(spool)
        #: the ticket backend the WHOLE storm rides — conductor
        #: submissions, the controller's janitor, the gateway, and
        #: every worker subprocess (via --queue on its command
        #: line).  A corrupt sqlite db refuses loudly right here,
        #: before any process is spawned.
        self.queue_url = sc.effective_queue_url(self.spool,
                                                override=queue_url)
        self.q = get_ticket_queue(self.queue_url)
        #: journal root: == spool for the spool backend and for the
        #: 'sqlite' token's queue.db-inside-the-run layout
        self.jroot = self.q.journal_root or self.spool
        self.worker_extra_args = tuple(worker_extra_args)
        self.log = logger or get_logger("chaos")
        self.sleeper = sleeper
        self.gateway = None
        self._gateway_port = 0
        self._ctrl = None
        self._ctrl_thread: threading.Thread | None = None
        self._stopped_pids: set[int] = set()
        self.tickets: list[str] = []
        self.actions: list[dict] = []
        #: next beam index for EXTRA submissions (surge_submit /
        #: flap_capacity bursts) — continues past the steady
        #: workload's ids so every ticket id and outdir stays unique
        self._beam_seq = sc.workload.beams
        #: stream feeder threads (worker_kind=stream): one per
        #: session, landing chunk frames behind the submitted ticket
        self._feeders: list[threading.Thread] = []

    # ------------------------------------------------------------- fleet

    def _worker_cmd(self, worker_id: str) -> list[str]:
        import sys
        batch = (["--batch", str(self.sc.batch)]
                 if self.sc.batch > 1 else [])
        if self.sc.worker_kind == "stub":
            return [sys.executable, "-m", "tpulsar_torch.chaos.worker",
                    "--spool", self.spool, "--worker-id", worker_id,
                    "--queue", self.queue_url,
                    "--beam-s", str(self.sc.beam_s),
                    "--max-attempts", str(self.sc.max_attempts),
                    *batch, *self.worker_extra_args]
        if self.sc.worker_kind == "stream":
            # the host backend, as the JAX stream worker's default: this
            # package's worker defaults to the card, so ask for the host
            return [sys.executable, "-m", "tpulsar_torch.stream.worker",
                    "--spool", self.spool, "--worker-id", worker_id,
                    "--queue", self.queue_url,
                    "--max-attempts", str(self.sc.max_attempts),
                    "--backend", "numpy", "--device", "cpu",
                    *self.worker_extra_args]
        argv = [sys.executable, "-m", "tpulsar_torch"]
        cfgpath = os.environ.get("TPULSAR_CONFIG")
        if cfgpath:
            argv += ["--config", cfgpath]
        argv += ["serve", "--spool", self.spool,
                 "--worker-id", worker_id, "--no-warmstart",
                 "--queue", self.queue_url,
                 *batch, *self.worker_extra_args]
        return argv

    def _worker_env(self, worker_id: str) -> dict:
        import json as _json
        env = {"TPULSAR_CHAOS_SCHEDULE":
               scenario_mod.schedule_path(self.spool),
               "TPULSAR_CHAOS_WORKER": worker_id}
        if self.sc.tenants:
            env["TPULSAR_CHAOS_TENANTS"] = _json.dumps(
                self.sc.tenants)
        if self.sc.dataplane and self.gateway is not None:
            # spool-less stage-in: workers fetch blobs: refs and push
            # artifacts over HTTP — the gateway was started BEFORE
            # the fleet precisely so its URL exists to hand out here
            # (restart_gateway rebinds the same port, so the URL
            # survives the storm's gateway kills)
            env["TPULSAR_DATA_URL"] = self.gateway.url
        return env

    def _start_fleet(self):
        from tpulsar_torch.fleet.autoscale import AutoscaleConfig
        from tpulsar_torch.fleet.controller import FleetController
        asc = (AutoscaleConfig.from_dict(self.sc.autoscale)
               if self.sc.autoscale else None)
        self._ctrl = FleetController(
            self.spool, workers=self.sc.workers,
            queue=self.q,
            worker_cmd=self._worker_cmd,
            worker_env=self._worker_env,
            max_worker_restarts=self.sc.max_worker_restarts,
            ticket_max_attempts=self.sc.max_attempts,
            autoscale=asc,
            poll_s=self.sc.poll_s,
            drain_timeout_s=20.0, logger=self.log)
        self._ctrl_thread = threading.Thread(
            target=self._ctrl.run, name="chaos-fleet", daemon=True)
        self._ctrl_thread.start()

    def _start_gateway(self, port: int = 0):
        from tpulsar_torch.frontdoor.gateway import GatewayServer
        from tpulsar_torch.frontdoor.tenancy import TenantPolicy
        self.gateway = GatewayServer(
            queue=self.q,
            policy=TenantPolicy(self.sc.tenants),
            port=port,
            outdir_base=os.path.join(
                scenario_mod.chaos_dir(self.spool), "out"),
            retry_jitter_seed=self.sc.seed).start()
        self._gateway_port = self.gateway.port

    def _wait_fleet_fresh(self, timeout_s: float = 30.0) -> bool:
        # the controller may have clamped the initial count into the
        # autoscale [min, max] band — wait for what it actually spawned
        want = len(self._ctrl.workers) if self._ctrl is not None \
            else self.sc.workers
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if len(self.q.fresh_workers()) >= want:
                return True
            self.sleeper(0.1)
        return False

    # ----------------------------------------------------------- actions

    def _journal_action(self, t_rel: float, action: str,
                        worker: str = "", **extra) -> None:
        rec = {"t": round(t_rel, 3), "action": action,
               "worker": worker, **extra}
        self.actions.append(rec)
        telemetry.chaos_actions_total().inc(action=action)
        journal.record(self.jroot, "chaos_action", action=action,
                       worker=worker, t_rel=round(t_rel, 3), **extra)
        self.log.info("chaos t+%.2f: %s %s %s", t_rel, action,
                      worker or "-", extra or "")

    def _worker_pid(self, worker_id: str) -> int | None:
        hb = self.q.read_heartbeat(worker_id)
        pid = (hb or {}).get("pid")
        return int(pid) if pid else None

    def _do_action(self, a: scenario_mod.Action,
                   t_rel: float) -> None:
        if a.action in ("kill_worker", "stop_worker", "cont_worker"):
            pid = self._worker_pid(a.worker)
            if pid is None:
                self._journal_action(t_rel, a.action, a.worker,
                                     detail="no heartbeat pid — "
                                            "skipped")
                return
            sig = {"kill_worker": _SIGNALS[a.signal.upper()],
                   "stop_worker": signal.SIGSTOP,
                   "cont_worker": signal.SIGCONT}[a.action]
            try:
                os.kill(pid, sig)
            except OSError as e:
                self._journal_action(t_rel, a.action, a.worker,
                                     pid=pid, detail=f"kill failed: "
                                                     f"{e}")
                return
            if a.action == "stop_worker":
                self._stopped_pids.add(pid)
            elif a.action == "cont_worker":
                self._stopped_pids.discard(pid)
            self._journal_action(
                t_rel, a.action, a.worker, pid=pid,
                **({"signal": a.signal.upper()}
                   if a.action == "kill_worker" else {}))
        elif a.action == "restart_gateway":
            if self.gateway is None:
                self._journal_action(t_rel, a.action,
                                     detail="no gateway — skipped")
                return
            port = self._gateway_port
            self.gateway.stop()
            self._start_gateway(port=port)
            self._journal_action(t_rel, a.action, port=port)
        elif a.action == "pause_janitor":
            self._ctrl.pause_janitor(a.seconds)
            self._journal_action(t_rel, a.action,
                                 seconds=a.seconds)
        elif a.action == "surge_submit":
            # thundering herd: `beams` submissions as fast as the
            # transport allows — the backlog spike the autoscaler
            # must answer with a bounded, cooled-down scale-up
            self._journal_action(t_rel, a.action, beams=a.beams)
            for _ in range(a.beams):
                i = self._beam_seq
                self._beam_seq += 1
                self._submit(i, t_rel)
        elif a.action == "flap_capacity":
            # oscillating load: bursts separated by silence, faster
            # than a naive policy would scale — the hysteresis/
            # cooldown trap.  Runs inline on the conductor; later
            # timeline entries are not delayed (the plan executor
            # only sleeps when it is AHEAD of schedule).
            self._journal_action(t_rel, a.action, beams=a.beams,
                                 cycles=a.cycles,
                                 period_s=a.period_s)
            for cycle in range(a.cycles):
                for _ in range(a.beams):
                    i = self._beam_seq
                    self._beam_seq += 1
                    self._submit(i, t_rel + cycle * a.period_s)
                self.sleeper(a.period_s)

    # ---------------------------------------------------------- workload

    @property
    def stream_root(self) -> str:
        return os.path.join(scenario_mod.chaos_dir(self.spool),
                            "stream")

    def _stream_geometry(self) -> dict:
        wl = self.sc.workload
        return {"nchan": wl.stream_nchan,
                "chunk_len": wl.stream_chunk_len,
                "dt": 1e-4, "f_lo_mhz": 1300.0, "f_hi_mhz": 1500.0,
                "ndms": wl.stream_ndms, "dm_max": 30.0,
                "span_chunks": 2}

    def _submit_stream(self, i: int, t_rel: float) -> None:
        """One streaming session: open it through the real ingest
        module, submit its stream ticket, and start a feeder thread
        that lands chunks behind the claiming worker's back."""
        from tpulsar_torch.stream import ingest
        wl = self.sc.workload
        session = f"{self.sc.name}-s{i:03d}"
        tid = f"{self.sc.name}-{i:03d}"
        outdir = os.path.join(scenario_mod.chaos_dir(self.spool),
                              "out", f"beam{i:03d}")
        try:
            ingest.open_session(self.stream_root, session,
                                self._stream_geometry())
            self.q.submit(tid, [], outdir, job_id=i, kind="stream",
                          session=session,
                          stream_root=self.stream_root,
                          slo_s=wl.stream_slo_s)
            self.tickets.append(tid)
        except (OSError, ingest.StreamError) as e:
            self._journal_action(t_rel, "submit_refused",
                                 detail=str(e)[:120], beam=i)
            return
        th = threading.Thread(target=self._feed_session,
                              args=(i, session),
                              name=f"chaos-feed-{session}",
                              daemon=True)
        self._feeders.append(th)
        th.start()

    def _feed_session(self, i: int, session: str) -> None:
        """Land the session's chunks at the workload cadence —
        skipping the declared drop seqs, which the worker must
        zero-fill as gaps — then close it.  Runs on the conductor,
        whose faults layer is never armed: the ``stream.ingest``
        fault point is under test on the WORKER's read path."""
        from tpulsar_torch.stream import ingest
        wl = self.sc.workload
        drop = {int(s) for s in wl.stream_drop_seqs}
        for seq in range(wl.stream_chunks):
            if seq not in drop:
                chunk = stream_chunk_payload(
                    self.sc.name, self.sc.seed, i, seq,
                    wl.stream_nchan, wl.stream_chunk_len)
                try:
                    ingest.append_chunk(self.stream_root, session,
                                        seq, chunk)
                except OSError as e:
                    self.log.warning("feed %s seq %d failed: %s",
                                     session, seq, e)
            self.sleeper(wl.stream_interval_s)
        try:
            ingest.close_session(self.stream_root, session,
                                 wl.stream_chunks)
        except (OSError, ingest.StreamError) as e:
            self.log.warning("close %s failed: %s", session, e)

    def _submit(self, i: int, t_rel: float) -> None:
        wl = self.sc.workload
        if self.sc.worker_kind == "stream":
            self._submit_stream(i, t_rel)
            return
        datafiles = list(wl.datafiles or ["chaos://synthetic"])
        outdir = os.path.join(scenario_mod.chaos_dir(self.spool),
                              "out", f"beam{i:03d}")
        blobs: dict[str, str] = {}
        if self.sc.dataplane:
            # by-digest inputs: the beam's synthetic bytes go into
            # the gateway CAS FIRST (through the real PUT route), and
            # the ticket carries only {filename: sha256} refs — no
            # shared path ever reaches the worker
            from tpulsar_torch.dataplane import transfer
            payload = beam_payload(self.sc.name, self.sc.seed, i)
            try:
                digest = transfer.put_bytes(self.gateway.url, payload)
            except Exception as e:      # noqa: BLE001 — a refused
                # upload refuses the SUBMISSION (the ticket would be
                # unservable), journaled like any refused submit
                self._journal_action(t_rel, "submit_refused",
                                     detail=f"blob put: "
                                            f"{str(e)[:100]}", beam=i)
                return
            blobs = {f"beam{i:03d}.dat": digest}
        if wl.via == "gateway":
            from tpulsar_torch.frontdoor import client
            # the gateway may be mid-restart at this instant — that
            # is the point; a refused connection is retried briefly,
            # a 429 honors the jittered Retry-After
            last: Exception | None = None
            for _ in range(8):
                try:
                    rec = client.submit_beam(
                        self.gateway.url, datafiles, outdir=outdir,
                        tenant=wl.tenant, priority=wl.priority,
                        job_id=i, retries=2,
                        blobs=blobs or None)
                    self.tickets.append(rec["ticket"])
                    return
                except client.ClientError as e:
                    last = e
                    if e.code == 503:
                        self.sleeper(0.2)   # shed: fleet mid-recovery
                        continue
                    break
                except OSError as e:        # connection refused
                    last = e
                    self.sleeper(0.2)
            self._journal_action(t_rel, "submit_refused",
                                 detail=str(last)[:120], beam=i)
            return
        tid = f"{self.sc.name}-{i:03d}"
        extra = {"beam_s": self.sc.beam_s}
        if blobs:
            extra["blobs"] = blobs
        if wl.passes:
            extra["passes"] = wl.passes
            extra["pass_s"] = wl.pass_s
        if wl.tenant:
            extra["tenant"] = wl.tenant
        if wl.priority not in (None, ""):
            extra["priority"] = wl.priority
        try:
            # QueueCorrupt deliberately NOT absorbed here: a corrupt
            # database mid-storm must abort the run loudly, never
            # read as one refused submission
            self.q.submit(tid, datafiles, outdir, job_id=i, **extra)
            self.tickets.append(tid)
        except OSError as e:
            self._journal_action(t_rel, "submit_refused",
                                 detail=str(e)[:120], beam=i)

    # ------------------------------------------------------------ driver

    def run(self) -> dict:
        sc = self.sc
        os.makedirs(scenario_mod.chaos_dir(self.spool),
                    exist_ok=True)
        t0 = time.time()
        # placeholder (no entries): workers must FIND the schedule at
        # boot, but no window may open until the workload anchor
        scenario_mod.write_schedule(self.spool, sc, t0, arm=False)
        if sc.gateway and sc.dataplane:
            # dataplane runs start the gateway BEFORE the fleet: the
            # workers' TPULSAR_DATA_URL is baked into their spawn env,
            # so the CAS endpoint must exist first
            self._start_gateway()
        self._start_fleet()
        status = "aborted"
        quiesced = False
        try:
            if not self._wait_fleet_fresh():
                raise RuntimeError(
                    f"fleet never became fresh ({sc.workers} "
                    f"worker(s)) — check "
                    f"{self.spool}/workers/*.log")
            if sc.gateway and self.gateway is None:
                self._start_gateway()
            # the schedule's t0 is re-anchored to the WORKLOAD start:
            # scenario times mean "seconds into the storm", and fleet
            # boot must not eat into window positions
            t0 = time.time()
            scenario_mod.write_schedule(self.spool, sc, t0)
            journal.record(self.jroot, "chaos_run_start",
                           scenario=sc.name, seed=sc.seed,
                           workers=sc.workers,
                           gateway=bool(sc.gateway),
                           queue_url=self.queue_url,
                           worker_args=list(self.worker_extra_args))
            # one merged, seeded dispatch plan: submissions at their
            # (jittered) cadence, conductor actions at their t
            rng = random.Random(sc.seed)
            plan: list[tuple[float, object]] = []
            for i in range(sc.workload.beams):
                jitter = (rng.random() - 0.5) * 0.5 \
                    * sc.workload.interval_s
                plan.append((max(0.0, i * sc.workload.interval_s
                                 + jitter), i))
            for a in sc.conductor_actions():
                plan.append((a.t, a))
            plan.sort(key=lambda p: (p[0],
                                     isinstance(p[1], int)))
            for t_rel, item in plan:
                now_rel = time.time() - t0
                if t_rel > now_rel:
                    self.sleeper(t_rel - now_rel)
                if time.time() - t0 > sc.duration_s:
                    self.log.warning("duration_s %.0f exhausted "
                                     "mid-plan", sc.duration_s)
                    break
                if isinstance(item, int):
                    self._submit(item, t_rel)
                else:
                    self._do_action(item, t_rel)
            # stream sessions cannot reach a terminal result until
            # their feeders close them — wait those out first (the
            # run duration still bounds the whole storm)
            for th in self._feeders:
                th.join(timeout=max(
                    0.0, t0 + sc.duration_s - time.time()))
            # ---- quiesce: every submitted beam terminal
            deadline = min(t0 + sc.duration_s,
                           time.time() + sc.quiesce_timeout_s)
            while time.time() < deadline:
                if all(self.q.read_result(tid) is not None
                       for tid in self.tickets):
                    quiesced = True
                    break
                self.sleeper(0.25)
            status = "quiesced" if quiesced else "quiesce_timeout"
        except Exception as e:   # noqa: BLE001 — the manifest must
            status = f"error: {e}"            # record HOW it died
            self.log.exception("chaos run failed")
        finally:
            # SIGCONT anything still frozen — a stopped worker would
            # ignore the drain and hang the controller shutdown
            for pid in list(self._stopped_pids):
                try:
                    os.kill(pid, signal.SIGCONT)
                except OSError:
                    pass
            journal.record(self.jroot, "chaos_run_end",
                           scenario=sc.name, status=status,
                           quiesced=quiesced)
            if self._ctrl is not None:
                self._ctrl.request_drain()
            if self._ctrl_thread is not None:
                self._ctrl_thread.join(timeout=40.0)
            if self.gateway is not None:
                self.gateway.stop()
        manifest = {
            "scenario": sc.name, "seed": sc.seed,
            "tenants": sc.tenants, "max_attempts": sc.max_attempts,
            "workers": sc.workers, "worker_kind": sc.worker_kind,
            "queue_url": self.queue_url,
            "gateway": bool(sc.gateway),
            "gateway_port": self._gateway_port,
            "dataplane": bool(sc.dataplane),
            "t0": t0, "wall_s": round(time.time() - t0, 3),
            "status": status, "quiesced": quiesced,
            "actions": self.actions, "tickets": self.tickets,
        }
        try:
            protocol._atomic_write_json(
                scenario_mod.run_path(self.spool), manifest)
        except OSError:
            pass
        return manifest


def run_scenario(sc: scenario_mod.Scenario, spool: str,
                 **kw) -> dict:
    return ChaosRunner(sc, spool, **kw).run()
