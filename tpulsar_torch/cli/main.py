"""The operator CLI — counterpart of tpulsar/cli/main.py.

    python -m tpulsar_torch [--config PATH] [--db PATH] [--debug-*]
        <subcommand> [options]

Subcommands:

  serve   — the resident search server (serve/server.py): one
            device-owning process drains the admission queue, paying
            process start, kernel build and device set-up once per
            boot instead of once per beam (``--batch N`` searches up
            to N compatible beams as one coalesced group; ``--stream``
            claims stream session tickets instead and runs them
            through the streaming plane, stream/).  It takes the JAX
            package's ``serve`` flags plus ``--device`` (cuda, the
            default, or cpu; without a GPU it fails unless ``--device
            cpu`` is given).
  fleet   — the serving fleet (fleet/): a controller spawning and
            supervising N ``serve`` workers on one spool or queue
            (crash restart under a backoff budget, the janitor's
            requeue of a dead worker's claim, quarantine, rolling
            restart, fleet.json/fleet.prom, the hosted health
            doctor); ``--status``, ``--drain`` and
            ``--rolling-restart`` talk to a running fleet.  The
            workers run on the card unless given ``--worker-arg
            --device --worker-arg cpu``.
  doctor  — the node probe (dependencies, config, directories, job
            tracker, queue manager, a ``torch.cuda`` device probe in
            a subprocess, build state and pins); with
            ``--spool``/``--queue``/``--rules``/``--watch`` the fleet
            verdict from the alert rules (obs/alerts.py, health.py).
  gateway — the network front door (frontdoor/gateway.py) over a
            ticket queue, or with ``--federate`` a router over member
            gateways; mounts the blob store (``--blob-root``).
  submit  — submit a beam over HTTP (exit 0 done, 1 failed, 2 refused
            and retryable, 3 load-shed).
  blob    — put/get/gc/stats on the content-addressed store, local
            (``--root``) or through a gateway (``--url``).
  queue   — ``queue fsck`` of a spool or sqlite queue.
  index   — rebuild/fsck/query the candidate index.
  search  — one beam through the per-beam job (cli/search_job.py):
            ``search FILES --outdir DIR [--no-accel]`` plus
            ``--device`` (cuda, the default, or cpu; without a GPU it
            exits 2 unless ``--device cpu`` is given).
  plan    — the dedispersion plan of a file's header, of explicit
            geometry or of a survey (``--png`` plots it; matplotlib).
  checkpoint — a beam's checkpoint manifest (either package's: the
            schema is shared); ``--verify`` re-hashes every artifact
            (exit 1 on a mismatch).
  trace   — the span table of a results directory's newest
            ``<basenm>_trace.json`` (a TPULSAR_TRACE=1 search).
  obs     — the ops console over a spool or ``--queue``: ``timeline
            <ticket> [--stitch OUT]``, ``top [--once]``, ``tail [-n N]
            [--follow]``, ``blackbox [worker]``.
  lint    — the contract linter (analysis/; exit 0 clean, 1
            findings, 2 internal error).
  chaos   — the chaos harness (chaos/): ``run`` a seeded scenario (a
            controller-supervised fleet of stub, stream or ``serve``
            workers, optionally behind the gateway, under a timeline
            of kills, fault windows, gateway restarts and janitor
            pauses; exit 1 unless the storm quiesced), ``verify`` the
            system invariants over a spool or queue (exit 1 on any
            violation; ``--tail`` follows a live run), ``report`` the
            post-run digest with the MTTR of each kill.  A ``serve``
            storm runs its workers on the card; without a GPU the
            scenario's workers need ``--device cpu`` (the runner's
            ``worker_extra_args``).

and the orchestration daemons and their operator commands
(orchestrate/; the JAX CLI's, with the same tracker DB, results DB and
flags):

  daemons:   downloader | jobpool | uploader  (``--once`` for one
             iteration; ``--remote-root`` for the downloader's local
             archive)
  bootstrap: init-db
  ingest:    add-files
  control:   kill-jobs [--fail], remove-files
  monitor:   status, show processing|downloading|uploading|failed,
             stats [--png], monitor [--once]
  results:   db-shell

The jobpool submits each beam as the per-beam job through the
configured queue backend (``jobpooler.queue_manager``); the local
backend's default worker is ``python -m tpulsar_torch.cli.search_job``,
which runs on the GPU and fails without one (``jobpooler.submit_script``
names another command, e.g. one adding ``--device cpu``).

and the AOT layer's (aot/):

  aot     — ``compile`` builds and loads the port's two shared
            libraries (nvcc's CUDA kernels, g++'s native library)
            into the build directory (``TPULSAR_CACHE_DIR``) and
            writes its manifest; ``verify`` replays the builds and
            exits 1 if any library would be built in-line; ``ls``
            prints the build directory, the manifest and the registry
            (rc 0 / 1 / 3 as the JAX CLI's; its shape options select
            nothing here).

Every command but serve, search and aot compile|verify is control
plane: it touches no tensor, takes no ``--device`` and never
initializes CUDA (the doctor's device probe runs in a subprocess);
the gateway, the fleet controller, the daemons, the ops console and
the linter start and run on a host with no GPU.  The per-beam job
keeps its own entry point, ``python -m tpulsar_torch.cli.search_job``.
The CLI has all 28 of the JAX CLI's subcommands.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

from tpulsar_torch.obs import debugflags


def _metrics_dir() -> str:
    """Where daemons export their registries: <basic.log_dir>/metrics."""
    from tpulsar_torch.config import settings
    return os.path.join(settings().basic.log_dir, "metrics")


def _export_metrics(name: str) -> None:
    """Write this process's registry as <name>.prom (atomic replace)
    and append a snapshot line to <name>.jsonl, as the JAX CLI does:
    a scraper reads them without touching the process."""
    from tpulsar_torch.obs import metrics
    d = _metrics_dir()
    try:
        metrics.REGISTRY.write_prom(os.path.join(d, f"{name}.prom"))
        # bounded history: ~8 MB then rotate once
        metrics.REGISTRY.write_jsonl(os.path.join(d, f"{name}.jsonl"),
                                     max_bytes=8 << 20, daemon=name)
    except OSError:
        pass          # metrics export must never take the daemon down


def _serve_spool(cfg) -> str:
    """The one spool path the server and its clients share."""
    from tpulsar_torch.serve import protocol
    return cfg.jobpooler.serve_spool or protocol.default_spool_dir(cfg)


def _default_queue_url() -> str:
    """TPULSAR_QUEUE_URL: the deployment-wide default ticket-queue
    backend.  A --queue flag always wins; empty means the spool."""
    return os.environ.get("TPULSAR_QUEUE_URL", "")


def cmd_serve(args) -> int:
    """Resident search server (serve/): build and load the kernels and
    warm the device once, then process beams (or, with --stream,
    stream sessions) from the spool admission queue until drained
    (SIGTERM) — or, with --once, until the spool's current contents
    are processed."""
    from tpulsar_torch.config import settings
    from tpulsar_torch.serve.server import SearchServer

    cfg = settings()
    queue_url = args.queue or _default_queue_url()
    try:
        server = SearchServer(
            spool=args.spool or _serve_spool(cfg), cfg=cfg,
            queue_url=queue_url,
            worker_id=args.worker_id,
            worker_class=args.worker_class,
            max_queue_depth=cfg.jobpooler.serve_queue_depth,
            beam_deadline_s=args.beam_deadline,
            ticket_max_attempts=cfg.jobpooler.serve_max_attempts,
            warm_boot=not args.no_warmstart,
            warm_boot_scale=args.warmstart_scale,
            heartbeat_interval_s=cfg.jobpooler.serve_heartbeat_interval_s,
            prefetch_depth=args.prefetch_depth,
            batch_size=args.batch,
            batch_linger_s=args.batch_linger,
            stream=args.stream,
            device=args.device)
    except RuntimeError as e:
        # no GPU without --device cpu, or a queue database that fails
        # its integrity check: refused before anything is claimed
        print(f"serve: {e}", file=sys.stderr)
        return 2
    server.install_signal_handlers()
    print(f"serve: spool {server.spool} "
          + (f"queue {server.queue.url} "
             if server.queue.backend != "spool" else "")
          + (f"worker {args.worker_id} " if args.worker_id else "")
          + (f"class {args.worker_class} " if args.worker_class
             else "")
          + f"device {server.device} "
          + ("mode stream " if server.stream else "")
          + (f"batch {server.batch_size} " if server.batch_size > 1
             else "")
          + f"(depth {server.max_queue_depth}, "
          f"warm boot {'on' if server.warm_boot else 'off'}"
          + (f", beam deadline {args.beam_deadline:g} s"
             if args.beam_deadline else "") + ")", flush=True)
    try:
        rc = server.serve(once=args.once)
    finally:
        _export_metrics("serve")
    return rc


def cmd_fleet(args):
    """Multi-worker serving fleet (fleet/): a controller spawning and
    supervising N `serve` workers on one spool — or, with
    --status/--drain/--rolling-restart, talk to the running fleet
    through its spool.  The workers run on the card unless
    ``--worker-arg --device --worker-arg cpu`` is given; the
    controller itself never imports torch."""
    from tpulsar_torch.config import settings
    from tpulsar_torch.fleet import controller as fleet_ctl

    cfg = settings()
    spool = args.spool or _serve_spool(cfg)
    queue_url = args.queue or _default_queue_url()
    queue = None
    if queue_url:
        from tpulsar_torch.frontdoor.queue import get_ticket_queue
        queue = get_ticket_queue(queue_url)
    if args.status:
        print(fleet_ctl.render_status(spool, queue=queue))
        # scriptable health: nonzero when a running controller's
        # fleet.json went stale past the heartbeat grace
        return fleet_ctl.status_rc(spool)
    if args.drain:
        path = fleet_ctl.write_control(spool, "drain")
        print(f"fleet: drain requested ({path})")
        return 0
    if args.rolling_restart:
        path = fleet_ctl.write_control(spool, "rolling-restart")
        print(f"fleet: rolling restart requested ({path})")
        return 0
    nworkers = (args.workers if args.workers is not None
                else cfg.jobpooler.fleet_workers)
    autoscale_cfg = cfg.fleet_autoscale_config()
    if args.autoscale:
        # --autoscale MIN:MAX overrides (and enables) the config's
        # elastic policy for this controller; the knob->config
        # mapping itself lives in ONE place (fleet_autoscale_config)
        import dataclasses as _dc
        try:
            lo, _, hi = args.autoscale.partition(":")
            base = autoscale_cfg \
                or cfg.fleet_autoscale_config(force=True)
            autoscale_cfg = _dc.replace(
                base, min_workers=int(lo),
                max_workers=int(hi)).validate()
        except ValueError as e:
            print(f"--autoscale wants MIN:MAX within a sane elastic "
                  f"policy, got {args.autoscale!r}: {e}",
                  file=sys.stderr)
            return 2
    ctrl = fleet_ctl.FleetController(
        spool=spool, workers=nworkers, once=args.once,
        queue=queue,
        max_worker_restarts=args.max_restarts,
        ticket_max_attempts=cfg.jobpooler.serve_max_attempts,
        autoscale=autoscale_cfg,
        worker_args=tuple(args.worker_arg))
    print(f"fleet: {len(ctrl.workers)} worker(s) on spool {spool} "
          + (f"queue {ctrl.q.url} " if ctrl.q.backend != "spool"
             else "")
          + f"(restart budget {args.max_restarts}, ticket attempts cap "
          f"{cfg.jobpooler.serve_max_attempts}"
          + (f", elastic [{autoscale_cfg.min_workers}, "
             f"{autoscale_cfg.max_workers}] class "
             f"{autoscale_cfg.worker_class or 'ondemand'}"
             if autoscale_cfg else "") + ")", flush=True)
    try:
        rc = ctrl.run()
    finally:
        _export_metrics("fleet")
    return rc


def cmd_gateway(args):
    """The network front door (frontdoor/): an HTTP gateway
    accepting beam submissions (trace id minted at the edge),
    streaming per-ticket status from the journal, and serving the
    result store's candidate query API — or, with federation members
    configured, a router load-balancing submissions across hosts by
    advertised capacity."""
    import signal
    import threading

    from tpulsar_torch.config import settings
    from tpulsar_torch.frontdoor.federation import FederationRouter
    from tpulsar_torch.frontdoor.gateway import GatewayServer
    from tpulsar_torch.frontdoor.queue import get_ticket_queue
    from tpulsar_torch.frontdoor.tenancy import TenantPolicy

    cfg = settings()
    fd = cfg.frontdoor
    host = args.host or fd.gateway_host
    port = args.port if args.port is not None else fd.gateway_port
    policy = TenantPolicy.from_config(cfg)
    federate = args.federate or fd.federate
    if federate:
        gw = GatewayServer(router=FederationRouter(federate),
                           policy=policy, host=host, port=port,
                           token=args.token)
        role = f"router over {federate}"
    else:
        queue = get_ticket_queue(args.queue or _default_queue_url()
                                 or _serve_spool(cfg))
        gw = GatewayServer(
            queue=queue, policy=policy, host=host, port=port,
            outdir_base=args.outdir_base or os.path.join(
                cfg.processing.base_results_directory, "gateway"),
            default_depth=cfg.jobpooler.serve_queue_depth,
            query_limit=fd.results_query_limit,
            blob_root=args.blob_root, token=args.token)
        role = f"front of {queue!r}"
    gw.start()
    print(f"gateway: {gw.url} ({role})", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop.set())
    try:
        while not stop.wait(1.0):
            pass
    finally:
        gw.stop()
        _export_metrics("gateway")
    print("gateway: stopped")
    return 0


def cmd_submit(args):
    """Submit a beam over HTTP to a front-door gateway (and with
    --wait, poll until its terminal result).  Exit codes: 0 done or
    skipped, 1 failed, 2 refused (quota/backpressure — retryable),
    3 load-shed (submit to another host)."""
    import json

    from tpulsar_torch.frontdoor import client

    files = [os.path.abspath(f) for f in args.files]
    try:
        rec = client.submit_beam(
            args.gateway, files, outdir=args.outdir,
            tenant=args.tenant, priority=args.priority,
            job_id=args.job_id, retries=args.retries)
    except client.ClientError as e:
        print(json.dumps({"code": e.code, **e.payload}),
              file=sys.stderr)
        return 3 if e.code == 503 else 2 if e.code == 429 else 1
    print(json.dumps(rec))
    if not args.wait:
        return 0
    try:
        result = client.wait_for_result(args.gateway, rec["ticket"],
                                        timeout_s=args.timeout)
    except TimeoutError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0 if result.get("status") in ("done", "skipped") else 1


def _index_queue(args, spool):
    """Resolve an index ``--queue`` URL to (backend, journal root):
    reads route through the TicketQueue so ``sqlite:`` fleets are
    first-class, and the index (``<root>/candidates.db``) follows the
    backend's journal_root.  The bare token 'sqlite' expands to
    sqlite:<spool>/queue.db, as the JAX CLI's commands do."""
    url = getattr(args, "queue", "") or ""
    if not url:
        return None, spool
    if url == "sqlite":
        url = f"sqlite:{os.path.join(spool, 'queue.db')}"
    from tpulsar_torch.frontdoor.queue import get_ticket_queue
    q = get_ticket_queue(url)
    return q, q.journal_root or spool


def cmd_chaos(args):
    """The chaos harness (chaos/; the JAX CLI's command):

      run    — execute a declarative, seeded scenario: stand up a
               controller-supervised fleet (optionally behind the
               HTTP gateway) on a spool, submit a synthetic beam
               workload, run the failure timeline (worker kills,
               fault windows via the shared schedule file, gateway
               restarts), quiesce, and write the run manifest
      verify — replay the journal + spool + result store and assert
               the system invariants (exactly-once, no lost ticket,
               attempts discipline, quotas, trace ids, side-files);
               exit 1 on any violation; --tail audits live
      report — the post-run digest: actions, per-status counts,
               MTTR after each kill, and the invariant verdict

    The verifier is deliberately scenario-independent: it audits any
    spool a fleet has run on, chaos-conducted or not."""
    import json as _json

    from tpulsar_torch.chaos import invariants, runner, scenario
    from tpulsar_torch.obs import telemetry

    spool = args.spool
    if not spool:
        from tpulsar_torch.config import settings
        spool = _serve_spool(settings())
    if args.chaos_cmd == "run":
        sc = scenario.load(args.scenario)
        url = sc.effective_queue_url(spool, override=args.queue)
        print(f"chaos run: scenario {sc.name!r} (seed {sc.seed}, "
              f"{sc.workers} {sc.worker_kind} worker(s)"
              + (", gateway" if sc.gateway else "")
              + f") on spool {spool}"
              + (f" queue {url}" if not url.startswith("spool:")
                 else ""), flush=True)
        manifest = runner.run_scenario(sc, spool,
                                       queue_url=args.queue)
        print(_json.dumps({k: manifest[k] for k in
                           ("scenario", "status", "quiesced",
                            "wall_s", "tickets", "actions")},
                          indent=1))
        return 0 if manifest["quiesced"] else 1
    from tpulsar_torch.serve import protocol as _protocol
    # the manifest is ALWAYS consulted for run facts (quiesced);
    # --scenario only overrides the contract inputs (tenant table,
    # attempts cap) — quiescence is a property of the run, not the
    # scenario
    manifest = _protocol._read_json(scenario.run_path(spool))
    tenants = (manifest or {}).get("tenants") or {}
    max_attempts = (manifest or {}).get("max_attempts",
                                        args.max_attempts)
    if args.scenario:
        sc = scenario.load(args.scenario)
        tenants, max_attempts = sc.tenants, sc.max_attempts
    # the audit target: --queue override > the manifest's recorded
    # queue_url > the bare spool (the 'sqlite' token expands to the
    # run's queue.db, mirroring the scenario field)
    target = args.queue or (manifest or {}).get("queue_url") or ""
    if target == "sqlite":
        target = f"sqlite:{os.path.join(spool, 'queue.db')}"
    target = target or spool
    if args.chaos_cmd == "verify":
        if args.tail:
            report = invariants.tail_verify(
                target, tenants=tenants, max_attempts=max_attempts,
                timeout_s=args.timeout)
        else:
            quiesced = not args.live and (
                manifest is None or bool(manifest.get("quiesced",
                                                      True)))
            report = invariants.verify(
                target, tenants=tenants, max_attempts=max_attempts,
                quiesced=quiesced)
        print(invariants.render_verify(report))
        for name, n in report["invariants"].items():
            if n:
                telemetry.chaos_violations_total().inc(
                    n, invariant=name)
        return 0 if report["ok"] else 1
    if args.chaos_cmd == "report":
        print(invariants.render_report(target))
        return 0
    return 2




def cmd_queue(args):
    """Ticket-queue maintenance (frontdoor/).

    fsck — offline health check of a queue backend: PRAGMA
    integrity_check + a truncating WAL checkpoint for
    ``sqlite:<path>``, an orphan side-file sweep for a spool, plus
    per-state counts either way.  Exit 1 on ANY finding (or a
    database so corrupt the backend refuses to open it)."""
    from tpulsar_torch.frontdoor.queue import get_ticket_queue
    from tpulsar_torch.frontdoor.sqlite_queue import QueueCorrupt

    if args.queue_cmd != "fsck":
        return 2
    try:
        q = get_ticket_queue(args.url)
        report = q.fsck()
    except QueueCorrupt as e:
        # the backend refused to even open it — that IS the finding
        print(f"fsck: CORRUPT — {e}")
        return 1
    except (OSError, ValueError) as e:
        print(f"fsck: {e}", file=sys.stderr)
        return 2
    print(f"fsck {report['backend']}: {report['target']}")
    counts = report.get("counts") or {}
    print("  counts: " + " ".join(
        f"{k}={v}" for k, v in sorted(counts.items())))
    findings = report.get("findings") or []
    for f in findings:
        print(f"  FINDING {f.get('what', '?')}: "
              f"{f.get('detail', '')}")
    print("fsck: clean" if not findings
          else f"fsck: {len(findings)} finding(s)")
    return 1 if findings else 0


def _blob_target(args):
    """Resolve a blob command's target: ``--url`` (a gateway's blob
    routes, digest-verified both ends) beats ``--root`` beats the
    TPULSAR_BLOB_ROOT / <serve spool>/blobs convention."""
    from tpulsar_torch.config import settings
    from tpulsar_torch.dataplane import blobstore

    url = getattr(args, "url", "") or os.environ.get(
        "TPULSAR_DATA_URL", "")
    if url:
        return url, None
    root = getattr(args, "root", "") or \
        blobstore.default_blob_root(_serve_spool(settings()))
    return "", blobstore.BlobStore(root)


def cmd_blob(args):
    """Content-addressed artifact store (dataplane/):

      put FILE...  — ingest files, print ``<sha256>  <path>`` per
                     file (dedup is free: a re-put of identical
                     bytes is a no-op that returns the same digest)
      get DIGEST   — fetch one blob, verified against its digest
      gc           — drop unreferenced objects older than --ttl and
                     orphaned ingest temps
      stats        — object/byte counts for the store

    ``--url`` talks to a gateway's ``/v1/blobs/<digest>`` routes
    (token from --token / TPULSAR_GATEWAY_TOKEN); ``--root`` (or
    TPULSAR_BLOB_ROOT) addresses a local store directly."""
    import json

    from tpulsar_torch.dataplane import transfer

    if getattr(args, "token", ""):
        os.environ["TPULSAR_GATEWAY_TOKEN"] = args.token
    try:
        url, store = _blob_target(args)
        if args.blob_cmd == "put":
            for path in args.files:
                if url:
                    digest = transfer.put_file(url, path)
                else:
                    digest = store.put_file(path)
                    if getattr(args, "ref", ""):
                        store.add_ref(digest, args.ref)
                print(f"{digest}  {path}")
            return 0
        if args.blob_cmd == "get":
            dest = args.out or args.digest[:12]
            if url:
                n = transfer.get_to_file(url, args.digest, dest)
            else:
                n = store.fetch_to(args.digest, dest)
            print(f"{dest}  {n} B")
            return 0
        if args.blob_cmd == "gc":
            if url:
                print("blob gc is local-only: pass --root (the "
                      "store owner collects; a client must not)",
                      file=sys.stderr)
                return 2
            print(json.dumps(store.gc(ttl_s=args.ttl)))
            return 0
        if args.blob_cmd == "stats":
            if url:
                print("blob stats is local-only: pass --root",
                      file=sys.stderr)
                return 2
            print(json.dumps(store.stats()))
            return 0
    except FileNotFoundError as e:
        print(f"blob: {e}", file=sys.stderr)
        return 1
    except (OSError, ValueError, transfer.TransferError) as e:
        print(f"blob: {e}", file=sys.stderr)
        return 1
    return 2


def cmd_index(args):
    """Persistent candidate index (dataplane/index.py):

      rebuild — re-derive every row from the done outdirs' parse
                (the outdirs are the source of truth; the index is
                a cache a crash can never make authoritative)
      fsck    — PRAGMA integrity_check + truncating WAL checkpoint
      query   — the indexed /v1/candidates answer from the CLI

    Reads resolve like obs: ``--queue`` routes through a ticket
    backend ('sqlite' expands to sqlite:<spool>/queue.db)."""
    import json

    from tpulsar_torch.config import settings
    from tpulsar_torch.dataplane import index as dp_index

    spool = args.spool or _serve_spool(settings())
    queue, root = _index_queue(args, spool)
    idx = dp_index.CandidateIndex(dp_index.index_path(root))
    try:
        if args.index_cmd == "rebuild":
            if queue is None:
                from tpulsar_torch.frontdoor.queue import get_ticket_queue
                queue = get_ticket_queue(spool)
            print(json.dumps(idx.rebuild(queue)))
            return 0
        if args.index_cmd == "fsck":
            print(json.dumps(idx.fsck()))
            return 0
        if args.index_cmd == "query":
            print(json.dumps(idx.query(
                ticket=args.ticket or None,
                min_sigma=args.min_sigma, limit=args.limit)))
            return 0
    except ValueError as e:
        print(f"index: {e}", file=sys.stderr)
        return 1
    except (OSError, dp_index.IndexCorrupt) as e:
        print(f"index: {e}", file=sys.stderr)
        return 1
    finally:
        idx.close()
    return 2


# ------------------------------------------------ orchestration daemons

def _tracker(args):
    from tpulsar_torch.orchestrate.jobtracker import JobTracker
    return JobTracker(args.db) if args.db else JobTracker()


def _notify(cfg):
    """Daemon crash fan-out through the alert notifier plane
    (obs/alerts.py, spec from TPULSAR_ALERT_NOTIFY): the SMTP-era
    ErrorMailer is retired — pager/webhook/log routing is one
    pluggable spec."""
    from tpulsar_torch.obs import alerts

    try:
        notifier = alerts.make_notifier(
            os.environ.get("TPULSAR_ALERT_NOTIFY", "log"))
    except ValueError as e:
        print(f"bad TPULSAR_ALERT_NOTIFY ({e}); falling back to log",
              file=sys.stderr)
        notifier = alerts.LogNotifier()

    def send(subject, body):
        try:
            notifier.notify({"rule": "daemon_error",
                             "severity": "page", "state": "firing",
                             "subject": subject, "body": body})
        except Exception:
            pass          # notification must never take a daemon down
    return send


def _daemon_loop(name: str, iteration, status, sleep_s: float, notify):
    """Run a daemon with crash notification and exponential backoff on
    repeated errors (reference bin/StartDownloader.py:14-36)."""
    delay_mult = 1
    while True:
        try:
            status()
            iteration()
            delay_mult = 1
        except KeyboardInterrupt:
            print(f"{name}: interrupted; exiting")
            return 0
        except Exception:
            tb = traceback.format_exc()
            print(tb, file=sys.stderr)
            notify(f"{name} crashed", tb)
            delay_mult = min(delay_mult * 2, 32)
        _export_metrics(name)
        time.sleep(sleep_s * delay_mult)


def cmd_init_db(args):
    t = _tracker(args)
    print(f"job-tracker DB ready at {t.db_path}")
    return 0


def cmd_add_files(args):
    """Manual ingest (reference bin/add_files.py): register existing
    files as status 'added' after type/duplicate checks."""
    from tpulsar_torch.io import datafile
    t = _tracker(args)
    added = 0
    for fn in args.files:
        fn = os.path.abspath(fn)
        if not os.path.exists(fn):
            print(f"skip {fn}: does not exist")
            continue
        try:
            cls = datafile.get_datafile_type([fn])
        except datafile.DatafileError as e:
            print(f"skip {fn}: {e}")
            continue
        m = cls.fnmatch(fn)
        if m and m.groupdict().get("beam") == "7":
            print(f"skip {fn}: beam 7 (pointless to search - reference "
                  f"pipeline_utils.py:114)")
            continue
        dup = t.query(
            "SELECT id FROM files WHERE filename=? AND status NOT IN "
            "('failed','terminal_failure','deleted')", [fn], fetchone=True)
        if dup:
            print(f"skip {fn}: already tracked")
            continue
        t.insert("files", filename=fn, remote_filename=os.path.basename(fn),
                 size=os.path.getsize(fn), status="added",
                 details="added manually")
        added += 1
    print(f"added {added} files")
    return 0


def _queue_manager_kwargs(cfg) -> dict:
    """Per-backend constructor kwargs from config (shared by the job
    pool and kill-jobs)."""
    state_dir = os.path.join(cfg.processing.base_working_directory,
                             ".queue_state")
    qm_kw = {}
    if cfg.jobpooler.queue_manager == "local":
        qm_kw = {"max_jobs_running": cfg.jobpooler.max_jobs_running,
                 "state_dir": os.path.join(
                     cfg.processing.base_working_directory, ".localq")}
        if cfg.jobpooler.submit_script:
            qm_kw["script"] = cfg.jobpooler.submit_script
    elif cfg.jobpooler.queue_manager in ("slurm", "pbs", "moab"):
        qm_kw = {"script": cfg.jobpooler.submit_script,
                 "queue_name": cfg.jobpooler.queue_name,
                 "max_jobs_running": cfg.jobpooler.max_jobs_running,
                 "max_jobs_queued": cfg.jobpooler.max_jobs_queued,
                 "state_file": os.path.join(
                     state_dir, f"{cfg.jobpooler.queue_manager}.json")}
        if cfg.jobpooler.queue_manager in ("slurm", "moab"):
            qm_kw["walltime_per_gb"] = cfg.jobpooler.walltime_per_gb
    elif cfg.jobpooler.queue_manager == "tpu_slice":
        hosts = [h.strip() for h in cfg.jobpooler.tpu_hosts.split(",")
                 if h.strip()]
        qm_kw = {"hosts": hosts,
                 "launcher": cfg.jobpooler.tpu_launcher,
                 "state_file": os.path.join(state_dir, "tpu_slice.json")}
    elif cfg.jobpooler.queue_manager == "warm":
        fb = {"max_jobs_running": cfg.jobpooler.max_jobs_running,
              "state_dir": os.path.join(
                  cfg.processing.base_working_directory, ".localq")}
        if cfg.jobpooler.submit_script:
            fb["script"] = cfg.jobpooler.submit_script
        qm_kw = {"spool": _serve_spool(cfg),
                 "max_queue_depth": cfg.jobpooler.serve_queue_depth,
                 "fallback_kwargs": fb}
    return qm_kw


def _make_pool(args, cfg):
    from tpulsar_torch.orchestrate.pool import JobPool
    from tpulsar_torch.orchestrate.queue_managers import get_queue_manager
    qm = get_queue_manager(cfg.jobpooler.queue_manager,
                           **_queue_manager_kwargs(cfg))
    return JobPool(_tracker(args), qm,
                   cfg.processing.base_results_directory,
                   max_attempts=cfg.jobpooler.max_attempts,
                   notify=_notify(cfg),
                   delete_raw_on_terminal=cfg.basic.delete_rawdata)


def cmd_jobpool(args):
    from tpulsar_torch.config import settings
    cfg = settings()
    pool = _make_pool(args, cfg)

    def show():
        print(f"jobpool status: {pool.status()}")

    if args.once:
        show()
        pool.rotate()
        _export_metrics("jobpool")
        return 0
    return _daemon_loop("jobpool", pool.rotate, show,
                        cfg.background.sleep, _notify(cfg))


def cmd_downloader(args):
    from tpulsar_torch.config import settings
    from tpulsar_torch.orchestrate import downloader as dl
    cfg = settings()
    root = args.remote_root or cfg.download.api_service_url
    if not root:
        print("downloader: set --remote-root (local fixture) or "
              "download.api_service_url", file=sys.stderr)
        return 2
    if cfg.download.transport == "http":
        transport = dl.HTTPTransport(root)
        service = dl.HTTPRestoreService(root)
    else:
        transport = dl.LocalTransport(root)
        service = dl.LocalRestoreService(root)
    d = dl.Downloader(_tracker(args), service, transport,
                      datadir=cfg.download.datadir,
                      space_to_use=cfg.download.space_to_use,
                      min_free_space=cfg.download.min_free_space,
                      numdownloads=cfg.download.numdownloads,
                      numrestores=cfg.download.numrestores,
                      numretries=cfg.download.numretries,
                      request_timeout_hours=cfg.download.request_timeout_hours,
                      request_numbits=cfg.download.request_numbits,
                      request_datatype=cfg.download.request_datatype)
    if args.once:
        d.run()
        # finish the transfers this iteration started before exiting
        d.wait_downloads()
        print(d.status())
        _export_metrics("downloader")
        return 0
    return _daemon_loop("downloader", d.run,
                        lambda: print(d.status()),
                        cfg.background.sleep, _notify(cfg))


def cmd_uploader(args):
    from tpulsar_torch.config import settings
    from tpulsar_torch.orchestrate.uploader import JobUploader
    cfg = settings()
    up = JobUploader(_tracker(args), db_url=cfg.resultsdb.url,
                     notify=_notify(cfg),
                     delete_raw_on_upload=cfg.basic.delete_rawdata)
    if args.once:
        up.run()
        _export_metrics("uploader")
        return 0
    return _daemon_loop("uploader", up.run, lambda: None,
                        cfg.background.sleep, _notify(cfg))


def cmd_status(args):
    t = _tracker(args)
    print("=== tpulsar status ===")
    for table in ("requests", "files", "jobs", "job_submits"):
        rows = t.query(
            f"SELECT status, COUNT(*) c FROM {table} GROUP BY status")
        counts = ", ".join(f"{r['status']}={r['c']}" for r in rows) or "empty"
        print(f"{table:>14s}: {counts}")
    return 0


def cmd_show(args):
    t = _tracker(args)
    what = args.what
    queries = {
        "processing": ("SELECT s.job_id, s.queue_id, s.output_dir, "
                       "s.updated_at FROM job_submits s "
                       "WHERE s.status='running'"),
        "downloading": ("SELECT id, remote_filename, size, updated_at "
                        "FROM files WHERE status IN "
                        "('downloading','unverified')"),
        "uploading": ("SELECT id, job_id, output_dir, updated_at FROM "
                      "job_submits WHERE status IN "
                      "('processed','upload_failed')"),
        "failed": ("SELECT id, status, details, updated_at FROM jobs "
                   "WHERE status IN ('failed','retrying',"
                   "'terminal_failure')"),
    }
    rows = t.query(queries[what])
    if not rows:
        print(f"nothing {what}")
        return 0
    cols = rows[0].keys()
    print(" | ".join(cols))
    for r in rows:
        print(" | ".join(str(r[c])[:60] for c in cols))
    return 0


def cmd_kill_jobs(args):
    """Fail running submissions (reference bin/kill_jobs.py /
    stop_processing_jobs.py: fail vs polite remove)."""
    from tpulsar_torch.config import settings
    cfg = settings()
    pool = _make_pool(args, cfg)
    t = pool.t
    ids = args.job_ids or [r["id"] for r in t.query(
        "SELECT id FROM jobs WHERE status='submitted'")]
    for job_id in ids:
        sub = t.query(
            "SELECT id sid, queue_id FROM job_submits WHERE job_id=? "
            "AND status='running'", [job_id], fetchone=True)
        if sub:
            pool.qm.delete(sub["queue_id"])
            t.update("job_submits", sub["sid"], status="stopped",
                     details="killed by operator")
        new_status = "failed" if args.fail else "terminal_failure"
        t.update("jobs", job_id, status=new_status,
                 details="stopped by operator")
        print(f"job {job_id} -> {new_status}")
    return 0


def cmd_remove_files(args):
    t = _tracker(args)
    for fid in args.file_ids:
        row = t.query("SELECT * FROM files WHERE id=?", [fid],
                      fetchone=True)
        if row is None:
            print(f"file {fid}: not found")
            continue
        if row["filename"] and os.path.exists(row["filename"]):
            os.remove(row["filename"])
        t.update("files", fid, status="deleted",
                 details="removed by operator")
        print(f"file {fid} deleted")
    return 0


def cmd_stats(args):
    """Pipeline statistics dashboard (reference
    bin/show_pipeline_stats.py:12-99): cumulative job counts, restore
    history, and raw-data disk usage — rendered to a PNG (and printed
    as text).  --follow re-renders every --interval seconds, the
    reference's self-updating figure."""
    if getattr(args, "follow", False):
        import time as _time
        args.follow = False
        try:
            while True:
                cmd_stats(args)
                print(f"-- refreshing every {args.interval:.0f} s "
                      f"(Ctrl-C to stop) --", flush=True)
                _time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
    t = _tracker(args)
    jobs = t.query("SELECT status, COUNT(*) c FROM jobs GROUP BY status")
    files = t.query("SELECT status, COUNT(*) c, COALESCE(SUM(size),0) s "
                    "FROM files GROUP BY status")
    reqs = t.query("SELECT status, COUNT(*) c FROM requests "
                   "GROUP BY status")
    print("jobs:     ", {r["status"]: r["c"] for r in jobs} or "none")
    print("files:    ", {r["status"]: r["c"] for r in files} or "none")
    print("requests: ", {r["status"]: r["c"] for r in reqs} or "none")
    disk_bytes = sum(r["s"] for r in files
                     if r["status"] in ("downloading", "unverified",
                                        "downloaded", "added"))
    print(f"raw data on disk: {disk_bytes / 2**30:.2f} GiB")
    _print_daemon_metrics()

    if args.png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # cumulative created/uploaded/terminal over time
        created = [r["created_at"] for r in t.query(
            "SELECT created_at FROM jobs ORDER BY created_at")]
        uploaded = [r["updated_at"] for r in t.query(
            "SELECT updated_at FROM jobs WHERE status='uploaded' "
            "ORDER BY updated_at")]
        failed = [r["updated_at"] for r in t.query(
            "SELECT updated_at FROM jobs WHERE status='terminal_failure' "
            "ORDER BY updated_at")]
        from datetime import datetime

        def _ts(series):
            return [datetime.strptime(s, "%Y-%m-%d %H:%M:%S")
                    for s in series if s]

        fig, axes = plt.subplots(2, 1, figsize=(8, 7))
        for series, label in ((created, "created"),
                              (uploaded, "uploaded"),
                              (failed, "terminal failure")):
            times = _ts(series)
            if times:
                axes[0].step(times, range(1, len(times) + 1),
                             where="post", label=label)
        axes[0].set_ylabel("cumulative jobs")
        axes[0].tick_params(axis="x", rotation=30, labelsize=7)
        if axes[0].get_legend_handles_labels()[0]:
            axes[0].legend(loc="upper left", fontsize=8)
        labels = [r["status"] for r in files]
        sizes = [r["s"] / 2**30 for r in files]
        axes[1].bar(labels, sizes, color="0.5")
        axes[1].set_ylabel("raw data (GiB)")
        axes[1].tick_params(axis="x", rotation=30)
        fig.suptitle("tpulsar pipeline stats")
        fig.tight_layout()
        fig.savefig(args.png, dpi=100)
        plt.close(fig)
        print(f"wrote {args.png}")
    return 0


def _print_daemon_metrics(names: tuple[str, ...] = ()) -> None:
    """Render the daemons' exported metrics (the .prom files written
    each loop iteration) — `stats`/`monitor` show live telemetry from
    processes they are not part of."""
    import glob

    d = _metrics_dir()
    paths = sorted(glob.glob(os.path.join(d, "*.prom")))
    if names:
        paths = [p for p in paths
                 if os.path.basename(p).split(".")[0] in names]
    if not paths:
        return
    print(f"--- daemon metrics ({d}) ---")
    for p in paths:
        age = time.time() - os.path.getmtime(p)
        print(f"[{os.path.basename(p).split('.')[0]}] "
              f"(exported {age:.0f} s ago)")
        try:
            with open(p) as fh:
                for ln in fh:
                    if ln.startswith("#") or not ln.strip():
                        continue
                    print(f"  {ln.rstrip()}")
        except OSError:
            continue


def cmd_monitor(args):
    """Live download monitor (reference bin/monitor_downloads.py):
    refreshes per-file progress until interrupted."""
    t = _tracker(args)
    try:
        while True:
            rows = t.query(
                "SELECT id, remote_filename, filename, size, status "
                "FROM files WHERE status IN ('downloading','unverified',"
                "'new','retrying')")
            os.system("clear" if os.name != "nt" else "cls")
            print(f"=== downloads ({time.strftime('%H:%M:%S')}) ===")
            if not rows:
                print("nothing in flight")
            for r in rows:
                have = (os.path.getsize(r["filename"])
                        if r["filename"] and os.path.exists(r["filename"])
                        else 0)
                total = r["size"] or 0
                pct = 100.0 * have / total if total else 0.0
                bar = "#" * int(pct / 5)
                print(f"[{r['id']:>4}] {os.path.basename(r['remote_filename'] or '?'):<40.40} "
                      f"{r['status']:<12} |{bar:<20}| {pct:5.1f}%")
            _print_daemon_metrics(("downloader",))
            if args.once:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_db_shell(args):
    """Interactive SQL prompt on the results DB (reference
    lib/python/database.py:184-224 InteractiveDatabasePrompt, with
    table-name completion instead of sproc completion)."""
    import cmd as cmd_mod

    from tpulsar_torch.config import settings
    from tpulsar_torch.orchestrate.results_db import ResultsDB

    db = ResultsDB(args.url or settings().resultsdb.url)
    tables = [r["name"] for r in db.execute(
        "SELECT name FROM sqlite_master WHERE type='table'").fetchall()]

    class Prompt(cmd_mod.Cmd):
        prompt = "resultsdb> "
        intro = (f"connected ({', '.join(tables) or 'no tables'}); "
                 f"'.tables' lists tables, EOF/quit exits")

        def default(self, line):
            if line.strip() in (".tables", "tables"):
                print("\n".join(tables))
                return
            try:
                cur = db.execute(line)
                rows = cur.fetchall()
            except Exception as e:
                print(f"error: {e}")
                return
            if rows:
                cols = rows[0].keys()
                print(" | ".join(cols))
                for r in rows[:200]:
                    print(" | ".join(str(r[c])[:40] for c in cols))
                if len(rows) > 200:
                    print(f"... {len(rows) - 200} more rows")
            db.commit()

        def completenames(self, text, *ignored):
            kw = ["SELECT", "INSERT", "UPDATE", "DELETE", "quit"]
            return [k for k in kw + tables if k.lower().startswith(
                text.lower())]

        def do_quit(self, line):
            return True

        do_EOF = do_quit

    try:
        Prompt().cmdloop()
    except KeyboardInterrupt:
        pass
    finally:
        db.close()
    return 0


def _obs_queue(args, spool):
    """Resolve an obs/doctor ``--queue`` URL to (backend, journal
    root): reads route through the TicketQueue so ``sqlite:`` fleets
    are first-class, and the filesystem root (worker metric
    snapshots, blackbox dumps, alerts.json) follows the backend's
    journal_root.  The bare token 'sqlite' expands to
    sqlite:<spool>/queue.db, mirroring the chaos commands."""
    url = getattr(args, "queue", "") or ""
    if not url:
        return None, spool
    if url == "sqlite":
        url = f"sqlite:{os.path.join(spool, 'queue.db')}"
    from tpulsar_torch.frontdoor.queue import get_ticket_queue
    q = get_ticket_queue(url)
    return q, q.journal_root or spool


def cmd_plan(args):
    """Show (and optionally plot) the dedispersion plan for an
    observation or explicit parameters (reference DDplan2b.py CLI)."""
    from tpulsar_torch.plan import ddplan

    # An explicit DM range suppresses the file-backend survey plan —
    # the operator's range always wins; --survey always forces the
    # hardcoded plan.
    explicit_range = args.lodm is not None or args.hidm is not None
    lodm = args.lodm if args.lodm is not None else 0.0
    hidm = args.hidm if args.hidm is not None else 1000.0
    if args.files:
        from tpulsar_torch.io import datafile
        si = datafile.autogen_dataobj(args.files).specinfo
        survey = args.survey if args.survey is not None else \
            ("" if explicit_range else None)
        steps, obs, _nsub = ddplan.plan_for(
            si, lodm, hidm, args.numsub, survey=survey)
    else:
        obs = ddplan.Observation(dt=args.dt, fctr=args.fctr, bw=args.bw,
                                 numchan=args.numchan,
                                 blocklen=args.blocklen)
        if args.survey:
            steps = ddplan.survey_plan(args.survey)
        else:
            steps = ddplan.generate_ddplan(obs, lodm, hidm,
                                           numsub=args.numsub)
    print(ddplan.describe_plan(steps, obs))
    if args.png:
        print("wrote", ddplan.plot_plan(steps, obs, args.png))
    return 0


def cmd_trace(args):
    """Summarize the last beam's telemetry trace in a results dir
    (the `<basenm>_trace.json` a TPULSAR_TRACE=1 search writes):
    per-span seconds/share/scope-count table, newest file wins.
    Same find/summarize/render implementation as
    tools/torch_trace_summarize.py — this is the operator-facing
    spelling."""
    from tpulsar_torch.obs import trace as trace_lib

    try:
        trace_file = trace_lib.find_trace_file(args.path)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(trace_lib.render_summary(trace_lib.summarize_file(
        trace_file)))
    return 0


def cmd_obs(args):
    """The fleet ops console (obs/journal.py + fleetview.py +
    health.py):

      timeline <ticket> — one beam's full lifecycle from the spool's
                          ticket journal, across every worker that
                          touched it (claims, steals, quarantine),
                          with durations between transitions
      top               — live per-worker state, queue depths, and
                          journal-derived SLO quantiles (refresh
                          loop; --once for scripts)
      tail              — follow the ticket journal as events land
      blackbox <worker> — render a dead worker's flight-recorder
                          dump (the last seconds before death)

    All of them read spool/backend state only — no connection to any
    worker or controller process is needed.  ``--queue`` routes the
    reads through a ticket-queue backend (the ``sqlite:`` path)."""
    from tpulsar_torch.config import settings
    from tpulsar_torch.obs import fleetview, journal

    spool = args.spool or _serve_spool(settings())
    queue, root = _obs_queue(args, spool)
    if args.obs_cmd == "timeline":
        text = journal.render_timeline(root, args.ticket,
                                       queue=queue)
        print(text)
        if args.stitch:
            import json as _json
            try:
                obj = fleetview.stitch(root, args.ticket)
            except FileNotFoundError as e:
                print(str(e), file=sys.stderr)
                return 1
            with open(args.stitch, "w") as fh:
                _json.dump(obj, fh)
            print(f"stitched Perfetto timeline -> {args.stitch} "
                  f"({len(obj['traceEvents'])} events)")
        return 0 if not text.startswith("no journal events") else 1
    if args.obs_cmd == "top":
        try:
            while True:
                text = fleetview.render_top(root, queue=queue)
                if not args.once:
                    os.system("clear" if os.name != "nt" else "cls")
                print(text, flush=True)
                if args.once:
                    return 0
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
    if args.obs_cmd == "blackbox":
        from tpulsar_torch.obs import health
        text = health.render_blackbox(root, args.worker)
        print(text)
        return 0 if not text.startswith("no blackbox dump") else 1
    if args.obs_cmd == "tail":
        # ride the journal's offset-tailed reader: the attach read
        # replays history once, each poll then costs O(new bytes)
        # (rotation handled inside read_events; torn appends are
        # recovered or skipped by its tail-line contract)
        import json as _json

        def _tail_read(off):
            # corruption is WARNED and skipped, never fatal: an
            # operator's tail must keep following past a bad line
            # (the chaos verifier is the strict reader), and raising
            # here would stall the loop at the same offset forever
            bad: list = []
            try:
                if queue is not None:
                    evs, off = queue.read_events_after(off)
                else:
                    evs, off = journal.read_events(root,
                                                   after_offset=off,
                                                   bad_lines=bad)
            except OSError:
                return [], off
            for b in bad:
                print(f"# journal corrupt line skipped: "
                      f"{b['text'][:80]!r}", file=sys.stderr)
            return evs, off

        events, offset = _tail_read(0)
        for ev in events[-args.lines:]:
            print(_json.dumps(ev, sort_keys=True))
        if not args.follow:
            return 0 if events else 1
        try:
            while True:
                time.sleep(args.interval)
                new, offset = _tail_read(offset)
                for ev in new:
                    print(_json.dumps(ev, sort_keys=True),
                          flush=True)
        except KeyboardInterrupt:
            return 0
    return 2


def cmd_checkpoint(args):
    """Inspect/audit a beam's crash-resume checkpoints (checkpoint/;
    the schema is the JAX package's, so either package's checkpoints
    read here): render the manifest — fingerprint, one row per
    artifact (key, kind, bytes, sha256 prefix, age) — and with
    --verify re-hash every artifact against its manifest entry (exit
    1 on any mismatch: the beam would recompute those on resume).
    Accepts either a checkpoint dir or a beam outdir containing
    ``.checkpoint``."""
    from tpulsar_torch import checkpoint as ckpt

    root = args.dir
    if not os.path.exists(ckpt.manifest_path(root)) \
            and os.path.exists(
                ckpt.manifest_path(ckpt.default_root(root))):
        root = ckpt.default_root(root)
    doc = ckpt.read_manifest(root)
    if doc is None:
        print(f"no readable checkpoint manifest under {root} "
              f"(schema {ckpt.SCHEMA})")
        return 1
    entries = doc.get("entries") or {}
    print(f"checkpoint: {root}")
    print(f"  schema {doc.get('schema')}  fingerprint "
          f"{str(doc.get('fingerprint'))[:16]}…  "
          f"{len(entries)} artifact(s)")
    now = time.time()
    for key, e in sorted(entries.items()):
        age = now - float(e.get("written_at", now))
        print(f"  {key:<12s} {e.get('kind', '?'):<9s} "
              f"{e.get('bytes', -1):>10d} B  "
              f"sha256 {str(e.get('sha256'))[:12]}…  "
              f"{age:7.1f} s old")
    if not args.verify:
        return 0
    report = ckpt.verify_root(root)
    bad = [e for e in report["entries"] if not e["ok"]]
    for e in bad:
        print(f"  INVALID {e['key']}: {e['reason']}")
    print("verify: OK — every artifact matches its manifest entry"
          if report["ok"] else
          f"verify: {len(bad)} invalid artifact(s) — resume would "
          f"recompute them")
    return 0 if report["ok"] else 1


def cmd_aot(args):
    """The AOT layer's operator surface (aot/) — counterpart of the JAX
    CLI's ``aot``:

      compile — build and load every registered library and write the
                manifest
      verify  — replay the builds and loads against the manifest; exit
                1 if any library had to be built (a miss)
      ls      — print the build directory, the manifest state and the
                registry

    rc 0 ok / 1 failures or misses / 3 deadline deferral.  The JAX
    CLI's ``--scale``, ``--accel``, ``--config``, ``--fast`` and
    ``--beams`` choose the shapes its XLA programs compile at; a
    library has no shapes, so here they select nothing (a line says
    so when one is set)."""
    from tpulsar_torch.aot import cachedir, registry, warmstart

    if args.aot_cmd == "ls":
        print(f"cache dir: {cachedir.resolve()}")
        manifest = warmstart.load_manifest()
        manifested = set(manifest["programs"]) if manifest else set()
        print(f"manifest:  {cachedir.manifest_path()}"
              + ("" if manifest else " (absent)"))
        print(f"{len(registry.PROGRAMS)} registered programs:")
        for prog in registry.PROGRAMS:
            mark = "*" if prog.name in manifested else " "
            print(f"  {mark} {prog.name:36s} "
                  f"{prog.module}.{prog.load} target={prog.target}")
        if manifest:
            print("  (* = in the warm-start manifest)")
        print(f"{len(registry.EXEMPT_SITES)} exempt compiler sites "
              "(no library is built there):")
        for site, why in sorted(registry.EXEMPT_SITES.items()):
            print(f"    {site}: {why}")
        return 0

    shaped = [flag for flag, set_ in (
        ("--scale", args.scale != 1.0), ("--accel", args.accel),
        ("--config", args.aot_config != 0), ("--fast", args.fast),
        ("--beams", args.beams != 0)) if set_]
    if shaped:
        print(f"{', '.join(shaped)}: XLA program shapes of the JAX "
              "package; the port's libraries have no shapes, so this "
              "selects nothing")
    only = tuple(s.strip() for s in args.only.split(",") if s.strip())
    return warmstart.run_gate(only=only, deadline=args.deadline,
                              verify=args.aot_cmd == "verify")


def cmd_lint(args):
    from tpulsar_torch.analysis import cli as lint_cli
    return lint_cli.run(args)


def cmd_search(args):
    """One beam through the per-beam job (cli/search_job.py), on the
    card unless --device cpu.  Without a GPU and without --device cpu
    it exits 2, naming the device, before anything is read."""
    from tpulsar_torch import resolve_device
    from tpulsar_torch.cli import search_job

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"search: cannot run on device {args.device!r}: {e}",
              file=sys.stderr)
        return 2
    argv = list(args.files) + ["--outdir", args.outdir,
                               "--device", args.device]
    if args.no_accel:
        argv.append("--no-accel")
    return search_job.main(argv)


def _doctor_alerts(args):
    """Fleet health verdict from the declarative alert pack
    (obs/health.py + obs/alerts.py): one-shot evaluates the rules
    read-only against the journal/metrics/fsck surfaces and exits
    0 healthy / 1 firing; ``--watch`` hosts a resident
    HealthDetector instead (journaling alert transitions, persisting
    alerts.json, fanning out through the notifier) — the standalone
    spelling of the loop every FleetController already runs."""
    from tpulsar_torch.config import settings
    from tpulsar_torch.obs import alerts as alerts_lib, health

    spool = args.spool or _serve_spool(settings())
    queue, root = _obs_queue(args, spool)
    rules = alerts_lib.load_rules(args.rules) if args.rules else None
    title = f"fleet health: {root}"
    if not args.watch:
        active = health.evaluate_once(root, queue=queue, rules=rules)
        print(health.render_alerts(active, title=title))
        return 1 if active else 0
    det = health.HealthDetector(root, queue=queue, rules=rules)
    interval = (args.interval if args.interval > 0
                else health.alert_interval_s())
    try:
        while True:
            active = det.tick()
            print(health.render_alerts(
                active, title=f"{title} (watch, {interval:g}s)"),
                flush=True)
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


#: the device probe, run in a subprocess under --device-timeout: one
#: small matmul on the card, its device count and name, and whether
#: the CUDA kernel library of this checkout is built
_DEVICE_PROBE = """
import json, torch
rec = {"torch": torch.__version__, "cuda": torch.version.cuda,
       "ndev": torch.cuda.device_count()}
if torch.cuda.is_available():
    x = torch.ones((64, 64), device="cuda")
    rec["ok"] = float((x @ x).sum().item()) == 64.0 ** 3
    rec["name"] = torch.cuda.get_device_name(0)
print(json.dumps(rec))
"""

#: the environment pins the port's search reads (the JAX doctor's
#: TPULSAR_PALLAS and TPULSAR_ACCEL_NATIVE have no meaning here)
_DOCTOR_PINS = ("TPULSAR_DD_FAMILY", "TPULSAR_ACCEL_BATCH",
                "TPULSAR_ACCEL_PLANE_DTYPE", "TPULSAR_SP_DETREND")


def cmd_doctor(args):
    """Environment probe — counterpart of the JAX CLI's ``doctor``:
    the reference's install_test.py dependency check and test_job.py
    worker-node probe (imports, config, directories writable, job
    tracker reachable, queue-manager contract, and a device probe in
    a subprocess under a timeout) rolled into one operator command.
    Exit 0 = healthy.

    Adapted to this package: the accelerator probe is a ``torch.cuda``
    probe (one small matmul on the card, printing the device count
    and name; a node without a CUDA device fails it, since the
    entry points default to the card), and the JAX doctor's
    "fallback paths" section (smoke caches under its compile cache)
    becomes this package's own state: whether the CUDA kernel
    library and the native library of this checkout are built in
    ``tpulsar_torch/_build/``, the ``TPULSAR_*`` pins the search
    reads, and ``degraded.snapshot()``.  The doctor process itself
    imports no torch.

    With --spool/--queue/--rules/--watch the doctor judges the FLEET
    instead of the node: the declarative alert pack against the live
    journal (see _doctor_alerts)."""
    if args.watch or args.spool or args.queue or args.rules:
        return _doctor_alerts(args)
    import importlib
    import json
    import subprocess
    import tempfile

    from tpulsar_torch.config import settings

    failures = []

    def report(name: str, ok: bool, detail: str = "") -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {name}"
              + (f" — {detail}" if detail else ""))
        if not ok:
            failures.append(name)

    print("dependencies:")
    for mod, hint in [("numpy", "pip install numpy"),
                      ("scipy", "pip install scipy"),
                      ("matplotlib", "pip install matplotlib "
                                     "(plots/stats dashboards)"),
                      ("yaml", "pip install pyyaml (YAML configs; "
                               "python configs work without it)")]:
        try:
            importlib.import_module(mod)
            report(f"import {mod}", True)
        except ImportError as e:
            report(f"import {mod}", False, f"{e}; hint: {hint}")

    cfg = settings()
    print("config:")
    try:
        # create_dirs: a fresh install's missing directories are not a
        # health problem — the writability probes below verify them
        cfg.check_sanity(create_dirs=True)
        report("check_sanity", True)
    except Exception as e:
        report("check_sanity", False, str(e)[:200])

    print("directories writable:")
    for name, path in [
            ("basic.log_dir", cfg.basic.log_dir),
            ("download.datadir", cfg.download.datadir),
            ("processing.base_working_directory",
             cfg.processing.base_working_directory),
            ("processing.base_results_directory",
             cfg.processing.base_results_directory)]:
        try:
            os.makedirs(path, exist_ok=True)
            with tempfile.TemporaryFile(dir=path):
                pass
            report(f"{name} = {path}", True)
        except OSError as e:
            report(f"{name} = {path}", False, str(e))

    print("job tracker:")
    try:
        from tpulsar_torch.orchestrate import jobtracker

        db = jobtracker.JobTracker(args.db or cfg.background.jobtracker_db)
        n = db.query("SELECT count(*) FROM jobs", fetchone=True)
        report("query jobs table", True, f"{n[0]} jobs")
    except Exception as e:
        report("query jobs table", False,
               f"{e}; hint: run `python -m tpulsar_torch init-db` "
               f"first")

    print("queue manager:")
    try:
        from tpulsar_torch.orchestrate.queue_managers import \
            get_queue_manager

        qm = get_queue_manager(cfg.jobpooler.queue_manager,
                               **_queue_manager_kwargs(cfg))
        missing = [m for m in ("submit", "can_submit", "is_running",
                               "delete", "status", "had_errors",
                               "get_errors")
                   if not callable(getattr(qm, m, None))]
        report(f"{cfg.jobpooler.queue_manager} implements the 7-method "
               f"contract", not missing, ",".join(missing))
    except Exception as e:
        report("instantiate queue manager", False, str(e)[:200])

    print("device:")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    probe_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    rec = None
    try:
        out = subprocess.run([sys.executable, "-c", _DEVICE_PROBE],
                             capture_output=True, text=True,
                             env=probe_env,
                             timeout=args.device_timeout)
        for line in reversed(out.stdout.strip().splitlines()):
            try:
                rec = json.loads(line)
                break
            except json.JSONDecodeError:
                continue
        if out.returncode != 0 or rec is None:
            rec = None
            report("device probe", False,
                   out.stderr.strip()[-200:] or "no output")
        elif rec.get("ok"):
            report("device probe", True,
                   f"{rec['ndev']}x {rec['name']} (torch "
                   f"{rec['torch']}, CUDA {rec['cuda']})")
        else:
            report("device probe", False,
                   f"no CUDA device (torch {rec['torch']}, CUDA "
                   f"{rec['cuda']}); the entry points need --device "
                   f"cpu on this node")
    except subprocess.TimeoutExpired:
        report("device probe", False,
               f"hung > {args.device_timeout:.0f} s (wedged card?)")

    print("build state and pins:")
    from tpulsar_torch.aot import cachedir, registry, warmstart

    manifest = warmstart.load_manifest()
    listed = (manifest or {}).get("programs", {})
    print(f"  [{'ok' if manifest else '--'}] build dir "
          f"{cachedir.resolve()}: manifest "
          + ("with " + ", ".join(sorted(listed)) if manifest else
             "absent — `python -m tpulsar_torch aot compile` writes it"))
    current = set()
    for prog in registry.PROGRAMS:
        lib = registry.library_path(prog)
        current.add(os.path.basename(lib))
        built = os.path.exists(lib)
        fresh = listed.get(prog.name, {}).get("library") == lib
        print(f"  [{'ok' if built else '--'}] {prog.title}: {lib}"
              + ((" (in the manifest)" if fresh else
                  " (not in the manifest)") if built else
                 " not built — `aot compile` or its first use "
                 "builds it"))
    stale = sorted(cachedir.library_entries() - current)
    if stale:
        print(f"  [--] {len(stale)} stale libraries in the build dir "
              f"(other sources, flags or hosts): {', '.join(stale)}")
    for var in _DOCTOR_PINS:
        val = os.environ.get(var)
        if val is not None:
            print(f"  [pin] {var}={val}")
    from tpulsar_torch.search import degraded

    snap = degraded.snapshot()
    if snap:
        for flag, detail in sorted(snap.items()):
            print(f"  [degraded] {flag}: {detail}")
    else:
        print("  [ok] no degraded modes noted in this process "
              "(per-run flags land in each results dir's .report)")

    print(("all checks passed" if not failures
           else f"{len(failures)} check(s) FAILED: "
                + ", ".join(failures)))
    return 0 if not failures else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpulsar_torch",
                                description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--db", default=None, help="job-tracker DB path")
    p.add_argument("--config", default=None, metavar="PATH",
                   help="config file (python or YAML); exported as "
                        "TPULSAR_CONFIG so worker subprocesses load "
                        "the same settings")
    debugflags.add_cli_flags(p)
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("init-db").set_defaults(fn=cmd_init_db)

    sp = sub.add_parser("add-files")
    sp.add_argument("files", nargs="+")
    sp.set_defaults(fn=cmd_add_files)

    for name, fn in (("jobpool", cmd_jobpool),
                     ("uploader", cmd_uploader)):
        sp = sub.add_parser(name)
        sp.add_argument("--once", action="store_true")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("downloader")
    sp.add_argument("--once", action="store_true")
    sp.add_argument("--remote-root", default=None)
    sp.set_defaults(fn=cmd_downloader)

    sub.add_parser("status").set_defaults(fn=cmd_status)

    sp = sub.add_parser("show")
    sp.add_argument("what", choices=["processing", "downloading",
                                     "uploading", "failed"])
    sp.set_defaults(fn=cmd_show)

    sp = sub.add_parser("kill-jobs")
    sp.add_argument("job_ids", nargs="*", type=int)
    sp.add_argument("--fail", action="store_true",
                    help="mark failed (retryable) instead of terminal")
    sp.set_defaults(fn=cmd_kill_jobs)

    sp = sub.add_parser("remove-files")
    sp.add_argument("file_ids", nargs="+", type=int)
    sp.set_defaults(fn=cmd_remove_files)

    sp = sub.add_parser("db-shell")
    sp.add_argument("--url", default=None,
                    help="results DB (default: resultsdb.url)")
    sp.set_defaults(fn=cmd_db_shell)

    sp = sub.add_parser("stats")
    sp.add_argument("--png", default=None,
                    help="also render the dashboard to this PNG")
    sp.add_argument("--follow", action="store_true",
                    help="re-render every --interval seconds")
    sp.add_argument("--interval", type=float, default=30.0)
    sp.set_defaults(fn=cmd_stats)

    sp = sub.add_parser("monitor")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--once", action="store_true")
    sp.set_defaults(fn=cmd_monitor)

    sp = sub.add_parser("plan")
    sp.add_argument("files", nargs="*", help="observation files")
    sp.add_argument("--dt", type=float, default=65.476e-6)
    sp.add_argument("--fctr", type=float, default=1375.5)
    sp.add_argument("--bw", type=float, default=322.617)
    sp.add_argument("--numchan", type=int, default=960)
    sp.add_argument("--blocklen", type=int, default=2048)
    sp.add_argument("--lodm", type=float, default=None)
    sp.add_argument("--hidm", type=float, default=None)
    sp.add_argument("--numsub", type=int, default=96)
    sp.add_argument("--survey", default=None,
                    help="use the hardcoded survey plan (pdev|wapp)")
    sp.add_argument("--png", default=None,
                    help="also plot the plan (needs matplotlib)")
    sp.set_defaults(fn=cmd_plan)

    sp = sub.add_parser(
        "search", help="search one beam through the per-beam job, on "
                       "the card unless --device cpu")
    sp.add_argument("files", nargs="+")
    sp.add_argument("--outdir", required=True)
    sp.add_argument("--no-accel", action="store_true")
    sp.add_argument("--device", default="cuda",
                    help="where the search runs: cuda (default) or "
                         "cpu; without a GPU the command exits 2 "
                         "unless cpu is asked for")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser(
        "obs",
        help="fleet observability console: per-ticket lifecycle "
             "timeline from the spool journal, live fleet top, "
             "journal tail, and crashed-worker blackbox dumps — all "
             "from spool/backend state alone")
    osub = sp.add_subparsers(dest="obs_cmd", required=True)

    def _obs_queue_arg(op):
        op.add_argument(
            "--queue", default="",
            help="route reads through this ticket-queue backend URL "
                 "(sqlite:<path> / spool:<dir>); the bare token "
                 "'sqlite' expands to sqlite:<spool>/queue.db")

    op = osub.add_parser(
        "timeline", help="one beam's lifecycle across the fleet "
                         "(journal events + durations)")
    op.add_argument("ticket")
    op.add_argument("--spool", default=None)
    _obs_queue_arg(op)
    op.add_argument("--stitch", default=None, metavar="OUT.json",
                    help="also write the stitched Perfetto timeline "
                         "(journal events + this beam's trace spans "
                         "from every worker, one time axis)")
    op.set_defaults(fn=cmd_obs)
    op = osub.add_parser(
        "top", help="live per-worker state, queue depths, and "
                    "journal SLO quantiles")
    op.add_argument("--spool", default=None)
    _obs_queue_arg(op)
    op.add_argument("--interval", type=float, default=2.0)
    op.add_argument("--once", action="store_true")
    op.set_defaults(fn=cmd_obs)
    op = osub.add_parser("tail", help="follow the ticket journal")
    op.add_argument("--spool", default=None)
    _obs_queue_arg(op)
    op.add_argument("-n", "--lines", type=int, default=20)
    op.add_argument("-f", "--follow", action="store_true")
    op.add_argument("--interval", type=float, default=0.5)
    op.set_defaults(fn=cmd_obs)
    op = osub.add_parser(
        "blackbox", help="render a crashed worker's flight-recorder "
                         "dump: the bounded ring of its last "
                         "claims/journal appends/heartbeats, written "
                         "to <spool>/blackbox/ on abnormal exit")
    op.add_argument("worker", nargs="?", default="",
                    help="worker id (empty = the single-server dump)")
    op.add_argument("--spool", default=None)
    _obs_queue_arg(op)
    op.set_defaults(fn=cmd_obs)

    sp = sub.add_parser(
        "checkpoint",
        help="inspect a beam's crash-resume checkpoints: render the "
             "sha256 manifest, --verify re-hashes every artifact "
             "(exit 1 on mismatch)")
    sp.add_argument("dir", help="checkpoint dir, or a beam outdir "
                                "containing .checkpoint")
    sp.add_argument("--verify", action="store_true",
                    help="re-hash every artifact against the manifest")
    sp.set_defaults(fn=cmd_checkpoint)

    sp = sub.add_parser(
        "trace",
        help="per-stage rollup of the last beam's telemetry trace "
             "(TPULSAR_TRACE=1 searches write <basenm>_trace.json)")
    sp.add_argument("path", help="results dir (newest *_trace.json "
                                 "wins) or a trace file")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser(
        "aot",
        help="AOT layer: build the registered libraries into the "
             "build directory (compile), check a warm start against "
             "the manifest (verify), or list the registry (ls)")
    asub = sp.add_subparsers(dest="aot_cmd", required=True)
    nothing = "the JAX CLI's; selects nothing here (a library has no shapes)"
    for name, hlp in (
            ("compile", "build and load every library + write the "
                        "manifest"),
            ("verify", "replay the builds and loads; exit 1 on any "
                       "library built in-line")):
        ap = asub.add_parser(name, help=hlp)
        ap.add_argument("--scale", type=float, default=1.0, help=nothing)
        ap.add_argument("--accel", action="store_true", help=nothing)
        ap.add_argument("--config", type=int, default=0,
                        dest="aot_config", help=nothing)
        ap.add_argument("--fast", action="store_true", help=nothing)
        ap.add_argument("--deadline", type=float, default=0.0,
                        help="soft budget, checked between builds; "
                             "rc 3 defers the rest (re-run resumes)")
        ap.add_argument("--only", default="",
                        help="comma-separated library-name substrings "
                             "to gate (native, cuda_dd)")
        ap.add_argument("--beams", type=int, default=0, help=nothing)
        ap.set_defaults(fn=cmd_aot)
    ap = asub.add_parser("ls", help="list the library registry, "
                                    "exemptions, and manifest state")
    ap.set_defaults(fn=cmd_aot)

    sp = sub.add_parser(
        "lint",
        help="static contract linter: prove the fault-point / "
             "metric / journal-event / env-knob catalogs and the "
             "spool-write discipline have not drifted (rc 0 clean / "
             "1 findings / 2 internal error; no torch)")
    from tpulsar_torch.analysis.cli import add_arguments as _lint_args
    _lint_args(sp)
    sp.set_defaults(fn=cmd_lint)

    sp = sub.add_parser(
        "chaos",
        help="chaos harness: run a seeded fleet-wide failure "
             "scenario (run), audit the journal/spool against the "
             "system invariants (verify), or print the post-run "
             "digest incl. MTTR (report)")
    csub = sp.add_subparsers(dest="chaos_cmd", required=True)
    cp = csub.add_parser(
        "run", help="execute a scenario file against a fresh fleet "
                    "on the spool")
    cp.add_argument("--scenario", required=True,
                    help="scenario JSON path, or a packaged name "
                         "(e.g. ci_smoke)")
    cp.add_argument("--spool", default=None,
                    help="spool dir (default: the serve spool)")
    cp.add_argument("--queue", default="",
                    help="ticket-queue backend URL for the storm "
                         "(overrides the scenario's queue_url); the "
                         "bare token 'sqlite' expands to "
                         "sqlite:<spool>/queue.db")
    cp.set_defaults(fn=cmd_chaos)
    cp = csub.add_parser(
        "verify", help="assert the system invariants over the "
                       "spool's journal + state; exit 1 on any "
                       "violation")
    cp.add_argument("--spool", default=None)
    cp.add_argument("--queue", default="",
                    help="audit this queue backend URL instead of "
                         "the spool (default: the run manifest's "
                         "recorded queue_url); 'sqlite' expands to "
                         "sqlite:<spool>/queue.db")
    cp.add_argument("--scenario", default=None,
                    help="scenario providing the tenant table / "
                         "attempts cap (default: the spool's run "
                         "manifest)")
    cp.add_argument("--max-attempts", type=int, default=3)
    cp.add_argument("--tail", action="store_true",
                    help="follow the journal live (offset-tailed) "
                         "and report violations as evidence lands; "
                         "final full audit on chaos_run_end")
    cp.add_argument("--timeout", type=float, default=0.0,
                    help="--tail gives up after this many seconds "
                         "(0 = until run end / Ctrl-C)")
    cp.add_argument("--live", action="store_true",
                    help="audit a still-running fleet: skip the "
                         "quiesce-only judgments (lost tickets, "
                         "leftover side-files)")
    cp.set_defaults(fn=cmd_chaos)
    cp = csub.add_parser(
        "report", help="post-run digest: actions, statuses, MTTR "
                       "per kill, invariant verdict")
    cp.add_argument("--spool", default=None)
    cp.add_argument("--queue", default="",
                    help="report against this queue backend URL "
                         "(default: the run manifest's queue_url)")
    cp.add_argument("--scenario", default=None)
    cp.add_argument("--max-attempts", type=int, default=3)
    cp.set_defaults(fn=cmd_chaos)

    sp = sub.add_parser(
        "serve",
        help="resident search server: one device-owning process "
             "drains the spool admission queue (kernel build and "
             "device set-up paid once per boot, not once per beam)")
    sp.add_argument("--once", action="store_true",
                    help="process the spool's current tickets, then "
                         "exit 0 (CI / cron mode)")
    sp.add_argument("--spool", default=None,
                    help="spool dir (default: jobpooler.serve_spool "
                         "or <base_working_directory>/.serve_spool)")
    sp.add_argument("--queue", default="",
                    help="ticket-queue backend URL (spool:<dir> / "
                         "sqlite:<path> / memory:); "
                         "default: TPULSAR_QUEUE_URL or the spool "
                         "itself.  The spool stays the worker's "
                         "scratch/log root either way")
    sp.add_argument("--no-warmstart", action="store_true",
                    help="skip the boot-time warm search (the kernel "
                         "build and load still happen at boot)")
    sp.add_argument("--warmstart-scale", type=float, default=0.05,
                    help="fraction of a Mock beam's samples the boot's "
                         "warm search covers")
    sp.add_argument("--beam-deadline", type=float, default=0.0,
                    help="per-beam watchdog seconds (0 = none): a "
                         "hung beam fails its ticket instead of "
                         "wedging the server")
    sp.add_argument("--prefetch-depth", type=int, default=1,
                    help="beams the stage-in thread prepares ahead "
                         "of the device")
    sp.add_argument("--worker-id", default="",
                    help="fleet worker id: heartbeat goes to "
                         "server.<id>.json and claims/results are "
                         "stamped with it (empty = single-server "
                         "server.json)")
    sp.add_argument("--worker-class", default="",
                    choices=["", "ondemand", "spot"],
                    help="capacity class stamped on heartbeats, "
                         "claims, and results")
    sp.add_argument("--batch", type=int, default=1,
                    help="batched admission: claim up to N "
                         "compatible tickets per ordering pass and "
                         "search them as ONE coalesced batch-of-"
                         "beams dispatch (1 = per-beam admission); "
                         "per-beam results, checkpoints, and "
                         "exactly-once semantics are unchanged")
    sp.add_argument("--batch-linger", type=float, default=2.0,
                    help="bounded wait (s) a partial batch lingers "
                         "for late-arriving compatible tickets "
                         "before dispatching partial")
    sp.add_argument("--stream", action="store_true",
                    help="streaming search mode: claim stream session "
                         "tickets (kind=stream, fed through "
                         "tpulsar_torch.stream.ingest) and run each "
                         "through the streaming plane — chunked "
                         "dedispersion on the CUDA stage-2 kernel + "
                         "span single-pulse triggers, exactly-once "
                         "with a checkpointed carry; beam tickets "
                         "fail")
    sp.add_argument("--device", default="cuda",
                    help="where every beam runs: cuda (default) or "
                         "cpu; the server never moves to the CPU by "
                         "itself")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser(
        "fleet",
        help="multi-worker serving fleet: spawn/supervise N `serve` "
             "workers on one spool (work-stealing claims, crash "
             "restart with backoff budget, poisoned-beam quarantine, "
             "rolling restart)")
    sp.add_argument("--workers", type=int, default=None,
                    help="worker count (default: "
                         "jobpooler.fleet_workers; 0 = janitor/"
                         "aggregator only, for externally-launched "
                         "workers; with autoscaling this is the "
                         "INITIAL count, clamped into [min, max])")
    sp.add_argument("--autoscale", default="", metavar="MIN:MAX",
                    help="run the fleet elastic: scale workers "
                         "between MIN and MAX from journal-derived "
                         "signals (queue-wait SLO, backlog per "
                         "worker, advertised headroom) with "
                         "hysteresis + cooldown; scale-down drains "
                         "on-demand workers and SIGKILLs spot ones "
                         "(config: jobpooler.fleet_autoscale and the "
                         "autoscale_* knobs)")
    sp.add_argument("--spool", default=None,
                    help="spool dir (default: jobpooler.serve_spool "
                         "or <base_working_directory>/.serve_spool)")
    sp.add_argument("--queue", default="",
                    help="ticket-queue backend URL the whole fleet "
                         "claims from (sqlite:<path> / spool:<dir>); "
                         "default: TPULSAR_QUEUE_URL or the spool.  "
                         "Workers inherit it on their command line")
    sp.add_argument("--once", action="store_true",
                    help="exit 0 once the spool's tickets are all "
                         "terminal (CI / cron mode; workers run "
                         "serve --once)")
    sp.add_argument("--status", action="store_true",
                    help="print fleet health (heartbeats, spool "
                         "counts, fleet.json) and exit")
    sp.add_argument("--drain", action="store_true",
                    help="ask the running controller to drain the "
                         "fleet and exit")
    sp.add_argument("--rolling-restart", action="store_true",
                    dest="rolling_restart",
                    help="ask the running controller to cycle "
                         "workers one at a time (never fully cold)")
    sp.add_argument("--max-restarts", type=int, default=5,
                    help="crash-restart budget per worker before the "
                         "controller leaves it down")
    sp.add_argument("--worker-arg", action="append", default=[],
                    metavar="ARG",
                    help="extra argument passed to every `serve` "
                         "worker (repeatable), e.g. "
                         "--worker-arg=--no-warmstart; the workers "
                         "run on the card unless given "
                         "--worker-arg --device --worker-arg cpu")
    sp.set_defaults(fn=cmd_fleet)

    sp = sub.add_parser(
        "doctor",
        help="health doctor: with no flags, probe the NODE (imports, "
             "config, directories, job tracker, queue manager, "
             "CUDA device, build state); with --spool/--queue/"
             "--watch, judge the FLEET against the declarative alert pack (SLO burn "
             "rate, worker flap, quarantine, fsck, ...) — rc 0 "
             "healthy / 1 firing")
    sp.add_argument("--device-timeout", type=float, default=60.0,
                    help="device probe timeout, seconds")
    sp.add_argument("--spool", default="",
                    help="fleet mode: evaluate the alert rules over "
                         "this spool's journal + metric snapshots")
    sp.add_argument("--queue", default="",
                    help="fleet mode: route reads through this "
                         "ticket-queue backend URL ('sqlite' expands "
                         "to sqlite:<spool>/queue.db)")
    sp.add_argument("--rules", default="",
                    help="JSON alert-rules file extending/replacing "
                         "the built-in pack (default: "
                         "TPULSAR_ALERT_RULES)")
    sp.add_argument("--watch", action="store_true",
                    help="host a resident detector loop: journal "
                         "alert transitions, persist alerts.json, "
                         "notify via TPULSAR_ALERT_NOTIFY")
    sp.add_argument("--interval", type=float, default=0.0,
                    help="--watch tick period seconds (default: "
                         "TPULSAR_ALERT_INTERVAL_S)")
    sp.set_defaults(fn=cmd_doctor)

    sp = sub.add_parser(
        "gateway",
        help="network front door: HTTP beam submission + status "
             "streaming + candidate query API over a ticket queue — "
             "or a federation router over member gateways "
             "(--federate / frontdoor.federate)")
    sp.add_argument("--host", default=None,
                    help="bind address (default: "
                         "frontdoor.gateway_host)")
    sp.add_argument("--port", type=int, default=None,
                    help="bind port (default: frontdoor.gateway_port;"
                         " 0 = ephemeral, printed at boot)")
    sp.add_argument("--spool", "--queue", dest="queue", default=None,
                    help="ticket queue: a spool dir (default: the "
                         "serve spool), sqlite:<path> or "
                         "memory:<name>")
    sp.add_argument("--federate", default=None, metavar="N=URL,...",
                    help="run as a federation ROUTER over these "
                         "member gateways instead of fronting a "
                         "local queue")
    sp.add_argument("--outdir-base", default=None,
                    help="results dir root for submissions that "
                         "name no outdir (default: "
                         "<base_results_directory>/gateway)")
    sp.add_argument("--blob-root", default=None,
                    help="mount the content-addressed blob store at "
                         "this directory (default: TPULSAR_BLOB_ROOT "
                         "or <spool>/blobs; router mode proxies and "
                         "never stores)")
    sp.add_argument("--token", default=None,
                    help="shared-secret bearer token required on "
                         "mutating routes (default: "
                         "TPULSAR_GATEWAY_TOKEN; empty = open)")
    sp.set_defaults(fn=cmd_gateway)

    sp = sub.add_parser(
        "submit",
        help="submit a beam over HTTP to a front-door gateway")
    sp.add_argument("files", nargs="+", help="beam data files")
    sp.add_argument("--gateway", default="http://127.0.0.1:8970",
                    metavar="URL")
    sp.add_argument("--outdir", default=None,
                    help="results dir (default: gateway derives one)")
    sp.add_argument("--tenant", default="")
    sp.add_argument("--priority", default=None,
                    help="low|normal|high or an integer (capped at "
                         "the tenant's class)")
    sp.add_argument("--job-id", type=int, default=None)
    sp.add_argument("--wait", action="store_true",
                    help="poll until the terminal result and exit "
                         "by its status")
    sp.add_argument("--timeout", type=float, default=600.0,
                    help="--wait timeout seconds")
    sp.add_argument("--retries", type=int, default=0,
                    help="resubmit after a retryable 429 refusal up "
                         "to N times, sleeping the gateway's "
                         "jittered Retry-After hint between tries")
    sp.set_defaults(fn=cmd_submit)

    sp = sub.add_parser(
        "queue",
        help="ticket-queue maintenance: fsck runs the backend's "
             "integrity audit (sqlite PRAGMA integrity_check + WAL "
             "checkpoint, spool orphan-sidefile sweep) and prints "
             "per-state counts; exit 1 on findings")
    qsub = sp.add_subparsers(dest="queue_cmd", required=True)
    qp = qsub.add_parser(
        "fsck", help="audit a queue backend's on-disk state")
    qp.add_argument("url",
                    help="queue URL: sqlite:<path>, spool:<dir>, or "
                         "a bare spool directory path")
    qp.set_defaults(fn=cmd_queue)

    sp = sub.add_parser(
        "blob",
        help="content-addressed artifact store: put/get blobs by "
             "sha256 (local --root or a gateway --url, verified "
             "both ends), gc unreferenced objects, print stats")
    bsub = sp.add_subparsers(dest="blob_cmd", required=True)

    def _blob_common(bp):
        bp.add_argument("--root", default="",
                        help="local store dir (default: "
                             "TPULSAR_BLOB_ROOT or <spool>/blobs)")
        bp.add_argument("--url", default="",
                        help="gateway base URL — route through its "
                             "/v1/blobs/<digest> API instead of a "
                             "local store (default: "
                             "TPULSAR_DATA_URL)")
        bp.add_argument("--token", default="",
                        help="bearer token for --url puts (default: "
                             "TPULSAR_GATEWAY_TOKEN)")

    bp = bsub.add_parser("put", help="ingest files; print "
                                     "'<sha256>  <path>' per file")
    bp.add_argument("files", nargs="+")
    bp.add_argument("--ref", default="",
                    help="also pin a named reference on each blob "
                         "(local store only; gc keeps referenced "
                         "objects)")
    _blob_common(bp)
    bp.set_defaults(fn=cmd_blob)
    bp = bsub.add_parser("get", help="fetch one blob, verified "
                                     "against its digest")
    bp.add_argument("digest")
    bp.add_argument("--out", default="",
                    help="destination path (default: the digest's "
                         "first 12 hex chars in the cwd)")
    _blob_common(bp)
    bp.set_defaults(fn=cmd_blob)
    bp = bsub.add_parser(
        "gc", help="drop unreferenced objects older than --ttl and "
                   "orphaned ingest temps (local store only)")
    bp.add_argument("--ttl", type=float, default=7 * 86400.0,
                    help="age floor in seconds before an "
                         "unreferenced object is collected")
    _blob_common(bp)
    bp.set_defaults(fn=cmd_blob)
    bp = bsub.add_parser("stats", help="object/byte counts")
    _blob_common(bp)
    bp.set_defaults(fn=cmd_blob)

    sp = sub.add_parser(
        "index",
        help="persistent candidate index: rebuild from the done "
             "outdirs' parse, fsck the sqlite file, or query "
             "candidates without touching any outdir")
    isub = sp.add_subparsers(dest="index_cmd", required=True)

    def _index_common(ip):
        ip.add_argument("--spool", default=None,
                        help="spool dir (default: the serve spool); "
                             "the index lives at "
                             "<spool>/candidates.db")
        ip.add_argument("--queue", default="",
                        help="route reads through this ticket-queue "
                             "backend URL ('sqlite' expands to "
                             "sqlite:<spool>/queue.db)")

    ip = isub.add_parser(
        "rebuild", help="re-derive every row from the done outdirs "
                        "(outdirs are the source of truth; the "
                        "index is only their cache)")
    _index_common(ip)
    ip.set_defaults(fn=cmd_index)
    ip = isub.add_parser("fsck", help="integrity-check + WAL "
                                      "checkpoint; exit 1 on damage")
    _index_common(ip)
    ip.set_defaults(fn=cmd_index)
    ip = isub.add_parser(
        "query", help="the indexed /v1/candidates answer, from the "
                      "CLI")
    ip.add_argument("--ticket", default="",
                    help="restrict to one ticket id")
    ip.add_argument("--min-sigma", type=float, default=0.0)
    ip.add_argument("--limit", type=int, default=200)
    _index_common(ip)
    ip.set_defaults(fn=cmd_index)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.config:
        # load-and-validate now, and export for worker subprocesses
        from tpulsar_torch.config import load_config, set_settings

        os.environ["TPULSAR_CONFIG"] = os.path.abspath(args.config)
        set_settings(load_config(args.config))
    debugflags.apply_cli_flags(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
