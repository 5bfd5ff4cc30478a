"""The operator CLI — counterpart of tpulsar/cli/main.py.

    python -m tpulsar_torch [--config PATH] serve [options]

Subcommands so far:

  serve — the resident search server (serve/server.py): one
          device-owning process drains the spool admission queue,
          paying process start, kernel build and device set-up once
          per boot instead of once per beam (``--batch N`` searches
          up to N compatible beams as one coalesced group;
          ``--stream`` claims stream session tickets instead and
          runs them through the streaming plane, stream/).  It takes
          the JAX package's ``tpulsar serve`` flags plus ``--device`` (cuda,
          the default, or cpu; without a GPU it fails unless
          ``--device cpu`` is given).

The per-beam job keeps its own entry point,
``python -m tpulsar_torch.cli.search_job``.  The JAX CLI's other
subcommands (downloader, jobpool, uploader, fleet, gateway, ...)
are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys


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
    except (RuntimeError, NotImplementedError) as e:
        # no GPU without --device cpu, or an option of a later slice:
        # refused before anything is claimed
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpulsar_torch",
                                description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, metavar="PATH",
                   help="config file (python or YAML); exported as "
                        "TPULSAR_CONFIG so worker subprocesses load "
                        "the same settings")
    sub = p.add_subparsers(dest="cmd", required=True)

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
                         "memory:; sqlite: is not ported yet); "
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.config:
        # load-and-validate now, and export for worker subprocesses
        from tpulsar_torch.config import load_config, set_settings

        os.environ["TPULSAR_CONFIG"] = os.path.abspath(args.config)
        set_settings(load_config(args.config))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
