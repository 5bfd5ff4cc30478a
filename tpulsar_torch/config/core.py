"""Config domains and validation — counterpart of
tpulsar/config/core.py: the same domains, fields and defaults, so one
configuration file (TPULSAR_CONFIG) serves both packages.

Domains mirror the reference's nine config modules (lib/python/config/
{basic,background,commondb,download,email,jobpooler,processing,
searching,upload}_example.py) plus the front door; each field that had
a filesystem or type validator there has one here
(config_types.py:121-247), and all violations are reported together
(InsaneConfigsError, config_types.py:45-65).

The fleet autoscaler's knobs are checked through
fleet_autoscale_config, the front door's tenant policy
(frontdoor.tenants) is validated, and settings() installs the serve
heartbeat window (_apply_runtime_knobs), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from tpulsar_torch.frontdoor.tenancy import TenantPolicy
from tpulsar_torch.serve import protocol


class ConfigError(Exception):
    pass


class InsaneConfigsError(ConfigError):
    """All validation problems, consolidated."""

    def __init__(self, problems: list[str]):
        self.problems = problems
        super().__init__(
            "configuration failed validation:\n  - " + "\n  - ".join(problems))


# ------------------------------------------------------------------ domains

@dataclasses.dataclass
class BasicConfig:
    institution: str = "local"
    pipeline: str = "tpulsar"
    survey: str = "PALFA2.0"
    pipelinedir: str = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    log_dir: str = "/tmp/tpulsar_data/logs"
    coords_table: str = ""                 # optional WAPP coord fix table
    delete_rawdata: bool = False


@dataclasses.dataclass
class BackgroundConfig:
    screen_output: bool = True
    jobtracker_db: str = "/tmp/tpulsar_data/jobtracker.db"
    sleep: float = 60.0                    # daemon loop sleep seconds


@dataclasses.dataclass
class DownloadConfig:
    datadir: str = "/tmp/tpulsar_data/rawdata"
    space_to_use: int = 60 * 2 ** 30       # 60 GB quota
    min_free_space: int = 10 * 2 ** 30
    numdownloads: int = 2                  # concurrent transfers
    numrestores: int = 5                   # outstanding restore requests
    numretries: int = 3
    request_timeout_hours: float = 6.0
    api_service_url: str = ""              # restore service endpoint
    transport: str = "local"               # local | http
    request_numbits: int = 4
    request_datatype: str = "mock"


@dataclasses.dataclass
class ProcessingConfig:
    base_working_directory: str = "/tmp/tpulsar_data/work"
    base_results_directory: str = "/tmp/tpulsar_data/results"
    zaplistdir: str = ""
    default_zaplist: str = ""
    zaplist_url: str = ""   # remote custom-zaplist tarball location
    #                         (http(s) base URL or local dir); when
    #                         set, workers refresh zaplistdir before
    #                         searching (reference pipeline_utils.py:
    #                         191-219 FTP-modtime refresh)
    num_cores: int = 1
    use_subbands: bool = True


@dataclasses.dataclass
class JobPoolerConfig:
    queue_manager: str = "local"     # local | slurm | pbs | moab |
    #                                  tpu_slice | warm
    max_jobs_running: int = 2
    max_jobs_queued: int = 1
    max_attempts: int = 2
    submit_script: str = ""
    queue_name: str = ""
    walltime_per_gb: float = 50.0          # hours/GB heuristic (moab.py:14)
    tpu_hosts: str = ""                    # comma-separated, for tpu_slice
    tpu_launcher: str = "ssh {host} {cmd}"
    serve_spool: str = ""                  # warm backend spool dir; ""
    #                                        = <base_working_directory>/
    #                                        .serve_spool
    serve_queue_depth: int = 8             # per-worker admission-queue
    #                                        share (can_submit sums it
    #                                        over fresh workers)
    serve_max_attempts: int = 3            # crash-shaped claims before
    #                                        a beam is quarantined
    fleet_workers: int = 2                 # default `tpulsar fleet`
    #                                        worker count
    serve_heartbeat_interval_s: float = 10.0   # worker heartbeat
    #                                        cadence
    heartbeat_max_age_s: float = 120.0     # heartbeats older than
    #                                        this read stale (worker
    #                                        presumed gone); one knob
    #                                        for the whole stack —
    #                                        freshness, capacity,
    #                                        janitor grace, autoscaler
    #                                        reaction.  Floor-checked
    #                                        against the heartbeat
    #                                        interval.
    # --- elastic fleet (tpulsar/fleet/autoscale.py) ---
    fleet_autoscale: bool = False          # scale workers between
    #                                        min/max from journal
    #                                        signals
    fleet_min_workers: int = 1
    fleet_max_workers: int = 4
    autoscale_queue_wait_slo_s: float = 30.0   # scale-up SLO trigger
    autoscale_backlog_per_worker: float = 2.0  # pending/worker target
    autoscale_cooldown_s: float = 30.0     # min gap between actions
    autoscale_idle_window_s: float = 60.0  # sustained-low-load gate
    #                                        before scale-down
    autoscale_drain_deadline_s: float = 20.0   # drain grace before
    #                                        the SIGKILL escalation
    autoscale_worker_class: str = "spot"   # class of elastic workers
    #                                        (spot = SIGKILL routine)


@dataclasses.dataclass
class FrontdoorConfig:
    """The network front door (tpulsar/frontdoor/): HTTP gateway,
    tenant admission policy, federation membership."""
    gateway_host: str = "127.0.0.1"        # bind address; 0.0.0.0 to
    #                                        serve beyond localhost
    gateway_port: int = 8970
    #: tenant name -> {"priority": "low|normal|high"|int,
    #:                 "max_inflight": N, "max_pending": N}
    #: (0 = unlimited); unknown tenants get default_priority and no
    #: quotas.  Enforced in claim ordering (max_inflight) and at
    #: gateway admission (max_pending).
    tenants: dict = dataclasses.field(default_factory=dict)
    default_priority: str = "normal"
    #: comma-separated "name=url" member gateways; non-empty turns
    #: `tpulsar gateway` into a federation router over these hosts
    federate: str = ""
    #: cap on candidate rows per result-store query response
    results_query_limit: int = 200


@dataclasses.dataclass
class SearchingConfig:
    use_hi_accel: bool = True
    lo_accel_numharm: int = 16
    lo_accel_zmax: int = 0
    hi_accel_numharm: int = 8
    hi_accel_zmax: int = 50
    sifting_sigma_threshold: float = 4.0
    sifting_r_err: float = 1.1
    sifting_min_num_dms: int = 2
    sifting_low_dm_cutoff: float = 2.0
    to_prepfold_sigma: float = 6.0
    max_cands_to_fold: int = 100
    singlepulse_threshold: float = 5.0
    nsub: int = 96
    datatype: str = "mock"
    low_T_to_search: float = 0.0       # seconds; 0 = search everything
    dm_min: float = 0.0                # DM trial window, trimmed from
    dm_max: float = 0.0                # the plan at whole-pass
    #                                    granularity (DDplan2b's -l/-d
    #                                    range args); dm_max 0 = no cap


@dataclasses.dataclass
class EmailConfig:
    enabled: bool = False
    recipient: str = ""
    smtp_host: str = "localhost"
    smtp_port: int = 0
    smtp_username: str = ""
    smtp_password: str = ""
    use_ssl: bool = False
    use_tls: bool = False
    send_on_failures: bool = True
    send_on_terminal_failures: bool = True
    send_on_crash: bool = True


@dataclasses.dataclass
class ResultsDBConfig:
    """Replaces the reference's commondb (MSSQL) settings with a
    pluggable results database (database.py:15-37)."""
    url: str = "/tmp/tpulsar_data/results.db"   # sqlite path
    backend: str = "sqlite"


@dataclasses.dataclass
class UploadConfig:
    version_num_file: str = "version_number.txt"


@dataclasses.dataclass
class TpulsarConfig:
    basic: BasicConfig = dataclasses.field(default_factory=BasicConfig)
    background: BackgroundConfig = dataclasses.field(
        default_factory=BackgroundConfig)
    download: DownloadConfig = dataclasses.field(
        default_factory=DownloadConfig)
    processing: ProcessingConfig = dataclasses.field(
        default_factory=ProcessingConfig)
    jobpooler: JobPoolerConfig = dataclasses.field(
        default_factory=JobPoolerConfig)
    frontdoor: FrontdoorConfig = dataclasses.field(
        default_factory=FrontdoorConfig)
    searching: SearchingConfig = dataclasses.field(
        default_factory=SearchingConfig)
    email: EmailConfig = dataclasses.field(default_factory=EmailConfig)
    resultsdb: ResultsDBConfig = dataclasses.field(
        default_factory=ResultsDBConfig)
    upload: UploadConfig = dataclasses.field(default_factory=UploadConfig)

    # ------------------------------------------------------------ checking

    def check_sanity(self, create_dirs: bool = False) -> None:
        """Validate every domain; raise InsaneConfigsError listing all
        problems (reference semantics: config_types.py:45-65)."""
        problems: list[str] = []

        def check_dir(domain: str, field: str, path: str,
                      writable: bool = True):
            if not path:
                problems.append(f"{domain}.{field}: empty path")
                return
            if not os.path.isdir(path):
                if create_dirs:
                    try:
                        os.makedirs(path, exist_ok=True)
                    except OSError as e:
                        problems.append(
                            f"{domain}.{field}: cannot create {path}: {e}")
                        return
                else:
                    problems.append(f"{domain}.{field}: {path} is not a directory")
                    return
            if writable and not os.access(path, os.W_OK):
                problems.append(f"{domain}.{field}: {path} not writable")

        check_dir("basic", "log_dir", self.basic.log_dir)
        check_dir("download", "datadir", self.download.datadir)
        check_dir("processing", "base_working_directory",
                  self.processing.base_working_directory)
        check_dir("processing", "base_results_directory",
                  self.processing.base_results_directory)
        for parent, db in (("background", self.background.jobtracker_db),
                           ("resultsdb", self.resultsdb.url)):
            d = os.path.dirname(os.path.abspath(db))
            if not os.path.isdir(d):
                if create_dirs:
                    os.makedirs(d, exist_ok=True)
                else:
                    problems.append(f"{parent}: parent dir {d} missing")

        if self.download.numdownloads < 1:
            problems.append("download.numdownloads must be >= 1")
        if self.download.min_free_space > self.download.space_to_use:
            problems.append(
                "download.min_free_space exceeds download.space_to_use")
        if self.jobpooler.max_attempts < 1:
            problems.append("jobpooler.max_attempts must be >= 1")
        if self.jobpooler.queue_manager not in (
                "local", "slurm", "pbs", "moab", "tpu_slice", "warm"):
            problems.append(
                f"jobpooler.queue_manager unknown: "
                f"{self.jobpooler.queue_manager!r}")
        if self.jobpooler.serve_queue_depth < 1:
            problems.append("jobpooler.serve_queue_depth must be >= 1")
        if self.jobpooler.serve_max_attempts < 1:
            problems.append("jobpooler.serve_max_attempts must be >= 1")
        if self.jobpooler.fleet_workers < 1:
            problems.append("jobpooler.fleet_workers must be >= 1")
        if self.jobpooler.serve_heartbeat_interval_s <= 0:
            problems.append(
                "jobpooler.serve_heartbeat_interval_s must be "
                "positive")
        elif self.jobpooler.heartbeat_max_age_s \
                < 3 * self.jobpooler.serve_heartbeat_interval_s:
            # the floor: a staleness window under ~3 heartbeats
            # would declare healthy workers dead on one missed beat
            problems.append(
                f"jobpooler.heartbeat_max_age_s "
                f"({self.jobpooler.heartbeat_max_age_s:g}) must be "
                f">= 3 x serve_heartbeat_interval_s "
                f"({self.jobpooler.serve_heartbeat_interval_s:g})")
        try:
            self.fleet_autoscale_config()
        except ValueError as e:
            problems.append(f"jobpooler autoscale: {e}")
        if (self.jobpooler.queue_manager == "tpu_slice"
                and not self.jobpooler.tpu_hosts.strip()):
            problems.append(
                "jobpooler.queue_manager='tpu_slice' requires "
                "jobpooler.tpu_hosts (comma-separated host list)")
        if (self.jobpooler.queue_manager in ("slurm", "pbs", "moab")
                and not self.jobpooler.submit_script):
            problems.append(
                f"jobpooler.queue_manager="
                f"{self.jobpooler.queue_manager!r} requires "
                f"jobpooler.submit_script")
        if self.download.transport not in ("local", "http"):
            problems.append(
                f"download.transport unknown: "
                f"{self.download.transport!r}")
        if self.email.enabled and not self.email.recipient:
            problems.append("email.enabled but email.recipient empty")
        if self.searching.nsub < 1:
            problems.append("searching.nsub must be >= 1")
        if not (0 <= self.frontdoor.gateway_port <= 65535):
            problems.append("frontdoor.gateway_port out of range")
        if self.frontdoor.results_query_limit < 1:
            problems.append(
                "frontdoor.results_query_limit must be >= 1")
        try:
            TenantPolicy(self.frontdoor.tenants,
                         self.frontdoor.default_priority)
        except ValueError as e:
            problems.append(f"frontdoor.tenants: {e}")

        if problems:
            raise InsaneConfigsError(problems)

    def fleet_autoscale_config(self, force: bool = False):
        """The jobpooler autoscale knobs as a validated
        fleet.autoscale.AutoscaleConfig (None when autoscaling is
        off; ``force=True`` builds it regardless — the CLI's
        ``--autoscale MIN:MAX`` path, so the knob->config mapping
        lives in exactly one place).  Raises ValueError on
        inconsistent knobs — called from check_sanity so a bad
        elastic config fails at load, not at the first scale
        decision."""
        jp = self.jobpooler
        if not jp.fleet_autoscale and not force:
            return None
        from tpulsar_torch.fleet.autoscale import AutoscaleConfig
        return AutoscaleConfig(
            min_workers=jp.fleet_min_workers,
            max_workers=jp.fleet_max_workers,
            queue_wait_slo_s=jp.autoscale_queue_wait_slo_s,
            backlog_per_worker=jp.autoscale_backlog_per_worker,
            cooldown_s=jp.autoscale_cooldown_s,
            idle_window_s=jp.autoscale_idle_window_s,
            drain_deadline_s=jp.autoscale_drain_deadline_s,
            worker_class=jp.autoscale_worker_class).validate()

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# ------------------------------------------------------------------ loading

_SETTINGS: TpulsarConfig | None = None


def load_config(path: str | None = None, create_dirs: bool = True
                ) -> TpulsarConfig:
    """Load configuration from a python file defining domain dicts
    (e.g. ``download = {"numdownloads": 3}``), a YAML file, or use
    defaults when path is None.  Validates before returning."""
    cfg = TpulsarConfig()
    if path:
        overrides: dict[str, Any]
        if path.endswith((".yml", ".yaml")):
            import yaml
            with open(path) as fh:
                overrides = yaml.safe_load(fh) or {}
        else:
            ns: dict[str, Any] = {}
            with open(path) as fh:
                exec(compile(fh.read(), path, "exec"), {}, ns)
            overrides = {k: v for k, v in ns.items()
                         if not k.startswith("_") and isinstance(v, dict)}
        for domain, values in overrides.items():
            if not hasattr(cfg, domain):
                raise ConfigError(f"unknown config domain {domain!r}")
            dom = getattr(cfg, domain)
            for k, v in values.items():
                if not hasattr(dom, k):
                    raise ConfigError(f"unknown setting {domain}.{k}")
                setattr(dom, k, v)
    cfg.check_sanity(create_dirs=create_dirs)
    return cfg


def _apply_runtime_knobs(cfg: TpulsarConfig) -> None:
    """Propagate config fields that back module-level runtime knobs
    (today: the heartbeat staleness window every serve freshness
    judgment resolves through)."""
    v = cfg.jobpooler.heartbeat_max_age_s
    # a DEFAULT-valued config must not install an override: doing so
    # would shadow the TPULSAR_HEARTBEAT_MAX_AGE_S env var in every
    # process — only an explicitly non-default value wins over env
    try:
        protocol.set_heartbeat_max_age(
            v if v != protocol.HEARTBEAT_MAX_AGE_S else None)
    except ValueError:
        pass


def settings() -> TpulsarConfig:
    """Process-global settings (lazy default)."""
    global _SETTINGS
    if _SETTINGS is None:
        _SETTINGS = load_config(os.environ.get("TPULSAR_CONFIG"))
        _apply_runtime_knobs(_SETTINGS)
    return _SETTINGS


def set_settings(cfg: TpulsarConfig | None) -> None:
    """Install cfg as the process-global settings (None: load them
    again from TPULSAR_CONFIG at the next settings() call)."""
    global _SETTINGS
    _SETTINGS = cfg
    if cfg is not None:
        _apply_runtime_knobs(cfg)
