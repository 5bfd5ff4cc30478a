"""The port's elastic autoscaler (tpulsar_torch/fleet/autoscale.py)
and the config and controller surfaces around it, against the JAX
package's: the decision, ledger, restart-budget, heartbeat-window and
trail cases of tests/test_autoscale.py run on both packages;
Autoscaler.decide gives the same Decision on the same seeded Signals
sequences in both; journal_scale_event writes the same evidence; and
both configurations validate and map the autoscale knobs alike.

Every comparison is exact.  The cases of tests/test_autoscale.py
that read the chaos harness (the scaling_bounded / no_elastic_strike
invariants, the scenario schema for surges and flaps) run on each
package's chaos verifier and scenario; its elastic end-to-end case
runs the port's stub worker (``python -m tpulsar_torch.chaos.worker``)
under each package's controller and is marked slow, as there."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_autoscale as jcases  # noqa: E402
import tpulsar.chaos  # noqa: E402
from test_torch_fleet import PORT_STUB  # noqa: E402
from tpulsar.chaos import invariants as jinvariants  # noqa: E402
from tpulsar.config import core as jcore  # noqa: E402
from tpulsar.fleet import autoscale as jautoscale  # noqa: E402
from tpulsar.fleet import controller as jctl  # noqa: E402
from tpulsar.obs import journal as jjournal  # noqa: E402
from tpulsar.serve import protocol as jprotocol  # noqa: E402
from tpulsar_torch.chaos import invariants as tinvariants  # noqa: E402
from tpulsar_torch.chaos import scenario as tscenario  # noqa: E402
from tpulsar_torch.config import core as tcore  # noqa: E402
from tpulsar_torch.fleet import autoscale as tautoscale  # noqa: E402
from tpulsar_torch.fleet import controller as tctl  # noqa: E402
from tpulsar_torch.obs import journal as tjournal  # noqa: E402
from tpulsar_torch.serve import protocol as tprotocol  # noqa: E402

PACKAGES = {
    "jax": dict(autoscale=jautoscale, fleet_ctl=jctl, journal=jjournal,
                protocol=jprotocol, invariants=jinvariants),
    "torch": dict(autoscale=tautoscale, fleet_ctl=tctl,
                  journal=tjournal, protocol=tprotocol,
                  invariants=tinvariants),
}
CORES = {"jax": jcore, "torch": tcore}


@pytest.fixture(autouse=True)
def _heartbeat_knob_reset():
    yield
    jprotocol.set_heartbeat_max_age(None)
    tprotocol.set_heartbeat_max_age(None)
    os.environ.pop("TPULSAR_HEARTBEAT_MAX_AGE_S", None)


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request, monkeypatch):
    """The package under test: tests/test_autoscale.py's module
    globals pointed at its autoscale, controller, journal, protocol
    and chaos verifier (and the scenario module its cases import
    inside their bodies); the stub worker is the port's."""
    for name, mod in PACKAGES[request.param].items():
        monkeypatch.setattr(jcases, name, mod)
    monkeypatch.setattr(jcases, "_STUB_ARGV", PORT_STUB)
    if request.param == "torch":
        monkeypatch.setattr(tpulsar.chaos, "scenario", tscenario)
    return request.param


@pytest.mark.parametrize("case", [
    "test_scale_up_proportional_to_backlog_and_clamped",
    "test_scale_up_on_starving_oldest_waiter",
    "test_scale_up_on_recent_p95_breach",
    "test_scale_up_on_exhausted_advertised_headroom",
    "test_victim_selection_spares_base_slots",
    "test_cooldown_suppresses_consecutive_actions",
    "test_scale_down_needs_sustained_idle_window",
    "test_scale_down_blocked_by_floor_and_high_p95",
    "test_oldest_pending_wait_from_mtimes",
    "test_signals_tail_recent_queue_waits",
    "test_elective_kill_requeues_attempt_neutral",
    "test_unledgered_dead_owner_still_strikes",
    "test_recycled_pid_in_other_slot_still_strikes",
    "test_ledger_prunes_stale_entries",
    "test_claim_carries_worker_class",
    "test_restart_budget_decays_after_healthy_uptime",
    "test_restart_budget_still_caps_crash_loops",
    "test_restart_decay_disabled_with_zero_window",
    "test_decision_trail_renders",
    "test_scaling_bounded_passes_clean_history",
    "test_scaling_bounded_flags_band_and_arithmetic",
    "test_scaling_bounded_flags_cooldown_thrash",
    "test_no_elastic_strike_flags_struck_victim",
])
def test_autoscale_case_on_both_packages(case, pkg, tmp_path):
    """Each case of tests/test_autoscale.py, unchanged, on the
    package's autoscaler, controller and spool protocol."""
    getattr(jcases, case)(tmp_path)


def test_scenario_validates_surge_and_flap(pkg):
    jcases.test_scenario_validates_surge_and_flap()


@pytest.mark.slow
def test_controller_elastic_surge_and_lull_e2e(pkg, tmp_path):
    """The elastic end-to-end case: the package's controller scales a
    fleet of the port's stub workers up through a surge and down
    through the lull, zero strikes, its verifier clean."""
    jcases.test_controller_elastic_surge_and_lull_e2e(tmp_path)


@pytest.mark.parametrize("case", [
    "test_config_validation_is_loud",
    "test_heartbeat_max_age_env_and_config_override",
    "test_hb_fresh_resolves_window_at_call_time",
])
def test_autoscale_knob_case_on_both_packages(case, pkg):
    getattr(jcases, case)()


def test_default_config_does_not_shadow_env_knob(pkg):
    """An untouched (120 s) configuration leaves the
    TPULSAR_HEARTBEAT_MAX_AGE_S knob alive; an explicit one wins."""
    core, protocol = CORES[pkg], PACKAGES[pkg]["protocol"]
    os.environ["TPULSAR_HEARTBEAT_MAX_AGE_S"] = "11.0"
    core._apply_runtime_knobs(core.TpulsarConfig())
    assert protocol.heartbeat_max_age() == 11.0
    cfg = core.TpulsarConfig()
    cfg.jobpooler.heartbeat_max_age_s = 90.0
    core._apply_runtime_knobs(cfg)
    assert protocol.heartbeat_max_age() == 90.0


def test_config_floor_validates_against_heartbeat_interval(pkg,
                                                           tmp_path):
    core = CORES[pkg]
    cfg = _cfg_in(core, tmp_path)
    cfg.jobpooler.heartbeat_max_age_s = 20.0       # < 3 x 10 s
    with pytest.raises(core.InsaneConfigsError,
                       match="heartbeat_max_age_s"):
        cfg.check_sanity(create_dirs=True)
    cfg.jobpooler.heartbeat_max_age_s = 30.0
    cfg.check_sanity(create_dirs=True)


def _cfg_in(core, tmp_path):
    cfg = core.TpulsarConfig()
    cfg.basic.log_dir = str(tmp_path / "logs")
    cfg.background.jobtracker_db = str(tmp_path / "jt.db")
    cfg.download.datadir = str(tmp_path / "raw")
    cfg.processing.base_working_directory = str(tmp_path / "work")
    cfg.processing.base_results_directory = str(tmp_path / "res")
    return cfg


def test_config_validates_autoscale_knobs(pkg, tmp_path):
    """check_sanity refuses inconsistent autoscale knobs, and
    fleet_autoscale_config maps them (None when autoscaling is off,
    built regardless with force=True)."""
    core = CORES[pkg]
    cfg = _cfg_in(core, tmp_path)
    cfg.jobpooler.fleet_autoscale = True
    cfg.jobpooler.fleet_max_workers = 0
    with pytest.raises(core.InsaneConfigsError, match="autoscale"):
        cfg.check_sanity(create_dirs=True)
    cfg.jobpooler.fleet_max_workers = 4
    cfg.check_sanity(create_dirs=True)
    assert cfg.fleet_autoscale_config().max_workers == 4
    cfg.jobpooler.fleet_autoscale = False
    assert cfg.fleet_autoscale_config() is None
    assert cfg.fleet_autoscale_config(force=True).worker_class == "spot"


def test_fleet_autoscale_config_equal_in_both_packages():
    jc, tc = jcore.TpulsarConfig(), tcore.TpulsarConfig()
    for c in (jc, tc):
        c.jobpooler.fleet_autoscale = True
        c.jobpooler.fleet_min_workers = 2
        c.jobpooler.fleet_max_workers = 5
        c.jobpooler.autoscale_cooldown_s = 12.5
    assert dataclasses.asdict(tc.fleet_autoscale_config()) == \
        dataclasses.asdict(jc.fleet_autoscale_config())


def _signal_runs(seed: int, n: int = 40) -> list[dict]:
    """A seeded sequence of signal readings a second apart: backlog
    surges, idle stretches, starving waiters, p95 breaches, shed and
    backpressured capacity."""
    rng = np.random.default_rng(seed)
    out, t, live = [], 1000.0, 1
    for _ in range(n):
        t += float(rng.uniform(0.5, 4.0))
        idle = rng.random() < 0.4
        out.append(dict(
            t=t, pending=0 if idle else int(rng.integers(0, 20)),
            claimed=0 if idle else int(rng.integers(0, 4)),
            live_workers=live, fresh_workers=live,
            capacity=(None if rng.random() < 0.1
                      else int(rng.integers(0, 9))),
            oldest_wait_s=0.0 if idle else float(rng.uniform(0, 15)),
            queue_wait_p95_s=(None if rng.random() < 0.3
                              else float(rng.uniform(0, 14))),
            tenant_backlog={"a": int(rng.integers(0, 5))}))
        live = int(rng.integers(1, 5))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decide_gives_the_same_decisions(seed, tmp_path):
    """Both packages' Autoscaler, fed the same Signals in lockstep
    (each decision noted as an action, as the controller does), make
    the same Decision at every step; the scale events they journal
    carry the same evidence."""
    cfg = dict(min_workers=1, max_workers=4, queue_wait_slo_s=10.0,
               backlog_per_worker=2.0, cooldown_s=5.0,
               idle_window_s=3.0, drain_deadline_s=1.0,
               worker_class="spot", slo_lookback_s=30.0)
    engines, specs = {}, {}
    for name, mod in (("jax", jautoscale), ("torch", tautoscale)):
        spool = PACKAGES[name]["protocol"].ensure_spool(
            str(tmp_path / name))
        specs[name] = mod.AutoscaleConfig(**cfg).validate()
        engines[name] = (mod, spool, mod.Autoscaler(specs[name], spool))
    decided = 0
    for kw in _signal_runs(seed):
        got = {}
        for name, (mod, spool, eng) in engines.items():
            d = eng.decide(mod.Signals(**kw))
            got[name] = None if d is None else dataclasses.asdict(d)
            if d is not None:
                mod.journal_scale_event(
                    spool, d, specs[name], kw["live_workers"],
                    kw["live_workers"] + (d.n if d.direction == "up"
                                          else -d.n))
                eng.note_action(kw["t"])
        assert got["torch"] == got["jax"], kw
        decided += got["torch"] is not None
    assert decided
    trails = {name: [{k: v for k, v in e.items() if k != "t"}
                     for e in mod.decision_trail(spool)]
              for name, (mod, spool, _) in engines.items()}
    assert trails["torch"] == trails["jax"] and trails["torch"]
    trail = jautoscale.decision_trail(engines["jax"][1])
    assert tautoscale.render_trail(trail) == \
        jautoscale.render_trail(trail)
