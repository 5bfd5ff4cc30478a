"""Per-tenant priority classes and quotas, enforced in claim ordering
— counterpart of tpulsar/frontdoor/tenancy.py (a copy).

One shared spool serving many submitters needs admission fairness:
without it, a tenant that dumps 10k bulk beams starves everyone
else's interactive work for hours (plain FIFO), and a tenant with a
runaway submitter monopolises every worker.  This module is the
policy the claim path consults:

  * every ticket carries a ``tenant`` (default ``"default"``) and the
    numeric ``priority`` its tenant's class resolves to;
  * ``claim_order`` replaces FIFO with (priority desc, submitted_at)
    — higher-priority tenants' beams are claimed first, FIFO within
    a class;
  * a tenant at its ``max_inflight`` quota has its pending tickets
    SKIPPED (deferred, not dropped): they stay queued and become
    eligible the moment one of its in-flight beams finishes.  Quota
    never blocks anyone else — the scan just moves on to the next
    eligible ticket, so a low-priority tenant at quota cannot delay a
    high-priority tenant's claim even by one beam;
  * ``admit`` is the gateway-side check: a tenant past its
    ``max_pending`` submission quota is refused at the front door
    (HTTP 429) instead of flooding the spool.

The policy is enforced where claims happen (every TicketQueue
backend's ``claim_next``), not where tickets are written — a client
that bypasses the gateway and writes tickets straight into the spool
still cannot jump its class or exceed its in-flight quota.

stdlib only.
"""

from __future__ import annotations

import dataclasses

from tpulsar_torch.obs import telemetry

#: the named priority classes tickets and config may use (larger =
#: claimed first); integers are accepted anywhere a name is
PRIORITY_CLASSES = {"low": 0, "normal": 10, "high": 20}

DEFAULT_TENANT = "default"


def resolve_priority(value, default: int = PRIORITY_CLASSES["normal"]
                     ) -> int:
    """A priority class name or bare integer -> numeric priority."""
    if value is None or value == "":
        return default
    if isinstance(value, bool):
        return default
    if isinstance(value, (int, float)):
        return int(value)
    try:
        return PRIORITY_CLASSES[str(value).strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown priority class {value!r} (known: "
            f"{', '.join(PRIORITY_CLASSES)}, or an integer)") from None


@dataclasses.dataclass
class TenantSpec:
    """One tenant's admission contract.  ``max_inflight`` bounds
    concurrently CLAIMED beams (enforced in claim ordering);
    ``max_pending`` bounds beams waiting in the queue (enforced at
    gateway admission).  0 = unlimited."""
    priority: int = PRIORITY_CLASSES["normal"]
    max_inflight: int = 0
    max_pending: int = 0


class TenantPolicy:
    """The parsed tenant table.  ``tenants`` maps tenant name ->
    ``{"priority": "high"|int, "max_inflight": N, "max_pending": N}``
    (the shape of config ``frontdoor.tenants``); unknown tenants get
    a default spec at ``default_priority``."""

    def __init__(self, tenants: dict | None = None,
                 default_priority="normal"):
        self.default_priority = resolve_priority(default_priority)
        self.tenants: dict[str, TenantSpec] = {}
        for name, spec in (tenants or {}).items():
            if not isinstance(spec, dict):
                raise ValueError(
                    f"tenant {name!r}: spec must be a dict, got "
                    f"{type(spec).__name__}")
            unknown = set(spec) - {"priority", "max_inflight",
                                   "max_pending"}
            if unknown:
                raise ValueError(
                    f"tenant {name!r}: unknown key(s) "
                    f"{sorted(unknown)}")
            self.tenants[str(name)] = TenantSpec(
                priority=resolve_priority(spec.get("priority"),
                                          self.default_priority),
                max_inflight=int(spec.get("max_inflight", 0)),
                max_pending=int(spec.get("max_pending", 0)))

    @property
    def is_trivial(self) -> bool:
        """True when the policy cannot change anything: no tenants
        configured means every ticket shares one class and no quota
        exists, so claim ordering is plain FIFO — backends skip the
        per-pending-record parse entirely.  (Consequence: ticket-
        level ``priority`` requests only take effect once at least
        one tenant is configured.)"""
        return not self.tenants

    @classmethod
    def from_config(cls, cfg=None) -> "TenantPolicy":
        if cfg is None:
            from tpulsar_torch.config import settings
            cfg = settings()
        fd = getattr(cfg, "frontdoor", None)
        if fd is None:
            return cls()
        return cls(fd.tenants, fd.default_priority)

    def spec(self, tenant: str) -> TenantSpec:
        return self.tenants.get(tenant or DEFAULT_TENANT,
                                TenantSpec(self.default_priority))

    def priority_of(self, rec: dict) -> int:
        """A ticket's effective priority: its tenant's class, capped
        above by it — a ticket may ask for LESS urgency than its
        tenant's class grants, never more (the ticket-level field is
        a politeness knob, not an escalation path)."""
        tenant_prio = self.spec(rec.get("tenant", "")).priority
        asked = rec.get("priority")
        if asked in (None, ""):
            return tenant_prio
        try:
            return min(tenant_prio, resolve_priority(asked))
        except ValueError:
            return tenant_prio

    # -------------------------------------------------------- claim side

    def claim_order(self, pending: list[dict],
                    inflight_by_tenant: dict[str, int]) -> list[str]:
        """The ticket ids a claimer should attempt, in order:
        quota-eligible tickets sorted by (priority desc, submitted_at,
        ticket id).  Tickets of tenants at their ``max_inflight`` are
        deferred (skipped, left queued).  ``pending`` is the parsed
        incoming records; ``inflight_by_tenant`` counts currently
        claimed beams per tenant."""
        eligible: list[tuple] = []
        deferred: dict[str, int] = {}
        # budget the scan: a tenant's quota headroom is consumed by
        # its own earlier (higher-ranked) pending tickets too, so one
        # claim pass cannot hand N workers N beams of a tenant whose
        # quota allows only one more
        ranked = sorted(
            pending,
            key=lambda r: (-self.priority_of(r),
                           r.get("submitted_at", 0.0),
                           str(r.get("ticket", ""))))
        headroom: dict[str, int] = {}
        for rec in ranked:
            tenant = rec.get("tenant", "") or DEFAULT_TENANT
            cap = self.spec(tenant).max_inflight
            if cap > 0:
                left = headroom.setdefault(
                    tenant, cap - int(inflight_by_tenant.get(tenant,
                                                             0)))
                if left <= 0:
                    deferred[tenant] = deferred.get(tenant, 0) + 1
                    continue
                headroom[tenant] = left - 1
            eligible.append(str(rec.get("ticket", "")))
        for tenant, n in deferred.items():
            telemetry.frontdoor_quota_deferred().set(n, tenant=tenant)
        for tenant in self.tenants:
            if tenant not in deferred:
                telemetry.frontdoor_quota_deferred().set(0,
                                                         tenant=tenant)
        return eligible

    # ------------------------------------------------------ gateway side

    def admit(self, tenant: str,
              pending_by_tenant: dict[str, int]
              ) -> tuple[bool, str]:
        """Gateway-side submission quota: (admitted, reason).  A
        tenant past ``max_pending`` is refused at the edge — its
        backlog must drain before it may queue more."""
        cap = self.spec(tenant).max_pending
        if cap > 0 and int(pending_by_tenant.get(
                tenant or DEFAULT_TENANT, 0)) >= cap:
            return False, (f"tenant {tenant or DEFAULT_TENANT!r} at "
                           f"max_pending quota ({cap})")
        return True, ""
