"""Fleet placement: which service owns which tenant.

Pure and torch-free — the controller composes these with live services;
the tests exercise them with nothing but dicts. Placement is weighted
occupancy: every admitted tenant costs its SLO class's weight
(premium 4 / standard 2 / bulk 1 — the same priority order the wave
scheduler uses, serve/slo.py), and a new tenant lands on the service
carrying the least weight of its OWN class first, total weight second
(ties break on service name, so placement is deterministic for the
parity gates). Balancing within the class before balancing the totals
is what keeps two premium tenants off one service while bulk piles up
on the other — occupancy AND SLO class, per the fleet contract.

This module also hosts ``FLEET_COUNTERS``, the fleet plane's counter
table (a registry-backed dict shim like ``TENANCY_COUNTERS``), because
it is the one fleet module everything else may import without cycles.

Port note: a copy of ``openr_tpu/fleet/placement.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from openr_tpu_torch.telemetry import get_registry as _get_registry

# weighted occupancy cost per SLO class (mirrors serve/slo.py priority
# order: heavier classes claim more of a service's budget)
SLO_WEIGHT: Dict[str, int] = {"premium": 4, "standard": 2, "bulk": 1}

FLEET_COUNTERS = _get_registry().counter_dict(
    [
        "placements",          # tenants admitted through the policy
        "migrations",          # sealed live migrations (A -> B warm)
        "migration_aborts",    # import failed; tenant stayed on A
        "promotions",          # standby promoted to primary
        "promotion_deletes",   # route deletes across ALL promotions (gate: 0)
        "promotion_unshipped", # journal records surrendered by a crash
        #                        promotion (rung 2) — the hazard rule's
        #                        conscious-loss counter, never silent
        "failovers_detected",  # dead primaries found by maybe_failover
        "client_redirects",    # moved_to redirects served to clients
        "journal_stream_errors",  # standby ship attempts that failed
        "journal_records",     # records appended across all journals
    ],
    prefix="fleet.",
)


class FleetAdmissionError(RuntimeError):
    """No service can take the tenant (every candidate at capacity)."""


class ServiceLoad:
    """One service's placement-table row: its admitted tenants by SLO
    class, a tenant-count capacity, and the weighted occupancy the
    policy ranks on."""

    __slots__ = ("name", "capacity", "tenants")

    def __init__(self, name: str, capacity: int = 64):
        self.name = name
        self.capacity = capacity
        self.tenants: Dict[str, str] = {}  # tenant_id -> slo class

    def weight(self) -> int:
        return sum(SLO_WEIGHT.get(s, 2) for s in self.tenants.values())

    def class_count(self, slo: str) -> int:
        return sum(1 for s in self.tenants.values() if s == slo)

    def admit(self, tenant_id: str, slo: str) -> None:
        self.tenants[tenant_id] = slo

    def evict(self, tenant_id: str) -> Optional[str]:
        return self.tenants.pop(tenant_id, None)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"ServiceLoad({self.name!r}, tenants={len(self.tenants)}, "
            f"weight={self.weight()})"
        )


class PlacementPolicy:
    """Deterministic weighted-occupancy placement with per-class
    balancing (see module docstring for the ranking rule)."""

    def choose(
        self,
        services: Sequence[ServiceLoad],
        slo: str = "standard",
        exclude: Sequence[str] = (),
    ) -> ServiceLoad:
        if slo not in SLO_WEIGHT:
            raise ValueError(f"unknown SLO class: {slo!r}")
        skip = set(exclude)
        candidates = [
            s for s in services
            if s.name not in skip and len(s.tenants) < s.capacity
        ]
        if not candidates:
            raise FleetAdmissionError(
                f"no service can admit slo={slo!r} "
                f"(fleet of {len(services)}, excluded {sorted(skip)})"
            )
        return min(
            candidates,
            key=lambda s: (s.class_count(slo), s.weight(), s.name),
        )

    def place(
        self,
        services: Sequence[ServiceLoad],
        tenant_id: str,
        slo: str = "standard",
        exclude: Sequence[str] = (),
    ) -> ServiceLoad:
        """Choose and record: the returned service already carries the
        tenant in its row. Counted ``fleet.placements``."""
        svc = self.choose(services, slo, exclude=exclude)
        svc.admit(tenant_id, slo)
        FLEET_COUNTERS["placements"] += 1
        return svc


def placement_table(services: Sequence[ServiceLoad]) -> Dict[str, Dict]:
    """The fleet's placement table, jsonable — what ``fleet_services``
    serves to breeze/ops tooling."""
    return {
        s.name: {
            "tenants": dict(sorted(s.tenants.items())),
            "weight": s.weight(),
            "capacity": s.capacity,
        }
        for s in services
    }
