"""Internal RIB representation and route-delta computation.

Port note: a copy of ``openr_tpu/decision/rib.py`` without the
thread-confinement lint marker.

Behavioral parity with the reference ``openr/decision/RibEntry.h``,
``openr/decision/RouteUpdate.h`` and ``DecisionRouteDb``
(openr/decision/Decision.cpp:112 calculateUpdate / :146 update).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set

from openr_tpu_torch.types import (
    IpPrefix,
    MplsRoute,
    NextHop,
    PerfEvents,
    PrefixEntry,
    PrefixType,
    RouteDatabase,
    RouteDatabaseDelta,
    UnicastRoute,
)


@dataclass
class RibUnicastEntry:
    """reference: openr/decision/RibEntry.h:37 RibUnicastEntry"""

    prefix: IpPrefix
    nexthops: Set[NextHop] = field(default_factory=set)
    best_prefix_entry: Optional[PrefixEntry] = None
    best_area: str = ""
    do_not_install: bool = False

    def __eq__(self, other) -> bool:
        # equality drives delta computation; best_area intentionally NOT
        # compared (matches reference RibUnicastEntry::operator==)
        return (
            isinstance(other, RibUnicastEntry)
            and self.prefix == other.prefix
            and self.best_prefix_entry == other.best_prefix_entry
            and self.do_not_install == other.do_not_install
            and self.nexthops == other.nexthops
        )

    def to_unicast_route(self) -> UnicastRoute:
        prefix_type = None
        data = None
        if (
            self.best_prefix_entry is not None
            and self.best_prefix_entry.type == PrefixType.BGP
        ):
            prefix_type = PrefixType.BGP
            data = self.best_prefix_entry.data
        return UnicastRoute(
            dest=self.prefix,
            next_hops=tuple(self.nexthops),
            do_not_install=self.do_not_install,
            prefix_type=prefix_type,
            data=data,
        )


@dataclass
class RibMplsEntry:
    """reference: openr/decision/RibEntry.h:93 RibMplsEntry"""

    label: int
    nexthops: Set[NextHop] = field(default_factory=set)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RibMplsEntry)
            and self.label == other.label
            and self.nexthops == other.nexthops
        )

    def to_mpls_route(self) -> MplsRoute:
        return MplsRoute(top_label=self.label, next_hops=tuple(self.nexthops))


@dataclass
class DecisionRouteUpdate:
    """Route delta published by Decision, consumed by Fib / PrefixManager.
    reference: openr/decision/RouteUpdate.h:22 DecisionRouteUpdate."""

    unicast_routes_to_update: Dict[IpPrefix, RibUnicastEntry] = field(
        default_factory=dict
    )
    unicast_routes_to_delete: List[IpPrefix] = field(default_factory=list)
    mpls_routes_to_update: List[RibMplsEntry] = field(default_factory=list)
    mpls_routes_to_delete: List[int] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None
    # in-process telemetry trace adopted from the triggering
    # publication (oldest-chain rule, same as perf_events)
    trace: Optional[object] = None

    def empty(self) -> bool:
        return not (
            self.unicast_routes_to_update
            or self.unicast_routes_to_delete
            or self.mpls_routes_to_update
            or self.mpls_routes_to_delete
        )

    def to_route_db_delta(self, node_name: str = "") -> RouteDatabaseDelta:
        return RouteDatabaseDelta(
            this_node_name=node_name,
            unicast_routes_to_update=[
                e.to_unicast_route()
                for _, e in sorted(
                    self.unicast_routes_to_update.items(),
                    key=lambda kv: kv[0],
                )
            ],
            unicast_routes_to_delete=sorted(self.unicast_routes_to_delete),
            mpls_routes_to_update=[
                e.to_mpls_route()
                for e in sorted(
                    self.mpls_routes_to_update, key=lambda e: e.label
                )
            ],
            mpls_routes_to_delete=sorted(self.mpls_routes_to_delete),
            perf_events=self.perf_events,
        )


# a passive container with a single owner at any moment: Decision
# mutates it on whichever role currently drives emission (see
# Decision.route_db's owner confinement) — it carries no lock of its
# own by design
@dataclass
class DecisionRouteDb:
    """The full computed RIB. reference: openr/decision/Decision.h:95."""

    unicast_routes: Dict[IpPrefix, RibUnicastEntry] = field(default_factory=dict)
    mpls_routes: Dict[int, RibMplsEntry] = field(default_factory=dict)

    def add_unicast_route(self, entry: RibUnicastEntry) -> None:
        self.unicast_routes[entry.prefix] = entry

    def add_mpls_route(self, entry: RibMplsEntry) -> None:
        self.mpls_routes[entry.label] = entry

    def calculate_update(self, new_db: "DecisionRouteDb") -> DecisionRouteUpdate:
        """Delta from self -> new_db (reference: Decision.cpp:112)."""
        delta = DecisionRouteUpdate()
        for prefix, entry in new_db.unicast_routes.items():
            old = self.unicast_routes.get(prefix)
            if old is None or old != entry:
                delta.unicast_routes_to_update[prefix] = entry
        for prefix in self.unicast_routes:
            if prefix not in new_db.unicast_routes:
                delta.unicast_routes_to_delete.append(prefix)
        for label, entry in new_db.mpls_routes.items():
            old = self.mpls_routes.get(label)
            if old is None or old != entry:
                delta.mpls_routes_to_update.append(entry)
        for label in self.mpls_routes:
            if label not in new_db.mpls_routes:
                delta.mpls_routes_to_delete.append(label)
        return delta

    def update(self, delta: DecisionRouteUpdate) -> None:
        """Apply a delta in place (reference: Decision.cpp:146)."""
        for prefix in delta.unicast_routes_to_delete:
            self.unicast_routes.pop(prefix, None)
        for prefix, entry in delta.unicast_routes_to_update.items():
            self.unicast_routes[prefix] = entry
        for label in delta.mpls_routes_to_delete:
            self.mpls_routes.pop(label, None)
        for entry in delta.mpls_routes_to_update:
            self.mpls_routes[entry.label] = entry

    def to_route_db(self, node_name: str = "") -> RouteDatabase:
        return RouteDatabase(
            this_node_name=node_name,
            unicast_routes=[
                e.to_unicast_route()
                for _, e in sorted(self.unicast_routes.items(), key=lambda kv: kv[0])
            ],
            mpls_routes=[
                e.to_mpls_route()
                for _, e in sorted(self.mpls_routes.items(), key=lambda kv: kv[0])
            ],
        ).canonicalize()
