"""RibPolicy: TTL'd centrally-injected route transforms.

Port note: a copy of ``openr_tpu/decision/rib_policy.py``; nothing left out.

Behavioral parity with the reference ``openr/decision/RibPolicy.{h,cpp}``
and the thrift shapes in ``openr/if/OpenrCtrl.thrift`` (RibPolicy,
RibPolicyStatement, RibRouteAction/Weight): statements match routes by
prefix and set per-next-hop weights (by neighbor, by area, or default);
zero-weight next-hops are dropped and routes left with no next-hops are
deleted. A policy is only effective within its TTL — the Decision module
schedules a rebuild at expiry so effects revert.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Set, Tuple

from openr_tpu_torch.decision.rib import RibUnicastEntry
from openr_tpu_torch.types import IpPrefix, NextHop


@dataclass
class RibRouteActionWeight:
    """reference: OpenrCtrl.thrift:94 RibRouteActionWeight."""

    default_weight: int = 0
    area_to_weight: Dict[str, int] = field(default_factory=dict)
    neighbor_to_weight: Dict[str, int] = field(default_factory=dict)


@dataclass
class RibRouteAction:
    """reference: OpenrCtrl.thrift:114 RibRouteAction."""

    set_weight: Optional[RibRouteActionWeight] = None


@dataclass
class RibPolicyStatement:
    """reference: OpenrCtrl.thrift:124 RibPolicyStatement."""

    name: str = ""
    prefixes: Tuple[IpPrefix, ...] = ()
    action: RibRouteAction = field(default_factory=RibRouteAction)

    def __post_init__(self) -> None:
        if not isinstance(self.prefixes, tuple):
            self.prefixes = tuple(self.prefixes)
        self._prefix_set: Set[IpPrefix] = set(self.prefixes)

    def match(self, route: RibUnicastEntry) -> bool:
        return route.prefix in self._prefix_set

    def apply_action(
        self, route: RibUnicastEntry
    ) -> Optional[RibUnicastEntry]:
        """Set next-hop weights; drop zero-weight next-hops. Returns a
        TRANSFORMED COPY (None = no match): the input entry is shared
        with the solver's route-reuse caches, and mutating it in place
        would make the policy effect permanent — an expired policy
        could never restore the dropped next-hops of a reused route.
        reference: RibPolicyStatement::applyAction."""
        if not self.match(route) or self.action.set_weight is None:
            return None
        weights = self.action.set_weight
        new_nexthops: Set[NextHop] = set()
        for nh in route.nexthops:
            weight = weights.default_weight
            if nh.area is not None and nh.area in weights.area_to_weight:
                weight = weights.area_to_weight[nh.area]
            if (
                nh.neighbor_node_name is not None
                and nh.neighbor_node_name in weights.neighbor_to_weight
            ):
                weight = weights.neighbor_to_weight[nh.neighbor_node_name]
            if weight <= 0:
                continue  # zero weight: next-hop dropped
            new_nexthops.add(
                NextHop(
                    address=nh.address,
                    weight=weight,
                    mpls_action=nh.mpls_action,
                    metric=nh.metric,
                    area=nh.area,
                    neighbor_node_name=nh.neighbor_node_name,
                )
            )
        return replace(route, nexthops=new_nexthops)


@dataclass
class PolicyChange:
    updated_routes: List[IpPrefix] = field(default_factory=list)
    deleted_routes: List[IpPrefix] = field(default_factory=list)


class RibPolicy:
    def __init__(
        self, statements: List[RibPolicyStatement], ttl_secs: float = 300.0
    ):
        self.statements = list(statements)
        self.ttl_secs = ttl_secs
        self._valid_until = time.monotonic() + ttl_secs

    def get_ttl_remaining_s(self) -> float:
        return max(0.0, self._valid_until - time.monotonic())

    def is_active(self) -> bool:
        return time.monotonic() < self._valid_until

    def match(self, route: RibUnicastEntry) -> bool:
        return any(s.match(route) for s in self.statements)

    def apply_action(
        self, route: RibUnicastEntry
    ) -> Optional[RibUnicastEntry]:
        # first successful match/action terminates processing
        for statement in self.statements:
            if statement.match(route):
                return statement.apply_action(route)
        return None

    def apply_policy(
        self, unicast_routes: Dict[IpPrefix, RibUnicastEntry]
    ) -> PolicyChange:
        """Transform all matching routes; delete ones whose next-hop set
        becomes empty. reference: RibPolicy::applyPolicy."""
        change = PolicyChange()
        if not self.is_active():
            return change
        for prefix, route in list(unicast_routes.items()):
            new_route = self.apply_action(route)
            if new_route is None:
                continue
            if not new_route.nexthops:
                del unicast_routes[prefix]
                change.deleted_routes.append(prefix)
            else:
                unicast_routes[prefix] = new_route
                change.updated_routes.append(prefix)
        return change
