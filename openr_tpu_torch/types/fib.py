"""Route database types exchanged between Decision and Fib.

Port note: a copy of ``openr_tpu/types/fib.py``; nothing left out.

Schema parity with the reference IDL ``openr/if/Fib.thrift``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from openr_tpu_torch.types.lsdb import PerfEvents
from openr_tpu_torch.types.network import IpPrefix, MplsRoute, UnicastRoute


@dataclass
class RouteDatabase:
    """reference: openr/if/Fib.thrift RouteDatabase"""

    this_node_name: str = ""
    unicast_routes: List[UnicastRoute] = field(default_factory=list)
    mpls_routes: List[MplsRoute] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None

    def canonicalize(self) -> "RouteDatabase":
        """Sort routes so two equal RouteDatabases compare equal."""
        self.unicast_routes.sort(key=lambda r: r.dest)
        self.mpls_routes.sort(key=lambda r: r.top_label)
        return self


@dataclass
class RouteDatabaseDelta:
    """reference: openr/if/Fib.thrift RouteDatabaseDelta"""

    this_node_name: str = ""
    unicast_routes_to_update: List[UnicastRoute] = field(default_factory=list)
    unicast_routes_to_delete: List[IpPrefix] = field(default_factory=list)
    mpls_routes_to_update: List[MplsRoute] = field(default_factory=list)
    mpls_routes_to_delete: List[int] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None

    def empty(self) -> bool:
        return not (
            self.unicast_routes_to_update
            or self.unicast_routes_to_delete
            or self.mpls_routes_to_update
            or self.mpls_routes_to_delete
        )
