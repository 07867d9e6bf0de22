"""Link-state database value types.

Port note: a copy of ``openr_tpu/types/lsdb.py``; nothing left out.

Schema parity with the reference IDL ``openr/if/Lsdb.thrift``: Adjacency,
AdjacencyDatabase, PrefixMetrics, PrefixEntry, PrefixDatabase, PerfEvents.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from openr_tpu_torch.types.network import BinaryAddress, IpPrefix, PrefixType


class PrefixForwardingType(enum.IntEnum):
    # reference: openr/if/OpenrConfig.thrift PrefixForwardingType
    IP = 0
    SR_MPLS = 1


class PrefixForwardingAlgorithm(enum.IntEnum):
    # reference: openr/if/OpenrConfig.thrift PrefixForwardingAlgorithm
    SP_ECMP = 0
    KSP2_ED_ECMP = 1


class CompareType(enum.IntEnum):
    """How a metric entity present in only one vector compares.
    reference: openr/if/Lsdb.thrift:165-173 CompareType."""

    WIN_IF_PRESENT = 1
    WIN_IF_NOT_PRESENT = 2
    IGNORE_IF_NOT_PRESENT = 3


@dataclass(frozen=True)
class MetricEntity:
    """reference: openr/if/Lsdb.thrift:175-195 MetricEntity."""

    type: int
    priority: int
    op: CompareType = CompareType.WIN_IF_PRESENT
    is_best_path_tie_breaker: bool = False
    metric: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.metric, tuple):
            object.__setattr__(self, "metric", tuple(self.metric))


@dataclass(frozen=True)
class MetricVector:
    """reference: openr/if/Lsdb.thrift:197-206 MetricVector."""

    version: int = 1
    metrics: Tuple[MetricEntity, ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.metrics, tuple):
            object.__setattr__(self, "metrics", tuple(self.metrics))

    def sorted_metrics(self):
        return sorted(self.metrics, key=lambda e: -e.priority)


@dataclass(frozen=True)
class PerfEvent:
    """reference: openr/if/Lsdb.thrift:24-28"""

    node_name: str
    event_descr: str
    unix_ts: int = 0


@dataclass
class PerfEvents:
    """reference: openr/if/Lsdb.thrift:30-32"""

    events: List[PerfEvent] = field(default_factory=list)

    def add(self, node_name: str, descr: str) -> None:
        self.events.append(
            PerfEvent(node_name=node_name, event_descr=descr,
                      unix_ts=int(time.time() * 1000))
        )


@dataclass(frozen=True)
class Adjacency:
    """One directed adjacency advertised by a node toward a neighbor.

    reference: openr/if/Lsdb.thrift:69-102
    """

    other_node_name: str
    if_name: str
    metric: int = 1
    next_hop_v6: BinaryAddress = field(default_factory=BinaryAddress)
    next_hop_v4: BinaryAddress = field(default_factory=BinaryAddress)
    adj_label: int = 0
    is_overloaded: bool = False
    rtt: int = 0
    timestamp: int = 0
    weight: int = 1
    other_if_name: str = ""


@dataclass(frozen=True)
class AdjacencyDatabase:
    """Full link-state of a single router, flooded under ``adj:<node>`` keys.

    reference: openr/if/Lsdb.thrift:104-125
    """

    this_node_name: str
    is_overloaded: bool = False
    adjacencies: Tuple[Adjacency, ...] = ()
    node_label: int = 0
    area: str = "0"
    perf_events: Optional[PerfEvents] = None

    def __post_init__(self) -> None:
        if not isinstance(self.adjacencies, tuple):
            object.__setattr__(self, "adjacencies", tuple(self.adjacencies))


@dataclass(frozen=True, order=True)
class PrefixMetrics:
    """Best-route selection metrics. Field order here IS the comparison
    order used by best-route selection: (path_preference DESC,
    source_preference DESC, distance ASC).

    reference: openr/if/Lsdb.thrift PrefixMetrics; comparison semantics
    reference: openr/common/Util.h:549 (selectBestPrefixMetrics tuple)
    """

    version: int = 1
    path_preference: int = 0  # prefer higher
    source_preference: int = 0  # prefer higher
    distance: int = 0  # prefer lower

    def comparison_key(self) -> Tuple[int, int, int]:
        return (self.path_preference, self.source_preference, -self.distance)


@dataclass(frozen=True)
class PrefixEntry:
    """One prefix advertisement from one node.

    reference: openr/if/Lsdb.thrift:263-336
    """

    prefix: IpPrefix
    type: PrefixType = PrefixType.DEFAULT
    forwarding_type: PrefixForwardingType = PrefixForwardingType.IP
    forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    )
    min_nexthop: Optional[int] = None
    prepend_label: Optional[int] = None
    mv: Optional[MetricVector] = None  # deprecated BGP metric vector
    metrics: PrefixMetrics = field(default_factory=PrefixMetrics)
    tags: Tuple[str, ...] = ()
    area_stack: Tuple[str, ...] = ()
    data: Optional[bytes] = None

    def __post_init__(self) -> None:
        if not isinstance(self.tags, tuple):
            object.__setattr__(self, "tags", tuple(sorted(self.tags)))
        if not isinstance(self.area_stack, tuple):
            object.__setattr__(self, "area_stack", tuple(self.area_stack))


@dataclass(frozen=True)
class PrefixDatabase:
    """All prefixes bound to a router, flooded under ``prefix:`` keys.

    reference: openr/if/Lsdb.thrift:338-354
    """

    this_node_name: str
    prefix_entries: Tuple[PrefixEntry, ...] = ()
    delete_prefix: bool = False
    area: str = "0"
    perf_events: Optional[PerfEvents] = None

    def __post_init__(self) -> None:
        if not isinstance(self.prefix_entries, tuple):
            object.__setattr__(self, "prefix_entries", tuple(self.prefix_entries))
