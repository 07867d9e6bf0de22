"""Typed message schema for openr-tpu (reference: openr/if/*.thrift).

Port note: mirrors ``openr_tpu/types/__init__.py``; the Spark types are
imported from ``types/spark.py``, as in the reference.
"""

from openr_tpu_torch.types.network import (
    AdminDistance,
    BinaryAddress,
    IpPrefix,
    MplsAction,
    MplsActionCode,
    MplsRoute,
    NextHop,
    PrefixType,
    UnicastRoute,
)
from openr_tpu_torch.types.lsdb import (
    Adjacency,
    AdjacencyDatabase,
    PerfEvent,
    PerfEvents,
    PrefixDatabase,
    PrefixEntry,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    PrefixMetrics,
)
from openr_tpu_torch.types.kvstore import (
    DEFAULT_AREA,
    TTL_INFINITY,
    KeyDumpParams,
    KeyGetParams,
    KeySetParams,
    KvStorePeerState,
    PeerSpec,
    Publication,
    Value,
)
from openr_tpu_torch.types.fib import RouteDatabase, RouteDatabaseDelta

__all__ = [
    "AdminDistance",
    "BinaryAddress",
    "IpPrefix",
    "MplsAction",
    "MplsActionCode",
    "MplsRoute",
    "NextHop",
    "PrefixType",
    "UnicastRoute",
    "Adjacency",
    "AdjacencyDatabase",
    "PerfEvent",
    "PerfEvents",
    "PrefixDatabase",
    "PrefixEntry",
    "PrefixForwardingAlgorithm",
    "PrefixForwardingType",
    "PrefixMetrics",
    "DEFAULT_AREA",
    "TTL_INFINITY",
    "KeyDumpParams",
    "KeyGetParams",
    "KeySetParams",
    "KvStorePeerState",
    "PeerSpec",
    "Publication",
    "Value",
    "RouteDatabase",
    "RouteDatabaseDelta",
]
