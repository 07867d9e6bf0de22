"""Spark neighbor-discovery wire messages and events.

Schema parity with the reference IDL ``openr/if/Spark.thrift`` (hello /
handshake / heartbeat packets, SparkNeighborEvent) — field semantics kept,
layout re-expressed as dataclasses over the canonical wire codec.

Port note: a copy of ``openr_tpu/types/spark.py``; nothing left out.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.types.network import BinaryAddress, IpPrefix


@dataclass(frozen=True)
class ReflectedNeighborInfo:
    """What I know about having heard you (echoed in my hellos so you can
    confirm bidirectional visibility and compute RTT).
    reference: Spark.thrift ReflectedNeighborInfo."""

    seq_num: int = 0
    last_nbr_msg_sent_ts_us: int = 0  # your hello's sentTs as I saw it
    last_my_msg_rcvd_ts_us: int = 0  # when I received it (my clock)


@dataclass
class SparkHelloMsg:
    """reference: Spark.thrift SparkHelloMsg."""

    node_name: str
    if_name: str
    seq_num: int
    neighbor_infos: Dict[str, ReflectedNeighborInfo] = field(
        default_factory=dict
    )
    version: int = 1
    solicit_response: bool = False
    restarting: bool = False
    sent_ts_us: int = 0


@dataclass
class SparkHandshakeMsg:
    """reference: Spark.thrift SparkHandshakeMsg."""

    node_name: str
    if_name: str
    is_adj_established: bool = False
    hold_time_ms: int = 3000
    graceful_restart_time_ms: int = 30000
    transport_address_v6: BinaryAddress = field(default_factory=BinaryAddress)
    transport_address_v4: BinaryAddress = field(default_factory=BinaryAddress)
    openr_ctrl_port: int = 2018
    area: str = "0"
    # receiver targeting: when set, only this neighbor should process
    neighbor_node_name: Optional[str] = None
    # the sender's KvStore peer-sync port (reference: Spark.thrift:97
    # kvStoreCmdPort); 0 when cross-process peering is not exposed.
    # TRAILING deliberately: the wire codec decodes positionally and
    # only forward-compats unknown trailing fields, so a mixed-version
    # neighborhood (old daemon, new handshake) still negotiates
    kvstore_peer_port: int = 0


@dataclass
class SparkHeartbeatMsg:
    """reference: Spark.thrift SparkHeartbeatMsg."""

    node_name: str
    if_name: str
    seq_num: int = 0
    hold_time_ms: int = 3000


@dataclass
class SparkPacket:
    """Envelope: exactly one of the messages is set."""

    hello: Optional[SparkHelloMsg] = None
    handshake: Optional[SparkHandshakeMsg] = None
    heartbeat: Optional[SparkHeartbeatMsg] = None
    version: int = 1


class SparkNeighborEventType(enum.IntEnum):
    """reference: Spark.thrift SparkNeighborEventType."""

    NEIGHBOR_UP = 1
    NEIGHBOR_DOWN = 2
    NEIGHBOR_RESTARTING = 3
    NEIGHBOR_RESTARTED = 4
    NEIGHBOR_RTT_CHANGE = 5


@dataclass
class SparkNeighbor:
    """Info about an established neighbor carried in events."""

    node_name: str
    local_if_name: str
    remote_if_name: str
    transport_address_v6: BinaryAddress = field(default_factory=BinaryAddress)
    transport_address_v4: BinaryAddress = field(default_factory=BinaryAddress)
    openr_ctrl_port: int = 2018
    area: str = "0"
    rtt_us: int = 0
    # reference: Spark.thrift:97 kvStoreCmdPort (trailing: see
    # SparkHandshakeMsg)
    kvstore_peer_port: int = 0


@dataclass
class SparkNeighborEvent:
    event_type: SparkNeighborEventType
    neighbor: SparkNeighbor


@dataclass(frozen=True)
class InterfaceInfo:
    """reference: openr/if/Lsdb.thrift InterfaceInfo."""

    is_up: bool
    if_index: int = 0
    networks: Tuple[IpPrefix, ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.networks, tuple):
            object.__setattr__(self, "networks", tuple(self.networks))


@dataclass
class InterfaceDatabase:
    """reference: openr/if/Lsdb.thrift InterfaceDatabase."""

    this_node_name: str = ""
    interfaces: Dict[str, InterfaceInfo] = field(default_factory=dict)
