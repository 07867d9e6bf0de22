"""Spark packets in the reference's thrift CompactProtocol wire format.

The reference serializes ``SparkHelloPacket`` (openr/if/Spark.thrift:
ReflectedNeighborInfo:25, SparkHelloMsg:60, SparkHeartbeatMsg:73,
SparkHandshakeMsg:78, SparkHelloPacket:113) with CompactProtocol onto
the ``ff02::1`` multicast socket. This module maps the framework's
Spark dataclasses onto that exact byte layout so an openr-tpu daemon
can discover (and be discovered by) stock Open/R neighbors on the same
LAN. Hold/GR times ride in milliseconds, exactly like the reference
(Spark.cpp:781 sends holdTime_.count() of a milliseconds duration;
:1496 reads it back as milliseconds).

Differences the adapters absorb:
- the reference's handshake/heartbeat carry no interface name (the
  receiver knows its own rx interface; the REMOTE interface comes from
  the hello msg) — decode leaves ``if_name`` empty and the Spark FSM
  keeps the hello-learned value;
- ``domainName`` carries the daemon's configured domain
  (OpenrConfig.domain; a stock neighbor drops mismatches);
- the framework's packet-level version maps to the hello msg's
  ``version`` field (the only place the reference carries one).

Format sniffing: the framework's native codec (utils/wire.py) always
starts a packet with the dataclass marker byte ``'O'`` (0x4F), which can
never begin a compact-protocol struct whose first field id is >= 3
(header 0x3C/0x4C...). Spark accepts BOTH formats on receive and sends
whichever ``wire_format`` selects — the dual-stack pattern the
reference uses for its own wire migrations (KvStore.cpp:2940-2973).

Port note: a copy of ``openr_tpu/spark/thrift_wire.py``; nothing left out.
"""

from __future__ import annotations

from typing import Dict

from openr_tpu_torch.types.spark import (
    ReflectedNeighborInfo,
    SparkHandshakeMsg,
    SparkHeartbeatMsg,
    SparkHelloMsg,
    SparkPacket,
)
from openr_tpu_torch.utils import thrift_compact as tc

# Network.thrift BinaryAddress schema + adapters are shared with the
# FibService wire (utils/thrift_compact.py)
BINARY_ADDRESS = tc.BINARY_ADDRESS

REFLECTED_NEIGHBOR_INFO = tc.StructSchema(
    "ReflectedNeighborInfo",
    (
        tc.Field(1, ("i64",), "seqNum"),
        tc.Field(2, ("i64",), "lastNbrMsgSentTsInUs"),
        tc.Field(3, ("i64",), "lastMyMsgRcvdTsInUs"),
    ),
)

SPARK_HELLO_MSG = tc.StructSchema(
    "SparkHelloMsg",
    (
        tc.Field(1, ("string",), "domainName"),
        tc.Field(2, ("string",), "nodeName"),
        tc.Field(3, ("string",), "ifName"),
        tc.Field(4, ("i64",), "seqNum"),
        tc.Field(
            5,
            ("map", ("string",), ("struct", REFLECTED_NEIGHBOR_INFO)),
            "neighborInfos",
        ),
        tc.Field(6, ("i32",), "version"),
        tc.Field(7, ("bool",), "solicitResponse"),
        tc.Field(8, ("bool",), "restarting"),
        tc.Field(9, ("i64",), "sentTsInUs"),
    ),
)

SPARK_HEARTBEAT_MSG = tc.StructSchema(
    "SparkHeartbeatMsg",
    (
        tc.Field(1, ("string",), "nodeName"),
        tc.Field(2, ("i64",), "seqNum"),
    ),
)

SPARK_HANDSHAKE_MSG = tc.StructSchema(
    "SparkHandshakeMsg",
    (
        tc.Field(1, ("string",), "nodeName"),
        tc.Field(2, ("bool",), "isAdjEstablished"),
        tc.Field(3, ("i64",), "holdTime"),
        tc.Field(4, ("i64",), "gracefulRestartTime"),
        tc.Field(5, ("struct", BINARY_ADDRESS), "transportAddressV6"),
        tc.Field(6, ("struct", BINARY_ADDRESS), "transportAddressV4"),
        tc.Field(7, ("i32",), "openrCtrlThriftPort"),
        tc.Field(9, ("i32",), "kvStoreCmdPort"),
        tc.Field(10, ("string",), "area"),
        tc.Field(11, ("string",), "neighborNodeName", optional=True),
    ),
)

SPARK_HELLO_PACKET = tc.StructSchema(
    "SparkHelloPacket",
    (
        tc.Field(
            3, ("struct", SPARK_HELLO_MSG), "helloMsg", optional=True
        ),
        tc.Field(
            4,
            ("struct", SPARK_HEARTBEAT_MSG),
            "heartbeatMsg",
            optional=True,
        ),
        tc.Field(
            5,
            ("struct", SPARK_HANDSHAKE_MSG),
            "handshakeMsg",
            optional=True,
        ),
    ),
)

# the native codec's first byte for any dataclass packet; a compact
# SparkHelloPacket starts with a field header whose id >= 3 (0x3C...)
NATIVE_MARKER = ord("O")

# the reference's date-coded protocol version (Constants.h:274
# kOpenrVersion / :277 kOpenrSupportedVersion{20200604}): a stock
# Open/R neighbor drops hellos whose version is below its supported
# floor, so the thrift wire must speak the reference's numbering —
# the framework-internal version (1) stays internal
OPENR_VERSION = 20200825
OPENR_SUPPORTED_VERSION = 20200604


_addr_to_wire = tc._bin_addr_to_wire
_addr_from_wire = tc._bin_addr_from_wire


def encode_packet(pkt: SparkPacket, domain: str = "") -> bytes:
    """One SparkPacket -> compact-protocol SparkHelloPacket bytes."""
    out: Dict = {}
    if pkt.hello is not None:
        h = pkt.hello
        out["helloMsg"] = {
            "domainName": domain,
            "nodeName": h.node_name,
            "ifName": h.if_name,
            "seqNum": h.seq_num,
            "neighborInfos": {
                nbr: {
                    "seqNum": info.seq_num,
                    "lastNbrMsgSentTsInUs": info.last_nbr_msg_sent_ts_us,
                    "lastMyMsgRcvdTsInUs": info.last_my_msg_rcvd_ts_us,
                }
                for nbr, info in h.neighbor_infos.items()
            },
            # reference numbering on the wire (a stock neighbor
            # rejects anything below its date-coded floor)
            "version": OPENR_VERSION,
            "solicitResponse": h.solicit_response,
            "restarting": h.restarting,
            "sentTsInUs": h.sent_ts_us,
        }
    if pkt.heartbeat is not None:
        out["heartbeatMsg"] = {
            "nodeName": pkt.heartbeat.node_name,
            "seqNum": pkt.heartbeat.seq_num,
        }
    if pkt.handshake is not None:
        m = pkt.handshake
        out["handshakeMsg"] = {
            "nodeName": m.node_name,
            "isAdjEstablished": m.is_adj_established,
            "holdTime": m.hold_time_ms,
            "gracefulRestartTime": m.graceful_restart_time_ms,
            "transportAddressV6": _addr_to_wire(m.transport_address_v6),
            "transportAddressV4": _addr_to_wire(m.transport_address_v4),
            "openrCtrlThriftPort": m.openr_ctrl_port,
            "kvStoreCmdPort": m.kvstore_peer_port,
            "area": m.area,
            **(
                {"neighborNodeName": m.neighbor_node_name}
                if m.neighbor_node_name is not None
                else {}
            ),
        }
    return tc.encode(SPARK_HELLO_PACKET, out)


def decode_packet(data: bytes) -> SparkPacket:
    """Compact-protocol SparkHelloPacket bytes -> SparkPacket."""
    d = tc.decode(SPARK_HELLO_PACKET, data)
    pkt = SparkPacket()
    hello = d.get("helloMsg")
    if hello is not None:
        pkt.hello = SparkHelloMsg(
            node_name=hello.get("nodeName", ""),
            if_name=hello.get("ifName", ""),
            seq_num=hello.get("seqNum", 0),
            neighbor_infos={
                nbr: ReflectedNeighborInfo(
                    seq_num=i.get("seqNum", 0),
                    last_nbr_msg_sent_ts_us=i.get(
                        "lastNbrMsgSentTsInUs", 0
                    ),
                    last_my_msg_rcvd_ts_us=i.get(
                        "lastMyMsgRcvdTsInUs", 0
                    ),
                )
                for nbr, i in hello.get("neighborInfos", {}).items()
            },
            solicit_response=hello.get("solicitResponse", False),
            restarting=hello.get("restarting", False),
            sent_ts_us=hello.get("sentTsInUs", 0),
        )
        v = hello.get("version", OPENR_VERSION)
        # map the reference's date-coded version onto the framework's
        # internal numbering: anything at/above the reference floor is
        # acceptable (internally version 1); a below-floor sender maps
        # to 0 so Spark's version check rejects it
        pkt.version = 1 if v >= OPENR_SUPPORTED_VERSION or v == 1 else 0
    heartbeat = d.get("heartbeatMsg")
    if heartbeat is not None:
        pkt.heartbeat = SparkHeartbeatMsg(
            node_name=heartbeat.get("nodeName", ""),
            if_name="",  # receiver uses its rx interface
            seq_num=heartbeat.get("seqNum", 0),
        )
    handshake = d.get("handshakeMsg")
    if handshake is not None:
        pkt.handshake = SparkHandshakeMsg(
            node_name=handshake.get("nodeName", ""),
            if_name="",  # remote interface comes from the hello msg
            is_adj_established=handshake.get("isAdjEstablished", False),
            hold_time_ms=handshake.get("holdTime", 3000),
            graceful_restart_time_ms=handshake.get(
                "gracefulRestartTime", 30000
            ),
            transport_address_v6=_addr_from_wire(
                handshake.get("transportAddressV6", {})
            ),
            transport_address_v4=_addr_from_wire(
                handshake.get("transportAddressV4", {})
            ),
            openr_ctrl_port=handshake.get("openrCtrlThriftPort", 2018),
            area=handshake.get("area", "0"),
            neighbor_node_name=handshake.get("neighborNodeName"),
            kvstore_peer_port=handshake.get("kvStoreCmdPort", 0),
        )
    return pkt
