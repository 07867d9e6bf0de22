"""The port's Spark (``spark/spark.py``), its thrift wire
(``spark/thrift_wire.py``) and ``MockIoProvider`` against ``openr_tpu``'s,
on the same inputs.

Packets built in both packages' types must encode to the same bytes on
both wires (the reference's CompactProtocol layout and the native codec),
and each package must decode the other's. The scripted LAN runs of
``tests/test_spark.py`` (discovery, hold expiry, graceful restart, the
edge cases) run once in each package; they must end in the same neighbour
states with the same neighbour events on every node (RTTs and RTT
changes are left out: they are clock readings). A port Spark and a
reference Spark on one simulated LAN must form an adjacency on either
wire. Every wait polls against a deadline; every Spark and provider is
stopped.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from openr_tpu.messaging import queue as jax_queue
from openr_tpu.spark import io_provider as jax_io
from openr_tpu.spark import spark as jax_spark
from openr_tpu.spark import thrift_wire as jax_thrift_wire
from openr_tpu.types import BinaryAddress as JaxBinaryAddress
from openr_tpu.types import spark as jax_spark_types
from openr_tpu.utils import thrift_compact as jax_tc
from openr_tpu.utils import wire as jax_wire
from openr_tpu_torch.messaging import queue as port_queue
from openr_tpu_torch.spark import io_provider as port_io
from openr_tpu_torch.spark import spark as port_spark
from openr_tpu_torch.spark import thrift_wire as port_thrift_wire
from openr_tpu_torch.types import BinaryAddress
from openr_tpu_torch.types import spark as port_spark_types
from openr_tpu_torch.utils import thrift_compact as port_tc
from openr_tpu_torch.utils import wire

PKGS = {
    "port": SimpleNamespace(queue=port_queue, io=port_io, spark=port_spark,
                            thrift_wire=port_thrift_wire, S=port_spark_types,
                            Addr=BinaryAddress, wire=wire, tc=port_tc),
    "jax": SimpleNamespace(queue=jax_queue, io=jax_io, spark=jax_spark,
                           thrift_wire=jax_thrift_wire, S=jax_spark_types,
                           Addr=JaxBinaryAddress, wire=jax_wire, tc=jax_tc),
}

FAST = dict(hello_interval_s=0.05, fast_hello_interval_s=0.03, handshake_interval_s=0.03,
            heartbeat_interval_s=0.05, hold_time_s=1.0, graceful_restart_time_s=1.5)
WAIT_S = 8.0


# -- packets on both wires ----------------------------------------------------


def _hello(p):
    S = p.S
    return S.SparkPacket(hello=S.SparkHelloMsg(
        node_name="alpha", if_name="eth1", seq_num=42,
        neighbor_infos={"beta": S.ReflectedNeighborInfo(
            seq_num=9, last_nbr_msg_sent_ts_us=123456, last_my_msg_rcvd_ts_us=123999)},
        solicit_response=True, sent_ts_us=111))


def _handshake(p):
    S = p.S
    return S.SparkPacket(handshake=S.SparkHandshakeMsg(
        node_name="alpha", if_name="eth1", hold_time_ms=1500, graceful_restart_time_ms=9000,
        transport_address_v6=p.Addr.from_str("fe80::1"), openr_ctrl_port=2018,
        kvstore_peer_port=60002, area="pod7", neighbor_node_name="beta"))


def _heartbeat(p):
    return p.S.SparkPacket(heartbeat=p.S.SparkHeartbeatMsg(node_name="n1", if_name="eth0",
                                                          seq_num=7))


PACKETS = {"hello": _hello, "handshake": _handshake, "heartbeat": _heartbeat}


@pytest.mark.parametrize("kind", sorted(PACKETS))
def test_thrift_wire_packets_are_the_same_bytes(kind):
    port_pkt, jax_pkt = PACKETS[kind](PKGS["port"]), PACKETS[kind](PKGS["jax"])
    data = port_thrift_wire.encode_packet(port_pkt, domain="openr")
    assert data == jax_thrift_wire.encode_packet(jax_pkt, domain="openr")
    assert data[0] != port_thrift_wire.NATIVE_MARKER
    port_back = port_thrift_wire.decode_packet(data)
    jax_back = jax_thrift_wire.decode_packet(data)
    assert wire.dumps(port_back) == jax_wire.dumps(jax_back)
    if kind == "heartbeat":
        # the hand-derived golden of tests/test_spark.py (no domain)
        assert port_thrift_wire.encode_packet(port_pkt) == bytes(
            [0x4C, 0x18, 0x02, 0x6E, 0x31, 0x16, 0x0E, 0x00, 0x00])


@pytest.mark.parametrize("kind", sorted(PACKETS))
def test_native_wire_packets_are_the_same_bytes(kind):
    port_pkt, jax_pkt = PACKETS[kind](PKGS["port"]), PACKETS[kind](PKGS["jax"])
    data = wire.dumps(port_pkt)
    assert data == jax_wire.dumps(jax_pkt)
    assert data[0] == port_thrift_wire.NATIVE_MARKER
    assert wire.loads(data, port_spark_types.SparkPacket) == port_pkt
    assert jax_wire.loads(data, jax_spark_types.SparkPacket) == jax_pkt


@pytest.mark.parametrize("version", (20190101, 20200604))
def test_version_floor_on_the_thrift_wire(version):
    """A hello below the reference's date-coded floor decodes below
    ``LOWEST_SUPPORTED_VERSION`` in both packages; one at the floor does
    not."""
    hello = {"helloMsg": {"domainName": "", "nodeName": "old", "ifName": "eth0", "seqNum": 1,
                          "neighborInfos": {}, "version": version, "solicitResponse": False,
                          "restarting": False, "sentTsInUs": 0}}
    raw = port_tc.encode(port_thrift_wire.SPARK_HELLO_PACKET, hello)
    assert raw == jax_tc.encode(jax_thrift_wire.SPARK_HELLO_PACKET, hello)
    port_v = port_thrift_wire.decode_packet(raw).version
    assert port_v == jax_thrift_wire.decode_packet(raw).version
    floor = port_spark.Spark.LOWEST_SUPPORTED_VERSION
    assert (port_v < floor) == (version < port_thrift_wire.OPENR_SUPPORTED_VERSION)


# -- scripted LANs, once in each package ---------------------------------------


class Lan:
    """``tests/test_spark.py``'s harness over one package's modules."""

    def __init__(self, p):
        self.p = p
        self.io = p.io.MockIoProvider()
        self.sparks = {}
        self.readers = {}
        self.events = {}

    def add_node(self, name, ifaces, area="0", key=None, **overrides):
        q = self.p.queue.ReplicateQueue(name=f"nbr:{name}")
        key = key or name
        self.readers[key] = q.get_reader("test")
        self.events.setdefault(key, [])
        spark = self.p.spark.Spark(name, self.io, q, area=area,
                                   v6_addr=self.p.Addr.from_str(f"fe80::{len(self.sparks) + 1}"),
                                   **dict(FAST, **overrides))
        spark.start()
        for iface in ifaces:
            spark.add_interface(iface)
        self.sparks[key] = spark
        return spark

    def drain(self, key, timeout=0.2):
        while True:
            try:
                ev = self.readers[key].get(timeout=timeout)
            except self.p.queue.QueueTimeoutError:
                return
            n = ev.neighbor
            if ev.event_type.name == "NEIGHBOR_RTT_CHANGE":
                continue  # a clock reading, as the RTT itself
            self.events[key].append((ev.event_type.name, n.node_name, n.local_if_name,
                                     n.remote_if_name, n.area))
            timeout = 0.05

    def wait_event(self, key, name, count=1, timeout=WAIT_S):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.drain(key, timeout=0.1)
            if sum(e[0] == name for e in self.events[key]) >= count:
                return
        raise AssertionError(f"{key}: no {name} within {timeout} s: {self.events[key]}")

    def summary(self):
        for key in self.readers:
            self.drain(key, timeout=0.05)
        states = {}
        for key, spark in self.sparks.items():
            try:
                states[key] = {i: {n: s.name for n, s in nbrs.items()}
                               for i, nbrs in spark.get_neighbors().items()}
            except Exception:  # a stopped Spark answers nothing
                states[key] = None
        counters = {k: {c: v for c, v in s.counters.items()
                        if c in ("spark.neighbor_up", "spark.neighbor_down",
                                 "spark.invalid_version")}
                    for k, s in self.sparks.items()}
        return {"states": states, "events": self.events, "counters": counters}

    def stop(self):
        for spark in self.sparks.values():
            try:
                spark.stop()
            except Exception:
                pass
        self.io.stop()


def _discovery(lan):
    lan.io.connect_pair("if_a_b", "if_b_a")
    lan.add_node("a", ["if_a_b"])
    lan.add_node("b", ["if_b_a"])
    lan.wait_event("a", "NEIGHBOR_UP")
    lan.wait_event("b", "NEIGHBOR_UP")


def _three_node_lan(lan):
    for x, y in (("if_a", "if_b"), ("if_a", "if_c"), ("if_b", "if_c")):
        lan.io.connect_pair(x, y)
    for n in "abc":
        lan.add_node(n, [f"if_{n}"])
    for n in "abc":
        lan.wait_event(n, "NEIGHBOR_UP", count=2)


def _hold_expiry(lan):
    _discovery(lan)
    lan.io.partition("if_b_a")
    lan.io.partition("if_a_b")
    lan.wait_event("a", "NEIGHBOR_DOWN")
    lan.wait_event("b", "NEIGHBOR_DOWN")


def _reconnect(lan):
    _hold_expiry(lan)
    lan.io.heal("if_b_a")
    lan.io.heal("if_a_b")
    lan.wait_event("a", "NEIGHBOR_UP", count=2)
    lan.wait_event("b", "NEIGHBOR_UP", count=2)


def _interface_removal(lan):
    _discovery(lan)
    lan.sparks["a"].remove_interface("if_a_b")
    lan.wait_event("a", "NEIGHBOR_DOWN")
    lan.wait_event("b", "NEIGHBOR_DOWN")


def _graceful_restart(lan):
    _discovery(lan)
    lan.sparks["b"].stop(graceful_restart=True)
    lan.wait_event("a", "NEIGHBOR_RESTARTING")
    lan.add_node("b", ["if_b_a"], key="b-new")
    lan.wait_event("a", "NEIGHBOR_RESTARTED")
    lan.wait_event("b-new", "NEIGHBOR_UP")


def _gr_expiry(lan):
    lan.io.connect_pair("if_a_b", "if_b_a")
    lan.add_node("a", ["if_a_b"], graceful_restart_time_s=0.5)
    lan.add_node("b", ["if_b_a"])
    lan.wait_event("a", "NEIGHBOR_UP")
    lan.wait_event("b", "NEIGHBOR_UP")
    lan.sparks["b"].stop(graceful_restart=True)
    lan.wait_event("a", "NEIGHBOR_RESTARTING")
    lan.wait_event("a", "NEIGHBOR_DOWN")


def _area_mismatch(lan):
    lan.io.connect_pair("if_a_b", "if_b_a")
    lan.add_node("a", ["if_a_b"], area="0")
    lan.add_node("b", ["if_b_a"], area="1")
    time.sleep(0.8)


def _unidirectional(lan):
    lan.io.connect_one_way("if_a_b", "if_b_a")
    lan.add_node("a", ["if_a_b"])
    lan.add_node("b", ["if_b_a"])
    time.sleep(0.8)


def _looped_hello(lan):
    lan.io.connect_one_way("if_a_b", "if_a_b")
    lan.add_node("a", ["if_a_b"])
    time.sleep(0.5)


def _old_version(lan):
    lan.io.connect_pair("if_a_b", "if_b_a")
    a = lan.add_node("a", ["if_a_b"])
    S = lan.p.S
    lan.io.send("if_b_a", lan.p.wire.dumps(S.SparkPacket(
        version=0, hello=S.SparkHelloMsg(node_name="ancient", if_name="if_b_a", seq_num=1))))
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and not a.get_counters()["spark.invalid_version"]:
        time.sleep(0.02)


def _hub_and_spoke(lan):
    lan.io.connect_pair("if_hub_1", "if_s1_hub")
    lan.io.connect_pair("if_hub_2", "if_s2_hub")
    lan.add_node("hub", ["if_hub_1", "if_hub_2"])
    lan.add_node("s1", ["if_s1_hub"])
    lan.add_node("s2", ["if_s2_hub"])
    lan.wait_event("hub", "NEIGHBOR_UP", count=2)
    lan.wait_event("s1", "NEIGHBOR_UP")
    lan.wait_event("s2", "NEIGHBOR_UP")


def _down_without_adjacency(lan):
    lan.io.connect_one_way("if_a_b", "if_b_a")
    a = lan.add_node("a", ["if_a_b"])
    lan.add_node("b", ["if_b_a"])
    time.sleep(0.3)
    a.remove_interface("if_a_b")
    time.sleep(0.3)


SCENARIOS = {
    "discovery": _discovery, "three_node_lan": _three_node_lan,
    "hold_expiry": _hold_expiry, "reconnect": _reconnect,
    "interface_removal": _interface_removal, "graceful_restart": _graceful_restart,
    "gr_expiry": _gr_expiry, "area_mismatch": _area_mismatch,
    "unidirectional": _unidirectional, "looped_hello": _looped_hello,
    "old_version": _old_version, "hub_and_spoke": _hub_and_spoke,
    "down_without_adjacency": _down_without_adjacency,
}


def _run(pkg, scenario):
    lan = Lan(PKGS[pkg])
    try:
        SCENARIOS[scenario](lan)
        return lan.summary()
    finally:
        lan.stop()


def _event_sets(events):
    """Each node's events in order of kind, by neighbour: the order of two
    neighbours' events on one node is a race in both packages."""
    out = {}
    for key, evs in events.items():
        by_nbr = {}
        for ev in evs:
            by_nbr.setdefault(ev[1], []).append(ev)
        out[key] = by_nbr
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scripted_lan_ends_in_the_reference_states(scenario):
    port, ref = _run("port", scenario), _run("jax", scenario)
    assert port["states"] == ref["states"]
    assert _event_sets(port["events"]) == _event_sets(ref["events"])
    assert port["counters"] == ref["counters"]
    if scenario in ("area_mismatch", "unidirectional", "looped_hello",
                    "down_without_adjacency"):
        assert not any(e[0] == "NEIGHBOR_DOWN" for e in port["events"].get("a", []))
        assert not any(e[0] == "NEIGHBOR_UP" for evs in port["events"].values() for e in evs)
    if scenario == "old_version":
        assert port["counters"]["a"]["spark.invalid_version"] == 1


@pytest.mark.parametrize("wire_format", ("native", "thrift"))
def test_port_and_reference_spark_form_an_adjacency(wire_format):
    """One simulated LAN (the port's provider), one Spark of each
    package: each must see the other come up, on either wire."""
    io = port_io.MockIoProvider()
    q_port, q_jax = port_queue.ReplicateQueue(), jax_queue.ReplicateQueue()
    r_port, r_jax = q_port.get_reader("t"), q_jax.get_reader("t")
    a = port_spark.Spark("pa", io, q_port, v6_addr=BinaryAddress.from_str("fe80::1"),
                         wire_format=wire_format, **FAST)
    b = jax_spark.Spark("jb", io, q_jax, v6_addr=JaxBinaryAddress.from_str("fe80::2"),
                        wire_format=wire_format, **FAST)
    io.connect_pair("if_pa", "if_jb")
    try:
        a.start()
        b.start()
        a.add_interface("if_pa")
        b.add_interface("if_jb")
        ev_a = r_port.get(timeout=WAIT_S)
        ev_b = r_jax.get(timeout=WAIT_S)
        assert ev_a.event_type.name == ev_b.event_type.name == "NEIGHBOR_UP"
        assert (ev_a.neighbor.node_name, ev_a.neighbor.remote_if_name) == ("jb", "if_jb")
        assert (ev_b.neighbor.node_name, ev_b.neighbor.remote_if_name) == ("pa", "if_pa")
        assert ev_a.neighbor.transport_address_v6.to_str() == "fe80::2"
    finally:
        a.stop()
        b.stop()
        io.stop()
