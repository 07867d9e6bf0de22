"""Spark: neighbor discovery over interface-scoped multicast.

Behavioral parity with the reference ``openr/spark/Spark.{h,cpp}``:

- periodic hello packets carrying reflected neighbor info so both ends
  confirm bidirectional visibility (processHelloMsg, Spark.cpp:1175)
- per-(iface, neighbor) FSM IDLE -> WARM -> NEGOTIATE -> ESTABLISHED with
  a RESTART state for graceful restart (Spark.h:45-51)
- handshake exchange negotiating area / hold times / transport addresses
  (processHandshakeMsg, Spark.cpp:1419)
- heartbeats refreshing the hold timer; expiry -> neighbor down
  (processHeartbeatMsg, Spark.cpp:1566)
- RTT measurement from the 4-timestamp echo (t4-t1)-(t3-t2) fed through a
  StepDetector so only significant changes re-advertise
- graceful-restart announcement on shutdown (floodRestartingMsg,
  Spark.h:92); a restarting neighbor's adjacency is held for its
  advertised GR window
- interface add/remove driven by InterfaceDatabase updates
  (processInterfaceUpdates, Spark.cpp:1703)

Events are published as SparkNeighborEvent on the neighbor-updates queue,
consumed by LinkMonitor.

Port note: a copy of ``openr_tpu/spark/spark.py``; nothing left out.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.spark.io_provider import IoProvider
from openr_tpu_torch.types import BinaryAddress
from openr_tpu_torch.types.spark import (
    InterfaceDatabase,
    ReflectedNeighborInfo,
    SparkHandshakeMsg,
    SparkHeartbeatMsg,
    SparkHelloMsg,
    SparkNeighbor,
    SparkNeighborEvent,
    SparkNeighborEventType,
    SparkPacket,
)
from openr_tpu_torch.spark import thrift_wire
from openr_tpu_torch.utils import wire
from openr_tpu_torch.utils.eventbase import OpenrEventBase
from openr_tpu_torch.utils.stepdetector import StepDetector, StepDetectorConfig


class SparkNeighState(enum.IntEnum):
    """reference: Spark.h:45-51."""

    IDLE = 0
    WARM = 1
    NEGOTIATE = 2
    ESTABLISHED = 3
    RESTART = 4


def _now_us() -> int:
    return int(time.monotonic() * 1_000_000)


@dataclass
class _Neighbor:
    node_name: str
    local_if: str
    state: SparkNeighState = SparkNeighState.IDLE
    remote_if: str = ""
    area: str = ""
    seq_num: int = 0
    # reflection bookkeeping for RTT
    last_their_sent_ts_us: int = 0
    last_my_rcvd_ts_us: int = 0
    rtt_us: int = 0
    hold_time_ms: int = 3000
    gr_time_ms: int = 30000
    transport_v6: BinaryAddress = field(default_factory=BinaryAddress)
    transport_v4: BinaryAddress = field(default_factory=BinaryAddress)
    ctrl_port: int = 2018
    kvstore_peer_port: int = 0
    hold_timer=None
    gr_timer=None
    rtt_detector: Optional[StepDetector] = None

    def to_info(self) -> SparkNeighbor:
        return SparkNeighbor(
            node_name=self.node_name,
            local_if_name=self.local_if,
            remote_if_name=self.remote_if,
            transport_address_v6=self.transport_v6,
            transport_address_v4=self.transport_v4,
            openr_ctrl_port=self.ctrl_port,
            kvstore_peer_port=self.kvstore_peer_port,
            area=self.area,
            rtt_us=self.rtt_us,
        )


class Spark:
    def __init__(
        self,
        my_node_name: str,
        io_provider: IoProvider,
        neighbor_updates_queue: ReplicateQueue,
        interface_updates_queue: Optional[ReplicateQueue] = None,
        area: str = "0",
        interface_areas: Optional[Dict[str, str]] = None,
        hello_interval_s: float = 0.5,
        fast_hello_interval_s: float = 0.05,
        handshake_interval_s: float = 0.05,
        heartbeat_interval_s: float = 0.2,
        hold_time_s: float = 1.5,
        graceful_restart_time_s: float = 10.0,
        ctrl_port: int = 2018,
        kvstore_peer_port: int = 0,
        v4_addr: Optional[BinaryAddress] = None,
        v6_addr: Optional[BinaryAddress] = None,
        wire_format: str = "native",
        domain: str = "openr",
    ):
        self.my_node_name = my_node_name
        self.area = area
        # border routers place interfaces in different areas (reference:
        # per-area interface regexes in OpenrConfig AreaConfig); unlisted
        # interfaces fall back to the default area
        self._interface_areas = dict(interface_areas or {})
        self.evb = OpenrEventBase(name=f"spark:{my_node_name}")
        self._io = io_provider
        self._neighbor_updates = neighbor_updates_queue
        self._hello_interval = hello_interval_s
        self._fast_hello_interval = fast_hello_interval_s
        self._handshake_interval = handshake_interval_s
        self._heartbeat_interval = heartbeat_interval_s
        self._hold_time_ms = int(hold_time_s * 1000)
        self._gr_time_ms = int(graceful_restart_time_s * 1000)
        self._ctrl_port = ctrl_port
        # advertised to neighbors in handshakes so they can dial our
        # KvStore peer server (reference: Spark.thrift:97 kvStoreCmdPort)
        self._kvstore_peer_port = kvstore_peer_port
        # "native" = the framework codec; "thrift" = the reference's
        # CompactProtocol SparkHelloPacket layout (spark/thrift_wire.py)
        # so stock Open/R neighbors on the LAN can parse our packets.
        # RECEIVE always accepts both (format sniffed by first byte) —
        # the reference's own dual-stack migration pattern.
        assert wire_format in ("native", "thrift"), wire_format
        self._wire_format = wire_format
        # rides thrift-wire hellos as domainName: a stock Open/R
        # neighbor drops hellos whose domain mismatches its own
        self._domain = domain
        self._v4 = v4_addr or BinaryAddress()
        self._v6 = v6_addr or BinaryAddress()
        # if_name -> {neighbor_node -> _Neighbor}
        self._tracked: Dict[str, Dict[str, _Neighbor]] = {}
        self._timers: Dict[str, list] = {}
        self._seq = 0
        self.counters: Dict[str, int] = {
            "spark.hello_sent": 0,
            "spark.hello_recv": 0,
            "spark.handshake_sent": 0,
            "spark.heartbeat_sent": 0,
            "spark.neighbor_up": 0,
            "spark.neighbor_down": 0,
            "spark.invalid_version": 0,
        }
        if interface_updates_queue is not None:
            self.evb.add_queue_reader(
                interface_updates_queue.get_reader(f"spark:{my_node_name}"),
                self._on_interface_updates,
            )

    def set_kvstore_peer_port(self, port: int) -> None:
        """Set the advertised peer port once the KvStore peer server has
        bound (an ephemeral bind resolves only after construction).
        Must be called before start()."""
        self._kvstore_peer_port = port

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.evb.run_in_thread()

    def stop(self, graceful_restart: bool = False) -> None:
        if graceful_restart:
            self.evb.call_and_wait(self._flood_restarting)
        self.evb.stop()
        self.evb.join()
        for if_name in list(self._tracked):
            self._io.detach(if_name)

    # -- interface management --------------------------------------------

    def area_for_interface(self, if_name: str) -> str:
        return self._interface_areas.get(if_name, self.area)

    def add_interface(self, if_name: str) -> None:
        self.evb.call_and_wait(lambda: self._add_interface(if_name))

    def remove_interface(self, if_name: str) -> None:
        self.evb.call_and_wait(lambda: self._remove_interface(if_name))

    def _on_interface_updates(self, if_db: InterfaceDatabase) -> None:
        """reference: Spark.cpp:1703 processInterfaceUpdates."""
        want = {
            name for name, info in if_db.interfaces.items() if info.is_up
        }
        have = set(self._tracked)
        for name in want - have:
            self._add_interface(name)
        for name in have - want:
            self._remove_interface(name)

    def _add_interface(self, if_name: str) -> None:
        if if_name in self._tracked:
            return
        self._tracked[if_name] = {}
        self._io.attach(
            if_name,
            lambda local_if, data: self.evb.run_in_event_base(
                lambda: self._process_packet(local_if, data)
            ),
        )
        hello = self.evb.schedule_periodic(
            self._fast_hello_interval,
            lambda: self._send_hello(if_name),
        )
        heartbeat = self.evb.schedule_periodic(
            self._heartbeat_interval,
            lambda: self._send_heartbeat(if_name),
            jitter_first=True,
        )
        self._timers[if_name] = [hello, heartbeat]
        self._send_hello(if_name, solicit=True)

    def _remove_interface(self, if_name: str) -> None:
        neighbors = self._tracked.pop(if_name, {})
        for timer in self._timers.pop(if_name, []):
            timer.cancel()
        self._io.detach(if_name)
        for neighbor in neighbors.values():
            if neighbor.state in (
                SparkNeighState.ESTABLISHED,
                SparkNeighState.RESTART,
            ):
                self._emit(SparkNeighborEventType.NEIGHBOR_DOWN, neighbor)

    # -- senders ----------------------------------------------------------

    def _send_hello(
        self, if_name: str, solicit: bool = False, restarting: bool = False
    ) -> None:
        if if_name not in self._tracked:
            return
        self._seq += 1
        infos = {}
        for name, neighbor in self._tracked[if_name].items():
            infos[name] = ReflectedNeighborInfo(
                seq_num=neighbor.seq_num,
                last_nbr_msg_sent_ts_us=neighbor.last_their_sent_ts_us,
                last_my_msg_rcvd_ts_us=neighbor.last_my_rcvd_ts_us,
            )
        msg = SparkHelloMsg(
            node_name=self.my_node_name,
            if_name=if_name,
            seq_num=self._seq,
            neighbor_infos=infos,
            solicit_response=solicit,
            restarting=restarting,
            sent_ts_us=_now_us(),
        )
        self._io.send(if_name, self._encode(SparkPacket(hello=msg)))
        self.counters["spark.hello_sent"] += 1

    def _send_handshake(self, if_name: str, to_neighbor: str) -> None:
        msg = SparkHandshakeMsg(
            node_name=self.my_node_name,
            if_name=if_name,
            is_adj_established=self._tracked.get(if_name, {})
            .get(to_neighbor, _Neighbor("", ""))
            .state
            == SparkNeighState.ESTABLISHED,
            hold_time_ms=self._hold_time_ms,
            graceful_restart_time_ms=self._gr_time_ms,
            transport_address_v6=self._v6,
            transport_address_v4=self._v4,
            openr_ctrl_port=self._ctrl_port,
            kvstore_peer_port=self._kvstore_peer_port,
            area=self.area_for_interface(if_name),
            neighbor_node_name=to_neighbor,
        )
        self._io.send(if_name, self._encode(SparkPacket(handshake=msg)))
        self.counters["spark.handshake_sent"] += 1

    def _send_heartbeat(self, if_name: str) -> None:
        if if_name not in self._tracked:
            return
        if not any(
            n.state == SparkNeighState.ESTABLISHED
            for n in self._tracked[if_name].values()
        ):
            return
        self._seq += 1
        msg = SparkHeartbeatMsg(
            node_name=self.my_node_name,
            if_name=if_name,
            seq_num=self._seq,
            hold_time_ms=self._hold_time_ms,
        )
        self._io.send(if_name, self._encode(SparkPacket(heartbeat=msg)))
        self.counters["spark.heartbeat_sent"] += 1

    def flood_restarting(self) -> None:
        """Announce graceful restart on every tracked interface without
        stopping (reference: OpenrCtrl floodRestartingMsg)."""
        self.evb.call_and_wait(self._flood_restarting)

    def _flood_restarting(self) -> None:
        """reference: Spark.h:92 floodRestartingMsg."""
        for if_name in self._tracked:
            self._send_hello(if_name, restarting=True)

    # -- receive path -----------------------------------------------------

    # lowest protocol version we interoperate with (reference:
    # Spark.cpp packet validation against kOpenrSupportedVersion)
    LOWEST_SUPPORTED_VERSION = 1

    def _encode(self, pkt: SparkPacket) -> bytes:
        if self._wire_format == "thrift":
            return thrift_wire.encode_packet(pkt, domain=self._domain)
        return wire.dumps(pkt)

    def _process_packet(self, if_name: str, data: bytes) -> None:
        """reference: Spark.cpp:1597 processPacket."""
        if if_name not in self._tracked:
            return
        try:
            if data and data[0] == thrift_wire.NATIVE_MARKER:
                packet = wire.loads(data, SparkPacket)
            else:
                packet = thrift_wire.decode_packet(data)
        except Exception:
            return
        if packet.version < self.LOWEST_SUPPORTED_VERSION:
            self.counters["spark.invalid_version"] += 1
            return
        if packet.hello is not None:
            self._process_hello(if_name, packet.hello)
        elif packet.handshake is not None:
            self._process_handshake(if_name, packet.handshake)
        elif packet.heartbeat is not None:
            self._process_heartbeat(if_name, packet.heartbeat)

    def _get_or_create(self, if_name: str, node: str) -> _Neighbor:
        neighbors = self._tracked[if_name]
        if node not in neighbors:
            neighbors[node] = _Neighbor(node_name=node, local_if=if_name)
        return neighbors[node]

    def _process_hello(self, if_name: str, msg: SparkHelloMsg) -> None:
        """reference: Spark.cpp:1175 processHelloMsg."""
        if msg.node_name == self.my_node_name:
            return  # our own multicast echo
        self.counters["spark.hello_recv"] += 1
        now_us = _now_us()
        neighbor = self._get_or_create(if_name, msg.node_name)
        neighbor.remote_if = msg.if_name
        neighbor.seq_num = msg.seq_num
        neighbor.last_their_sent_ts_us = msg.sent_ts_us
        neighbor.last_my_rcvd_ts_us = now_us

        if msg.restarting:
            if neighbor.state in (
                SparkNeighState.ESTABLISHED,
                SparkNeighState.RESTART,
            ):
                self._enter_restart(neighbor)
            return

        if neighbor.state == SparkNeighState.IDLE:
            neighbor.state = SparkNeighState.WARM

        they_hear_us = self.my_node_name in msg.neighbor_infos
        if they_hear_us:
            refl = msg.neighbor_infos[self.my_node_name]
            # 4-timestamp RTT: (t4 - t1) - (t3 - t2)
            if refl.last_nbr_msg_sent_ts_us and refl.last_my_msg_rcvd_ts_us:
                rtt = (now_us - refl.last_nbr_msg_sent_ts_us) - (
                    msg.sent_ts_us - refl.last_my_msg_rcvd_ts_us
                )
                if rtt > 0:
                    self._update_rtt(neighbor, rtt)
            if neighbor.state == SparkNeighState.WARM:
                neighbor.state = SparkNeighState.NEGOTIATE
                self._send_handshake(if_name, neighbor.node_name)
            elif neighbor.state == SparkNeighState.NEGOTIATE:
                self._send_handshake(if_name, neighbor.node_name)
            elif neighbor.state == SparkNeighState.RESTART:
                # neighbor came back from graceful restart
                neighbor.state = SparkNeighState.ESTABLISHED
                self._cancel_timer(neighbor, "gr_timer")
                self._refresh_hold(neighbor)
                self._emit(
                    SparkNeighborEventType.NEIGHBOR_RESTARTED, neighbor
                )
        elif msg.solicit_response:
            self._send_hello(if_name, solicit=False)

    def _process_handshake(self, if_name: str, msg: SparkHandshakeMsg) -> None:
        """reference: Spark.cpp:1419 processHandshakeMsg."""
        if msg.node_name == self.my_node_name:
            return
        if (
            msg.neighbor_node_name is not None
            and msg.neighbor_node_name != self.my_node_name
        ):
            return
        neighbor = self._get_or_create(if_name, msg.node_name)
        if msg.area != self.area_for_interface(if_name):
            return  # area mismatch: no adjacency
        if msg.if_name:
            # the thrift wire's handshake carries no interface name; the
            # hello-learned remote_if stands (reference: the remote
            # ifName only rides SparkHelloMsg)
            neighbor.remote_if = msg.if_name
        neighbor.area = msg.area
        neighbor.hold_time_ms = msg.hold_time_ms
        neighbor.gr_time_ms = msg.graceful_restart_time_ms
        neighbor.transport_v6 = msg.transport_address_v6
        neighbor.transport_v4 = msg.transport_address_v4
        neighbor.ctrl_port = msg.openr_ctrl_port
        neighbor.kvstore_peer_port = msg.kvstore_peer_port

        if neighbor.state in (
            SparkNeighState.WARM,
            SparkNeighState.NEGOTIATE,
        ):
            neighbor.state = SparkNeighState.ESTABLISHED
            self._refresh_hold(neighbor)
            self.counters["spark.neighbor_up"] += 1
            self._emit(SparkNeighborEventType.NEIGHBOR_UP, neighbor)
            if not msg.is_adj_established:
                # make sure the other side can establish too
                self._send_handshake(if_name, neighbor.node_name)
        elif neighbor.state == SparkNeighState.ESTABLISHED:
            self._refresh_hold(neighbor)
            if not msg.is_adj_established:
                # the other side restarted its negotiation: answer so it
                # can (re-)establish
                self._send_handshake(if_name, neighbor.node_name)

    def _process_heartbeat(self, if_name: str, msg: SparkHeartbeatMsg) -> None:
        """reference: Spark.cpp:1566 processHeartbeatMsg."""
        if msg.node_name == self.my_node_name:
            return
        neighbor = self._tracked[if_name].get(msg.node_name)
        if neighbor is None or neighbor.state != SparkNeighState.ESTABLISHED:
            return
        self._refresh_hold(neighbor)

    # -- helpers ----------------------------------------------------------

    def _update_rtt(self, neighbor: _Neighbor, rtt_us: int) -> None:
        if neighbor.rtt_detector is None:
            neighbor.rtt_us = rtt_us

            def on_step(new_mean: float, neighbor=neighbor) -> None:
                neighbor.rtt_us = int(new_mean)
                if neighbor.state == SparkNeighState.ESTABLISHED:
                    self._emit(
                        SparkNeighborEventType.NEIGHBOR_RTT_CHANGE, neighbor
                    )

            neighbor.rtt_detector = StepDetector(
                StepDetectorConfig(
                    fast_window_size=10,
                    slow_window_size=60,
                    lower_threshold=2.0,
                    upper_threshold=5.0,
                    abs_threshold=500,
                ),
                on_step,
            )
        neighbor.rtt_detector.add_value(float(rtt_us))

    def _refresh_hold(self, neighbor: _Neighbor) -> None:
        self._cancel_timer(neighbor, "hold_timer")
        neighbor.hold_timer = self.evb.schedule_timeout(
            neighbor.hold_time_ms / 1000.0,
            lambda: self._hold_expired(neighbor),
        )

    def _cancel_timer(self, neighbor: _Neighbor, attr: str) -> None:
        timer = getattr(neighbor, attr, None)
        if timer is not None:
            timer.cancel()
            setattr(neighbor, attr, None)

    def _hold_expired(self, neighbor: _Neighbor) -> None:
        if neighbor.state == SparkNeighState.ESTABLISHED:
            self._neighbor_down(neighbor)

    def _enter_restart(self, neighbor: _Neighbor) -> None:
        """Graceful restart: hold the adjacency for the GR window."""
        neighbor.state = SparkNeighState.RESTART
        self._cancel_timer(neighbor, "hold_timer")
        self._cancel_timer(neighbor, "gr_timer")
        neighbor.gr_timer = self.evb.schedule_timeout(
            neighbor.gr_time_ms / 1000.0,
            lambda: self._gr_expired(neighbor),
        )
        self._emit(SparkNeighborEventType.NEIGHBOR_RESTARTING, neighbor)

    def _gr_expired(self, neighbor: _Neighbor) -> None:
        if neighbor.state == SparkNeighState.RESTART:
            self._neighbor_down(neighbor)

    def _neighbor_down(self, neighbor: _Neighbor) -> None:
        self._cancel_timer(neighbor, "hold_timer")
        self._cancel_timer(neighbor, "gr_timer")
        neighbor.state = SparkNeighState.IDLE
        self.counters["spark.neighbor_down"] += 1
        self._emit(SparkNeighborEventType.NEIGHBOR_DOWN, neighbor)
        self._tracked.get(neighbor.local_if, {}).pop(neighbor.node_name, None)

    def _emit(self, event_type: SparkNeighborEventType, neighbor: _Neighbor):
        self._neighbor_updates.push(
            SparkNeighborEvent(
                event_type=event_type, neighbor=neighbor.to_info()
            )
        )

    # -- introspection ----------------------------------------------------

    def get_neighbors(self) -> Dict[str, Dict[str, SparkNeighState]]:
        return self.evb.call_and_wait(
            lambda: {
                if_name: {n: nb.state for n, nb in neighbors.items()}
                for if_name, neighbors in self._tracked.items()
            }
        )

    def get_counters(self) -> Dict[str, int]:
        return self.evb.call_and_wait(lambda: dict(self.counters))
