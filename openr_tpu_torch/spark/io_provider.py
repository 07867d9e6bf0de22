"""IoProvider: the raw-packet I/O seam under Spark.

Behavioral parity with the reference ``openr/spark/IoProvider.h`` (socket
syscall virtualization) and ``openr/tests/mocks/MockIoProvider.{h,cpp}``
(simulated multicast LAN with per-pair latency and partition control) —
so many Spark instances can run in one process over a controlled fabric.

A UDP-multicast-backed implementation for real deployments lives in
``UdpIoProvider`` (ff02::1-style iface-scoped multicast; reference:
Constants.h:136,263 port 6666).

Port note: a copy of ``openr_tpu/spark/io_provider.py``; nothing left out.
``UdpIoProvider`` comes along; nothing in the port uses it until the
process entry point is ported.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

# callback(local_if_name, payload_bytes)
RecvCallback = Callable[[str, bytes], None]


class IoProvider:
    def attach(self, if_name: str, callback: RecvCallback) -> None:
        """Open the interface for send/recv; deliver inbound packets to
        callback (from the provider's thread)."""
        raise NotImplementedError

    def detach(self, if_name: str) -> None:
        raise NotImplementedError

    def send(self, if_name: str, payload: bytes) -> None:
        """Multicast payload out of if_name."""
        raise NotImplementedError


class MockIoProvider(IoProvider):
    """Simulated LAN: packets sent on an iface are delivered to every
    connected iface after the configured latency.
    reference: tests/mocks/MockIoProvider.h:41."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # if_name -> [(peer_if_name, latency_ms)]
        self._connected: Dict[str, List[Tuple[str, int]]] = defaultdict(list)
        self._endpoints: Dict[str, RecvCallback] = {}
        self._partitioned: set = set()
        # (deliver_at_monotonic, seq, dst_if, payload)
        self._mailbox: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = 0
        self._running = True
        self._thread = threading.Thread(
            target=self._process_mailboxes, name="mock-io", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._thread.join(timeout=2)

    # -- topology control (test API) --------------------------------------

    def set_connected_pairs(
        self, pairs: Dict[str, List[Tuple[str, int]]]
    ) -> None:
        """reference: MockIoProvider.h:83 setConnectedPairs."""
        with self._lock:
            self._connected = defaultdict(list, {
                k: list(v) for k, v in pairs.items()
            })

    def connect_pair(self, if_a: str, if_b: str, latency_ms: int = 1) -> None:
        with self._lock:
            self._connected[if_a].append((if_b, latency_ms))
            self._connected[if_b].append((if_a, latency_ms))

    def connect_one_way(
        self, if_from: str, if_to: str, latency_ms: int = 1
    ) -> None:
        """Unidirectional connectivity (the reference's ConnectedIfPairs
        is directional too): packets flow if_from -> if_to only — a
        broken-cable / asymmetric-filter scenario."""
        with self._lock:
            self._connected[if_from].append((if_to, latency_ms))

    def partition(self, if_name: str) -> None:
        """Drop all packets to/from if_name (link cut)."""
        with self._lock:
            self._partitioned.add(if_name)

    def heal(self, if_name: str) -> None:
        with self._lock:
            self._partitioned.discard(if_name)

    # -- IoProvider -------------------------------------------------------

    def attach(self, if_name: str, callback: RecvCallback) -> None:
        with self._lock:
            self._endpoints[if_name] = callback

    def detach(self, if_name: str) -> None:
        with self._lock:
            self._endpoints.pop(if_name, None)

    def send(self, if_name: str, payload: bytes) -> None:
        with self._lock:
            if if_name in self._partitioned:
                return
            peers = list(self._connected.get(if_name, ()))
            self._seq += 1
            seq = self._seq
        now = time.monotonic()
        for peer_if, latency_ms in peers:
            self._mailbox.put(
                (now + latency_ms / 1000.0, seq, peer_if, payload)
            )

    # -- delivery loop ----------------------------------------------------

    def _process_mailboxes(self) -> None:
        """reference: MockIoProvider.h:78 processMailboxes."""
        while self._running:
            try:
                deliver_at, seq, dst_if, payload = self._mailbox.get(
                    timeout=0.1
                )
            except queue.Empty:
                continue
            delay = deliver_at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            with self._lock:
                if dst_if in self._partitioned:
                    continue
                cb = self._endpoints.get(dst_if)
            if cb is not None:
                try:
                    cb(dst_if, payload)
                except Exception:
                    pass


class UdpIoProvider(IoProvider):
    """Link-local UDP multicast transport for real multi-host deployment
    (one socket per interface, mcast group + port as in the reference)."""

    MCAST_GROUP = "ff02::1"

    def __init__(self, port: int = 6666):
        self._port = port
        self._socks: Dict[str, socket.socket] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._running = True

    def attach(self, if_name: str, callback: RecvCallback) -> None:
        if_index = socket.if_nametoindex(if_name)
        sock = socket.socket(socket.AF_INET6, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("::", self._port))
        group = socket.inet_pton(socket.AF_INET6, self.MCAST_GROUP)
        mreq = group + if_index.to_bytes(4, "little")
        sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_JOIN_GROUP, mreq)
        sock.setsockopt(
            socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_IF, if_index
        )
        sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_LOOP, 0)
        sock.settimeout(0.2)
        self._socks[if_name] = sock

        def recv_loop() -> None:
            while self._running and if_name in self._socks:
                try:
                    data, _ = sock.recvfrom(65535)
                except socket.timeout:
                    continue
                except OSError:
                    return
                callback(if_name, data)

        t = threading.Thread(
            target=recv_loop, name=f"udp-io:{if_name}", daemon=True
        )
        t.start()
        self._threads[if_name] = t

    def detach(self, if_name: str) -> None:
        sock = self._socks.pop(if_name, None)
        if sock is not None:
            sock.close()

    def send(self, if_name: str, payload: bytes) -> None:
        sock = self._socks.get(if_name)
        if sock is not None:
            sock.sendto(payload, (self.MCAST_GROUP, self._port))
