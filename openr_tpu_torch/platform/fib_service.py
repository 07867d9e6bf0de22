"""FibService: the platform-agent RPC surface Fib programs routes into.

Interface parity with the reference thrift ``FibService``
(openr/if/Platform.thrift:171): per-client-id unicast/MPLS route
add/delete/sync plus liveness (aliveSince) so Fib can detect agent
restarts and trigger a full resync.

``MockFibAgent`` is the in-memory implementation used by tests
(reference: openr/tests/mocks/MockNetlinkFibHandler.{h,cpp}) with
injectable failures; the Linux netlink-backed implementation lives in
``openr_tpu/platform/netlink.py``.

Port note: a copy of ``openr_tpu/platform/fib_service.py``; nothing left
out. The netlink and thrift agents of the reference's ``platform/`` are not
ported: the port's Fib programs ``MockFibAgent`` (or any ``FibService``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from openr_tpu_torch.types import IpPrefix, MplsRoute, UnicastRoute


class FibAgentError(Exception):
    pass


class FibService:
    """Abstract platform agent interface."""

    def add_unicast_routes(
        self, client_id: int, routes: List[UnicastRoute]
    ) -> None:
        raise NotImplementedError

    def delete_unicast_routes(
        self, client_id: int, prefixes: List[IpPrefix]
    ) -> None:
        raise NotImplementedError

    def add_mpls_routes(self, client_id: int, routes: List[MplsRoute]) -> None:
        raise NotImplementedError

    def delete_mpls_routes(self, client_id: int, labels: List[int]) -> None:
        raise NotImplementedError

    def sync_fib(self, client_id: int, routes: List[UnicastRoute]) -> None:
        raise NotImplementedError

    def sync_mpls_fib(self, client_id: int, routes: List[MplsRoute]) -> None:
        raise NotImplementedError

    def get_route_table_by_client(self, client_id: int) -> List[UnicastRoute]:
        raise NotImplementedError

    def get_mpls_route_table_by_client(self, client_id: int) -> List[MplsRoute]:
        raise NotImplementedError

    def alive_since(self) -> int:
        raise NotImplementedError


class MockFibAgent(FibService):
    """In-memory FibService with failure injection for tests."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._unicast: Dict[int, Dict[IpPrefix, UnicastRoute]] = {}
        self._mpls: Dict[int, Dict[int, MplsRoute]] = {}
        self._alive_since = int(time.time())
        self.fail_requests = False
        self.counters = {
            "add_unicast": 0,
            "delete_unicast": 0,
            "add_mpls": 0,
            "delete_mpls": 0,
            "sync_fib": 0,
            "sync_mpls_fib": 0,
        }

    # -- test controls ----------------------------------------------------

    def restart(self) -> None:
        """Simulate agent restart: state wiped, aliveSince bumps."""
        with self._lock:
            self._unicast.clear()
            self._mpls.clear()
            self._alive_since = int(time.time() * 1000)  # strictly increases

    def set_fail(self, fail: bool) -> None:
        self.fail_requests = fail

    def _maybe_fail(self) -> None:
        if self.fail_requests:
            raise FibAgentError("injected failure")

    # -- FibService -------------------------------------------------------

    def add_unicast_routes(self, client_id, routes) -> None:
        self._maybe_fail()
        with self._lock:
            table = self._unicast.setdefault(client_id, {})
            for r in routes:
                table[r.dest] = r
            self.counters["add_unicast"] += len(routes)

    def delete_unicast_routes(self, client_id, prefixes) -> None:
        self._maybe_fail()
        with self._lock:
            table = self._unicast.setdefault(client_id, {})
            for p in prefixes:
                table.pop(p, None)
            self.counters["delete_unicast"] += len(prefixes)

    def add_mpls_routes(self, client_id, routes) -> None:
        self._maybe_fail()
        with self._lock:
            table = self._mpls.setdefault(client_id, {})
            for r in routes:
                table[r.top_label] = r
            self.counters["add_mpls"] += len(routes)

    def delete_mpls_routes(self, client_id, labels) -> None:
        self._maybe_fail()
        with self._lock:
            table = self._mpls.setdefault(client_id, {})
            for label in labels:
                table.pop(label, None)
            self.counters["delete_mpls"] += len(labels)

    def sync_fib(self, client_id, routes) -> None:
        self._maybe_fail()
        with self._lock:
            self._unicast[client_id] = {r.dest: r for r in routes}
            self.counters["sync_fib"] += 1

    def sync_mpls_fib(self, client_id, routes) -> None:
        self._maybe_fail()
        with self._lock:
            self._mpls[client_id] = {r.top_label: r for r in routes}
            self.counters["sync_mpls_fib"] += 1

    def get_route_table_by_client(self, client_id) -> List[UnicastRoute]:
        with self._lock:
            return sorted(
                self._unicast.get(client_id, {}).values(),
                key=lambda r: r.dest,
            )

    def get_mpls_route_table_by_client(self, client_id) -> List[MplsRoute]:
        with self._lock:
            return sorted(
                self._mpls.get(client_id, {}).values(),
                key=lambda r: r.top_label,
            )

    def alive_since(self) -> int:
        with self._lock:
            return self._alive_since
