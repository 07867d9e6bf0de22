"""Netlink layer: kernel interface/address/route access.

Interface parity with the reference ``openr/nl/NetlinkProtocolSocket.h``
(get_all_links / add_route / delete_route + event publication) with a
mock in-memory kernel for tests
(reference: openr/tests/mocks/MockNetlinkProtocolSocket.{h,cpp}).

The real Linux implementation (AF_NETLINK rtnetlink socket) is provided
in ``LinuxNetlinkSocket`` guarded by platform availability; everything
above it (LinkMonitor, Fib handler) only sees this interface.

Port note: a copy of ``openr_tpu/platform/netlink.py``; nothing left out.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.types import IpPrefix, UnicastRoute


class NetlinkError(OSError):
    """Kernel (or mock) rejected a netlink operation; errno carried."""


@dataclass
class NlLink:
    """reference: fbnl::Link (openr/nl/NetlinkTypes.h)."""

    if_name: str
    if_index: int
    is_up: bool = True
    addresses: Tuple[IpPrefix, ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.addresses, tuple):
            self.addresses = tuple(self.addresses)


@dataclass(frozen=True)
class NlNeighbor:
    """Kernel neighbor-table (ARP/NDP) entry.
    reference: fbnl::Neighbor (openr/nl/NetlinkTypes.h:1-632)."""

    if_index: int
    destination: IpPrefix  # host address of the neighbor
    link_address: bytes = b""  # MAC, empty when not yet resolved
    state: int = 0  # NUD_* bitmask
    is_reachable: bool = False


# NUD_* neighbor states (linux/neighbour.h)
NUD_INCOMPLETE = 0x01
NUD_REACHABLE = 0x02
NUD_STALE = 0x04
NUD_DELAY = 0x08
NUD_PROBE = 0x10
NUD_FAILED = 0x20
NUD_NOARP = 0x40
NUD_PERMANENT = 0x80
# states the reference treats as usable
NUD_VALID = (
    NUD_PERMANENT | NUD_NOARP | NUD_REACHABLE | NUD_PROBE
    | NUD_STALE | NUD_DELAY
)


class NetlinkEventType(enum.IntEnum):
    LINK = 1
    ADDRESS = 2
    NEIGHBOR = 3
    ROUTE = 4


@dataclass
class NetlinkEvent:
    event_type: NetlinkEventType
    # set ONLY for LINK events — LinkMonitor treats a non-None link as
    # an interface state change, so ADDRESS/ROUTE events must not
    # fabricate one (their payload rides prefix/if_index)
    link: Optional[NlLink] = None
    neighbor: Optional[NlNeighbor] = None
    # ADDRESS: the touched prefix; ROUTE: the route's destination
    prefix: Optional[IpPrefix] = None
    if_index: int = 0
    deleted: bool = False


class NetlinkProtocolSocket:
    """Abstract kernel access interface.
    reference surface: openr/nl/NetlinkProtocolSocket.h:96-196 (routes,
    MPLS label routes, links, addresses, neighbors, event fan-out)."""

    def get_all_links(self) -> List[NlLink]:
        raise NotImplementedError

    def add_route(self, route: UnicastRoute) -> None:
        raise NotImplementedError

    def delete_route(self, prefix: IpPrefix) -> None:
        raise NotImplementedError

    def get_all_routes(self) -> List[UnicastRoute]:
        raise NotImplementedError

    def add_ifaddress(self, if_name: str, prefix: IpPrefix) -> None:
        raise NotImplementedError

    def del_ifaddress(self, if_name: str, prefix: IpPrefix) -> None:
        raise NotImplementedError

    def get_ifaddresses(self, if_name: str) -> List[IpPrefix]:
        raise NotImplementedError

    def get_all_neighbors(self) -> List[NlNeighbor]:
        raise NotImplementedError

    def add_mpls_route(self, route) -> None:
        """Program one MPLS label route (types.MplsRoute): top_label ->
        next hops whose mpls_action is SWAP/PHP/POP_AND_LOOKUP.
        reference: nl/NetlinkProtocolSocket.h:131 addRoute(label)."""
        raise NotImplementedError

    def delete_mpls_route(self, label: int) -> None:
        raise NotImplementedError

    def get_all_mpls_routes(self) -> List:
        raise NotImplementedError


class MockNetlinkProtocolSocket(NetlinkProtocolSocket):
    """In-memory kernel with event injection
    (reference: tests/mocks/MockNetlinkProtocolSocket.h +
    NetlinkEventsInjector)."""

    def __init__(self, events_queue: Optional[ReplicateQueue] = None):
        self.events_queue = events_queue or ReplicateQueue(name="netlinkEvents")
        self._lock = threading.Lock()
        self._links: Dict[str, NlLink] = {}
        self._routes: Dict[IpPrefix, UnicastRoute] = {}
        self._neighbors: Dict[Tuple[int, IpPrefix], NlNeighbor] = {}
        self._mpls: Dict[int, object] = {}
        self._next_index = 1

    # -- neighbor-table injection (reference:
    # tests/mocks/NetlinkEventsInjector) --------------------------------

    def _link_or_raise(self, if_name: str) -> NlLink:
        link = self._links.get(if_name)
        if link is None:
            raise NetlinkError(19, f"no such link {if_name}")
        return link

    def set_neighbor(
        self,
        if_name: str,
        destination: IpPrefix,
        link_address: bytes = b"",
        state: int = NUD_REACHABLE,
    ) -> NlNeighbor:
        with self._lock:
            link = self._link_or_raise(if_name)
            nbr = NlNeighbor(
                if_index=link.if_index,
                destination=destination,
                link_address=link_address,
                state=state,
                is_reachable=bool(state & NUD_VALID),
            )
            self._neighbors[(link.if_index, destination)] = nbr
        self.events_queue.push(
            NetlinkEvent(
                event_type=NetlinkEventType.NEIGHBOR, neighbor=nbr
            )
        )
        return nbr

    def del_neighbor(self, if_name: str, destination: IpPrefix) -> None:
        with self._lock:
            link = self._link_or_raise(if_name)
            nbr = self._neighbors.pop((link.if_index, destination), None)
        if nbr is not None:
            self.events_queue.push(
                NetlinkEvent(
                    event_type=NetlinkEventType.NEIGHBOR,
                    neighbor=nbr,
                    deleted=True,
                )
            )

    # -- test injection ---------------------------------------------------

    def add_link(
        self, if_name: str, is_up: bool = True, addresses: Tuple = ()
    ) -> NlLink:
        with self._lock:
            link = NlLink(
                if_name=if_name,
                if_index=self._next_index,
                is_up=is_up,
                addresses=tuple(addresses),
            )
            self._next_index += 1
            self._links[if_name] = link
        self.events_queue.push(
            NetlinkEvent(event_type=NetlinkEventType.LINK, link=link)
        )
        return link

    def set_link_state(self, if_name: str, is_up: bool) -> None:
        with self._lock:
            link = self._links[if_name]
            link.is_up = is_up
        self.events_queue.push(
            NetlinkEvent(event_type=NetlinkEventType.LINK, link=link)
        )

    # -- NetlinkProtocolSocket -------------------------------------------

    def get_all_links(self) -> List[NlLink]:
        with self._lock:
            return list(self._links.values())

    def add_route(self, route: UnicastRoute) -> None:
        with self._lock:
            self._routes[route.dest] = route
        self.events_queue.push(
            NetlinkEvent(
                event_type=NetlinkEventType.ROUTE, prefix=route.dest
            )
        )

    def delete_route(self, prefix: IpPrefix) -> None:
        with self._lock:
            existed = self._routes.pop(prefix, None) is not None
        if existed:
            self.events_queue.push(
                NetlinkEvent(
                    event_type=NetlinkEventType.ROUTE,
                    prefix=prefix,
                    deleted=True,
                )
            )

    def get_all_routes(self) -> List[UnicastRoute]:
        with self._lock:
            return sorted(self._routes.values(), key=lambda r: r.dest)

    def add_ifaddress(self, if_name: str, prefix: IpPrefix) -> None:
        with self._lock:
            link = self._links[if_name]
            link.addresses = tuple(link.addresses) + (prefix,)
        self.events_queue.push(
            NetlinkEvent(event_type=NetlinkEventType.ADDRESS, link=link)
        )

    def del_ifaddress(self, if_name: str, prefix: IpPrefix) -> None:
        with self._lock:
            link = self._links[if_name]
            link.addresses = tuple(
                a for a in link.addresses if a != prefix
            )
        self.events_queue.push(
            NetlinkEvent(event_type=NetlinkEventType.ADDRESS, link=link)
        )

    def get_ifaddresses(self, if_name: str) -> List[IpPrefix]:
        with self._lock:
            link = self._links.get(if_name)
            if link is None:
                raise NetlinkError(19, f"no such link {if_name}")
            return list(link.addresses)

    def get_all_neighbors(self) -> List[NlNeighbor]:
        with self._lock:
            return sorted(
                self._neighbors.values(),
                key=lambda n: (n.if_index, n.destination),
            )

    def add_mpls_route(self, route) -> None:
        with self._lock:
            self._mpls[route.top_label] = route

    def delete_mpls_route(self, label: int) -> None:
        with self._lock:
            self._mpls.pop(label, None)

    def get_all_mpls_routes(self) -> List:
        with self._lock:
            return sorted(
                self._mpls.values(), key=lambda r: r.top_label
            )
