"""Network-layer value types.

Port note: a copy of ``openr_tpu/types/network.py``; nothing left out.

Schema parity with the reference IDL ``openr/if/Network.thrift`` (BinaryAddress,
IpPrefix, MplsAction, NextHopThrift, UnicastRoute, MplsRoute), re-expressed as
immutable Python dataclasses with canonical ordering/hashing so they can be
used in sets and sorted deterministically (the reference relies on
unordered_set + thrift comparators).
"""

from __future__ import annotations

import enum
import ipaddress
from dataclasses import dataclass, field
from typing import Optional, Tuple


class MplsActionCode(enum.IntEnum):
    # reference: openr/if/Network.thrift:27-33
    PUSH = 0
    SWAP = 1
    PHP = 2  # pen-ultimate hop popping: POP and FORWARD
    POP_AND_LOOKUP = 3
    NOOP = 4


class PrefixType(enum.IntEnum):
    # reference: openr/if/Network.thrift:104-119
    LOOPBACK = 1
    DEFAULT = 2
    BGP = 3
    PREFIX_ALLOCATOR = 4
    BREEZE = 5
    RIB = 6
    SLO_PREFIX_ALLOCATOR = 7
    TYPE_1 = 21
    TYPE_2 = 22
    TYPE_3 = 23
    TYPE_4 = 24
    TYPE_5 = 25


class AdminDistance(enum.IntEnum):
    # reference: openr/if/Network.thrift:18-25
    DIRECTLY_CONNECTED = 0
    STATIC_ROUTE = 1
    EBGP = 20
    IBGP = 200
    NETLINK_LISTENER = 225
    MAX_ADMIN_DISTANCE = 255


@dataclass(frozen=True, order=True)
class BinaryAddress:
    """An IP address as raw bytes, optionally scoped to an interface.

    reference: openr/if/Network.thrift:55-58
    """

    addr: bytes = b""
    if_name: Optional[str] = None

    @staticmethod
    def from_str(s: str, if_name: Optional[str] = None) -> "BinaryAddress":
        return BinaryAddress(addr=ipaddress.ip_address(s).packed, if_name=if_name)

    @property
    def is_v4(self) -> bool:
        return len(self.addr) == 4

    def to_str(self) -> str:
        if not self.addr:
            return ""
        return str(ipaddress.ip_address(self.addr))

    def __repr__(self) -> str:  # compact, operator friendly
        scope = f"%{self.if_name}" if self.if_name else ""
        return f"Addr({self.to_str()}{scope})"


@dataclass(frozen=True, order=True)
class IpPrefix:
    """reference: openr/if/Network.thrift:60-63"""

    prefix_address: BinaryAddress = field(default_factory=BinaryAddress)
    prefix_length: int = 0

    @staticmethod
    def from_str(s: str) -> "IpPrefix":
        net = ipaddress.ip_network(s, strict=False)
        return IpPrefix(
            prefix_address=BinaryAddress(addr=net.network_address.packed),
            prefix_length=net.prefixlen,
        )

    @property
    def is_v4(self) -> bool:
        return self.prefix_address.is_v4

    def to_str(self) -> str:
        return f"{self.prefix_address.to_str()}/{self.prefix_length}"

    def __repr__(self) -> str:
        return f"Prefix({self.to_str()})"


@dataclass(frozen=True)
class MplsAction:
    """reference: openr/if/Network.thrift:46-52

    ``push_labels``: index 0 is bottom-of-stack, last is top-of-stack.
    """

    action: MplsActionCode = MplsActionCode.NOOP
    swap_label: Optional[int] = None
    push_labels: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.push_labels is not None and not isinstance(self.push_labels, tuple):
            object.__setattr__(self, "push_labels", tuple(self.push_labels))

    def _key(self):
        return (int(self.action), self.swap_label or 0, self.push_labels or ())

    def __lt__(self, other: "MplsAction") -> bool:
        return self._key() < other._key()


@dataclass(frozen=True)
class NextHop:
    """A resolved next-hop: address + egress interface + cost (+MPLS action).

    reference: NextHopThrift, openr/if/Network.thrift:65-95
    """

    address: BinaryAddress = field(default_factory=BinaryAddress)
    weight: int = 0  # 0 == ECMP member
    mpls_action: Optional[MplsAction] = None
    metric: int = 0
    area: Optional[str] = None
    neighbor_node_name: Optional[str] = None

    def _key(self):
        return (
            self.address,
            self.weight,
            self.mpls_action._key() if self.mpls_action else (),
            self.metric,
            self.area or "",
            self.neighbor_node_name or "",
        )

    def __lt__(self, other: "NextHop") -> bool:
        return self._key() < other._key()


@dataclass(frozen=True)
class UnicastRoute:
    """reference: openr/if/Network.thrift:121-135"""

    dest: IpPrefix
    next_hops: Tuple[NextHop, ...] = ()
    admin_distance: Optional[AdminDistance] = None
    prefix_type: Optional[PrefixType] = None
    data: Optional[bytes] = None
    do_not_install: bool = False

    def __post_init__(self) -> None:
        # canonical next-hop ordering => byte-identical serialized routes
        object.__setattr__(
            self, "next_hops", tuple(sorted(self.next_hops, key=lambda n: n._key()))
        )


@dataclass(frozen=True)
class MplsRoute:
    """reference: openr/if/Network.thrift:97-101"""

    top_label: int
    next_hops: Tuple[NextHop, ...] = ()
    admin_distance: Optional[AdminDistance] = None

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "next_hops", tuple(sorted(self.next_hops, key=lambda n: n._key()))
        )
