"""BGP peering configuration schema.

Models the reference's ``openr/if/BgpConfig.thrift`` (261 lines:
BgpPeerTimers:13, RouteLimit:22, AdvertiseLinkBandwidth:37, AddPath:49,
PeerGroup:56, BgpPeer:99, BgpConfig:211) as typed dataclasses with
constructor validation, JSON parsing, and the reference's peer-group
overlay semantics ("Peer Group name. peer config overwrites peer group
config", BgpConfig.thrift:201-203).

A registered plugin always starts with the daemon (the hook doubles as
the generic extension point, so non-BGP plugins exist); a BGP speaker
plugin receives this section through ``PluginArgs.bgp_config`` — None
when peering is disabled, so speakers must check before peering. The
reference instead gates ``pluginStart`` itself on BGP peering
(Main.cpp:595-601) because its plugin slot is BGP-only; the daemon
mirrors that intent by warning when peering is configured but no
plugin is registered to speak it (main.py).

Port note: a copy of ``openr_tpu/config/bgp_config.py``; nothing left out.
"""

from __future__ import annotations

import enum
import ipaddress
from dataclasses import dataclass, field, fields, replace
from typing import Dict, List, Optional


class BgpConfigError(ValueError):
    pass


class AdvertiseLinkBandwidth(enum.IntEnum):
    """reference: BgpConfig.thrift:37-40."""

    NONE = 0
    AGGREGATE = 1


class AddPath(enum.IntEnum):
    """reference: BgpConfig.thrift:49-54."""

    NONE = 0
    RECEIVE = 1
    SEND = 2
    BOTH = 3


@dataclass(frozen=True)
class BgpPeerTimers:
    """reference: BgpConfig.thrift:13-20."""

    hold_time_seconds: int = 30
    keep_alive_seconds: int = 10
    out_delay_seconds: int = 0
    withdraw_unprog_delay_seconds: int = 0
    graceful_restart_seconds: Optional[int] = None
    graceful_restart_end_of_rib_seconds: Optional[int] = None

    def validate(self) -> None:
        if self.hold_time_seconds and self.keep_alive_seconds:
            if self.hold_time_seconds < 3 * self.keep_alive_seconds:
                raise BgpConfigError(
                    "bgp hold_time must be >= 3x keep_alive "
                    f"({self.hold_time_seconds} < "
                    f"3*{self.keep_alive_seconds})"
                )


@dataclass(frozen=True)
class RouteLimit:
    """reference: BgpConfig.thrift:22-29."""

    max_routes: int = 12000
    warning_only: bool = False
    warning_limit: int = 0


@dataclass(frozen=True)
class PeerGroup:
    """Shared defaults a peer can inherit by name.
    reference: BgpConfig.thrift:56-93."""

    name: str = ""
    description: Optional[str] = None
    remote_as: Optional[int] = None
    local_addr: Optional[str] = None
    next_hop4: Optional[str] = None
    next_hop6: Optional[str] = None
    enabled: Optional[bool] = None
    router_port_id: Optional[int] = None
    is_passive: Optional[bool] = None
    is_confed_peer: Optional[bool] = None
    is_rr_client: Optional[bool] = None
    next_hop_self: Optional[bool] = None
    remove_private_as: Optional[bool] = None
    disable_ipv4_afi: Optional[bool] = None
    disable_ipv6_afi: Optional[bool] = None
    bgp_peer_timers: Optional[BgpPeerTimers] = None
    peer_tag: Optional[str] = None
    local_as: Optional[int] = None
    advertise_link_bandwidth: Optional[AdvertiseLinkBandwidth] = None
    pre_filter: Optional[RouteLimit] = None
    post_filter: Optional[RouteLimit] = None
    enable_stateful_ha: Optional[bool] = None
    add_path: Optional[AddPath] = None


@dataclass(frozen=True)
class BgpPeer:
    """One BGP session.
    reference: BgpConfig.thrift:99-208 (field ids in comments there)."""

    peer_addr: str = ""  # address, or prefix for passive listen ranges
    remote_as: Optional[int] = None
    local_addr: Optional[str] = None
    next_hop4: Optional[str] = None
    next_hop6: Optional[str] = None
    description: Optional[str] = None
    is_passive: Optional[bool] = None
    is_confed_peer: Optional[bool] = None
    type: Optional[str] = None
    peer_id: Optional[str] = None
    is_rr_client: Optional[bool] = None
    peer_tag: Optional[str] = None
    next_hop_self: Optional[bool] = None
    disable_ipv4_afi: Optional[bool] = None
    disable_ipv6_afi: Optional[bool] = None
    router_port_id: Optional[int] = None
    bgp_peer_timers: Optional[BgpPeerTimers] = None
    enabled: Optional[bool] = None
    remove_private_as: Optional[bool] = None
    local_as: Optional[int] = None
    advertise_link_bandwidth: Optional[AdvertiseLinkBandwidth] = None
    pre_filter: Optional[RouteLimit] = None
    post_filter: Optional[RouteLimit] = None
    enable_stateful_ha: Optional[bool] = None
    peer_group_name: Optional[str] = None
    add_path: Optional[AddPath] = None

    def validate(self) -> None:
        if not self.peer_addr:
            raise BgpConfigError("bgp peer needs peer_addr")
        addr = self.peer_addr.split("/")[0]
        try:
            ipaddress.ip_address(addr)
        except ValueError as exc:
            raise BgpConfigError(
                f"bad bgp peer_addr {self.peer_addr!r}: {exc}"
            ) from exc
        if "/" in self.peer_addr and not self.is_passive:
            raise BgpConfigError(
                f"prefix peer_addr {self.peer_addr!r} only works for "
                "passive listening sessions (BgpConfig.thrift:108-112)"
            )
        if self.bgp_peer_timers is not None:
            self.bgp_peer_timers.validate()


# PeerGroup attributes a peer may inherit (everything shared by name)
_OVERLAY_FIELDS = tuple(
    f.name
    for f in fields(PeerGroup)
    if f.name not in ("name", "description")
)


def resolve_peer(peer: BgpPeer, groups: Dict[str, PeerGroup]) -> BgpPeer:
    """Overlay semantics: start from the named peer group's values, then
    let every explicitly-set peer field win (reference:
    BgpConfig.thrift:201 'peer config overwrites peer group config')."""
    if peer.peer_group_name is None:
        return peer
    group = groups.get(peer.peer_group_name)
    if group is None:
        raise BgpConfigError(
            f"peer {peer.peer_addr} names unknown peer group "
            f"{peer.peer_group_name!r}"
        )
    merged = {}
    for name in _OVERLAY_FIELDS:
        if getattr(peer, name) is None:
            inherited = getattr(group, name)
            if inherited is not None:
                merged[name] = inherited
    return replace(peer, **merged) if merged else peer


@dataclass(frozen=True)
class BgpConfig:
    """reference: BgpConfig.thrift:211-261."""

    router_id: str = ""
    local_as: int = 0
    peers: List[BgpPeer] = field(default_factory=list)
    hold_time: int = 30
    listen_port: int = 179
    local_confed_as: Optional[int] = None
    listen_addr: str = "::"
    cold_start_convergence_seconds: Optional[int] = None
    graceful_restart_convergence_seconds: Optional[int] = None
    peer_groups: List[PeerGroup] = field(default_factory=list)
    compute_ucmp_from_link_bandwidth_community: Optional[bool] = None
    eor_time_s: int = 45

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        if not self.router_id:
            raise BgpConfigError("bgp config needs router_id")
        try:
            ipaddress.ip_address(self.router_id)
        except ValueError as exc:
            raise BgpConfigError(
                f"bad router_id {self.router_id!r}: {exc}"
            ) from exc
        if not (0 < self.local_as < 2 ** 32):
            raise BgpConfigError(f"bad local_as {self.local_as}")
        if not (0 < self.listen_port < 65536):
            raise BgpConfigError(f"bad listen_port {self.listen_port}")
        names = [g.name for g in self.peer_groups]
        if len(names) != len(set(names)):
            raise BgpConfigError("duplicate peer group names")
        groups = {g.name: g for g in self.peer_groups}
        seen = set()
        for peer in self.peers:
            if peer.peer_addr in seen:
                raise BgpConfigError(
                    f"duplicate bgp peer {peer.peer_addr}"
                )
            seen.add(peer.peer_addr)
            resolved = resolve_peer(peer, groups)
            resolved.validate()
            if resolved.remote_as is None:
                raise BgpConfigError(
                    f"peer {peer.peer_addr} has no remote_as (directly "
                    "or via its peer group)"
                )

    def resolved_peers(self) -> List[BgpPeer]:
        """Peers with their peer-group overlays applied."""
        groups = {g.name: g for g in self.peer_groups}
        return [resolve_peer(p, groups) for p in self.peers]

    # -- parsing -----------------------------------------------------------

    @staticmethod
    def from_dict(data: Dict) -> "BgpConfig":
        kwargs = dict(data)

        def build_timers(v):
            return BgpPeerTimers(**v) if isinstance(v, dict) else v

        def build_limit(v):
            return RouteLimit(**v) if isinstance(v, dict) else v

        def build_enum(cls, v):
            return cls[v] if isinstance(v, str) else (
                cls(v) if v is not None else None
            )

        def build_common(d: Dict) -> Dict:
            d = dict(d)
            if "bgp_peer_timers" in d:
                d["bgp_peer_timers"] = build_timers(d["bgp_peer_timers"])
            for key in ("pre_filter", "post_filter"):
                if key in d:
                    d[key] = build_limit(d[key])
            if "advertise_link_bandwidth" in d:
                d["advertise_link_bandwidth"] = build_enum(
                    AdvertiseLinkBandwidth, d["advertise_link_bandwidth"]
                )
            if "add_path" in d:
                d["add_path"] = build_enum(AddPath, d["add_path"])
            return d

        if "peers" in kwargs:
            kwargs["peers"] = [
                BgpPeer(**build_common(p)) for p in kwargs["peers"]
            ]
        if "peer_groups" in kwargs:
            kwargs["peer_groups"] = [
                PeerGroup(**build_common(g))
                for g in kwargs["peer_groups"]
            ]
        return BgpConfig(**kwargs)
