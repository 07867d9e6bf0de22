"""Typed daemon configuration.

Behavioral parity with the reference config layer
(``openr/if/OpenrConfig.thrift`` + ``openr/config/Config.h:34``): a typed
config struct parsed from JSON with constructor-time validation and
feature-flag helper accessors, passed immutably to every module. The
legacy-flag translation path (reference: GflagConfig,
openr/config/GflagConfig.h) is ``OpenrConfig.from_flags``, fed in the
reference by the argparse surface of its ``main.py`` (not ported yet).

Port note: a copy of ``openr_tpu/config/config.py``; nothing left out.
``enable_solver_mesh`` is kept so that configurations round-trip; the
port's daemon reads nothing of it (multi-device is not ported).
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from openr_tpu_torch.config.bgp_config import BgpConfig
from openr_tpu_torch.types.lsdb import PrefixForwardingAlgorithm, PrefixForwardingType


class ConfigError(ValueError):
    pass


@dataclass
class AreaConfig:
    """reference: OpenrConfig.thrift AreaConfig."""

    area_id: str = "0"
    neighbor_regexes: List[str] = field(default_factory=lambda: [".*"])
    include_interface_regexes: List[str] = field(default_factory=lambda: [".*"])
    exclude_interface_regexes: List[str] = field(default_factory=list)

    def matches_neighbor(self, node_name: str) -> bool:
        return any(re.fullmatch(rx, node_name) for rx in self.neighbor_regexes)

    def matches_interface(self, if_name: str) -> bool:
        if any(
            re.fullmatch(rx, if_name) for rx in self.exclude_interface_regexes
        ):
            return False
        return any(
            re.fullmatch(rx, if_name) for rx in self.include_interface_regexes
        )


@dataclass
class SparkConfig:
    """reference: OpenrConfig.thrift SparkConfig."""

    hello_time_s: float = 20.0
    fastinit_hello_time_ms: int = 500
    handshake_time_ms: int = 500
    keepalive_time_s: float = 2.0
    hold_time_s: float = 10.0
    graceful_restart_time_s: float = 30.0
    mcast_port: int = 6666  # reference: Flags.cpp spark_mcast_port
    # "native" (framework codec) or "thrift" (the reference's
    # CompactProtocol SparkHelloPacket layout — interop with stock
    # Open/R neighbors on the LAN); receive always accepts both
    wire_format: str = "native"

    def validate(self) -> None:
        if self.wire_format not in ("native", "thrift"):
            raise ConfigError(
                f"spark wire_format must be native|thrift, got "
                f"{self.wire_format!r}"
            )
        if self.hold_time_s < 3 * self.keepalive_time_s:
            raise ConfigError(
                "spark hold_time must be >= 3x keepalive_time"
            )
        if self.graceful_restart_time_s < 3 * self.keepalive_time_s:
            raise ConfigError(
                "spark graceful_restart_time must be >= 3x keepalive_time"
            )


@dataclass
class KvStoreConfig:
    """reference: OpenrConfig.thrift KvstoreConfig."""

    key_ttl_ms: int = 300_000
    sync_interval_s: float = 60.0
    ttl_decrement_ms: int = 1
    enable_flood_optimization: bool = False
    is_flood_root: bool = False
    # reference: KvstoreFloodRate (0 = unlimited)
    flood_msg_per_sec: int = 0
    flood_msg_burst_size: int = 0
    # cross-process peer sync: TCP port the peer server binds (0 =
    # ephemeral; reference: Constants.h:257 kvstore port 60002) and
    # the wire spoken on it — the framework's own RPC codec, or thrift
    # framed CompactProtocol for interop with stock Open/R peers
    # (reference dual-stack flag: enable_kvstore_thrift,
    # KvStore.cpp:2940-2973)
    peer_port: int = 60002
    enable_kvstore_thrift: bool = False

    def flood_rate(self):
        if self.flood_msg_per_sec > 0 and self.flood_msg_burst_size > 0:
            return (float(self.flood_msg_per_sec),
                    self.flood_msg_burst_size)
        return None


@dataclass
class DecisionConfig:
    """reference: OpenrConfig.thrift DecisionConfig."""

    debounce_min_ms: int = 10
    debounce_max_ms: int = 250
    # reference default: true (Flags.cpp:39)
    enable_bgp_route_programming: bool = True


@dataclass
class LinkMonitorConfig:
    """reference: OpenrConfig.thrift LinkMonitorConfig."""

    linkflap_initial_backoff_ms: int = 60_000
    linkflap_max_backoff_ms: int = 300_000
    use_rtt_metric: bool = False


@dataclass
class WatchdogConfig:
    interval_s: float = 20.0
    thread_timeout_s: float = 300.0
    max_memory_mb: int = 800


@dataclass
class PrefixAllocationConfig:
    """reference: OpenrConfig.thrift PrefixAllocationConfig +
    Flags.cpp enable_prefix_alloc/seed_prefix/alloc_prefix_len/
    static_prefix_alloc/set_loopback_address/loopback_iface."""

    enabled: bool = False
    # "" means dynamic leaf mode: params learned from the
    # e2e-network-prefix KvStore key
    seed_prefix: str = ""
    alloc_prefix_len: int = 64
    static_allocation: bool = False
    set_loopback_addr: bool = False
    loopback_iface: str = "lo"

    def validate(self) -> None:
        if not self.enabled or self.static_allocation:
            return
        if self.seed_prefix:
            from openr_tpu_torch.types import IpPrefix

            try:
                seed = IpPrefix.from_str(self.seed_prefix)
            except Exception as e:
                raise ConfigError(
                    f"bad seed_prefix {self.seed_prefix!r}: {e}"
                ) from e
            if self.alloc_prefix_len < seed.prefix_length:
                raise ConfigError(
                    "alloc_prefix_len shorter than the seed prefix"
                )
            addr_bits = 8 * len(seed.prefix_address.addr)
            if self.alloc_prefix_len > addr_bits:
                raise ConfigError(
                    f"alloc_prefix_len /{self.alloc_prefix_len} exceeds "
                    f"the seed's {addr_bits}-bit address width"
                )


@dataclass
class OpenrConfig:
    """reference: OpenrConfig.thrift OpenrConfig (314 lines)."""

    node_name: str = ""
    domain: str = "openr"
    areas: List[AreaConfig] = field(default_factory=lambda: [AreaConfig()])
    listen_addr: str = "::"
    openr_ctrl_port: int = 2018
    dryrun: bool = False
    enable_v4: bool = False
    enable_netlink_fib_handler: bool = False
    enable_ordered_fib_programming: bool = False
    enable_best_route_selection: bool = True
    enable_kvstore_request_queue: bool = False
    enable_watchdog: bool = True
    enable_lfa: bool = False
    # reference default: disabled (Flags.cpp enable_rib_policy)
    enable_rib_policy: bool = False
    # SR node-label election via per-area RangeAllocator when no static
    # node_label is configured (reference: Flags.cpp
    # enable_segment_routing + LinkMonitor.cpp:171)
    enable_segment_routing: bool = False
    prefix_forwarding_type: PrefixForwardingType = PrefixForwardingType.IP
    prefix_forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    )
    per_prefix_keys: bool = True
    spark: SparkConfig = field(default_factory=SparkConfig)
    kvstore: KvStoreConfig = field(default_factory=KvStoreConfig)
    decision: DecisionConfig = field(default_factory=DecisionConfig)
    link_monitor: LinkMonitorConfig = field(default_factory=LinkMonitorConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    prefix_alloc: PrefixAllocationConfig = field(
        default_factory=PrefixAllocationConfig
    )
    persistent_store_path: str = "/tmp/openr_tpu_persistent_store.bin"
    node_label: int = 0
    solver_backend: str = "device"
    # shard the KSP2 engine's resident all-pairs state over ALL local
    # devices (ksp2_engine.set_engine_mesh at daemon start): the
    # engine's 12k single-chip activation bound scales with
    # sqrt(ndev). Off by default — a single-device mesh only adds
    # dispatch overhead.
    enable_solver_mesh: bool = False
    # BGP peering section (reference: openr/if/BgpConfig.thrift, gating
    # pluginStart at Main.cpp:595-601); None = BGP peering disabled
    bgp_config: Optional["BgpConfig"] = None

    # -- construction -----------------------------------------------------

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """reference: Config ctor validation (config/Config.h:34)."""
        if not self.node_name:
            raise ConfigError("node_name is required")
        if re.search(r"[\s:/]", self.node_name):
            raise ConfigError(
                "node_name must not contain whitespace, ':' or '/'"
            )
        if not self.areas:
            raise ConfigError("at least one area is required")
        area_ids = [a.area_id for a in self.areas]
        if len(area_ids) != len(set(area_ids)):
            raise ConfigError("duplicate area ids")
        self.spark.validate()
        self.prefix_alloc.validate()
        if (self.kvstore.flood_msg_per_sec > 0) != (
            self.kvstore.flood_msg_burst_size > 0
        ):
            raise ConfigError(
                "kvstore flood rate limiting needs BOTH "
                "flood_msg_per_sec and flood_msg_burst_size > 0 "
                f"(got {self.kvstore.flood_msg_per_sec}/"
                f"{self.kvstore.flood_msg_burst_size})"
            )
        if self.decision.debounce_min_ms > self.decision.debounce_max_ms:
            raise ConfigError("decision debounce min > max")
        if (
            self.prefix_forwarding_algorithm
            == PrefixForwardingAlgorithm.KSP2_ED_ECMP
            and self.prefix_forwarding_type != PrefixForwardingType.SR_MPLS
        ):
            raise ConfigError("KSP2_ED_ECMP requires SR_MPLS forwarding type")

    @staticmethod
    def from_dict(data: Dict) -> "OpenrConfig":
        def build(cls, value):
            if value is None:
                return cls()
            return cls(**value)

        kwargs = dict(data)
        if "areas" in kwargs:
            kwargs["areas"] = [AreaConfig(**a) for a in kwargs["areas"]]
        for key, cls in (
            ("spark", SparkConfig),
            ("kvstore", KvStoreConfig),
            ("decision", DecisionConfig),
            ("link_monitor", LinkMonitorConfig),
            ("watchdog", WatchdogConfig),
            ("prefix_alloc", PrefixAllocationConfig),
        ):
            if key in kwargs:
                kwargs[key] = build(cls, kwargs[key])
        if kwargs.get("bgp_config") is not None:
            kwargs["bgp_config"] = BgpConfig.from_dict(
                kwargs["bgp_config"]
            )
        if "prefix_forwarding_type" in kwargs and isinstance(
            kwargs["prefix_forwarding_type"], str
        ):
            kwargs["prefix_forwarding_type"] = PrefixForwardingType[
                kwargs["prefix_forwarding_type"]
            ]
        if "prefix_forwarding_algorithm" in kwargs and isinstance(
            kwargs["prefix_forwarding_algorithm"], str
        ):
            kwargs["prefix_forwarding_algorithm"] = PrefixForwardingAlgorithm[
                kwargs["prefix_forwarding_algorithm"]
            ]
        return OpenrConfig(**kwargs)

    @staticmethod
    def from_file(path: str) -> "OpenrConfig":
        with open(path) as f:
            return OpenrConfig.from_dict(json.load(f))

    def to_dict(self) -> Dict:
        out = asdict(self)
        out["prefix_forwarding_type"] = self.prefix_forwarding_type.name
        out["prefix_forwarding_algorithm"] = (
            self.prefix_forwarding_algorithm.name
        )
        return out

    # -- feature-flag helpers (reference: Config.h accessors) -------------

    def is_bgp_peering_enabled(self) -> bool:
        """reference: Config::isBgpPeeringEnabled — gates pluginStart
        (Main.cpp:595-601)."""
        return self.bgp_config is not None

    def area_for_neighbor(self, node_name: str) -> Optional[str]:
        for area in self.areas:
            if area.matches_neighbor(node_name):
                return area.area_id
        return None

    def area_ids(self) -> List[str]:
        return [a.area_id for a in self.areas]
