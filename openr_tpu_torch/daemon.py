"""OpenrNode: full-daemon assembly (the reference's Main.cpp + the test
fixture OpenrWrapper, openr/tests/OpenrWrapper.h:38).

Constructs the typed queues, wires the modules
(KvStore <- LinkMonitor <- Spark; KvStore -> Decision -> Fib; PrefixManager
-> KvStore) and starts them in dependency order with reverse-order
teardown (reference: Main.cpp:269-280 queue wiring, :374-504 module
startup order, :604-654 shutdown).

Multiple OpenrNodes in one process over a MockIoProvider + in-process
KvStore transports form a complete simulated network (the reference's
OpenrSystemTest pattern).

Port note: a port of ``openr_tpu/daemon.py``. ``OpenrNode(device=)`` is
where Decision solves: None means the card (raising without CUDA), the
tests pass ``"cpu"``. ``start()`` installs no compile listeners (the
reference's JAX hooks; the port compiles no jit programs), and
``start_ctrl_server`` is left out with the TCP ctrl server it starts: the
in-process ``ctrl_handler`` is built as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from openr_tpu_torch.decision.decision import Decision
from openr_tpu_torch.device import resolve_device
from openr_tpu_torch.fib.fib import Fib
from openr_tpu_torch.kvstore.client import KvStoreClient
from openr_tpu_torch.kvstore.store import InProcessTransport, KvStore, PeerTransport
from openr_tpu_torch.linkmonitor.link_monitor import LinkMonitor
from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.platform.fib_service import FibService, MockFibAgent
from openr_tpu_torch.prefixmgr.prefix_manager import PrefixManager
from openr_tpu_torch.spark.io_provider import IoProvider
from openr_tpu_torch.spark.spark import Spark
from openr_tpu_torch.types import BinaryAddress, IpPrefix, PrefixEntry, PrefixType
from openr_tpu_torch.types.spark import SparkNeighbor
from openr_tpu_torch.utils.eventbase import OpenrEventBase


class OpenrNode:
    """One complete openr-tpu daemon instance."""

    def __init__(
        self,
        name: str,
        io_provider: IoProvider,
        node_registry: Optional[Dict[str, "OpenrNode"]] = None,
        fib_agent: Optional[FibService] = None,
        area: str = "0",
        areas: Optional[List[str]] = None,
        interface_areas: Optional[Dict[str, str]] = None,
        v6_addr: Optional[str] = None,
        spark_config: Optional[dict] = None,
        # cross-process KvStore peering: dial a neighbor's advertised
        # peer port (reference: thrift peer clients, KvStore.cpp:1400).
        # None = in-process registry resolution (simulations/tests)
        peer_transport_factory=None,
        use_rtt_metric: bool = False,
        config_store=None,
        solver_backend: str = "device",
        # library-level default is permissive (matches Decision's ctor);
        # the config-driven daemon passes the reference default (off)
        enable_rib_policy: bool = True,
        enable_v4: bool = False,
        enable_lfa: bool = False,
        enable_ordered_fib: bool = False,
        # reference default: true (Flags.cpp:39) — matches DecisionConfig
        enable_bgp_route_programming: bool = True,
        enable_best_route_selection: bool = True,
        enable_segment_routing: bool = False,
        node_label: int = 0,
        debounce_min_s: float = 0.01,
        # reference default: 250ms ceiling (common/Flags.cpp
        # decision_debounce_max_ms); tests pass a smaller value
        debounce_max_s: float = 0.25,
        enable_flood_optimization: bool = False,
        is_flood_root: bool = False,
        flood_rate=None,  # Optional[(msgs_per_sec, burst)]
        per_prefix_keys: bool = True,
        prefix_alloc=None,  # Optional[PrefixAllocationConfig]
        netlink=None,  # address programming target for the allocator
        device=None,  # where Decision solves: None = the card
    ):
        # where Decision solves, resolved before any module starts a thread:
        # without CUDA and without device="cpu" the node raises here
        self.device = resolve_device(device)
        self.name = name
        self.area = area
        # border routers participate in several areas; interface_areas maps
        # each interface to its area (default: the node's default area)
        self.areas = list(areas) if areas else [area]
        bad_areas = set((interface_areas or {}).values()) - set(self.areas)
        if bad_areas:
            # an adjacency in an unconfigured area would form at the Spark
            # level but never enter any LSDB — a silent blackhole
            raise ValueError(
                f"interface_areas references areas {sorted(bad_areas)} "
                f"not in this node's areas {self.areas}"
            )
        if area not in self.areas:
            # unlisted interfaces fall back to the default area; it must
            # be one this node actually participates in
            raise ValueError(
                f"default area {area!r} not in this node's areas "
                f"{self.areas}"
            )
        self.registry = node_registry if node_registry is not None else {}
        self.registry[name] = self

        # -- queues (reference: Main.cpp:269-280) -------------------------
        self.neighbor_updates = ReplicateQueue(name=f"{name}:neighborUpdates")
        self.interface_updates = ReplicateQueue(name=f"{name}:interfaceUpdates")
        self.route_updates = ReplicateQueue(name=f"{name}:routeUpdates")
        self.fib_updates = ReplicateQueue(name=f"{name}:fibUpdates")
        self.prefix_updates = ReplicateQueue(name=f"{name}:prefixUpdates")
        self.static_routes = ReplicateQueue(name=f"{name}:staticRoutes")
        # event-log samples from every module -> Monitor (reference:
        # Main.cpp:280 logSampleQueue wired into KvStore, LinkMonitor,
        # Fib, PrefixAllocator; Monitor drains the reader at :390)
        self.log_sample_queue = ReplicateQueue(name=f"{name}:logSamples")

        # -- modules ------------------------------------------------------
        from openr_tpu_torch.monitor.monitor import Monitor

        self.monitor = Monitor(name, self.log_sample_queue)
        self.kvstore = KvStore(
            node_id=name,
            areas=self.areas,
            enable_flood_optimization=enable_flood_optimization,
            is_flood_root=is_flood_root,
            flood_rate=flood_rate,
            log_sample_queue=self.log_sample_queue,
        )
        self.client_evb = OpenrEventBase(name=f"kvclient:{name}")
        self.kvstore_client = KvStoreClient(
            self.client_evb, name, self.kvstore
        )
        self.decision = Decision(
            name,
            kvstore_updates_queue=self.kvstore.updates_queue,
            route_updates_queue=self.route_updates,
            static_routes_queue=self.static_routes,
            debounce_min_s=debounce_min_s,
            debounce_max_s=debounce_max_s,
            solver_backend=solver_backend,
            enable_rib_policy=enable_rib_policy,
            enable_v4=enable_v4,
            compute_lfa_paths=enable_lfa,
            enable_ordered_fib=enable_ordered_fib,
            # BGP routes are computed either way; programming them is
            # gated (reference: enable_bgp_route_programming -> dryrun
            # marks do_not_install)
            bgp_dry_run=not enable_bgp_route_programming,
            enable_best_route_selection=enable_best_route_selection,
            device=self.device,
        )
        self.fib_agent = fib_agent or MockFibAgent()
        self.fib = Fib(
            name,
            self.fib_agent,
            self.route_updates,
            fib_updates_queue=self.fib_updates,
            kvstore_client=self.kvstore_client,
            area=area,
            log_sample_queue=self.log_sample_queue,
        )
        self.spark = Spark(
            name,
            io_provider,
            self.neighbor_updates,
            interface_updates_queue=self.interface_updates,
            area=area,
            interface_areas=interface_areas,
            v6_addr=BinaryAddress.from_str(v6_addr) if v6_addr else None,
            **(spark_config or {}),
        )
        self.link_monitor = LinkMonitor(
            name,
            neighbor_updates_queue=self.neighbor_updates,
            interface_updates_queue=self.interface_updates,
            kvstore_client=self.kvstore_client,
            kvstore=self.kvstore,
            peer_transport_factory=(
                peer_transport_factory or self._peer_transport
            ),
            config_store=config_store,
            area=area,
            areas=self.areas,
            node_label=node_label,
            enable_segment_routing=enable_segment_routing,
            use_rtt_metric=use_rtt_metric,
            log_sample_queue=self.log_sample_queue,
        )
        self.prefix_manager = PrefixManager(
            name,
            self.kvstore_client,
            prefix_updates_queue=self.prefix_updates,
            # border nodes re-originate Decision's best routes across areas
            decision_route_updates_queue=(
                self.route_updates if len(self.areas) > 1 else None
            ),
            areas=self.areas,
            per_prefix_keys=per_prefix_keys,
        )
        # automatic prefix allocation (reference: Main.cpp PrefixAllocator
        # construction gated on enable_prefix_alloc)
        self.prefix_allocator = None
        if prefix_alloc is not None and prefix_alloc.enabled:
            from openr_tpu_torch.allocators.prefix_allocator import PrefixAllocator
            from openr_tpu_torch.types import IpPrefix as _IpPrefix

            seed = (
                _IpPrefix.from_str(prefix_alloc.seed_prefix)
                if prefix_alloc.seed_prefix
                and not prefix_alloc.static_allocation
                else None
            )
            self.prefix_allocator = PrefixAllocator(
                name,
                self.client_evb,
                self.kvstore_client,
                self.prefix_manager,
                seed_prefix=seed,
                alloc_prefix_len=prefix_alloc.alloc_prefix_len,
                static_prefixes=(
                    {} if prefix_alloc.static_allocation else None
                ),
                netlink=(
                    netlink if prefix_alloc.set_loopback_addr else None
                ),
                loopback_if=prefix_alloc.loopback_iface,
                config_store=config_store,
                area=area,
                log_sample_queue=self.log_sample_queue,
            )
        from openr_tpu_torch.ctrl.handler import OpenrCtrlHandler

        self.ctrl_handler = OpenrCtrlHandler(
            name,
            kvstore=self.kvstore,
            decision=self.decision,
            fib=self.fib,
            link_monitor=self.link_monitor,
            prefix_manager=self.prefix_manager,
            spark=self.spark,
            monitor=self.monitor,
        )
        self.ctrl_handler._config_store = config_store
        self._started = False

    # -- peering ----------------------------------------------------------

    def _peer_transport(self, nbr: SparkNeighbor) -> Optional[PeerTransport]:
        """In-process transport resolution: look the neighbor up in the
        shared registry (the analogue of dialing its thrift port from the
        handshake's transport address)."""
        other = self.registry.get(nbr.node_name)
        if other is None:
            return None
        return InProcessTransport(other.kvstore)

    # -- lifecycle (reference startup order, Main.cpp:374-504) ------------

    def start(self) -> None:
        assert not self._started
        # Monitor first: it only reads the log queue, and every other
        # module may push from its first event on (reference startup
        # order: Main.cpp:385 Monitor before KvStore)
        self.monitor.start()
        self.kvstore.start()
        self.client_evb.run_in_thread()
        self.prefix_manager.start()
        self.spark.start()
        self.link_monitor.start()
        self.decision.start()
        self.fib.start()
        # plugin hook, after all modules are live (reference:
        # Main.cpp:595-601 pluginStart with the queue endpoints)
        from openr_tpu_torch import plugin

        if plugin.has_plugin():
            cfg = getattr(self.ctrl_handler, "_config", None)
            plugin.plugin_start(
                plugin.PluginArgs(
                    prefix_updates_queue=self.prefix_updates,
                    static_routes_queue=self.static_routes,
                    route_updates_reader=self.route_updates.get_reader(
                        f"plugin:{self.name}"
                    ),
                    config=cfg,
                    bgp_config=getattr(cfg, "bgp_config", None),
                )
            )
            self._plugin_started = True
        self._started = True

    def stop(self) -> None:
        if not self._started:
            return
        # reverse order teardown (reference: Main.cpp:604-654; pluginStop
        # first, before the queues it reads from close)
        if getattr(self, "_plugin_started", False):
            from openr_tpu_torch import plugin

            plugin.plugin_stop()
            self._plugin_started = False
        if self.prefix_allocator is not None:
            self.prefix_allocator.stop()
        self.fib.stop()
        self.decision.stop()
        self.link_monitor.stop()
        self.spark.stop()
        self.prefix_manager.stop()
        self.client_evb.stop()
        self.client_evb.join()
        self.kvstore.stop()
        # last, so producers are already quiet; samples still queued at
        # this instant are dropped (best-effort shutdown telemetry, like
        # the reference's logSampleQueue.close() at Main.cpp:617)
        self.monitor.stop()
        self._started = False

    # -- convenience ------------------------------------------------------

    def add_interface(self, if_name: str) -> None:
        self.spark.add_interface(if_name)

    def advertise_loopback(self, prefix_str: str, **entry_kwargs) -> IpPrefix:
        prefix = IpPrefix.from_str(prefix_str)
        self.prefix_manager.advertise_prefixes(
            [
                PrefixEntry(
                    prefix=prefix,
                    type=PrefixType.LOOPBACK,
                    **entry_kwargs,
                )
            ]
        )
        return prefix

    def get_fib_routes(self):
        return self.fib.get_route_db()
