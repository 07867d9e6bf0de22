"""LinkMonitor: neighbor events + kernel links -> adjacency advertisement.

Behavioral parity with the reference ``openr/link-monitor/LinkMonitor.cpp``:

- consumes Spark neighbor events: UP records an adjacency (metric from
  config or RTT), starts KvStore peering with the neighbor, and
  (re-)advertises our ``adj:<node>`` key (neighborUpEvent,
  LinkMonitor.cpp:300; advertiseKvStorePeers :508;
  advertiseAdjacencies :602)
- consumes netlink link/address events into an interface database with
  per-interface flap damping (ExponentialBackoff backing off rapidly
  flapping links; LinkMonitor.h:201-206), republished to Spark
  (processNetlinkEvent, LinkMonitor.cpp:914; syncInterfaces :854)
- drain control: node overload, per-link overload, per-link metric
  override — persisted via the config store so they survive restart
- adjacency advertisement is throttled to coalesce bursts

Port note: a copy of ``openr_tpu/linkmonitor/link_monitor.py``; nothing
left out.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from openr_tpu_torch.monitor.monitor import push_log_sample
from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.platform.netlink import (
    NetlinkEvent,
    NetlinkProtocolSocket,
)
from openr_tpu_torch.types import Adjacency, AdjacencyDatabase, PerfEvents
from openr_tpu_torch.types.spark import (
    InterfaceDatabase,
    InterfaceInfo,
    SparkNeighbor,
    SparkNeighborEvent,
    SparkNeighborEventType,
)
from openr_tpu_torch.allocators.range_allocator import RangeAllocator
from openr_tpu_torch.utils import keys as keyutil
from openr_tpu_torch.utils import wire
from openr_tpu_torch.utils.eventbase import (
    AsyncThrottle,
    ExponentialBackoff,
    OpenrEventBase,
)

# persisted drain-state key in the config store
# (reference: LinkMonitor persists thrift::LinkMonitorState)
LINK_MONITOR_STATE_KEY = "link-monitor-config"

# SR global label block node labels are elected from
# (reference: Constants.h:59 kSrGlobalRange)
SR_GLOBAL_RANGE = (101, 49999)
# claim-key marker (reference: Constants.h:205 kNodeLabelRangePrefix)
NODE_LABEL_MARKER = "nodeLabel:"
NODE_LABELS_PERSIST_KEY = "link-monitor-node-labels"


@dataclass
class _InterfaceEntry:
    """Per-interface state with flap damping
    (reference: link-monitor/InterfaceEntry)."""

    info: InterfaceInfo
    backoff: ExponentialBackoff
    advertised_up: bool = False


class LinkMonitor:
    def __init__(
        self,
        my_node_name: str,
        neighbor_updates_queue: ReplicateQueue,
        interface_updates_queue: ReplicateQueue,
        kvstore_client=None,
        kvstore=None,
        peer_transport_factory: Optional[
            Callable[[SparkNeighbor], object]
        ] = None,
        netlink: Optional[NetlinkProtocolSocket] = None,
        netlink_events_queue: Optional[ReplicateQueue] = None,
        config_store=None,
        area: str = "0",
        areas: Optional[List[str]] = None,
        node_label: int = 0,
        enable_segment_routing: bool = False,
        use_rtt_metric: bool = False,
        flap_initial_backoff_s: float = 0.05,
        flap_max_backoff_s: float = 2.0,
        advertise_throttle_s: float = 0.02,
        log_sample_queue: Optional[ReplicateQueue] = None,
    ):
        self.my_node_name = my_node_name
        self.area = area
        # all areas this node participates in (border routers list several);
        # each gets its own adj:<node> advertisement holding only that
        # area's adjacencies
        self.areas = list(areas) if areas else [area]
        self.node_label = node_label
        self.use_rtt_metric = use_rtt_metric
        self.evb = OpenrEventBase(name=f"linkmonitor:{my_node_name}")
        self._interface_updates = interface_updates_queue
        self._kvstore_client = kvstore_client
        self._kvstore = kvstore
        self._peer_transport_factory = peer_transport_factory
        self._netlink = netlink
        self._config_store = config_store
        self._flap_initial = flap_initial_backoff_s
        self._flap_max = flap_max_backoff_s
        self._log_sample_queue = log_sample_queue

        # (if_name, neighbor) -> (SparkNeighbor, Adjacency)
        self._adjacencies: Dict[Tuple[str, str], Tuple[SparkNeighbor, Adjacency]] = {}
        # (area, node) KvStore peers currently advertised — ADD_PEER is
        # logged only on a genuinely new peer, not each RTT re-advertise
        self._advertised_peers: Set[Tuple[str, str]] = set()
        self._interfaces: Dict[str, _InterfaceEntry] = {}
        self._metric_overrides: Dict[Tuple[str, str], int] = {}
        # interface-wide override (reference: setInterfaceMetric) —
        # the per-(iface, neighbor) override wins when both are set
        self._iface_metric_overrides: Dict[str, int] = {}
        self._link_overloads: Set[str] = set()
        self.is_overloaded = False
        self.counters: Dict[str, int] = {
            "link_monitor.neighbor_up": 0,
            "link_monitor.neighbor_down": 0,
            "link_monitor.advertise_adjacencies": 0,
            "link_monitor.advertise_interfaces": 0,
        }
        self._load_persisted_state()

        self._advertise_adj_throttled = AsyncThrottle(
            self.evb, advertise_throttle_s, self._advertise_adjacencies
        )

        # SR node-label election: one RangeAllocator per area over the
        # global SR block, consensus via the KvStore merge ordering
        # (reference: LinkMonitor.cpp:171-205 — per-area
        # RangeAllocator<int32_t> over kSrGlobalRange, elected label
        # re-advertised and persisted). A non-zero static node_label
        # short-circuits election, like the reference's static config.
        self._node_labels: Dict[str, int] = {}
        self._label_allocators: Dict[str, RangeAllocator] = {}
        if (
            enable_segment_routing
            and node_label == 0
            and kvstore_client is not None
        ):
            persisted: Dict[str, int] = {}
            if config_store is not None:
                persisted = config_store.load(NODE_LABELS_PERSIST_KEY) or {}
            # the allocator FSM must live on the SAME event base the
            # KvStore client delivers publications on
            alloc_evb = kvstore_client.evb
            for lm_area in self.areas:
                alloc = RangeAllocator(
                    alloc_evb,
                    kvstore_client,
                    my_node_name,
                    NODE_LABEL_MARKER,
                    SR_GLOBAL_RANGE,
                    lambda label, a=lm_area: self._on_node_label(a, label),
                    area=lm_area,
                )
                self._label_allocators[lm_area] = alloc
                alloc.start_allocator(init_value=persisted.get(lm_area))
        self._advertise_ifaces_throttled = AsyncThrottle(
            self.evb, advertise_throttle_s, self._advertise_interfaces
        )

        self.evb.add_queue_reader(
            neighbor_updates_queue.get_reader(f"lm:{my_node_name}"),
            self._on_neighbor_event,
        )
        if netlink_events_queue is not None:
            self.evb.add_queue_reader(
                netlink_events_queue.get_reader(f"lm:{my_node_name}"),
                self._on_netlink_event,
            )

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self.evb.run_in_thread()
        if self._netlink is not None:
            self.evb.run_in_event_base(self._sync_interfaces)

    def stop(self) -> None:
        for alloc in self._label_allocators.values():
            alloc.stop()
        self.evb.stop()
        self.evb.join()

    # -- SR node-label election ------------------------------------------

    def _on_node_label(self, area: str, label: Optional[int]) -> None:
        """Elected (or lost) a node label for one area: record, persist,
        re-advertise (reference: LinkMonitor.cpp:180-186 callback).
        Fires on the allocator's event base — marshal onto ours."""

        def apply() -> None:
            if label is None:
                self._node_labels.pop(area, None)
            else:
                self._node_labels[area] = label
            if self._config_store is not None:
                self._config_store.store(
                    NODE_LABELS_PERSIST_KEY, dict(self._node_labels)
                )
            self._advertise_adj_throttled()

        self.evb.run_immediately_or_in_event_base(apply)

    def node_label_for(self, area: str) -> int:
        return self._node_labels.get(area, self.node_label)

    # -- persisted drain state -------------------------------------------

    def _load_persisted_state(self) -> None:
        if self._config_store is None:
            return
        state = self._config_store.load(LINK_MONITOR_STATE_KEY)
        if state is None:
            return
        self.is_overloaded = bool(state.get("is_overloaded", False))
        self._link_overloads = set(state.get("link_overloads", []))
        self._iface_metric_overrides = dict(
            state.get("iface_metric_overrides", {})
        )
        self._metric_overrides = {
            (i, n): m
            for (i, n), m in (
                (tuple(k.split("|", 1)), v)
                for k, v in state.get("metric_overrides", {}).items()
            )
        }

    def _persist_state(self) -> None:
        if self._config_store is None:
            return
        self._config_store.store(
            LINK_MONITOR_STATE_KEY,
            {
                "is_overloaded": self.is_overloaded,
                "link_overloads": sorted(self._link_overloads),
                "metric_overrides": {
                    f"{i}|{n}": m
                    for (i, n), m in self._metric_overrides.items()
                },
                "iface_metric_overrides": dict(
                    self._iface_metric_overrides
                ),
            },
        )

    def _log_sample(self, **fields) -> None:
        """reference: LinkMonitor.cpp:1287 logNeighborEvent, :1303
        logLinkEvent, :1326 logPeerEvent."""
        push_log_sample(
            self._log_sample_queue, node_name=self.my_node_name, **fields
        )

    # -- spark events -----------------------------------------------------

    def _on_neighbor_event(self, event: SparkNeighborEvent) -> None:
        et = event.event_type
        nbr = event.neighbor
        if et != SparkNeighborEventType.NEIGHBOR_RTT_CHANGE:
            # transitions only — RTT jitter on a noisy fabric would
            # evict the rare UP/DOWN events from the bounded history
            self._log_sample(
                event=et.name,
                neighbor=nbr.node_name,
                interface=nbr.local_if_name,
                remote_interface=nbr.remote_if_name,
                area=nbr.area or self.area,
                rtt_us=nbr.rtt_us,
            )
        if et == SparkNeighborEventType.NEIGHBOR_UP:
            self._neighbor_up(event.neighbor)
        elif et == SparkNeighborEventType.NEIGHBOR_RESTARTED:
            self._neighbor_up(event.neighbor)
        elif et == SparkNeighborEventType.NEIGHBOR_DOWN:
            self._neighbor_down(event.neighbor)
        elif et == SparkNeighborEventType.NEIGHBOR_RESTARTING:
            # graceful restart: keep the adjacency, stop nothing
            pass
        elif et == SparkNeighborEventType.NEIGHBOR_RTT_CHANGE:
            self._rtt_change(event.neighbor)

    def _metric_for(self, nbr: SparkNeighbor) -> int:
        key = (nbr.local_if_name, nbr.node_name)
        if key in self._metric_overrides:
            return self._metric_overrides[key]
        if self.use_rtt_metric:
            # reference: metric = max(1, rtt_us / 100)
            return max(1, nbr.rtt_us // 100)
        return 1

    def _neighbor_up(self, nbr: SparkNeighbor) -> None:
        """reference: LinkMonitor.cpp:300 neighborUpEvent."""
        self.counters["link_monitor.neighbor_up"] += 1
        adj = Adjacency(
            other_node_name=nbr.node_name,
            if_name=nbr.local_if_name,
            other_if_name=nbr.remote_if_name,
            metric=self._metric_for(nbr),
            next_hop_v6=nbr.transport_address_v6,
            next_hop_v4=nbr.transport_address_v4,
            is_overloaded=nbr.local_if_name in self._link_overloads,
            rtt=nbr.rtt_us,
            timestamp=int(time.time()),
        )
        self._adjacencies[(nbr.local_if_name, nbr.node_name)] = (nbr, adj)
        self._advertise_kvstore_peer(nbr)
        self._advertise_adj_throttled()

    def _neighbor_down(self, nbr: SparkNeighbor) -> None:
        self.counters["link_monitor.neighbor_down"] += 1
        area = nbr.area or self.area
        self._adjacencies.pop((nbr.local_if_name, nbr.node_name), None)
        if self._kvstore is not None and not any(
            n.node_name == nbr.node_name and (n.area or self.area) == area
            for (n, _) in self._adjacencies.values()
        ):
            # drop the advertisement record first: a del_peer failure
            # must not suppress the ADD_PEER sample when the neighbor
            # later re-establishes
            self._advertised_peers.discard((area, nbr.node_name))
            try:
                self._kvstore.del_peer(area, nbr.node_name)
                self._log_sample(
                    event="DEL_PEER", peer_name=nbr.node_name, area=area
                )
            except Exception:
                pass
        self._advertise_adj_throttled()

    def _rtt_change(self, nbr: SparkNeighbor) -> None:
        entry = self._adjacencies.get((nbr.local_if_name, nbr.node_name))
        if entry is None:
            return
        if self.use_rtt_metric:
            self._neighbor_up(nbr)  # recompute metric + readvertise
        else:
            # record new rtt without metric change
            old_nbr, adj = entry
            self._adjacencies[(nbr.local_if_name, nbr.node_name)] = (
                nbr,
                Adjacency(
                    other_node_name=adj.other_node_name,
                    if_name=adj.if_name,
                    other_if_name=adj.other_if_name,
                    metric=adj.metric,
                    next_hop_v6=adj.next_hop_v6,
                    next_hop_v4=adj.next_hop_v4,
                    is_overloaded=adj.is_overloaded,
                    rtt=nbr.rtt_us,
                    timestamp=adj.timestamp,
                ),
            )

    def _advertise_kvstore_peer(self, nbr: SparkNeighbor) -> None:
        """Start KvStore flooding with the new neighbor
        (reference: LinkMonitor.cpp:508 advertiseKvStorePeers)."""
        if self._kvstore is None or self._peer_transport_factory is None:
            return
        try:
            transport = self._peer_transport_factory(nbr)
            if transport is not None:
                area = nbr.area or self.area
                self._kvstore.add_peer(area, nbr.node_name, transport)
                if (area, nbr.node_name) not in self._advertised_peers:
                    self._advertised_peers.add((area, nbr.node_name))
                    self._log_sample(
                        event="ADD_PEER",
                        peer_name=nbr.node_name,
                        area=area,
                    )
        except Exception:
            pass

    # -- adjacency advertisement -----------------------------------------

    def _build_adj_db(self, area: Optional[str] = None) -> AdjacencyDatabase:
        """Adjacencies for one area (or all, area=None for introspection)."""
        adjacencies = []
        for (if_name, node), (nbr, adj) in sorted(self._adjacencies.items()):
            if area is not None and (nbr.area or self.area) != area:
                continue
            metric = self._metric_overrides.get(
                (if_name, node),
                self._iface_metric_overrides.get(if_name, adj.metric),
            )
            adjacencies.append(
                Adjacency(
                    other_node_name=adj.other_node_name,
                    if_name=adj.if_name,
                    other_if_name=adj.other_if_name,
                    metric=metric,
                    next_hop_v6=adj.next_hop_v6,
                    next_hop_v4=adj.next_hop_v4,
                    adj_label=adj.adj_label,
                    is_overloaded=if_name in self._link_overloads,
                    rtt=adj.rtt,
                    timestamp=adj.timestamp,
                    weight=adj.weight,
                )
            )
        resolved_area = area if area is not None else self.area
        return AdjacencyDatabase(
            this_node_name=self.my_node_name,
            is_overloaded=self.is_overloaded,
            adjacencies=tuple(adjacencies),
            node_label=self.node_label_for(resolved_area),
            area=resolved_area,
        )

    def _advertise_adjacencies(self) -> None:
        """reference: LinkMonitor.cpp:602 advertiseAdjacencies (one
        adj:<node> advertisement per configured area)."""
        if self._kvstore_client is None:
            return
        self.counters["link_monitor.advertise_adjacencies"] += 1
        for area in self.areas:
            adj_db = self._build_adj_db(area)
            # originate the convergence perf chain here, so the e2e
            # account starts at the adjacency change, not at Decision
            # (reference: LinkMonitor.cpp:602 addPerfEvent
            # ADJ_DB_UPDATED)
            perf = PerfEvents()
            perf.add(self.my_node_name, "ADJ_DB_UPDATED")
            adj_db = AdjacencyDatabase(
                this_node_name=adj_db.this_node_name,
                is_overloaded=adj_db.is_overloaded,
                adjacencies=adj_db.adjacencies,
                node_label=adj_db.node_label,
                area=adj_db.area,
                perf_events=perf,
            )
            self._kvstore_client.persist_key(
                area,
                keyutil.adj_key(self.my_node_name),
                wire.dumps(adj_db),
            )

    # -- netlink interface tracking --------------------------------------

    def _sync_interfaces(self) -> None:
        """reference: LinkMonitor.cpp:854 syncInterfaces."""
        for link in self._netlink.get_all_links():
            self._apply_link_state(link.if_name, link.is_up, link.addresses)
        self._advertise_ifaces_throttled()

    def _on_netlink_event(self, event: NetlinkEvent) -> None:
        """reference: LinkMonitor.cpp:914 processNetlinkEvent."""
        if event.link is None:
            return
        self._apply_link_state(
            event.link.if_name, event.link.is_up, event.link.addresses
        )
        self._advertise_ifaces_throttled()

    def _apply_link_state(self, if_name, is_up, addresses) -> None:
        entry = self._interfaces.get(if_name)
        if entry is None:
            entry = self._interfaces[if_name] = _InterfaceEntry(
                info=InterfaceInfo(is_up=is_up, networks=tuple(addresses)),
                backoff=ExponentialBackoff(self._flap_initial, self._flap_max),
            )
            return
        was_up = entry.info.is_up
        entry.info = InterfaceInfo(is_up=is_up, networks=tuple(addresses))
        backoff_ms = 0
        if is_up and not was_up:
            # flap damping: a link coming back up is held for the current
            # backoff window; rapid flapping doubles the window
            entry.backoff.report_error()
            delay = entry.backoff.get_time_remaining_until_retry()
            backoff_ms = int(delay * 1000)
            if delay > 0:
                self.evb.schedule_timeout(
                    delay, self._advertise_ifaces_throttled
                )
        if was_up != is_up:  # reference logLinkEvent: transitions only
            self._log_sample(
                event=f"IFACE_{'UP' if is_up else 'DOWN'}",
                interface=if_name,
                backoff_ms=backoff_ms,
            )

    def _advertise_interfaces(self) -> None:
        self.counters["link_monitor.advertise_interfaces"] += 1
        interfaces: Dict[str, InterfaceInfo] = {}
        for if_name, entry in self._interfaces.items():
            is_up = entry.info.is_up
            if is_up and not entry.backoff.can_try_now():
                is_up = False  # still damped
            interfaces[if_name] = InterfaceInfo(
                is_up=is_up,
                if_index=entry.info.if_index,
                networks=entry.info.networks,
            )
        self._interface_updates.push(
            InterfaceDatabase(
                this_node_name=self.my_node_name, interfaces=interfaces
            )
        )

    # -- drain / overload APIs (thread-safe) ------------------------------

    def set_node_overload(self, overloaded: bool) -> None:
        def apply() -> None:
            if self.is_overloaded != overloaded:
                self.is_overloaded = overloaded
                self._persist_state()
                self._advertise_adj_throttled()

        self.evb.call_and_wait(apply)

    def set_link_overload(self, if_name: str, overloaded: bool) -> None:
        def apply() -> None:
            if overloaded:
                self._link_overloads.add(if_name)
            else:
                self._link_overloads.discard(if_name)
            self._persist_state()
            self._advertise_adj_throttled()

        self.evb.call_and_wait(apply)

    def set_link_metric(
        self, if_name: str, neighbor: str, metric: Optional[int]
    ) -> None:
        def apply() -> None:
            if metric is None:
                self._metric_overrides.pop((if_name, neighbor), None)
            else:
                self._metric_overrides[(if_name, neighbor)] = metric
            self._persist_state()
            self._advertise_adj_throttled()

        self.evb.call_and_wait(apply)

    def set_interface_metric(
        self, if_name: str, metric: Optional[int]
    ) -> None:
        """Interface-wide metric override for every adjacency on the
        interface (reference: OpenrCtrl setInterfaceMetric /
        unsetInterfaceMetric). None clears it."""

        def apply() -> None:
            if metric is None:
                self._iface_metric_overrides.pop(if_name, None)
            else:
                self._iface_metric_overrides[if_name] = metric
            self._persist_state()
            self._advertise_adj_throttled()

        self.evb.call_and_wait(apply)

    # -- introspection ----------------------------------------------------

    def get_adjacencies(self) -> AdjacencyDatabase:
        return self.evb.call_and_wait(self._build_adj_db)

    def get_interfaces(self) -> Dict[str, InterfaceInfo]:
        return self.evb.call_and_wait(
            lambda: {n: e.info for n, e in self._interfaces.items()}
        )

    def get_interface_details(self):
        """One-snapshot dump for the ctrl getInterfaces RPC (reference:
        LinkMonitor.thrift DumpLinksReply): node overload bit plus, per
        interface, (InterfaceInfo, link overload, interface-wide metric
        override or None). The per-(iface, neighbor) overrides ride
        getLinkMonitorAdjacencies, as in the reference."""

        def snap():
            return (
                self.is_overloaded,
                {
                    n: (
                        e.info,
                        n in self._link_overloads,
                        self._iface_metric_overrides.get(n),
                    )
                    for n, e in self._interfaces.items()
                },
            )

        return self.evb.call_and_wait(snap)

    def get_counters(self) -> Dict[str, int]:
        return self.evb.call_and_wait(lambda: dict(self.counters))
