"""SpfSolver: per-prefix best-route selection and next-hop computation.

Port note: mirrors ``openr_tpu/decision/spf_solver.py`` for the SP_ECMP
and KSP2_ED_ECMP route builds. Shortest-path distances and ECMP
first-hop sets come from the port's torch ops on the solver's device
("device" backend: the dense snapshot up to ``SPARSE_NODE_THRESHOLD``
nodes, sliced-ELL bands above it), or from the host Dijkstra oracle
("host" backend). KSP2 second paths are solved on the device by the
reference's per-build chunked masked dispatch (``_prefetch_ksp2_area``)
at every area size, and primed into the ``LinkState``'s kth-path cache;
the host backend computes them lazily with ``LinkState.get_kth_paths``.
Left out for later slices: the incremental ``Ksp2Engine``, the SP/KSP2
route-reuse caches and node-label patching (every build is the full
build those caches fall back to), the resident incremental ELL state
(each new topology version recompiles the bands), the native backend and
plugin backends, the multi-area world batch, prewarm/speculation, the
fault seams and every solver counter but the three in ``SPF_COUNTERS``.

Behavioural parity with the reference ``openr/decision/Decision.cpp``
SpfSolverImpl (buildRouteDb:569, createRouteForPrefix:402,
selectBestRoutes:737, maybeFilterDrainedNodes:783, selectBestPathsSpf:847,
addBestPaths:1033, getNextHopsWithMetric:1124, getNextHopsThrift:1211).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from openr_tpu_torch.decision.prefix_state import (
    NodeAndArea,
    PrefixEntries,
    PrefixState,
)
from openr_tpu_torch.decision.rib import (
    DecisionRouteDb,
    RibMplsEntry,
    RibUnicastEntry,
)
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.graph.linkstate import Link, LinkState
from openr_tpu_torch.graph.snapshot import INF, SnapshotCache
from openr_tpu_torch.types import (
    BinaryAddress,
    IpPrefix,
    MplsAction,
    MplsActionCode,
    NextHop,
    PrefixType,
)
from openr_tpu_torch.types.lsdb import (
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
)
from openr_tpu_torch.utils.constants import is_mpls_label_valid

Metric = int
AreaLinkStates = Dict[str, LinkState]

# above this node count the device backend switches from the dense
# snapshot (O(N^2) metric matrix) to the sliced-ELL bands
SPARSE_NODE_THRESHOLD = 4096

# solver counters, by the JAX package's names. spf_host_fallback counts the
# device views' queries answered by a host Dijkstra instead: it must stay at
# 0 on the route-build path. ksp2_device_batches counts masked KSP2 solves
# (one per chunk of destinations); ksp2_host_fallbacks counts destinations
# of such a batch whose exclusions the masks could not express, left to the
# lazy host path.
SPF_COUNTERS: Dict[str, int] = {
    "decision.spf_host_fallback": 0,
    "decision.ksp2_device_batches": 0,
    "decision.ksp2_host_fallbacks": 0,
}

# KSP2 device prefetch: below this many KSP2 destinations in an area the
# lazy host path takes them. The masked solve runs one relaxation per hop,
# so areas whose root is more than KSP2_DEVICE_MAX_HOPS hops from some node
# stay on the host too. KSP2_DEVICE_MASK_BUDGET bounds the bool mask slots
# of one dispatch; _ksp2_chunk sizes the destination chunks by it.
KSP2_DEVICE_MIN_DSTS = 32
KSP2_DEVICE_MAX_HOPS = 16
KSP2_DEVICE_MASK_BUDGET = 32_000_000


def _ksp2_chunk(graph) -> int:
    """Destinations per masked dispatch: the largest power of two up to
    1024 whose [chunk, slots] mask, doubled, fits the budget (at least
    1)."""
    slots = sum(band.rows * band.k for band in graph.bands)
    chunk = 1
    while chunk < 1024 and chunk * 2 * max(1, slots) <= KSP2_DEVICE_MASK_BUDGET:
        chunk *= 2
    return chunk

# per-solver view cache capacity (graphs, not views)
VIEW_CACHE_CAP = 4


def make_next_hop(
    address: BinaryAddress,
    if_name: Optional[str],
    metric: Metric,
    mpls_action: Optional[MplsAction] = None,
    area: Optional[str] = None,
    neighbor_node_name: Optional[str] = None,
) -> NextHop:
    """reference: openr/common/Util.cpp createNextHop"""
    if if_name is not None:
        address = BinaryAddress(addr=address.addr, if_name=if_name)
    return NextHop(
        address=address,
        metric=int(metric),
        mpls_action=mpls_action,
        area=area,
        neighbor_node_name=neighbor_node_name,
    )


@dataclass
class BestRouteSelectionResult:
    """reference: openr/decision/Decision.h BestRouteSelectionResult"""

    success: bool = False
    all_node_areas: Set[NodeAndArea] = field(default_factory=set)
    best_node_area: NodeAndArea = ("", "")

    def has_node(self, node: str) -> bool:
        return any(n == node for n, _ in self.all_node_areas)


def select_best_prefix_metrics(entries: PrefixEntries) -> Set[NodeAndArea]:
    """Pick advertisers with the best (path_pref DESC, source_pref DESC,
    distance ASC) metrics. The initial best is (0, 0, 0): advertisements
    strictly worse than the zero-metric tuple select nothing — matching the
    reference exactly. reference: openr/common/Util.h:549."""
    best_tuple = (0, 0, 0)
    best_keys: Set[NodeAndArea] = set()
    for key, entry in entries.items():
        t = entry.metrics.comparison_key()
        if t < best_tuple:
            continue
        if t > best_tuple:
            best_tuple = t
            best_keys.clear()
        best_keys.add(key)
    return best_keys


def select_best_node_area(
    all_node_areas: Set[NodeAndArea], my_node_name: str
) -> NodeAndArea:
    """Deterministic representative: self if present, else smallest key.
    reference: openr/common/Util.cpp:1057."""
    ordered = sorted(all_node_areas)
    for node_area in ordered:
        if node_area[0] == my_node_name:
            return node_area
    return ordered[0]


def get_prefix_forwarding_type_and_algorithm(
    entries: PrefixEntries, best_node_areas: Set[NodeAndArea]
) -> Tuple[PrefixForwardingType, PrefixForwardingAlgorithm]:
    """Lowest-common-denominator forwarding config among best advertisers.
    reference: openr/common/Util.cpp:617."""
    if not entries:
        return (PrefixForwardingType.IP, PrefixForwardingAlgorithm.SP_ECMP)
    ftype = PrefixForwardingType.SR_MPLS
    falgo = PrefixForwardingAlgorithm.KSP2_ED_ECMP
    for node_area, entry in entries.items():
        if node_area not in best_node_areas:
            continue
        ftype = min(ftype, entry.forwarding_type)
        falgo = min(falgo, entry.forwarding_algorithm)
        if (
            ftype == PrefixForwardingType.IP
            and falgo == PrefixForwardingAlgorithm.SP_ECMP
        ):
            break
    return (ftype, falgo)


class _SparseIndexAdapter:
    """Gives the sparse device view the same id_of/node_names surface
    the dense GraphSnapshot provides to the query methods."""

    __slots__ = ("node_names", "node_index", "n", "n_pad")

    def __init__(self, graph):
        self.node_names = graph.node_names
        self.node_index = graph.node_index
        self.n = graph.n
        self.n_pad = graph.n_pad

    def id_of(self, node):
        return self.node_index.get(node)


class SpfView:
    """SPF results for one area as seen from one root node.

    Device backend: the batched {root} + neighbours distance rows and
    ECMP first-hop rows, solved on ``device`` and read back as one packed
    buffer (dense snapshot for moderate N, sliced-ELL bands past
    SPARSE_NODE_THRESHOLD). Host backend: the Dijkstra oracle.
    """

    def __init__(
        self,
        ls: LinkState,
        root: str,
        backend: str,
        snapshots: Optional[SnapshotCache] = None,
    ):
        self._ls = ls
        self._root = root
        self._backend = backend
        if backend == "device":
            if len(ls.get_adjacency_databases()) > SPARSE_NODE_THRESHOLD:
                self._init_device_sparse(snapshots)
            else:
                self._init_device(snapshots)
        elif backend == "host":
            self._spf = ls.get_spf_result(root)
        else:
            raise ValueError(f"unknown SPF backend {backend!r}")

    # -- device backend ---------------------------------------------------

    def _init_device(self, snapshots: SnapshotCache) -> None:
        """Batched {source} + neighbours SPF over the dense snapshot: the
        only rows a route rebuild consumes (source distances for best-path
        selection, neighbour rows for ECMP first hops and LFA). Readback
        is O(B x N), not O(N^2)."""
        from openr_tpu_torch.ops import spf as spf_ops

        self._snap = snapshots.get(self._ls)
        sid = self._snap.id_of(self._root)
        self._sid = sid
        if sid is None:
            return
        srcs, srcs_dev = spf_ops.source_batch(self._snap, sid, snapshots.device)
        dev = self._snap.device_arrays(snapshots.device)
        packed = spf_ops.spf_view_batch_packed(
            dev.metric, dev.overloaded, srcs_dev
        )
        self._set_rows(packed.cpu().numpy(), srcs, srcs_dev.shape[0])

    def _init_device_sparse(self, snapshots: SnapshotCache) -> None:
        """Large-area device view over sliced-ELL bands compiled from
        this topology version (shared with the KSP2 masked solve): the
        same batched view as the dense path, with no N x N matrix
        anywhere."""
        from openr_tpu_torch.ops import spf_sparse

        if self._root not in self._ls.get_adjacency_databases():
            self._snap = None
            self._sid = None
            return
        graph = snapshots.ell(self._ls)
        srcs = spf_sparse.ell_source_batch(graph, self._ls, self._root)
        packed = spf_sparse.ell_view_batch_packed(graph, srcs, snapshots.device)
        self._snap = _SparseIndexAdapter(graph)
        self._sid = graph.node_index[self._root]
        self._set_rows(packed.cpu().numpy(), srcs, len(srcs))

    def _set_rows(self, packed: np.ndarray, srcs: List[int], bucket: int) -> None:
        self._d = packed[:bucket]
        self._fh_batch = packed[bucket:].astype(bool)
        self._batch_srcs = srcs  # row i of _d is distances from srcs[i]
        # padding repeats the source id; keep the first (real) row
        row_of: Dict[int, int] = {}
        for i, nid in enumerate(srcs):
            row_of.setdefault(nid, i)
        self._row_of = row_of

    # -- queries ----------------------------------------------------------

    def is_reachable(self, dst: str) -> bool:
        if self._backend == "device":
            if self._sid is None:
                return dst == self._root
            did = self._snap.id_of(dst)
            return did is not None and self._d[0, did] < INF
        return dst in self._spf

    def metric_to(self, dst: str) -> Optional[Metric]:
        if self._backend == "device":
            if self._sid is None:
                return 0 if dst == self._root else None
            did = self._snap.id_of(dst)
            if did is None or self._d[0, did] >= INF:
                return None
            return int(self._d[0, did])
        res = self._spf.get(dst)
        return res.metric if res is not None else None

    def next_hops_toward(self, dst: str) -> Set[str]:
        if self._backend == "device":
            if self._sid is None:
                return set()
            did = self._snap.id_of(dst)
            if did is None:
                return set()
            col = self._fh_batch[: len(self._batch_srcs), did]
            return {
                self._snap.node_names[self._batch_srcs[i]]
                for i in np.nonzero(col)[0]
            }
        res = self._spf.get(dst)
        return set(res.next_hops) if res is not None else set()

    def metric_between(self, a: str, b: str) -> Optional[Metric]:
        """Distance from node a to b, where a is the root or one of its
        neighbours (all LFA needs — reference: Decision.cpp:1192). A node
        outside the device batch is answered by the host Dijkstra, and
        counted in ``SPF_COUNTERS["decision.spf_host_fallback"]``."""
        if a == b:
            return 0
        if self._backend == "device":
            if self._sid is None:
                return None
            aid, bid = self._snap.id_of(a), self._snap.id_of(b)
            if aid is None or bid is None:
                return None
            row = self._row_of.get(aid)
            if row is None:
                SPF_COUNTERS["decision.spf_host_fallback"] += 1
                res = self._ls.get_spf_result(a)
                return res[b].metric if b in res else None
            if self._d[row, bid] >= INF:
                return None
            return int(self._d[row, bid])
        res = self._ls.get_spf_result(a)
        return res[b].metric if b in res else None


class SpfSolver:
    """reference: openr/decision/Decision.h:202 SpfSolver (pImpl).

    ``device`` (None = CUDA; raises without CUDA) is where the "device"
    backend solves. The "host" backend never touches a device."""

    def __init__(
        self,
        my_node_name: str,
        enable_v4: bool = False,
        compute_lfa_paths: bool = False,
        enable_ordered_fib: bool = False,
        bgp_dry_run: bool = False,
        enable_best_route_selection: bool = True,
        backend: str = "device",
        device: DeviceLike = None,
    ):
        if backend not in ("device", "host"):
            raise ValueError(f"unknown SPF backend {backend!r}")
        self.my_node_name = my_node_name
        self.enable_v4 = enable_v4
        self.compute_lfa_paths = compute_lfa_paths
        self.enable_ordered_fib = enable_ordered_fib
        self.bgp_dry_run = bgp_dry_run
        self.enable_best_route_selection = enable_best_route_selection
        self.backend = backend
        self.device = resolve_device(device)
        self._snapshots = SnapshotCache(self.device)
        self.static_mpls_routes: Dict[int, List[NextHop]] = {}
        self.best_routes_cache: Dict[IpPrefix, BestRouteSelectionResult] = {}
        # per-graph SPF view cache: ls -> {(version, root): view}. Strong
        # keys, LRU-bounded: each view holds its graph, so a weak dict
        # could never collect
        self._views: Dict[LinkState, Dict] = {}
        # per-prefix-state-version KSP2 destination sets
        # (_prefetch_ksp2_paths)
        self._ksp2_dsts_cache: Optional[tuple] = None
        # host-clock split of the last build's KSP2 prefetch, in ms, summed
        # over areas: hop_gate (the unit-metric SPF of the hop gate), graph
        # (the in-edge bands), first_paths (host traces), masks, solve
        # (upload, masked device solve, readback), second_paths (traces,
        # priming); and the chunks and destinations it solved, and the
        # bytes of packed edge masks it uploaded (mask_bytes)
        self.ksp2_stats: Dict[str, float] = {}

    # -- static MPLS routes ----------------------------------------------

    def update_static_mpls_routes(
        self,
        routes_to_update: Dict[int, List[NextHop]],
        routes_to_delete: List[int],
    ) -> None:
        for label, nhs in routes_to_update.items():
            self.static_mpls_routes[label] = list(nhs)
        for label in routes_to_delete:
            self.static_mpls_routes.pop(label, None)

    # -- SPF views --------------------------------------------------------

    def _view(self, area: str, ls: LinkState, root: str) -> SpfView:
        del area  # identity of the LinkState object is the key
        per_ls = self._views.pop(ls, None)
        if per_ls is None:
            per_ls = {}
        # re-insert on hit: eviction is LRU
        self._views[ls] = per_ls
        while len(self._views) > VIEW_CACHE_CAP:
            self._views.pop(next(iter(self._views)))
        key = (ls.topology_version, root)
        view = per_ls.get(key)
        if view is None:
            # drop stale versions of this graph
            for k in [k for k in per_ls if k[0] != key[0]]:
                del per_ls[k]
            view = SpfView(ls, root, self.backend, self._snapshots)
            per_ls[key] = view
        return view

    # -- route build ------------------------------------------------------

    def build_route_db(
        self,
        my_node_name: str,
        area_link_states: AreaLinkStates,
        prefix_state: PrefixState,
    ) -> Optional[DecisionRouteDb]:
        """Full RIB computation. reference: Decision.cpp:569 buildRouteDb."""
        if not any(ls.has_node(my_node_name) for ls in area_link_states.values()):
            return None

        # KSP2 second paths, batched on the device and primed into each
        # area's kth-path cache before the prefix loop reads them
        self._prefetch_ksp2_paths(my_node_name, area_link_states, prefix_state)

        route_db = DecisionRouteDb()
        self.best_routes_cache.clear()
        for prefix in prefix_state.prefixes():
            entry = self.create_route_for_prefix(
                my_node_name, area_link_states, prefix_state, prefix
            )
            if entry is not None:
                route_db.add_unicast_route(entry)

        # MPLS routes for node (SR) labels
        label_to_node = self._build_node_label_routes(
            my_node_name, area_link_states
        )
        route_db.mpls_routes.update(
            {lab: ne[1] for lab, ne in label_to_node.items()}
        )

        # MPLS routes for adjacency labels
        for _, ls in sorted(area_link_states.items()):
            for link in ls.ordered_links_from_node(my_node_name):
                top_label = link.adj_label_from(my_node_name)
                if top_label == 0:
                    continue
                if not is_mpls_label_valid(top_label):
                    continue
                route_db.add_mpls_route(
                    RibMplsEntry(
                        top_label,
                        {
                            make_next_hop(
                                link.nh_v6_from(my_node_name),
                                link.iface_from(my_node_name),
                                link.metric_from(my_node_name),
                                MplsAction(action=MplsActionCode.PHP),
                                link.area,
                                link.other_node(my_node_name),
                            )
                        },
                    )
                )

        # static MPLS routes
        for label, nhs in self.static_mpls_routes.items():
            route_db.add_mpls_route(RibMplsEntry(label, set(nhs)))

        return route_db

    # -- node-label routes -------------------------------------------------

    def _derive_label_entry(
        self,
        my_node_name: str,
        node: str,
        area: str,
        area_link_states: AreaLinkStates,
        top_label: int,
    ) -> Optional[RibMplsEntry]:
        """One node's SR label route (POP to self; SWAP/PHP toward a
        remote node). None when the node is unreachable."""
        if node == my_node_name:
            nh = make_next_hop(
                BinaryAddress.from_str("::"),
                None,
                0,
                MplsAction(action=MplsActionCode.POP_AND_LOOKUP),
                area,
                None,
            )
            return RibMplsEntry(top_label, {nh})
        metric_nhs = self._get_next_hops_with_metric(
            my_node_name, {(node, area)}, False, area_link_states
        )
        if not metric_nhs[1]:
            return None
        return RibMplsEntry(
            top_label,
            self._get_next_hops(
                my_node_name,
                {(node, area)},
                False,
                False,
                metric_nhs[0],
                metric_nhs[1],
                top_label,
                area_link_states,
                {},
            ),
        )

    def _build_node_label_routes(
        self,
        my_node_name: str,
        area_link_states: AreaLinkStates,
    ) -> Dict[int, Tuple[str, RibMplsEntry]]:
        """SR node-label routes for every labeled node
        (reference: Decision.cpp:600-650 buildRouteDb label loop)."""
        label_to_node: Dict[int, Tuple[str, RibMplsEntry]] = {}
        for area, ls in sorted(area_link_states.items()):
            for node, adj_db in sorted(ls.get_adjacency_databases().items()):
                top_label = adj_db.node_label
                if top_label == 0:
                    continue
                if not is_mpls_label_valid(top_label):
                    continue
                # label collision: deterministically keep the smaller name
                # (reference: Decision.cpp:620-633)
                existing = label_to_node.get(top_label)
                if existing is not None and existing[0] < node:
                    continue
                entry = self._derive_label_entry(
                    my_node_name, node, area, area_link_states, top_label
                )
                if entry is None:
                    continue
                label_to_node[top_label] = (node, entry)
        return label_to_node

    # -- prefix routes -----------------------------------------------------

    def create_route_for_prefix(
        self,
        my_node_name: str,
        area_link_states: AreaLinkStates,
        prefix_state: PrefixState,
        prefix: IpPrefix,
    ) -> Optional[RibUnicastEntry]:
        """reference: Decision.cpp:402 createRouteForPrefix."""
        all_entries = prefix_state.entries_for(prefix)
        if not all_entries:
            return None
        self.best_routes_cache.pop(prefix, None)

        # keep only entries from nodes reachable in their own area
        entries: PrefixEntries = dict(all_entries)
        for area, ls in area_link_states.items():
            view = self._view(area, ls, my_node_name)
            for node_area in list(entries):
                node, prefix_area = node_area
                if area == prefix_area and not view.is_reachable(node):
                    del entries[node_area]
        if not entries:
            return None

        if prefix.is_v4 and not self.enable_v4:
            return None

        has_bgp = has_non_bgp = missing_mv = False
        has_self_prepend_label = True
        for node_area, entry in entries.items():
            is_bgp = entry.type == PrefixType.BGP
            has_bgp |= is_bgp
            has_non_bgp |= not is_bgp
            if node_area[0] == my_node_name:
                has_self_prepend_label &= entry.prepend_label is not None
            if is_bgp and entry.mv is None:
                missing_mv = True
        if has_bgp:
            if has_non_bgp and not self.enable_best_route_selection:
                return None
            if missing_mv:
                return None  # a BGP advertiser without its metric vector

        best = self._select_best_routes(
            my_node_name, entries, has_bgp, area_link_states
        )
        if not best.success:
            return None
        if not best.all_node_areas:
            return None
        self.best_routes_cache[prefix] = best

        # routes to self-advertised prefixes are already programmed locally
        # unless we advertise with a prepend label (anycast origination)
        if best.has_node(my_node_name) and not has_self_prepend_label:
            return None

        ftype, falgo = get_prefix_forwarding_type_and_algorithm(
            entries, best.all_node_areas
        )
        if falgo == PrefixForwardingAlgorithm.SP_ECMP:
            return self._select_best_paths_spf(
                my_node_name,
                prefix,
                best,
                entries,
                has_bgp,
                ftype,
                area_link_states,
            )
        if falgo == PrefixForwardingAlgorithm.KSP2_ED_ECMP:
            return self._select_best_paths_ksp2(
                my_node_name,
                prefix,
                best,
                entries,
                has_bgp,
                ftype,
                area_link_states,
            )
        return None

    # -- best route selection --------------------------------------------

    def _select_best_routes(
        self,
        my_node_name: str,
        entries: PrefixEntries,
        is_bgp: bool,
        area_link_states: AreaLinkStates,
    ) -> BestRouteSelectionResult:
        """reference: Decision.cpp:737 selectBestRoutes."""
        ret = BestRouteSelectionResult()
        if self.enable_best_route_selection:
            ret.all_node_areas = select_best_prefix_metrics(entries)
            if ret.all_node_areas:
                ret.best_node_area = select_best_node_area(
                    ret.all_node_areas, my_node_name
                )
            ret.success = True
        elif is_bgp:
            return self._run_best_path_selection_bgp(
                my_node_name, entries, area_link_states
            )
        else:
            ret.all_node_areas = set(entries)
            ret.best_node_area = min(ret.all_node_areas)
            ret.success = True
        return self._maybe_filter_drained_nodes(ret, area_link_states)

    def _run_best_path_selection_bgp(
        self,
        my_node_name: str,
        entries: PrefixEntries,
        area_link_states: AreaLinkStates,
    ) -> BestRouteSelectionResult:
        """MetricVector-ordered BGP best-path selection.
        reference: Decision.cpp:807 runBestPathSelectionBgp."""
        from openr_tpu_torch.decision.metric_vector import (
            CompareResult,
            compare_metric_vectors,
        )

        ret = BestRouteSelectionResult()
        best_vector = None
        for node_area in sorted(entries):
            entry = entries[node_area]
            result = (
                CompareResult.WINNER
                if best_vector is None
                else compare_metric_vectors(entry.mv, best_vector)
            )
            if result in (CompareResult.TIE, CompareResult.ERROR):
                return ret  # ambiguous ordering: no route (success=False)
            if result == CompareResult.WINNER:
                ret.all_node_areas.clear()
            if result in (CompareResult.WINNER, CompareResult.TIE_WINNER):
                best_vector = entry.mv
                ret.best_node_area = node_area
            if result in (
                CompareResult.WINNER,
                CompareResult.TIE_WINNER,
                CompareResult.TIE_LOOSER,
            ):
                ret.all_node_areas.add(node_area)
        ret.success = True
        return self._maybe_filter_drained_nodes(ret, area_link_states)

    def _maybe_filter_drained_nodes(
        self,
        result: BestRouteSelectionResult,
        area_link_states: AreaLinkStates,
    ) -> BestRouteSelectionResult:
        """Drop overloaded (drained) advertisers; if everyone is drained,
        fall back to the unfiltered set. The representative best_node_area
        is kept as originally selected (matches the reference exactly).
        reference: Decision.cpp:783 maybeFilterDrainedNodes."""
        filtered = BestRouteSelectionResult(
            success=result.success,
            all_node_areas={
                (node, area)
                for node, area in result.all_node_areas
                if area not in area_link_states
                or not area_link_states[area].is_node_overloaded(node)
            },
            best_node_area=result.best_node_area,
        )
        return result if not filtered.all_node_areas else filtered

    def _get_min_next_hop_threshold(
        self, best: BestRouteSelectionResult, entries: PrefixEntries
    ) -> Optional[int]:
        """Max of advertised minNexthop requirements among best advertisers.
        reference: Decision.cpp:767 getMinNextHopThreshold."""
        threshold: Optional[int] = None
        for node_area in best.all_node_areas:
            entry = entries.get(node_area)
            if entry is None or entry.min_nexthop is None:
                continue
            if threshold is None or entry.min_nexthop > threshold:
                threshold = entry.min_nexthop
        return threshold

    # -- SP_ECMP ----------------------------------------------------------

    def _select_best_paths_spf(
        self,
        my_node_name: str,
        prefix: IpPrefix,
        best: BestRouteSelectionResult,
        entries: PrefixEntries,
        is_bgp: bool,
        ftype: PrefixForwardingType,
        area_link_states: AreaLinkStates,
    ) -> Optional[RibUnicastEntry]:
        """reference: Decision.cpp:847 selectBestPathsSpf."""
        per_destination = ftype == PrefixForwardingType.SR_MPLS

        # anycast origination: if we also advertise this prefix with a
        # prepend label, don't compute paths toward ourselves
        filtered_best = set(best.all_node_areas)
        if best.has_node(my_node_name) and per_destination:
            for node_area, entry in entries.items():
                if node_area[0] == my_node_name and entry.prepend_label is not None:
                    filtered_best.discard(node_area)
                    break

        min_metric, next_hop_nodes = self._get_next_hops_with_metric(
            my_node_name, filtered_best, per_destination, area_link_states
        )
        if not next_hop_nodes:
            return None

        next_hops = self._get_next_hops(
            my_node_name,
            best.all_node_areas,
            prefix.is_v4,
            per_destination,
            min_metric,
            next_hop_nodes,
            None,
            area_link_states,
            entries,
        )
        return self._add_best_paths(
            my_node_name, prefix, best, entries, is_bgp, next_hops
        )

    # -- KSP2_ED_ECMP -----------------------------------------------------

    def _prefetch_ksp2_paths(
        self,
        my_node_name: str,
        area_link_states: AreaLinkStates,
        prefix_state: PrefixState,
    ) -> None:
        """Batch the KSP2 second-path SPFs onto the device.

        Host semantics (LinkState.get_kth_paths, reference
        LinkState.cpp:763) run one Dijkstra per destination over the graph
        minus that destination's first-path links. Here each area with at
        least KSP2_DEVICE_MIN_DSTS KSP2 destinations solves them as
        masked graphs on the device (``_prefetch_ksp2_area``) and primes
        the area's kth-path cache; the others take the host path lazily.

        The reference returns the incremental engine's affected set here
        for its route-reuse cache; the port has neither yet, so every
        build is a full build and nothing is returned."""
        self.ksp2_stats = {}
        if self.backend != "device":
            return
        # the destination scan is O(total prefix entries): cache it per
        # prefix-state version
        dsts_key = (
            prefix_state,
            prefix_state.version,
            my_node_name,
            tuple(sorted(area_link_states)),
        )
        if self._ksp2_dsts_cache is not None and self._ksp2_dsts_cache[0] == dsts_key:
            area_dsts = self._ksp2_dsts_cache[1]
        else:
            area_dsts = {area: set() for area in area_link_states}
            for prefix in prefix_state.prefixes():
                for (node, p_area), entry in prefix_state.entries_for(prefix).items():
                    if (
                        entry.forwarding_algorithm
                        == PrefixForwardingAlgorithm.KSP2_ED_ECMP
                        and node != my_node_name
                        and p_area in area_dsts
                    ):
                        area_dsts[p_area].add(node)
            self._ksp2_dsts_cache = (dsts_key, area_dsts)
        for area, ls in sorted(area_link_states.items()):
            dsts = sorted(area_dsts[area])
            if len(dsts) < KSP2_DEVICE_MIN_DSTS or not ls.has_node(my_node_name):
                continue  # area covered by the host path
            self._prefetch_ksp2_area(ls, my_node_name, dsts)

    def _prefetch_ksp2_area(
        self, ls: LinkState, my_node_name: str, dsts: List[str]
    ) -> None:
        """One area's KSP2 second paths by the reference's per-build
        chunked masked dispatch (``spf_solver.py:2161-2213``), at every
        area size: trace the first paths on the host, mask each
        destination's first-path links, solve every destination's masked
        graph on the device in chunks of ``_ksp2_chunk``, trace the second
        paths from the rows and prime them into ``ls``. The reference's
        incremental ``Ksp2Engine`` branch (areas of at most its
        ``ENGINE_MAX_NODES``) is not ported yet; both prime the same
        ``get_kth_paths`` semantics."""
        from openr_tpu_torch.decision import ksp2_engine
        from openr_tpu_torch.ops import spf_sparse

        stats = self.ksp2_stats
        last = [time.perf_counter()]

        def lap(part: str) -> None:
            # host ms since the previous lap, added to stats[part]
            now = time.perf_counter()
            stats[part] = stats.get(part, 0.0) + (now - last[0]) * 1e3
            last[0] = now

        high_diameter = ls.get_max_hops_to_node(my_node_name) > KSP2_DEVICE_MAX_HOPS
        lap("hop_gate_ms")
        if high_diameter:
            return  # host Dijkstra wins
        graph = self._snapshots.ell(ls)
        sid = graph.node_index.get(my_node_name)
        if sid is None:
            return
        lap("graph_ms")
        # first paths: host trace off the one memoized base SPF
        exclusion_sets = []
        for dst in dsts:
            links: Set[Link] = set()
            for path in ls.get_kth_paths(my_node_name, dst, 1):
                links.update(path)
            exclusion_sets.append(links)
        cands_of = ksp2_engine.make_cands_of(ls, graph.node_index)
        transit_blocked = {
            name
            for name in graph.node_names
            if ls.is_node_overloaded(name) and name != my_node_name
        }
        lap("first_paths_ms")
        chunk = _ksp2_chunk(graph)
        for start in range(0, len(dsts), chunk):
            batch_dsts = dsts[start : start + chunk]
            batch_excl = exclusion_sets[start : start + chunk]
            pad = chunk - len(batch_dsts)
            # pad rows solve the unmasked graph and are never traced
            masks, ok = spf_sparse.build_edge_masks(
                graph, batch_excl + [set()] * pad
            )
            stats["mask_bytes"] = stats.get("mask_bytes", 0) + sum(m.nbytes for m in masks)
            lap("masks_ms")
            drows = spf_sparse.ell_masked_distances(graph, sid, masks, self.device)
            lap("solve_ms")
            SPF_COUNTERS["decision.ksp2_device_batches"] += 1
            for i, dst in enumerate(batch_dsts):
                if not ok[i]:
                    SPF_COUNTERS["decision.ksp2_host_fallbacks"] += 1
                    continue  # host path computes it lazily
                paths = ksp2_engine.trace_paths_from_row(
                    my_node_name,
                    dst,
                    graph.node_index,
                    drows[i].tolist(),
                    batch_excl[i],
                    cands_of,
                    transit_blocked,
                )
                ls.prime_kth_paths(my_node_name, dst, 2, paths)
            lap("second_paths_ms")
        stats["chunks"] = stats.get("chunks", 0) + -(-len(dsts) // chunk)
        stats["dsts"] = stats.get("dsts", 0) + len(dsts)

    def _select_best_paths_ksp2(
        self,
        my_node_name: str,
        prefix: IpPrefix,
        best: BestRouteSelectionResult,
        entries: PrefixEntries,
        is_bgp: bool,
        ftype: PrefixForwardingType,
        area_link_states: AreaLinkStates,
    ) -> Optional[RibUnicastEntry]:
        """2-shortest edge-disjoint ECMP over SR-MPLS tunnels.
        reference: Decision.cpp:908 selectBestPathsKsp2."""
        if ftype != PrefixForwardingType.SR_MPLS:
            return None

        next_hops: Set[NextHop] = set()
        paths: List[Tuple[str, list]] = []  # (area, path)

        for area, ls in sorted(area_link_states.items()):
            for node, best_area in sorted(best.all_node_areas):
                if node == my_node_name and best_area == area:
                    continue
                for path in ls.get_kth_paths(my_node_name, node, 1):
                    paths.append((area, path))

            first_count = len(paths)
            for node, best_area in sorted(best.all_node_areas):
                if area != best_area:
                    continue
                for sec_path in ls.get_kth_paths(my_node_name, node, 2):
                    # avoid double-spray: drop second paths that contain a
                    # first path (anycast in meshes)
                    if any(
                        LinkState.path_a_in_path_b(paths[i][1], sec_path)
                        for i in range(first_count)
                    ):
                        continue
                    paths.append((area, sec_path))

        if not paths:
            return None

        for path_area, path in paths:
            ls = area_link_states[path_area]
            adj_dbs = ls.get_adjacency_databases()
            cost = 0
            labels: List[int] = []
            next_node = my_node_name
            valid = True
            for link in path:
                hop_metric, next_node = link.metric_and_other(next_node)
                cost += hop_metric
                db = adj_dbs.get(next_node)
                if db is None:
                    valid = False
                    break
                labels.append(db.node_label)
            if not valid:
                continue
            # stack order: bottom-of-stack first => reverse the hop
            # order, then drop the first hop's own label (PHP)
            del labels[0]
            labels.reverse()
            dst_entry = entries.get((next_node, path_area))
            if dst_entry is not None and dst_entry.prepend_label is not None:
                labels.insert(0, dst_entry.prepend_label)

            mpls_action = None
            if labels:
                mpls_action = MplsAction(
                    action=MplsActionCode.PUSH, push_labels=tuple(labels)
                )
            first_link = path[0]
            next_hops.add(
                make_next_hop(
                    first_link.nh_v4_from(my_node_name)
                    if prefix.is_v4
                    else first_link.nh_v6_from(my_node_name),
                    first_link.iface_from(my_node_name),
                    cost,
                    mpls_action,
                    first_link.area,
                    first_link.other_node(my_node_name),
                )
            )

        return self._add_best_paths(
            my_node_name, prefix, best, entries, is_bgp, next_hops
        )

    def _add_best_paths(
        self,
        my_node_name: str,
        prefix: IpPrefix,
        best: BestRouteSelectionResult,
        entries: PrefixEntries,
        is_bgp: bool,
        next_hops: Set[NextHop],
    ) -> Optional[RibUnicastEntry]:
        """reference: Decision.cpp:1033 addBestPaths."""
        min_next_hop = self._get_min_next_hop_threshold(best, entries)
        if min_next_hop is not None and min_next_hop > len(next_hops):
            return None

        if best.has_node(my_node_name):
            prepend_label = None
            for node_area, entry in entries.items():
                if node_area[0] == my_node_name and entry.prepend_label is not None:
                    prepend_label = entry.prepend_label
                    break
            if prepend_label is None:
                raise RuntimeError("self route without prepend label")
            static_nhs = self.static_mpls_routes.get(prepend_label)
            if static_nhs:
                for nh in static_nhs:
                    next_hops.add(make_next_hop(nh.address, None, 0, None))

        best_entry = entries[best.best_node_area]
        return RibUnicastEntry(
            prefix=prefix,
            nexthops=next_hops,
            best_prefix_entry=best_entry,
            best_area=best.best_node_area[1],
            do_not_install=is_bgp and self.bgp_dry_run,
        )

    # -- next-hop math ----------------------------------------------------

    def _get_min_cost_nodes(
        self, view: SpfView, dst_node_areas: Set[NodeAndArea]
    ) -> Tuple[Metric, Set[str]]:
        """reference: Decision.cpp:1099 getMinCostNodes."""
        shortest: Optional[Metric] = None
        min_cost_nodes: Set[str] = set()
        for dst_node, _ in dst_node_areas:
            metric = view.metric_to(dst_node)
            if metric is None:
                continue
            if shortest is None or shortest >= metric:
                if shortest is None or shortest > metric:
                    shortest = metric
                    min_cost_nodes.clear()
                min_cost_nodes.add(dst_node)
        return (shortest if shortest is not None else -1, min_cost_nodes)

    def _get_next_hops_with_metric(
        self,
        my_node_name: str,
        dst_node_areas: Set[NodeAndArea],
        per_destination: bool,
        area_link_states: AreaLinkStates,
    ) -> Tuple[Metric, Dict[Tuple[str, str], Metric]]:
        """Map (first-hop node, dst) -> remaining distance from that first
        hop to the destination. reference: Decision.cpp:1124."""
        next_hop_nodes: Dict[Tuple[str, str], Metric] = {}
        shortest: Optional[Metric] = None

        for area, ls in sorted(area_link_states.items()):
            view = self._view(area, ls, my_node_name)
            area_min, min_cost_nodes = self._get_min_cost_nodes(
                view, dst_node_areas
            )
            if not min_cost_nodes:
                continue
            if shortest is not None and shortest < area_min:
                continue
            if shortest is None or shortest > area_min:
                shortest = area_min
                next_hop_nodes.clear()

            for dst_node in min_cost_nodes:
                dst_ref = dst_node if per_destination else ""
                for nh in view.next_hops_toward(dst_node):
                    next_hop_nodes[(nh, dst_ref)] = shortest - view.metric_to(nh)

            if self.compute_lfa_paths:
                # RFC 5286 loop-free alternates
                for link in ls.ordered_links_from_node(my_node_name):
                    if not link.is_up():
                        continue
                    neighbor = link.other_node(my_node_name)
                    neighbor_to_here = view.metric_between(
                        neighbor, my_node_name
                    )
                    if neighbor_to_here is None:
                        continue
                    for dst_node, dst_area in dst_node_areas:
                        if area != dst_area:
                            continue
                        dist_from_neighbor = view.metric_between(
                            neighbor, dst_node
                        )
                        if dist_from_neighbor is None:
                            continue
                        if dist_from_neighbor < shortest + neighbor_to_here:
                            key = (
                                neighbor,
                                dst_node if per_destination else "",
                            )
                            prev = next_hop_nodes.get(key)
                            if prev is None or prev > dist_from_neighbor:
                                next_hop_nodes[key] = dist_from_neighbor

        return (shortest if shortest is not None else -1, next_hop_nodes)

    def _get_next_hops(
        self,
        my_node_name: str,
        dst_node_areas: Set[NodeAndArea],
        is_v4: bool,
        per_destination: bool,
        min_metric: Metric,
        next_hop_nodes: Dict[Tuple[str, str], Metric],
        swap_label: Optional[int],
        area_link_states: AreaLinkStates,
        entries: PrefixEntries,
    ) -> Set[NextHop]:
        """Materialize per-link next-hops from the first-hop node map.
        reference: Decision.cpp:1211 getNextHopsThrift."""
        next_hops: Set[NextHop] = set()
        for area, ls in sorted(area_link_states.items()):
            for link in ls.ordered_links_from_node(my_node_name):
                dst_iter = (
                    sorted(dst_node_areas) if per_destination else [("", "")]
                )
                for dst_node, dst_area in dst_iter:
                    if dst_area and dst_area != area:
                        continue
                    neighbor = link.other_node(my_node_name)
                    remaining = next_hop_nodes.get((neighbor, dst_node))
                    if remaining is None or not link.is_up():
                        continue
                    # don't reach dst via another destination node
                    if (
                        dst_node
                        and (neighbor, area) in dst_node_areas
                        and neighbor != dst_node
                    ):
                        continue
                    dist_over_link = link.metric_from(my_node_name) + remaining
                    # without LFA only shortest-path links qualify
                    if not self.compute_lfa_paths and dist_over_link != min_metric:
                        continue

                    mpls_action = None
                    if swap_label is not None:
                        nh_is_dst = (neighbor, area) in dst_node_areas
                        mpls_action = (
                            MplsAction(action=MplsActionCode.PHP)
                            if nh_is_dst
                            else MplsAction(
                                action=MplsActionCode.SWAP,
                                swap_label=swap_label,
                            )
                        )
                    if dst_node:
                        push_labels: List[int] = []
                        dst_entry = entries.get((dst_node, area))
                        if dst_entry is not None and dst_entry.prepend_label is not None:
                            push_labels.append(dst_entry.prepend_label)
                            if not is_mpls_label_valid(push_labels[-1]):
                                continue
                        if dst_node != neighbor:
                            db = ls.get_adjacency_databases().get(dst_node)
                            if db is None:
                                continue
                            push_labels.append(db.node_label)
                            if not is_mpls_label_valid(push_labels[-1]):
                                continue
                        if push_labels:
                            mpls_action = MplsAction(
                                action=MplsActionCode.PUSH,
                                push_labels=tuple(push_labels),
                            )

                    next_hops.add(
                        make_next_hop(
                            link.nh_v4_from(my_node_name)
                            if is_v4
                            else link.nh_v6_from(my_node_name),
                            link.iface_from(my_node_name),
                            dist_over_link,
                            mpls_action,
                            link.area,
                            link.other_node(my_node_name),
                        )
                    )
        return next_hops
