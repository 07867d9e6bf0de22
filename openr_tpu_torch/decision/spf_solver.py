"""SpfSolver: per-prefix best-route selection and next-hop computation.

Port note: mirrors ``openr_tpu/decision/spf_solver.py`` for the SP_ECMP
and KSP2_ED_ECMP route builds. Shortest-path distances and ECMP
first-hop sets come from the port's torch ops on the solver's device
("device" backend: the dense snapshot up to ``SPARSE_NODE_THRESHOLD``
nodes, sliced-ELL bands above it), or from the host Dijkstra oracle
("host" backend). The sliced-ELL bands stay resident on the device
across topology versions (``_EllResidentCache``, one per solver): the
LinkState journal drives ``ell_patch`` and a warm-started
``EllState.reconverge``. KSP2 second paths come from the incremental
``Ksp2Engine`` (``decision/ksp2_engine.py``) in areas of at most
``ksp2_engine.engine_max_nodes()`` nodes: paths kept across churn, only
the affected destinations re-solved, the root's SPF view served from the
engine's fused dispatch (``_EllResidentCache.preload_view``), and KSP2
routes outside the affected set reused (``decision.ksp2_route_reuses``).
Larger areas, and roots other than an area engine's, take the per-build
chunked masked dispatch over the same resident bands. Both prime the
``LinkState``'s kth-path cache; the host backend computes second paths
lazily with ``LinkState.get_kth_paths``. SP_ECMP routes are reused
across builds where the SP dirty test (``_sp_dirty_nodes``) proves their
inputs unchanged, and node-label routes are patched in O(dirty).

One departure from the reference: when the root's overload bit flips,
the engine path puts the root into the area's affected set, so no route
of a prefix the root advertises is reused across its drain or undrain
(the reference's engine reuses them; its own host backend and chunked
dispatch do not). The "native" backend answers from the host C++ core
(``graph/native_spf.py``), the degradation ladder's last rung in Decision;
``prewarm`` and ``speculate_views`` are Decision's publication-time hooks;
a fresh device view solve crosses the fault seam ``decision.spf_solve``;
a plugin may register a backend of its own (``register_spf_backend``).
The view cache is an LRU of ``view_cache_cap`` graphs
(``OPENR_VIEW_CACHE_CAP``, ``route_engine.view_evictions``); with
``world_batch`` (``OPENR_WORLD_BATCH=1``) a build first solves every
area's view as one tenant-plane dispatch (``_world_preload`` over
``ops.world_batch``'s process-wide manager on the solver's device) and
preloads the views for the per-area builds, and ``fleet_preload_views``
installs a solver service's views for the next build; a failed preload
is counted (``decision.world_preload_failures``) and the areas are solved
one by one on the same device. Left out for a later slice: the state
hooks of the resident cache (``export_resident_state``,
``seed_resident_state``).

Behavioural parity with the reference ``openr/decision/Decision.cpp``
SpfSolverImpl (buildRouteDb:569, createRouteForPrefix:402,
selectBestRoutes:737, maybeFilterDrainedNodes:783, selectBestPathsSpf:847,
addBestPaths:1033, getNextHopsWithMetric:1124, getNextHopsThrift:1211).
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

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
from openr_tpu_torch.faults.injector import fault_point, get_injector, register_fault_site
from openr_tpu_torch.graph.linkstate import Link, LinkState
from openr_tpu_torch.graph.snapshot import INF, SnapshotCache
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops import spf_sparse
from openr_tpu_torch.ops.staging import UploadStager
from openr_tpu_torch.telemetry import get_registry
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

# solver counters, by the JAX package's names, stored in the port's
# telemetry registry (``SPF_COUNTERS[k] += 1`` and ``dict(SPF_COUNTERS)``
# work as on a dict), so ``Decision.get_counters`` and a registry snapshot
# read the same names. spf_host_fallback counts the device views' queries
# answered by a host Dijkstra instead: it must stay at 0 on the
# route-build path. ell_full_compiles and ell_patches count the resident
# bands' syncs (a full compile_ell, or an ell_patch of the journal's
# affected rows), ell_prewarms the publication-time syncs of ``prewarm``.
# ksp2_device_batches counts masked KSP2 solves (one per chunk of
# destinations); ksp2_host_fallbacks counts destinations of such a batch
# whose exclusions the masks could not express, left to the lazy host
# path. The KSP2 engine's: ksp2_cold_builds and ksp2_incremental_syncs
# count its syncs by kind, ksp2_warm_dispatches its fused dispatches
# seeded warm, ksp2_affected_dsts the destinations its incremental syncs
# marked affected, and ksp2_route_reuses the KSP2 routes a build took
# from the previous build. sp_route_reuses counts SP routes a build took
# from the previous build. device_state_resets and backend_switches count
# reset_device_state and set_backend calls.
SPF_COUNTERS = get_registry().counter_dict(
    [
        "decision.spf_host_fallback",
        "decision.ell_full_compiles",
        "decision.ell_patches",
        "decision.ell_prewarms",
        "decision.ksp2_device_batches",
        "decision.ksp2_host_fallbacks",
        "decision.ksp2_cold_builds",
        "decision.ksp2_incremental_syncs",
        "decision.ksp2_warm_dispatches",
        "decision.ksp2_affected_dsts",
        "decision.ksp2_route_reuses",
        "decision.sp_route_reuses",
        "decision.device_state_resets",
        "decision.backend_switches",
        # multi-area batched dispatch (ops.world_batch): builds whose
        # area views were solved as one tenant-plane dispatch, and
        # preload attempts that fell back to sequential solves
        "decision.world_preloads",
        "decision.world_preload_failures",
        # SpfSolver._views LRU demotions: a hot loop here means the view
        # cache cap (OPENR_VIEW_CACHE_CAP) is below the live area count
        "route_engine.view_evictions",
    ]
)

# the Decision degradation ladder's injection seam: a fresh device view
# solve (see openr_tpu_torch.faults)
FAULT_SPF_SOLVE = register_fault_site("decision.spf_solve")

SPF_BACKENDS = ("device", "host", "native")

# Alternate solver backends registered by plugins (reference: the
# pluginStart registration point, openr/plugin/Plugin.h:24-34). A factory
# takes (link_state, root) and returns an object implementing the SpfView
# query protocol: is_reachable / metric_to / next_hops_toward /
# metric_between. A registered backend runs only where the caller names
# it: the built-in names cannot be taken, and no rung of Decision's
# ladder steps down to one.
_SPF_BACKENDS: Dict[str, Callable[[LinkState, str], object]] = {}


def register_spf_backend(name: str, factory) -> None:
    """Register a custom SPF view backend usable as
    ``SpfSolver(..., backend=name)``. Built-in names ("device", "native",
    "host") cannot be overridden."""
    assert name not in SPF_BACKENDS, name
    _SPF_BACKENDS[name] = factory


def unregister_spf_backend(name: str) -> None:
    _SPF_BACKENDS.pop(name, None)


def _check_backend(backend: str) -> None:
    if backend not in SPF_BACKENDS and backend not in _SPF_BACKENDS:
        raise ValueError(f"unknown SPF backend {backend!r}")


def get_spf_counters() -> Dict[str, int]:
    """``SPF_COUNTERS``, the dispatch accounting's ``ops.*`` counters and,
    under "decision.", the resident bands' ``spf_sparse.ELL_COUNTERS``:
    one merged view."""
    out = dict(SPF_COUNTERS)
    reg = get_registry()
    # the committed-dispatch accounting and the executable cache's counters
    for k in ("ops.host_dispatches", "ops.blocking_syncs", "ops.async_reaps",
              "ops.aot_compiles", "ops.aot_hits", "ops.aot_fallbacks"):
        out[k] = reg.counter_get(k)
    for k, v in spf_sparse.ELL_COUNTERS.items():
        out["decision." + k] = v
    return out


# weakly keyed by the LIVE LinkState, so a recycled id() can never serve
# a dead graph's signature
_LINKS_SIG_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

_EMPTY_PREFIXES: frozenset = frozenset()


def _local_links_sig(ls: LinkState, node: str) -> tuple:
    """Signature of every route input read off the root's own links
    during next-hop materialization (Decision.cpp:1211): iface, metric,
    peer, liveness, v6/v4 next-hop addresses. Shared by the node-label
    and SP-reuse caches. Memoized per live graph x (topology version,
    attribute version, node): every field moves one of the two versions
    when it changes."""
    per_ls = _LINKS_SIG_MEMO.get(ls)
    if per_ls is None:
        per_ls = {}
        _LINKS_SIG_MEMO[ls] = per_ls
    key = (ls.topology_version, ls.attributes_version, node)
    sig = per_ls.get(key)
    if sig is None:
        while len(per_ls) > 32:  # a few roots x live versions
            per_ls.pop(next(iter(per_ls)))
        sig = tuple(
            (
                link.iface_from(node),
                link.metric_from(node),
                link.other_node(node),
                link.is_up(),
                link.nh_v6_from(node).addr,
                link.nh_v4_from(node).addr,
            )
            for link in ls.ordered_links_from_node(node)
        )
        per_ls[key] = sig
    return sig


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

# SpfSolver._views LRU capacity (graphs, not views). Overridable per
# solver via the view_cache_cap constructor arg.
VIEW_CACHE_CAP_DEFAULT = int(os.environ.get("OPENR_VIEW_CACHE_CAP", "4") or 4)


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

    __slots__ = ("node_names", "node_index", "n", "n_pad", "overloaded")

    def __init__(self, graph):
        # alias, don't copy: ell_patch passes the name tuple through, so
        # its identity survives churn (the labels cache keys on it)
        self.node_names = graph.node_names
        self.node_index = graph.node_index
        self.n = graph.n
        self.n_pad = graph.n_pad
        self.overloaded = graph.overloaded

    def id_of(self, node):
        return self.node_index.get(node)


# every live solver's device caches, for reset_device_caches
_DEVICE_CACHES: "weakref.WeakSet" = weakref.WeakSet()


class _EllResidentCache:
    """Device-resident sliced-ELL state (``EllState``) per LinkState
    identity, weakly keyed, on one device; its host-to-device copies go
    through one pinned ``UploadStager`` (the solver's, shared with its
    snapshots).

    On a topology change the LinkState journal's affected set drives
    ``ell_patch(widen=True)``; the patched rows land in the resident
    bands with the next warm solve (``view_packed``) or without one
    (``state_for``). Only a node-set change or a journal gap compiles
    from scratch. A scatter or solve that raises drops the entry, so the
    next build compiles cold; the error goes on up.

    A KSP2 engine solves the root's view inside its own fused dispatch and
    preloads it here (``preload_view``); ``view_packed`` hands a matching
    preloaded view out once instead of solving."""

    def __init__(self, device: DeviceLike = None,
                 stager: Optional[UploadStager] = None) -> None:
        self.device = resolve_device(device)
        self.stager = stager if stager is not None else UploadStager(self.device)
        # ls -> (synced topology_version, EllState)
        self._cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        # views solved by the KSP2 engines this build, consumed once by
        # view_packed: (weakref(ls), version, root, graph, srcs, packed).
        # Identity goes through the weakref, so a recycled id() never
        # serves a dead graph's rows; bounded FIFO
        self._preloaded: List[tuple] = []
        _DEVICE_CACHES.add(self)

    def invalidate(self) -> None:
        self._cache = weakref.WeakKeyDictionary()
        self._preloaded = []

    def preload_view(self, ls: LinkState, graph, srcs: List[int], packed: np.ndarray) -> None:
        self.preload_views(ls, [(graph, srcs, packed)])

    def preload_views(self, ls: LinkState, views) -> None:
        """Install solved views ``[(graph, srcs, packed)]`` of ``ls`` at
        its current version, each for the root ``srcs[0]`` names."""
        # entries of dead graphs can never match: drop them, so their
        # packed rows do not stay behind a dead LinkState
        self._preloaded = [e for e in self._preloaded if e[0]() is not None]
        for graph, srcs, packed in views:
            root = graph.node_names[srcs[0]]
            self._preloaded.append(
                (weakref.ref(ls), ls.topology_version, root, graph, srcs, packed)
            )
        # bound unconsumed entries, never below the area count (every
        # area engine preloads before any view is consumed) nor below
        # this batch's size
        cap = max(8, len(self._cache), len(views))
        del self._preloaded[:-cap]

    def has_preloaded(self, ls: LinkState, root: str) -> bool:
        """True when ``view_packed`` would hand out a preloaded view (no
        device work)."""
        return any(
            e[0]() is ls and e[1] == ls.topology_version and e[2] == root
            for e in self._preloaded
        )

    def drop(self, ls: LinkState) -> None:
        self._cache.pop(ls, None)

    def _sync(self, ls: LinkState):
        """``(state, pending)``: ``pending`` is a journaled patched
        EllGraph whose rows are not in the resident bands yet (None when
        the bands are current or were just compiled). The caller commits
        the cache version once the rows have landed."""
        entry = self._cache.get(ls)
        if entry is not None:
            version, state = entry
            if version == ls.topology_version:
                return state, None
            affected = ls.affected_since(version)
            patched = (
                spf_sparse.ell_patch(state.graph, ls, sorted(affected), widen=True)
                if affected is not None
                else None
            )
            if patched is not None:
                SPF_COUNTERS["decision.ell_patches"] += 1
                return state, patched
        state = spf_sparse.EllState(spf_sparse.compile_ell(ls), self.device, self.stager)
        SPF_COUNTERS["decision.ell_full_compiles"] += 1
        self._cache[ls] = (ls.topology_version, state)
        return state, None

    def state_for(self, ls: LinkState) -> "spf_sparse.EllState":
        """The synced resident state for solve-free consumers (the KSP2
        masked batches): pending rows are scattered without a view
        solve."""
        state, pending = self._sync(ls)
        if pending is not None:
            try:
                state.apply_patch(pending)
            except BaseException:
                self.drop(ls)
                raise
            self._cache[ls] = (ls.topology_version, state)
        return state

    def view_packed(self, ls: LinkState, root: str):
        """Sync the resident bands to ``ls`` and solve the batched
        {root} + neighbours view; pending patch rows ride the fused
        scatter + solve (``EllState.reconverge``). Returns (EllGraph,
        batch srcs, packed [2B, n_pad] host array: B distance rows, then
        B first-hop rows). A preloaded view of ``ls`` at its version and
        ``root`` is handed out, once, instead."""
        for i, (ls_ref, version, entry_root, graph, srcs, packed) in enumerate(self._preloaded):
            if ls_ref() is ls and version == ls.topology_version and entry_root == root:
                del self._preloaded[i]
                return graph, srcs, packed
        state, pending = self._sync(ls)
        graph = pending if pending is not None else state.graph
        srcs = spf_sparse.ell_source_batch(graph, ls, root)
        try:
            packed = da.reap_read(state.reconverge(graph, srcs))
        except BaseException:
            self.drop(ls)
            raise
        self._cache[ls] = (ls.topology_version, state)
        return state.graph, srcs, packed


def fleet_preload_views(ls: LinkState, views) -> None:
    """Install one batched wave's per-vantage solved views (a solver
    service's fan-in): each ``(graph, srcs, packed)`` triple is consumed
    once by the matching root's next SpfView of ``ls``, so N vantage
    route rebuilds follow one ``world_dispatch`` with no further device
    work. The reference keeps one process-wide resident cache; the port's
    are per solver, so every live one takes the views."""
    for cache in list(_DEVICE_CACHES):
        if isinstance(cache, _EllResidentCache):
            cache.preload_views(ls, views)


def reset_device_caches() -> None:
    """Drop every live solver's device-derived caches (resident ELL
    bands, preloaded views, compiled graph snapshots) and the tenant
    plane's world managers: the next build recompiles and re-lands
    everything from the LinkState alone, so a torn dispatch never leaves
    half-synced resident state behind."""
    for cache in list(_DEVICE_CACHES):
        cache.invalidate()
    from openr_tpu_torch.ops import world_batch

    world_batch.reset_world_manager()


class SpfView:
    """SPF results for one area as seen from one root node.

    Device backend: the batched {root} + neighbours distance rows and
    ECMP first-hop rows, solved on ``device`` and read back as one packed
    buffer (dense snapshot for moderate N, the resident sliced-ELL bands
    of ``resident`` past SPARSE_NODE_THRESHOLD, or at any size when a
    KSP2 engine preloaded this view there; a private resident cache when
    None). Host backend: the Dijkstra oracle; its view has no ``_d`` rows,
    so the SP dirty test never reuses a host build. Native backend: the
    host C++ core (``graph/native_spf.py``) over the host ``GraphSnapshot``
    (all-pairs distances and the root's first-hop matrix); it never
    touches the card, and raises when the core cannot be built.
    """

    def __init__(
        self,
        ls: LinkState,
        root: str,
        backend: str,
        snapshots: Optional[SnapshotCache] = None,
        resident: Optional[_EllResidentCache] = None,
    ):
        self._ls = ls
        self._root = root
        self._backend = backend
        if backend == "device":
            if len(ls.get_adjacency_databases()) > SPARSE_NODE_THRESHOLD or (
                resident is not None and resident.has_preloaded(ls, root)
            ):
                self._init_device_sparse(
                    resident if resident is not None
                    else _EllResidentCache(snapshots.device)
                )
            else:
                self._init_device(snapshots)
        elif backend == "native":
            self._init_native(snapshots)
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
        srcs, srcs_dev = spf_ops.source_batch(
            self._snap, sid, snapshots.device, snapshots.stager
        )
        dev = self._snap.device_arrays(snapshots.device, snapshots.stager)
        packed = spf_ops.spf_view_batch_packed(
            dev.metric, dev.overloaded, srcs_dev
        )
        self._set_rows(da.reap_read(packed), srcs, srcs_dev.shape[0])

    def _init_device_sparse(self, resident: _EllResidentCache) -> None:
        """Large-area device view over the resident sliced-ELL bands
        (shared with the KSP2 masked solve): the same batched view as
        the dense path, with no N x N matrix anywhere; a churn event
        costs a row scatter and a warm solve."""
        if self._root not in self._ls.get_adjacency_databases():
            self._snap = None
            self._sid = None
            return
        graph, srcs, packed = resident.view_packed(self._ls, self._root)
        self._snap = _SparseIndexAdapter(graph)
        self._sid = graph.node_index[self._root]
        self._set_rows(packed, srcs, len(srcs))

    # -- native backend ---------------------------------------------------

    def _init_native(self, snapshots: SnapshotCache) -> None:
        """All-pairs distances and the root's ECMP first hops from the
        native core, over the host snapshot (``SnapshotCache.get`` builds
        host arrays only; nothing is uploaded)."""
        from openr_tpu_torch.graph import native_spf

        self._snap = snapshots.get(self._ls)
        sid = self._snap.id_of(self._root)
        self._sid = sid
        if sid is None:
            self._d_all = None
            self._fh = None
            return
        self._d_all = native_spf.all_pairs_distances(self._snap)
        self._fh = native_spf.first_hop_matrix(
            self._snap, sid, self._d_all[sid], self._d_all
        ).astype(bool)

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
        if self._backend == "native":
            if self._sid is None:
                return dst == self._root
            did = self._snap.id_of(dst)
            return did is not None and self._d_all[self._sid, did] < INF
        return dst in self._spf

    def metric_to(self, dst: str) -> Optional[Metric]:
        if self._backend == "device":
            if self._sid is None:
                return 0 if dst == self._root else None
            did = self._snap.id_of(dst)
            if did is None or self._d[0, did] >= INF:
                return None
            return int(self._d[0, did])
        if self._backend == "native":
            if self._sid is None:
                return 0 if dst == self._root else None
            did = self._snap.id_of(dst)
            if did is None or self._d_all[self._sid, did] >= INF:
                return None
            return int(self._d_all[self._sid, did])
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
        if self._backend == "native":
            if self._sid is None:
                return set()
            did = self._snap.id_of(dst)
            if did is None:
                return set()
            col = self._fh[:, did]
            return {
                self._snap.node_names[v]
                for v in np.nonzero(col)[0]
                if v < self._snap.n
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
        if self._backend == "native":
            if self._d_all is None:
                return None
            aid, bid = self._snap.id_of(a), self._snap.id_of(b)
            if aid is None or bid is None or self._d_all[aid, bid] >= INF:
                return None
            return int(self._d_all[aid, bid])
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
        view_cache_cap: Optional[int] = None,
        world_batch: Optional[bool] = None,
    ):
        _check_backend(backend)
        self.my_node_name = my_node_name
        self.enable_v4 = enable_v4
        self.compute_lfa_paths = compute_lfa_paths
        self.enable_ordered_fib = enable_ordered_fib
        self.bgp_dry_run = bgp_dry_run
        self.enable_best_route_selection = enable_best_route_selection
        self.backend = backend
        self.device = resolve_device(device)
        # _views LRU capacity (per-graph slots); None -> env/default
        self.view_cache_cap = max(
            1, view_cache_cap if view_cache_cap is not None else VIEW_CACHE_CAP_DEFAULT
        )
        # multi-area tenant-plane dispatch (ops.world_batch): None -> the
        # env opt-in. Off by default: single-area deployments gain nothing
        self.world_batch = (
            world_batch if world_batch is not None
            else os.environ.get("OPENR_WORLD_BATCH") == "1"
        )
        self._snapshots = SnapshotCache(self.device)
        _DEVICE_CACHES.add(self._snapshots)
        # the device-resident sliced-ELL bands of the sparse views and the
        # KSP2 masked solve, per LinkState
        self._resident = _EllResidentCache(self.device, self._snapshots.stager)
        # incremental KSP2 engines, weakly keyed by LinkState: a dead area
        # graph releases its engine (resident [n, n] matrix, path caches)
        self._ksp2_engines: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        # debounce-terminal speculation ledger: ls -> (version, root)
        # staged by speculate_views and not yet consumed by a rebuild (the
        # staged view itself lives in _views)
        self._spec_staged: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
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
        # over areas: hop_gate (the unit-metric SPF of the hop gate, run
        # where no engine exists), graph (the resident bands' sync),
        # first_paths (host traces), masks, solve (upload, masked device
        # solve, readback), second_paths (traces, priming); the engine's
        # also diff (journal and pair diffs), dispatch (the fused
        # all-sources dispatch and its readback), affected (the distance
        # test), retrace, prime (priming and snapshot commit),
        # resident_masks and snapshot (a cold build's resident masks and
        # churn snapshots); and the chunks and destinations it solved and
        # the bytes of packed edge masks it uploaded (mask_bytes); the
        # engine's cold (1 for a cold build), affected (destinations) and
        # rows_changed (the speculative row diff's count)
        self.ksp2_stats: Dict[str, float] = {}
        self._init_route_caches()
        # bumped on every static-MPLS change: _add_best_paths merges static
        # next hops into self-advertised anycast routes, so the reuse meta
        # must change when they do
        self._static_routes_version = 0

    def _init_route_caches(self) -> None:
        """The route-reuse caches, empty."""
        # root -> (d, fh, node_names, links_sig, {node: (label, entry)}):
        # the node-label routes' column-diff fast path
        self._label_cache: Dict[str, tuple] = {}
        # per-prefix route reuse: prefix -> (RibUnicastEntry | None, best)
        self._route_cache: Dict[IpPrefix, tuple] = {}
        self._route_cache_meta: Optional[tuple] = None
        # ((prefix_state, version), {prefix: (advertisers, has KSP2)},
        # advertiser -> prefixes, KSP2 prefixes): built per prefix-state
        # version, read only when reuse can happen
        self._advertisers_cache: Optional[tuple] = None
        # root -> (build seq, {area -> the previous build's route-
        # determining signature}) for the SP dirty test: the root's
        # distance row, first-hop rows, overload bits, node labels, local
        # link signature ("absent" + versions where the root is not in
        # the area). LRU-by-build, at most 8 roots
        self._sp_reuse: Dict[str, tuple] = {}
        # build counter: ties each cached state to the build that made it,
        # so the label patch can prove its base is the build the SP dirty
        # set was diffed against
        self._build_seq = 0
        self._sp_prev_seq: Optional[int] = None
        # the previous build's non-None unicast entries and best results,
        # the bulk reuse path's starting point
        self._route_entries_cache: Optional[Dict] = None
        self._route_best_cache: Optional[Dict] = None
        # root -> (seq, label_to_node, winners, collision labels,
        # labels by node, area): the assembled node-label route map,
        # patched in O(dirty) when the SP dirty set names every
        # destination whose route could have moved
        self._label_state: Dict[str, tuple] = {}
        # node-label vector per live graph: labels move only on an
        # attribute change
        self._labels_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        # the nodes the KSP2 engines' affected sets speak for: KSP2 route
        # reuse holds only for prefixes whose advertisers all lie here
        self._ksp2_tracked: Set[str] = set()

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
        self._static_routes_version += 1

    # -- device state -------------------------------------------------------

    def reset_device_state(self) -> None:
        """Discard every cache derived from device solves, this solver's
        and (``reset_device_caches``) every live solver's resident and
        compiled graphs: the next build recomputes everything from the
        LinkStates alone."""
        self._views = {}
        self._ksp2_engines = weakref.WeakKeyDictionary()
        self._spec_staged = weakref.WeakKeyDictionary()
        self._ksp2_dsts_cache = None
        self._init_route_caches()
        reset_device_caches()
        SPF_COUNTERS["decision.device_state_resets"] += 1

    def set_backend(self, backend: str) -> None:
        """Switch the solve backend. The view and route caches are not
        keyed by backend, so a switch drops them."""
        _check_backend(backend)
        if backend == self.backend:
            return
        self.backend = backend
        self.reset_device_state()
        SPF_COUNTERS["decision.backend_switches"] += 1

    # -- publication-time hooks ---------------------------------------------

    def prewarm(self, area_link_states: AreaLinkStates) -> None:
        """Publication-time overlap hook (Decision calls it as
        publications land, before the debounced rebuild fires): scatter
        the pending topology deltas into the resident sliced-ELL bands
        now, so the band scatter overlaps the debounce window instead of
        sitting on the rebuild's critical path. Touches only graphs that
        already have resident state (never compiles one). The resident
        state journals stacked patches, so N prewarmed publications in
        one window still leave the rebuild on the warm-solve path.

        Like the reference, a failure here is not raised: this is an
        overlap, not a correctness step. ``_EllResidentCache.state_for``
        drops the state a failed scatter tore, so the next rebuild compiles
        the bands in full (``decision.ell_full_compiles``), and the failure
        is counted in ``decision.ell_prewarm_failures``."""
        if self.backend != "device":
            return
        for ls in area_link_states.values():
            entry = self._resident._cache.get(ls)
            if entry is None or entry[0] == ls.topology_version:
                continue
            try:
                self._resident.state_for(ls)
            except Exception:
                get_registry().counter_bump("decision.ell_prewarm_failures")
                continue
            SPF_COUNTERS["decision.ell_prewarms"] += 1

    def speculate_views(
        self, my_node_name: str, area_link_states: AreaLinkStates
    ) -> int:
        """Debounce-terminal speculation hook (Decision calls it once a
        saturated debounce window): solve the root's view for the current
        coalesced backlog now, so the rebuild's ``_view`` lands on a cache
        hit. Counted: ``ops.spec_dispatches`` on stage, ``ops.spec_hits``
        when the rebuild consumes it, ``ops.spec_cancels`` when a later
        publication supersedes it (or the solve failed), and
        ``ops.spec_skips`` when it stands down because a fault is armed:
        every fault seam belongs to the committed path's degradation
        ladder, and a speculative solve must not consume its charges.
        Returns the views staged."""
        reg = get_registry()
        if self.backend != "device":
            return 0
        if get_injector().any_armed:
            reg.counter_bump("ops.spec_skips")
            return 0
        staged = 0
        for area in sorted(area_link_states):
            ls = area_link_states[area]
            if not ls.has_node(my_node_name):
                continue
            key = (ls.topology_version, my_node_name)
            prev = self._spec_staged.pop(ls, None)
            if prev == key:
                self._spec_staged[ls] = prev
                continue
            if prev is not None:
                # an earlier stage for this graph died unconsumed
                reg.counter_bump("ops.spec_cancels")
            per_ls = self._views.get(ls)
            if per_ls is not None and key in per_ls:
                continue  # already current: nothing to speculate
            try:
                self._view(area, ls, my_node_name)
            except Exception:
                # abandoned speculation, never an escalation: the
                # committed rebuild owns the retry ladder
                reg.counter_bump("ops.spec_cancels")
                continue
            self._spec_staged[ls] = key
            reg.counter_bump("ops.spec_dispatches")
            staged += 1
        return staged

    # -- SPF views --------------------------------------------------------

    def _world_preload(self, my_node_name: str, area_link_states: AreaLinkStates) -> None:
        """Solve every eligible area's {root} + neighbours view as ONE
        batched tenant-plane dispatch (``ops.world_batch``, on the
        solver's device) and preload the results into the resident-view
        path, so the per-area SpfViews below are host-side slices instead
        of N sequential device round trips. A failure (or an area already
        holding a cached view) leaves the areas to the per-area solves on
        the same device; a failure is counted."""
        if self.backend != "device" or not self.world_batch:
            return
        items = []
        for area in sorted(area_link_states):
            ls = area_link_states[area]
            if not ls.has_node(my_node_name):
                continue
            per_ls = self._views.get(ls)
            if per_ls is not None and (ls.topology_version, my_node_name) in per_ls:
                continue  # cached view: a preload would go unconsumed
            items.append((f"{area}/{my_node_name}", ls, my_node_name))
        if len(items) < 2:
            return  # nothing to batch
        try:
            from openr_tpu_torch.ops import world_batch

            views = world_batch.get_world_manager(self.device).solve_views(items)
            for (_tid, ls, _root), (graph, srcs, packed) in zip(items, views):
                self._resident.preload_view(ls, graph, srcs, packed)
            SPF_COUNTERS["decision.world_preloads"] += 1
        except Exception:
            SPF_COUNTERS["decision.world_preload_failures"] += 1

    def _view(self, area: str, ls: LinkState, root: str) -> SpfView:
        del area  # identity of the LinkState object is the key
        per_ls = self._views.pop(ls, None)
        if per_ls is None:
            per_ls = {}
        # re-insert on hit: eviction is LRU
        self._views[ls] = per_ls
        while len(self._views) > self.view_cache_cap:
            self._views.pop(next(iter(self._views)))
            SPF_COUNTERS["route_engine.view_evictions"] += 1
        key = (ls.topology_version, root)
        view = per_ls.get(key)
        spec = self._spec_staged.get(ls)
        if spec is not None:
            if view is not None and spec == key:
                # the debounced rebuild consumed the staged view
                del self._spec_staged[ls]
                get_registry().counter_bump("ops.spec_hits")
            elif spec[0] != key[0]:
                # the graph moved past the staged version: the
                # speculative solve died unconsumed
                del self._spec_staged[ls]
                get_registry().counter_bump("ops.spec_cancels")
            # same version, another root (a query): the stage stays armed
        if view is None:
            # drop stale versions of this graph
            for k in [k for k in per_ls if k[0] != key[0]]:
                del per_ls[k]
            if self.backend == "device":
                # the degradation ladder's device seam: a cached view
                # never fails (its rows already crossed), a fresh device
                # solve can
                fault_point(FAULT_SPF_SOLVE)
            factory = _SPF_BACKENDS.get(self.backend)
            view = (
                factory(ls, root)
                if factory is not None
                else SpfView(ls, root, self.backend, self._snapshots, self._resident)
            )
            per_ls[key] = view
        return view

    # -- SP route reuse dirty test ------------------------------------------

    def _sp_dirty_nodes(
        self,
        my_node_name: str,
        area_link_states: AreaLinkStates,
    ) -> Tuple[bool, Optional[Set[str]]]:
        """Per-destination change detection for SP_ECMP route reuse.

        A non-KSP2 route from ``my_node_name`` toward advertiser ``a`` is
        a function of: (1) the prefix entries (version-gated by the
        caller), (2) the batched view's distance and first-hop COLUMNS of
        ``a`` (Decision.cpp:847, :1124), (3) the distance columns of the
        first-hop neighbours themselves (remaining = shortest -
        metric_to(nh), Decision.cpp:1211), (4) the advertiser's overload
        bit (Decision.cpp:783) and node label (SR PUSH), and (5) the
        local link signature.

        Compares (2)-(5) with the previous build and returns ``(stored,
        dirty)``: ``stored`` is True when a fresh signature was recorded;
        ``dirty`` is the set of node names whose routes MAY have changed,
        or None when no comparable previous signature exists (first
        build, re-index, neighbour-set change, a view without device rows
        such as the host backend's).

        Multi-area: a node is clean only if it is clean in every area;
        the per-area dirty sets are unioned. An area the root is absent
        from is pinned by its versions instead, so any churn there
        disables reuse for that build."""
        per_area = []
        for area in sorted(area_link_states):
            ls = area_link_states[area]
            if not ls.has_node(my_node_name):
                per_area.append((area, ls, None))
                continue
            view = self._view(area, ls, my_node_name)
            d = getattr(view, "_d", None)
            fh = getattr(view, "_fh_batch", None)
            snap = getattr(view, "_snap", None)
            srcs = getattr(view, "_batch_srcs", None)
            if d is None or fh is None or snap is None or srcs is None:
                return False, None
            per_area.append((area, ls, (d, fh, snap, srcs)))
        rec = self._sp_reuse.get(my_node_name)
        prev_all = rec[1] if rec is not None else None
        self._sp_prev_seq = rec[0] if rec is not None else None
        if prev_all is not None and set(prev_all) != {a for a, _ls, _v in per_area}:
            prev_all = None
        fresh_all: Dict[str, tuple] = {}
        dirty_all: Optional[Set[str]] = set() if prev_all is not None else None
        for area, ls, viewdata in per_area:
            if viewdata is None:
                # root-absent area: pin its whole state
                sig = ("absent", ls.topology_version, ls.attributes_version)
                fresh_all[area] = sig
                if dirty_all is not None and prev_all[area] != sig:
                    dirty_all = None
                continue
            dirty = self._sp_dirty_one_area(
                my_node_name, ls, viewdata,
                None if prev_all is None else prev_all[area],
            )
            fresh_all[area] = dirty[1]
            if dirty_all is not None:
                dirty_all = None if dirty[0] is None else dirty_all | dirty[0]
        # re-insert at the end: eviction is LRU-by-build, so other roots'
        # queries cannot evict the hot root's slot
        self._sp_reuse.pop(my_node_name, None)
        self._sp_reuse[my_node_name] = (self._build_seq, fresh_all)
        while len(self._sp_reuse) > 8:
            self._sp_reuse.pop(next(iter(self._sp_reuse)))
        return True, dirty_all

    def _sp_dirty_one_area(
        self,
        my_node_name: str,
        ls: LinkState,
        viewdata: tuple,
        prev: Optional[tuple],
    ) -> Tuple[Optional[Set[str]], tuple]:
        """One area's signature and comparison for ``_sp_dirty_nodes``:
        ``(dirty set or None when there is nothing to compare with, the
        fresh signature)``."""
        d, fh, snap, srcs = viewdata
        b = len(srcs)
        names = snap.node_names
        n = len(names)
        # only the first n columns name real nodes. Without LFA only the
        # ROOT's distance row is read (neighbour rows feed LFA, which
        # gates reuse off), so remote churn that reroutes around the root
        # stays invisible
        d = d[0:1, :n]
        fh = fh[:b, :n]
        links_sig = _local_links_sig(ls, my_node_name)
        # the cache keeps the names referent: identity (shared across
        # patches) or content must match
        lc = self._labels_cache.get(ls)
        if (
            lc is not None
            and lc[0] == ls.attributes_version
            and (lc[1] is names or list(lc[1]) == list(names))
        ):
            labels = lc[2]
        else:
            adj_dbs = ls.get_adjacency_databases()
            labels = np.fromiter(
                (adj_dbs[nm].node_label if nm in adj_dbs else -1 for nm in names),
                dtype=np.int64,
                count=n,
            )
            self._labels_cache[ls] = (ls.attributes_version, names, labels)
        # both snapshots and resident graphs carry the overload mask of
        # their topology version (an overload flip is a new version)
        ov = np.array(snap.overloaded[:n], dtype=bool)
        dirty: Optional[Set[str]] = None
        if (
            prev is not None
            and len(prev) == 7
            and prev[4] == links_sig
            and prev[0].shape == d.shape
            and prev[1].shape == fh.shape
            and list(prev[2]) == list(srcs)
            and (prev[3] is names or list(prev[3]) == list(names))
        ):
            col_changed = (
                (prev[0] != d).any(axis=0)
                | (prev[1] != fh).any(axis=0)
                | (prev[5] != ov)
                | (prev[6] != labels)
            )
            changed_rows = [i for i, nid in enumerate(srcs) if col_changed[int(nid)]]
            if changed_rows:
                # a moved neighbour column changes the remaining metric
                # of every destination it first-hops for (in the old or
                # the new first-hop sets)
                dep = fh[changed_rows].any(axis=0) | prev[1][changed_rows].any(axis=0)
                dirty_mask = col_changed | dep
            else:
                dirty_mask = col_changed
            dirty = {str(names[int(i)]) for i in np.flatnonzero(dirty_mask)}
        fresh = (d.copy(), fh.copy(), tuple(int(s) for s in srcs), names, links_sig, ov, labels)
        return dirty, fresh

    # -- route build ------------------------------------------------------

    def build_route_db(
        self,
        my_node_name: str,
        area_link_states: AreaLinkStates,
        prefix_state: PrefixState,
    ) -> Optional[DecisionRouteDb]:
        """Full RIB computation. reference: Decision.cpp:569 buildRouteDb.

        Per-prefix route reuse (reference analogue: the per-prefix
        incremental rebuild, Decision.cpp:1896-1917), from two change
        detectors: an SP_ECMP prefix whose advertisers are all clean
        under the SP dirty test keeps the previous build's route, and so
        does a prefix whose advertisers the KSP2 engines all track and
        none of them marked affected. LFA turns reuse off: it reads
        neighbour rows neither detector compares."""
        if not any(ls.has_node(my_node_name) for ls in area_link_states.values()):
            return None

        self._build_seq += 1
        route_db = DecisionRouteDb()
        self.best_routes_cache.clear()
        self._world_preload(my_node_name, area_link_states)
        # KSP2 second paths, batched on the device and primed into each
        # area's kth-path cache before the prefix loop reads them; the
        # engines' affected set, or None (no KSP2 reuse this build)
        affected = self._prefetch_ksp2_paths(my_node_name, area_link_states, prefix_state)

        # object references, not id()s: a recycled id on a new graph or
        # prefix state could alias
        meta = (
            prefix_state,
            prefix_state.version,
            my_node_name,
            self._static_routes_version,
            tuple((a, ls) for a, ls in sorted(area_link_states.items())),
        )
        sp_stored, sp_dirty = (
            self._sp_dirty_nodes(my_node_name, area_link_states)
            if not self.compute_lfa_paths
            else (False, None)
        )
        meta_ok = self._route_cache_meta == meta
        reuse = affected if affected is not None and not self.compute_lfa_paths and meta_ok else None
        reuse_sp = sp_dirty if meta_ok else None
        populate = (affected is not None or sp_stored) and not self.compute_lfa_paths
        self._route_cache_meta = meta if populate else None
        new_cache: Dict[IpPrefix, tuple] = {}

        adv_map = None
        if reuse is not None or reuse_sp is not None:
            # built only when reuse can consult it
            adv_key = (prefix_state, prefix_state.version)
            if self._advertisers_cache is None or self._advertisers_cache[0] != adv_key:
                ksp2 = PrefixForwardingAlgorithm.KSP2_ED_ECMP
                amap = {
                    p: (
                        {node for (node, _a) in entries},
                        any(e.forwarding_algorithm == ksp2 for e in entries.values()),
                    )
                    for p, entries in prefix_state.prefixes().items()
                }
                # inverted index + KSP2 set: the bulk path below touches
                # only the prefixes a dirty node advertises
                adv_index: Dict[str, Set[IpPrefix]] = {}
                ksp2_set: Set[IpPrefix] = set()
                for p, (advs, has_k) in amap.items():
                    if has_k:
                        ksp2_set.add(p)
                    for node in advs:
                        adv_index.setdefault(node, set()).add(p)
                self._advertisers_cache = (adv_key, amap, adv_index, ksp2_set)
            adv_map = self._advertisers_cache[1]

        # bulk reuse: with a valid dirty set only the prefixes a dirty
        # node advertises, and the KSP2 ones (whose gate needs the
        # engines' affected set), can route differently; every other
        # cached (entry, best) pair is adopted by two dict copies
        iter_prefixes = prefix_state.prefixes()
        if (
            reuse_sp is not None
            and adv_map is not None
            and self._route_entries_cache is not None
        ):
            _key, _amap, adv_index, ksp2_set = self._advertisers_cache
            must: Set[IpPrefix] = set(ksp2_set)
            for node in reuse_sp:
                must |= adv_index.get(node, _EMPTY_PREFIXES)
            route_db.unicast_routes = dict(self._route_entries_cache)
            self.best_routes_cache.update(self._route_best_cache)
            new_cache = dict(self._route_cache)
            for p in must:
                route_db.unicast_routes.pop(p, None)
                self.best_routes_cache.pop(p, None)
                new_cache.pop(p, None)
            # count what survived the pops: `must` may name prefixes that
            # were never cached
            SPF_COUNTERS["decision.sp_route_reuses"] += len(new_cache)
            iter_prefixes = must

        for prefix in iter_prefixes:
            if adv_map is not None and prefix in self._route_cache:
                advertisers, has_ksp2 = adv_map[prefix]
                # reusable when no input that could change it moved: a
                # non-KSP2 prefix whose advertisers are all clean under
                # the SP dirty test, or a prefix whose advertisers the
                # KSP2 engines all track and none marked affected; an
                # advertiser covered by neither forces a re-derive
                ok = (
                    not has_ksp2
                    and reuse_sp is not None
                    and advertisers.isdisjoint(reuse_sp)
                )
                if ok:
                    SPF_COUNTERS["decision.sp_route_reuses"] += 1
                elif (
                    reuse is not None
                    and advertisers <= self._ksp2_tracked
                    and advertisers.isdisjoint(reuse)
                ):
                    ok = True
                    SPF_COUNTERS["decision.ksp2_route_reuses"] += 1
                if ok:
                    entry, best = self._route_cache[prefix]
                    if best is not None:
                        self.best_routes_cache[prefix] = best
                    if entry is not None:
                        route_db.add_unicast_route(entry)
                    new_cache[prefix] = (entry, best)
                    continue
            entry = self.create_route_for_prefix(
                my_node_name, area_link_states, prefix_state, prefix
            )
            if entry is not None:
                route_db.add_unicast_route(entry)
            if populate:
                new_cache[prefix] = (entry, self.best_routes_cache.get(prefix))
        self._route_cache = new_cache
        if populate:
            self._route_entries_cache = dict(route_db.unicast_routes)
            self._route_best_cache = dict(self.best_routes_cache)
        else:
            self._route_entries_cache = None
            self._route_best_cache = None

        # MPLS routes for node (SR) labels: they depend only on the
        # graph, so the raw dirty set applies whatever the prefix meta
        label_to_node = self._build_node_label_routes(
            my_node_name, area_link_states, sp_dirty=sp_dirty
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

    def _store_label_state(
        self, my_node_name: str, area: str, result, winners, collisions, labels_by
    ) -> None:
        self._label_state.pop(my_node_name, None)
        self._label_state[my_node_name] = (
            self._build_seq, result, winners, collisions, labels_by, area,
        )
        while len(self._label_state) > 8:
            self._label_state.pop(next(iter(self._label_state)))

    def _patch_node_label_routes(
        self,
        my_node_name: str,
        area_link_states: AreaLinkStates,
        dirty: Set[str],
        st: tuple,
    ) -> Optional[Dict[int, Tuple[str, RibMplsEntry]]]:
        """O(dirty) update of the node-label route map: re-derive only
        the destinations the SP dirty test names and keep every other
        (node, entry) pair of the previous build. None when a contested
        label's winner must be found anew (the losing claimants' entries
        were never derived): the caller then runs the full loop."""
        ((area, ls),) = area_link_states.items()
        _seq, result, winners, collisions, labels_by, st_area = st
        if st_area != area:
            return None
        adj_dbs = ls.get_adjacency_databases()
        result = dict(result)
        winners = dict(winners)
        labels_by = dict(labels_by)
        collisions = set(collisions)
        for node in sorted(dirty):
            old_label = labels_by.pop(node, None)
            db = adj_dbs.get(node)
            top_label = db.node_label if db is not None else 0
            if top_label == 0 or not is_mpls_label_valid(top_label):
                top_label = None
            entry = (
                self._derive_label_entry(my_node_name, node, area, area_link_states, top_label)
                if top_label is not None
                else None
            )
            was_winner = winners.get(node)
            keeps_label = old_label is not None and old_label == top_label
            if was_winner is not None and not (keeps_label and entry is not None):
                # the winner of old_label goes: a losing claimant (whose
                # entry was never derived) may take over, and only the
                # full loop knows which
                if old_label in collisions:
                    return None
                result.pop(old_label, None)
                winners.pop(node, None)
            if top_label is None:
                continue
            labels_by[node] = top_label
            if entry is None:
                continue
            existing = result.get(top_label)
            if existing is not None and existing[0] != node:
                collisions.add(top_label)
                if existing[0] < node:
                    continue  # the smaller name keeps the label
                winners.pop(existing[0], None)
            result[top_label] = (node, entry)
            winners[node] = (top_label, entry)
        self._store_label_state(my_node_name, area, result, winners, collisions, labels_by)
        return result

    def _build_node_label_routes(
        self,
        my_node_name: str,
        area_link_states: AreaLinkStates,
        sp_dirty: Optional[Set[str]] = None,
    ) -> Dict[int, Tuple[str, RibMplsEntry]]:
        """SR node-label routes for every labeled node
        (reference: Decision.cpp:600-650 buildRouteDb label loop).

        Incremental paths (one area, a view with device rows, no LFA):
        (1) when the SP dirty test names every destination whose route
        could have moved, the previous build's map is patched in
        O(dirty) (``_patch_node_label_routes``); (2) otherwise the view's
        column diff marks label routes reusable per destination and the
        loop re-derives only the changed ones."""
        label_to_node: Dict[int, Tuple[str, RibMplsEntry]] = {}

        if sp_dirty is not None and len(area_link_states) == 1 and not self.compute_lfa_paths:
            st = self._label_state.get(my_node_name)
            if st is not None and self._sp_prev_seq is not None and st[0] == self._sp_prev_seq:
                patched = self._patch_node_label_routes(
                    my_node_name, area_link_states, sp_dirty, st
                )
                if patched is not None:
                    return patched

        reusable: Dict[str, Tuple[int, RibMplsEntry]] = {}
        cache_probe = None
        if len(area_link_states) == 1:
            ((area, ls),) = area_link_states.items()
            view = self._view(area, ls, my_node_name)
            d = getattr(view, "_d", None)
            fh = getattr(view, "_fh_batch", None)
            if d is not None and fh is not None and view._snap is not None:
                names = list(view._snap.node_names)
                links_sig = _local_links_sig(ls, my_node_name)
                cache_probe = (d.copy(), fh.copy(), names, links_sig)
                prev = self._label_cache.get(my_node_name)
                if (
                    prev is not None
                    and prev[2] == names
                    and prev[3] == links_sig
                    and prev[0].shape == d.shape
                    and prev[1].shape == fh.shape
                ):
                    # column-wise: a destination is dirty if any source
                    # row's distance or first-hop bit changed
                    changed_ids = {
                        int(i)
                        for i in np.flatnonzero(
                            (prev[0] != d).any(axis=0) | (prev[1] != fh).any(axis=0)
                        )
                    }
                    # next hops subtract the neighbour's own distance, so
                    # a moved neighbour row invalidates every label route
                    if changed_ids.isdisjoint(int(i) for i in view._batch_srcs):
                        reusable = {
                            node: lab_entry
                            for node, lab_entry in prev[4].items()
                            if view._snap.id_of(node) is not None
                            and view._snap.id_of(node) not in changed_ids
                        }

        built: Dict[str, Tuple[int, RibMplsEntry]] = {}
        labels_by: Dict[str, int] = {}
        collisions: Set[int] = set()
        for area, ls in sorted(area_link_states.items()):
            for node, adj_db in sorted(ls.get_adjacency_databases().items()):
                top_label = adj_db.node_label
                if top_label == 0:
                    continue
                if not is_mpls_label_valid(top_label):
                    continue
                labels_by[node] = top_label
                # label collision: deterministically keep the smaller name
                # (reference: Decision.cpp:620-633)
                existing = label_to_node.get(top_label)
                if existing is not None:
                    collisions.add(top_label)
                    if existing[0] < node:
                        continue
                cached = reusable.get(node) if node != my_node_name else None
                if cached is not None and cached[0] == top_label:
                    label_to_node[top_label] = (node, cached[1])
                    built[node] = cached
                    continue
                entry = self._derive_label_entry(
                    my_node_name, node, area, area_link_states, top_label
                )
                if entry is None:
                    continue
                label_to_node[top_label] = (node, entry)
                built[node] = (top_label, entry)

        self._label_cache.pop(my_node_name, None)
        if cache_probe is not None:
            # re-insert at the end: eviction is LRU-by-build
            self._label_cache[my_node_name] = (*cache_probe, built)
            while len(self._label_cache) > 8:
                self._label_cache.pop(next(iter(self._label_cache)))
        if len(area_link_states) == 1:
            ((only_area, _ls),) = area_link_states.items()
            self._store_label_state(
                my_node_name, only_area, label_to_node, built, collisions, labels_by
            )
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
    ) -> Optional[Set[str]]:
        """Batch the KSP2 second-path SPFs onto the device.

        Host semantics (LinkState.get_kth_paths, reference
        LinkState.cpp:763) run one Dijkstra per destination over the graph
        minus that destination's first-path links. Here each area with at
        least KSP2_DEVICE_MIN_DSTS KSP2 destinations solves them as
        masked graphs on the device (``_prefetch_ksp2_area``) and primes
        the area's kth-path cache; the others take the host path lazily.

        Returns the union of the area engines' affected sets, for KSP2
        route reuse, or None (no reuse this build). Reuse needs every
        area signalled: a best advertiser's KSP2 paths are computed in
        every area graph it appears in, so one unsignalled area's churn
        could change a reused route."""
        self.ksp2_stats = {}
        if self.backend != "device":
            return None
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
        if not any(area_dsts.values()):
            return None

        union_affected: Set[str] = set()
        union_tracked: Set[str] = set()
        all_signaled = True
        ran_any = False
        for area, ls in sorted(area_link_states.items()):
            dsts = sorted(area_dsts[area])
            if len(dsts) < KSP2_DEVICE_MIN_DSTS or not ls.has_node(my_node_name):
                all_signaled = False  # area covered by the host path
                continue
            result = self._prefetch_ksp2_area(ls, my_node_name, dsts)
            if result is None:
                all_signaled = False
                continue
            ran_any = True
            union_affected |= result
            union_tracked |= set(dsts)
        if not ran_any or not all_signaled:
            return None
        # a node advertising in area a but merely present in area b is
        # untracked by b's engine, so b's churn would never land it in
        # the affected set: its routes must not be reused
        self._ksp2_tracked = {
            n
            for n in union_tracked
            if all(
                (n in area_dsts[a]) or not a_ls.has_node(n)
                for a, a_ls in area_link_states.items()
            )
        } | {my_node_name}
        return union_affected

    def _prefetch_ksp2_area(
        self, ls: LinkState, my_node_name: str, dsts: List[str]
    ) -> Optional[Set[str]]:
        """One area's KSP2 second paths, primed into ``ls``. Up to
        ``ksp2_engine.engine_max_nodes()`` nodes the area's incremental
        engine (one per LinkState, for the root that made it) syncs and
        returns its affected set: all of ``dsts`` after a cold build, and
        the root as well when its overload bit flipped since the last
        sync (its drain changes the selection of every prefix it
        advertises). Else the per-build chunked masked dispatch
        (reference ``spf_solver.py:2161-2213``) runs and nothing is
        returned (no reuse). A failed sync or masked solve drops the
        area's engine and resident state and raises."""
        from openr_tpu_torch.decision import ksp2_engine

        stats = self.ksp2_stats
        lap = ksp2_engine.Laps(stats)
        if len(ls.get_adjacency_databases()) <= ksp2_engine.engine_max_nodes():
            engine = self._ksp2_engines.get(ls)
            if engine is not None and engine.src_name != my_node_name:
                # one engine per graph: keep the hot root's; other roots
                # take the host path
                return None
            if engine is None:
                high_diameter = ls.get_max_hops_to_node(my_node_name) > KSP2_DEVICE_MAX_HOPS
                lap("hop_gate_ms")
                if high_diameter:
                    return None  # host Dijkstra wins
                engine = ksp2_engine.Ksp2Engine(my_node_name, self._resident)
                self._ksp2_engines[ls] = engine
            engine.stats = stats
            try:
                affected = engine.sync(ls, dsts)
            except BaseException:
                self._ksp2_engines.pop(ls, None)
                self._resident.drop(ls)
                raise
            cold = affected is None and engine.valid
            stats["cold"] = stats.get("cold", 0) + int(cold)
            stats["dsts"] = stats.get("dsts", 0) + len(dsts)
            if engine.last_affected is not None:
                stats["affected"] = stats.get("affected", 0) + len(engine.last_affected)
            if engine.last_rows_changed is not None:
                stats["rows_changed"] = stats.get("rows_changed", 0) + engine.last_rows_changed
            if engine.valid and engine.ecc_hops > KSP2_DEVICE_MAX_HOPS:
                # the diameter grew past the device's win: this build's
                # paths are primed; drop the engine so later builds take
                # the memoized host hop check instead of cold builds
                del self._ksp2_engines[ls]
                return affected
            if cold:
                # no reuse this time, but the route cache built now is
                # valid for the next event: "engine ran", all affected
                affected = set(dsts)
            if affected is not None and engine.root_flipped:
                affected = affected | {my_node_name}
            return affected

        high_diameter = ls.get_max_hops_to_node(my_node_name) > KSP2_DEVICE_MAX_HOPS
        lap("hop_gate_ms")
        if high_diameter:
            return None  # host Dijkstra wins
        # the resident bands the sparse view solves on: the journal's rows
        # scattered in, no band upload per dispatch
        state = self._resident.state_for(ls)
        graph = state.graph
        sid = graph.node_index.get(my_node_name)
        if sid is None:
            return None
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
            try:
                drows = spf_sparse.ell_masked_distances_resident(state, sid, masks).reap()
            except BaseException:
                self._resident.drop(ls)
                raise
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
        return None

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
