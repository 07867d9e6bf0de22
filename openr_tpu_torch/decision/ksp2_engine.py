"""Incremental KSP2_ED_ECMP engine: paths kept across churn, only the
affected destinations re-solved.

Port note: mirrors ``openr_tpu/decision/ksp2_engine.py``:
``trace_paths_from_row`` and ``make_cands_of`` (also the per-build chunked
dispatch's tracer), ``_path_nodes``, ``_pad_ids``, the engine constants,
``engine_max_nodes`` and ``_fast_path_enabled``, and ``Ksp2Engine``. The
engine runs on the device of its solver's resident ELL cache
(``spf_solver._EllResidentCache``, one per solver, where the reference has
one global cache). Where the reference donates its resident matrices to the
fused dispatch, the port drops its reference before the dispatch and
rebinds to the outputs after it; the resident masks and masked rows of the
fast path take each batch's rows by ``index_copy_`` on the device. Its
readbacks land in pinned host memory (``ops.staging.Readback``), where the
reference kicks an async copy inside a dispatch-accounting window and reaps
it. The reference's annotations say what this docstring says in words:
``d_prev_dev``, ``dm_dev`` and ``masks_t`` are the resident device buffers,
all three rebuilt by ``_cold_build``; and an engine is driven by one owner
at a time (its solver), never by two threads at once. Every trace site
(cold build, recompute, retrace, the masked second paths) goes through
``_trace_many``, which runs the native batch tracer (``_TraceArrays`` over
``graph/native_spf.py``'s ``trace_batch``) on every device, the CPU
included. The Python tracer ``trace_paths_from_row`` stays as its plain
version: an engine runs it only when made with the module's ``TRACER``
set to "python", and the tests hold the two against each other. Where the
reference falls back to the Python tracer when the native core is
missing, the port raises. Left out for later slices: the device mesh
(``set_engine_mesh`` and the sharded dispatches).

The affected set comes from a sound distance test. A changed directed
edge C = (u, v) of weight w lies on some shortest path src -> dst iff

    d(src, u) + w + d(v, dst) == d(src, dst)

If no changed edge lies on dst's shortest-path DAG under either the old or
the new distances, dst's first-path trace is unchanged; masking only
removes edges, so base distances lower-bound masked ones, and the same
test bounds the second-path graph conservatively. The distances come from
a device-resident all-sources matrix over the sliced-ELL bands, recomputed
warm on every churn event in one fused dispatch that also serves the
root's SPF view (reference semantics: LinkState.cpp:763 getKthPaths,
Decision.cpp:908 selectBestPathsKsp2).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from openr_tpu_torch.graph.linkstate import Link, LinkState
from openr_tpu_torch.ops.minplus import INF

# Engine activation bound: the engine keeps the all-sources [n_pad, n_pad]
# int32 matrix resident and solves it once a churn event (about 0.4 GB
# at 10 000 nodes, 0.6 GB at the bound); above it the solver takes the
# per-build chunked dispatch.
ENGINE_MAX_NODES = 12288

# churn larger than this falls back to a full (cold) rebuild
ENGINE_MAX_CHANGED_PAIRS = 64
ENGINE_MAX_ENDPOINTS = 32
# if more than this fraction of destinations is affected, a cold rebuild
# is cheaper than the incremental machinery
ENGINE_FULL_REBUILD_FRACTION = 3  # affected * N > dsts  -> cold
# fast path: how many changed masked rows the fused dispatch reads back
# inline; more than this forces one extra full-matrix readback
ENGINE_ROW_BUDGET = 64
# the engines' tracer: "native" (the batch tracer of csrc/spfcore.cpp) or
# "python" (trace_paths_from_row, its plain version)
TRACER = "native"


def engine_max_nodes() -> int:
    """The activation bound (one device: no mesh scaling)."""
    return ENGINE_MAX_NODES


def _fast_path_enabled(device: torch.device) -> bool:
    """The resident-mask speculative solve trades extra device work (a
    masked re-solve of every destination per event) for one fewer host
    round trip and the host's second-path re-traces; on the CPU it is
    pure overhead, so it engages on a CUDA device only.
    ``OPENR_KSP2_FAST=1``/``0`` overrides (the tests set both)."""
    override = os.environ.get("OPENR_KSP2_FAST")
    if override is not None:
        return override == "1"
    return torch.device(device).type == "cuda"


def _counters():
    from openr_tpu_torch.decision import spf_solver as _ss

    return _ss.SPF_COUNTERS


class Laps:
    """Host-clock laps: ``lap(part)`` adds the ms since the previous lap
    (or since construction) to ``stats[part]``."""

    def __init__(self, stats: Dict[str, float]):
        self.stats = stats
        self._last = time.perf_counter()

    def __call__(self, part: str) -> None:
        now = time.perf_counter()
        self.stats[part] = self.stats.get(part, 0.0) + (now - self._last) * 1e3
        self._last = now

    def carve(self, part: str, ms: float) -> None:
        """Book ``ms`` just spent to ``part`` and keep it out of the next
        lap."""
        self.stats[part] = self.stats.get(part, 0.0) + ms
        self._last += ms / 1e3


def trace_paths_from_row(
    src: str,
    dest: str,
    index: Dict[str, int],
    dlist,
    excluded: Set[Link],
    cands_of,
    transit_blocked: Set[str],
    preds_cache: Optional[Dict[str, list]] = None,
):
    """Enumerate link-disjoint shortest paths src -> dest from a distance
    row: the same paths, in the same order, as LinkState._trace_one_path
    over the same SPF (both walk predecessor links in canonical sorted
    order; reference: LinkState.cpp:399 traceOnePath).

    ``preds_cache``: predecessor lists depend only on (dlist, excluded,
    transit_blocked), not on the destination, so a caller tracing many
    destinations from one row under the same filters may share one
    dict."""
    inf = int(INF)
    did = index.get(dest)
    if did is None:
        return []
    # a plain list indexes and compares much faster than a numpy row in
    # the predecessor scans below; one bulk tolist() pays for itself
    if isinstance(dlist, np.ndarray):
        dlist = dlist.tolist()
    if dlist[did] >= inf:
        return []

    visited: Set[Link] = set()
    preds: Dict[str, list] = preds_cache if preds_cache is not None else {}

    # first-path traces run with both filter sets empty: skip the two
    # per-candidate membership tests there
    plain = not excluded and not transit_blocked

    def preds_of(v: str):
        got = preds.get(v)
        if got is None:
            dv = dlist[index[v]]
            if plain:
                got = preds[v] = [
                    (link, u)
                    for link, u, uid, w in cands_of(v)
                    if uid is not None and dlist[uid] + w == dv
                ]
            else:
                got = preds[v] = [
                    (link, u)
                    for link, u, uid, w in cands_of(v)
                    if uid is not None
                    and link not in excluded
                    and (u == src or u not in transit_blocked)
                    and dlist[uid] < inf
                    and dlist[uid] + w == dv
                ]
        return got

    def trace_one(v: str):
        if v == src:
            return []
        for link, u in preds_of(v):
            if link in visited:
                continue
            visited.add(link)
            sub = trace_one(u)
            if sub is not None:
                sub.append(link)
                return sub
        return None

    paths = []
    path = trace_one(dest)
    while path:
        paths.append(path)
        path = trace_one(dest)
    return paths


def make_cands_of(ls: LinkState, node_index: Dict[str, int]):
    """Per-build candidate list factory shared by the trace calls: up
    links of each node in canonical order with (origin, origin id,
    metric) pre-resolved."""
    in_cands: Dict[str, list] = {}

    def cands_of(v: str):
        got = in_cands.get(v)
        if got is None:
            got = in_cands[v] = [
                (
                    link,
                    link.other_node(v),
                    node_index.get(link.other_node(v)),
                    link.metric_from(link.other_node(v)),
                )
                for link in ls.ordered_links_from_node(v)
                if link.is_up()
            ]
        return got

    return cands_of


def _path_nodes(src: str, path: List[Link]) -> List[str]:
    """Nodes visited after src along a traced path."""
    out = []
    cur = src
    for link in path:
        cur = link.other_node(cur)
        out.append(cur)
    return out


def _pad_ids(ids: List[int], bucket_min: int = 8) -> np.ndarray:
    """Pad an id list to a power-of-two bucket by repeating the first id
    (inert for row gathers), so the readback's shape takes few values."""
    bucket = bucket_min
    while bucket < len(ids):
        bucket *= 2
    return np.asarray(ids + [ids[0]] * (bucket - len(ids)), dtype=np.int32)


def _transit_blocked(ls: LinkState, graph, src_name: str) -> Set[str]:
    return {
        name
        for name in graph.node_names
        if ls.is_node_overloaded(name) and name != src_name
    }


class _TraceArrays:
    """Int-encoded view of the candidate structure for the native batch
    tracer (``csrc/spfcore.cpp`` ``ksp2_trace_batch``): a candidate CSR in
    the order ``make_cands_of`` yields, a link table for id <-> object
    mapping, and the transit-blocked bitmap. Built once, then kept across
    events: ``update`` rewrites only the ranges of the nodes a change
    touched, and every trace site of an event shares the result."""

    __slots__ = ("off", "link", "uid", "w", "links", "lid_of", "blocked", "n_pad",
                 "node_index")

    def __init__(self, graph, cands_of, transit_blocked):
        names = graph.node_names
        self.n_pad = graph.n_pad
        self.node_index = graph.node_index
        self.links: List[Link] = []
        # keyed by the Link VALUE (its hash is cached), not id(): the
        # Python tracer excludes via `link not in excluded`, and a link
        # that flapped down and back up is a fresh but equal object, whose
        # exclusion an identity key would drop
        self.lid_of: Dict[Link, int] = {}
        link_l: List[int] = []
        uid_l: List[int] = []
        w_l: List[int] = []
        off = np.zeros(self.n_pad + 1, np.int32)
        for i, v in enumerate(names):
            self._encode(cands_of(v), link_l, uid_l, w_l)
            off[i + 1] = len(link_l)
        off[len(names) + 1 :] = len(link_l)
        self.off = off
        self.link = np.asarray(link_l, np.int32)
        self.uid = np.asarray(uid_l, np.int32)
        self.w = np.asarray(w_l, np.int32)
        self._set_blocked(transit_blocked)

    def _encode(self, cands, link_l, uid_l, w_l) -> None:
        """Append one node's candidates. The table keeps the current Link
        object for a value: routes read attributes off the traced links."""
        lid_of = self.lid_of
        for lnk, _u, uuid, w in cands:
            lid = lid_of.get(lnk)
            if lid is None:
                lid = lid_of[lnk] = len(self.links)
                self.links.append(lnk)
            else:
                self.links[lid] = lnk
            link_l.append(lid)
            uid_l.append(-1 if uuid is None else int(uuid))
            w_l.append(int(w))

    def _set_blocked(self, transit_blocked) -> None:
        blocked = np.zeros(self.n_pad, np.uint8)
        for nm in transit_blocked:
            bi = self.node_index.get(nm)
            if bi is not None:
                blocked[bi] = 1
        self.blocked = blocked

    def update(self, cands_of, transit_blocked, dirty) -> None:
        """Re-encode the candidates of the nodes in ``dirty`` (names; the
        LinkState's journal of the changes since this table's version,
        which holds both ends of every link that changed) and splice them
        into the CSR; every other node's range is copied as it stands."""
        index = self.node_index
        rows = sorted(index[v] for v in dirty if v in index)
        names_of = {index[v]: v for v in dirty if v in index}
        off = self.off
        lens = np.diff(off)
        pieces = ([], [], [])
        prev = 0
        for i in rows:
            link_l: List[int] = []
            uid_l: List[int] = []
            w_l: List[int] = []
            self._encode(cands_of(names_of[i]), link_l, uid_l, w_l)
            lo, hi = off[prev], off[i]
            for piece, old, new in zip(pieces, (self.link, self.uid, self.w),
                                       (link_l, uid_l, w_l)):
                piece.append(old[lo:hi])
                piece.append(np.asarray(new, np.int32))
            lens[i] = len(link_l)
            prev = i + 1
        for piece, old in zip(pieces, (self.link, self.uid, self.w)):
            piece.append(old[off[prev]:])
        self.link, self.uid, self.w = (np.concatenate(p) for p in pieces)
        new_off = np.zeros_like(off)
        np.cumsum(lens, out=new_off[1:])
        self.off = new_off
        self._set_blocked(transit_blocked)

    def _excl_arrays(self, excls):
        """Per-destination exclusion ranges; a link absent from the
        current candidate table is down, so its exclusion is vacuous."""
        ids: List[int] = []
        off = np.zeros(len(excls) + 1, np.int32)
        for i, excl in enumerate(excls):
            for lnk in excl:
                lid = self.lid_of.get(lnk)
                if lid is not None:
                    ids.append(lid)
            off[i + 1] = len(ids)
        return off, np.asarray(ids, np.int32)

    def trace(self, src_id, dst_ids, rows, shared_row, excls):
        """Batch-enumerate through the native core. Paths come back as
        Link lists, identical in content and order to
        ``trace_paths_from_row``'s."""
        from openr_tpu_torch.graph import native_spf

        excl_off, excl_ids = self._excl_arrays(excls)
        got = native_spf.trace_batch(
            self.n_pad, len(self.links), self.off, self.link,
            self.uid, self.w, src_id, self.blocked,
            np.ascontiguousarray(dst_ids, np.int32),
            np.ascontiguousarray(rows, np.int32),
            shared_row, excl_off, excl_ids,
        )
        links = self.links
        return [[[links[l] for l in p] for p in paths] for paths in got]


class Ksp2Engine:
    """Per-(LinkState, root) incremental KSP2 state on ``resident``'s
    device: the resident all-sources matrix ``d_prev_dev``, and per
    destination its first and second paths, exclusion set and masked
    distance row (``dm``; on the fast path also resident: ``masks_t`` and
    ``dm_dev``). Invalid until the first successful cold build.

    ``stats`` receives the host-clock parts of each sync (``Laps``);
    ``root_flipped`` says whether the root's overload bit moved since the
    previous sync; ``last_hops`` is the last fused dispatch's all-sources
    hop count and ``last_rows_changed`` its speculative row diff's count
    (None off the fast path or on a cold build). ``tracer`` is the
    module's ``TRACER`` when the engine is made."""

    def __init__(self, src_name: str, resident) -> None:
        self.tracer = TRACER
        if self.tracer not in ("native", "python"):
            raise ValueError(f"unknown KSP2 tracer {self.tracer!r}")
        self._tarrays = None
        self.src_name = src_name
        self.resident = resident
        self.device = resident.device
        self.valid = False
        self.last_affected: Optional[Set[str]] = None
        self.d_prev_dev: Optional[torch.Tensor] = None
        self.masks_t: Optional[Tuple[torch.Tensor, ...]] = None
        self.dm_dev: Optional[torch.Tensor] = None
        self.state = None
        self.sid: Optional[int] = None
        self.dsts: Optional[List[str]] = None
        self.band_shapes: Optional[tuple] = None
        self.stats: Dict[str, float] = {}
        self._lap = Laps(self.stats)
        self._root_ov: Optional[bool] = None
        self.root_flipped = False
        self.last_hops = 0
        self.last_rows_changed: Optional[int] = None

    # -- public entry ------------------------------------------------------

    def sync(self, ls: LinkState, dsts: List[str]) -> Optional[Set[str]]:
        """Bring the cache to ls.topology_version, prime the LinkState
        kth-path cache for every destination, and return the set of
        destination names whose paths may have changed (for route
        reuse). Returns None when the engine had to cold-rebuild (no
        reuse this build)."""
        self._lap = Laps(self.stats)
        root_ov = ls.is_node_overloaded(self.src_name)
        self.root_flipped = self._root_ov is not None and root_ov != self._root_ov
        self._root_ov = root_ov
        self.last_rows_changed = None
        return self._sync(ls, dsts)

    def _sync(self, ls: LinkState, dsts: List[str]) -> Optional[Set[str]]:
        self.last_affected = None
        state = self.resident.state_for(ls)
        self._lap("graph_ms")
        if (
            not self.valid
            or state is not self.state
            or dsts != self.dsts
            or self.sid != state.graph.node_index.get(self.src_name)
            # a widened band (ell_patch grew a slot class in place)
            # changed the band tensor shapes the resident masks were
            # built for: re-seed everything from the new shapes
            or tuple(state.graph.bands) != self.band_shapes
        ):
            self._cold_build(ls, state, dsts)
            return None
        if (
            ls.topology_version == self.version
            and ls.attributes_version == self.aversion
        ):
            # nothing changed since the last build; the kth-path cache
            # was not invalidated, so priming is already in place
            self.last_affected = set()
            return set()
        affected_nodes = ls.affected_since(self.version)
        attr_nodes = ls.attr_affected_since(self.aversion)
        if affected_nodes is None or attr_nodes is None:
            self._cold_build(ls, state, dsts)
            return None
        affected_nodes = set(affected_nodes) | set(attr_nodes)
        changed = self._diff_pairs(ls, affected_nodes)
        if changed is None or len(changed) > ENGINE_MAX_CHANGED_PAIRS:
            self._cold_build(ls, state, dsts)
            return None
        ov_flips, label_flips = self._diff_nodes(ls, affected_nodes)
        if self.src_name in ov_flips:
            # the root's own drain state gates route selection broadly
            self._cold_build(ls, state, dsts)
            return None
        # an overload flip changes the EFFECTIVE weight (INF <-> w) of
        # every edge out of the node even though raw metrics are
        # untouched: inject those pairs so the membership tests run with
        # eff() consulting the old vs new overload maps
        for x in ov_flips:
            for link in ls.links_from_node(x):
                if not link.is_up():
                    continue
                pair = (x, link.other_node(x))
                if pair not in changed:
                    w = self.eff_w.get(pair, min(int(link.metric_from(x)), INF - 1))
                    sig = self.attr_sig.get(pair, ())
                    changed[pair] = (w, w, sig, sig)
        if len(changed) > ENGINE_MAX_CHANGED_PAIRS:
            self._cold_build(ls, state, dsts)
            return None

        graph = state.graph
        ep = sorted(
            {graph.node_index[u] for (u, v), _ in changed.items()}
            | {graph.node_index[v] for (u, v), _ in changed.items()}
        )
        if len(ep) > ENGINE_MAX_ENDPOINTS:
            self._cold_build(ls, state, dsts)
            return None
        if not ep:
            ep = [self.sid]
        self._lap("diff_ms")

        # one fused dispatch: all-sources + view + old/new endpoint rows
        # (+ on the fast path: the speculative masked re-solve of every
        # destination against the resident masks, row-diffed on device)
        from openr_tpu_torch.ops import spf_sparse

        view_srcs = spf_sparse.ell_source_batch(graph, ls, self.src_name)
        srcs, w_sv = spf_sparse._batch_host_args(graph, view_srcs)
        ep_ids = _pad_ids(ep)
        use_fast = self.masks_t is not None
        # increase-edge delta for the warm-started fixed point: pairs
        # whose collapsed min weight went up since d_prev_dev's epoch. An
        # overload flip changes effective weights without touching the
        # raw metrics the tight test runs on: seed cold then.
        inc = None
        if not ov_flips:
            inc = [
                (graph.node_index[u], graph.node_index[v], int(w_old))
                for (u, v), (w_old, w_new, _so, _sn) in changed.items()
                if w_new > w_old
            ]
            _counters()["decision.ksp2_warm_dispatches"] += 1
        # the old matrices are inputs only: drop the engine's references
        # before the dispatch, so a failure leaves nothing of a dead
        # epoch behind, and adopt the outputs right after it
        d_prev, self.d_prev_dev = self.d_prev_dev, None
        dm_new_dev = None
        if use_fast:
            dm_old, self.dm_dev = self.dm_dev, None
            d_all_dev, dm_new_dev, back, self.last_hops = spf_sparse.ell_all_view_rows_masked(
                state, srcs, w_sv, ep_ids, d_prev, self.masks_t, dm_old, self.sid,
                ENGINE_ROW_BUDGET, inc=inc,
            )
            del dm_old
        else:
            d_all_dev, back, self.last_hops = spf_sparse.ell_all_view_rows(
                state, srcs, w_sv, ep_ids, d_prev, inc=inc,
            )
        del d_prev
        self.d_prev_dev = d_all_dev
        if dm_new_dev is not None:
            self.dm_dev = dm_new_dev
        packed = back.reap()
        b = len(view_srcs)
        p = len(ep_ids)
        view_packed = packed[: 2 * b]
        rows_new = {int(i): packed[2 * b + x] for x, i in enumerate(ep_ids)}
        rows_old = {int(i): packed[2 * b + p + x] for x, i in enumerate(ep_ids)}
        self._preload_view(ls, graph, view_srcs, view_packed)
        d_new_src = view_packed[0].astype(np.int64)
        self._lap("dispatch_ms")

        aff1, aff2 = self._affected_dsts(ls, graph, changed, d_new_src, rows_new, rows_old)
        dst_set = set(self.dst_pos)
        # slot-map drift: a band patch that changes a node's in-edge SET
        # re-packs that row's slot assignments, re-aiming every resident
        # mask bit stored for those slots (the reference's soak seed
        # 40018). Metric-only patches keep the slot map. Destinations
        # whose stored paths touch a re-slotted node join aff1, the
        # stale-mask bucket, re-solved with fresh masks. Only the fast
        # path holds resident masks.
        if graph.slot_of is not None and self.masks_t is not None:
            for nm in affected_nodes:
                nid = graph.node_index.get(nm)
                if nid is None:
                    continue
                new_map = graph.slot_of.get(nid, {})
                old_map = self._slot_maps.get(nid)
                if old_map is not None and old_map != new_map:
                    if nm == self.src_name:
                        # every mask holds its first-hop bits in the
                        # root's row, and node_users never indexes the
                        # root: a re-slotted root stales every mask
                        aff1 |= set(self.dst_pos)
                    else:
                        aff1 |= self.node_users.get(nm, set())
                self._slot_maps[nid] = new_map
        aff1 &= dst_set
        aff2 &= dst_set
        # label/overload extras: paths are unchanged (the distance tests
        # cover path changes) but the routes built from them embed labels
        # and drain state: invalidate route reuse only
        route_extra: Set[str] = set()
        for x in ov_flips | label_flips:
            if x in self.dst_pos:
                route_extra.add(x)
            route_extra |= self.node_users.get(x, set())
        route_extra &= dst_set
        affected = aff1 | aff2 | route_extra | (self.host_dsts & dst_set)
        self._lap("affected_ms")

        if len(affected) * ENGINE_FULL_REBUILD_FRACTION > len(dsts):
            self._cold_build(ls, state, dsts)
            return None

        if use_fast:
            # the on-device row diff: the meta row carries the first
            # ENGINE_ROW_BUDGET changed row ids and the total count
            meta = packed[2 * b + 2 * p]
            ids = meta[:ENGINE_ROW_BUDGET]
            count = int(meta[ENGINE_ROW_BUDGET])
            self.last_rows_changed = count
            changed_rows = packed[2 * b + 2 * p + 1 :]
            row_map = {}
            if count <= ENGINE_ROW_BUDGET:
                for x, i in enumerate(ids):
                    if int(i) >= 0:
                        row_map[self.dsts[int(i)]] = changed_rows[x]
            else:
                # budget overflow: one extra readback of the full matrix
                from openr_tpu_torch.ops.staging import Readback

                dm_full = Readback(self.dm_dev).reap()
                moved = np.flatnonzero((dm_full != self.dm).any(axis=1))
                row_map = {self.dsts[int(i)]: dm_full[int(i)] for i in moved}
            # host-fallback dsts: adopt moved speculative rows into the
            # host mirror (keeps the overflow diff and future row budgets
            # quiet) but never re-trace from them
            for dst in self.host_dsts & set(row_map):
                self.dm[self.dst_pos[dst]] = row_map[dst]
            a_retrace = ((aff2 | set(row_map)) - aff1 - self.host_dsts) & dst_set
            if aff1:
                # first paths changed: masks are stale for these, so the
                # speculative rows are wrong by construction; re-solve
                # with fresh masks and scatter the corrections
                self._recompute(ls, state, sorted(aff1), d_new_src)
            if a_retrace:
                unrealized = self._retrace_only(ls, graph, sorted(a_retrace), row_map)
                if unrealized:
                    # masks drifted for these: full per-dst repair
                    self._recompute(ls, state, sorted(unrealized), d_new_src)
            # a moved speculative row means the destination's second
            # paths may have changed even when no membership test fired:
            # its routes must not be served from the reuse cache
            affected |= set(row_map) & dst_set
        else:
            recompute = sorted(aff1 | aff2)
            if recompute:
                self._recompute(ls, state, recompute, d_new_src)
        self._prime_all(ls)

        # commit snapshots
        for pair, (_w_old, w_new, _sig_old, sig_new) in changed.items():
            if w_new >= INF and sig_new is None:
                self.eff_w.pop(pair, None)
                self.attr_sig.pop(pair, None)
                for end in pair:
                    self.pairs_by_node.get(end, set()).discard(pair)
            else:
                self.eff_w[pair] = w_new
                self.attr_sig[pair] = sig_new
                for end in pair:
                    self.pairs_by_node.setdefault(end, set()).add(pair)
        for x in ov_flips:
            self.ov[x] = ls.is_node_overloaded(x)
        for x in label_flips:
            db = ls.get_adjacency_databases().get(x)
            self.node_label[x] = db.node_label if db else 0
        if any(w_old >= INF or w_new >= INF for (w_old, w_new, _so, _sn) in changed.values()):
            self.ecc_hops = ls.get_max_hops_to_node(self.src_name)
        self.d_base = d_new_src.astype(np.int32)
        self.version = ls.topology_version
        self.aversion = ls.attributes_version
        _counters()["decision.ksp2_incremental_syncs"] += 1
        _counters()["decision.ksp2_affected_dsts"] += len(affected)
        self.last_affected = affected
        self._lap("prime_ms")
        return affected

    # -- cold build --------------------------------------------------------

    def _cold_build(self, ls: LinkState, state, dsts: List[str]) -> None:
        from openr_tpu_torch.decision import spf_solver as _ss
        from openr_tpu_torch.ops import spf_sparse

        self.valid = False
        graph = state.graph
        self.state = state
        self.dsts = list(dsts)
        self.band_shapes = tuple(graph.bands)
        # per-node slot-map snapshot for drift detection (see _sync):
        # ell_patch replaces a node's inner dict wholesale, so the inner
        # dicts compare by content later
        self._slot_maps = dict(graph.slot_of) if graph.slot_of is not None else {}
        self.sid = graph.node_index.get(self.src_name)
        if self.sid is None:
            return
        self.dst_pos = {d: i for i, d in enumerate(dsts)}
        n = graph.n_pad

        # the fused dispatch seeds the resident all-sources matrix and
        # serves the view; d_prev is a placeholder on the cold path (the
        # reset sentinel restarts every row), the previous matrix when
        # its shape still fits
        view_srcs = spf_sparse.ell_source_batch(graph, ls, self.src_name)
        srcs, w_sv = spf_sparse._batch_host_args(graph, view_srcs)
        placeholder, self.d_prev_dev = self.d_prev_dev, None
        self.masks_t = None  # must be None while the chunked solves run
        self.dm_dev = None  # (no resident scatter)
        if placeholder is None or tuple(placeholder.shape) != (n, n):
            placeholder = torch.zeros((n, n), dtype=torch.int32, device=self.device)
        d_all_dev, back, self.last_hops = spf_sparse.ell_all_view_rows(
            state, srcs, w_sv, np.asarray([self.sid], np.int32), placeholder,
        )
        del placeholder
        self.d_prev_dev = d_all_dev
        packed = back.reap()
        b = len(view_srcs)
        self._preload_view(ls, graph, view_srcs, packed[: 2 * b])
        self.d_base = packed[0].astype(np.int32)
        self._lap("dispatch_ms")

        # first paths traced from the device base row (the same paths as
        # the host get_kth_paths(.., 1): same canonical order)
        cands_of = make_cands_of(ls, graph.node_index)
        transit_blocked = _transit_blocked(ls, graph, self.src_name)
        self.first_paths: Dict[str, List[List[Link]]] = {}
        self.second_paths: Dict[str, List[List[Link]]] = {}
        self.excl: Dict[str, Set[Link]] = {}
        self.node_users: Dict[str, Set[str]] = {}
        traced = self._trace_many(
            ls, graph, cands_of, transit_blocked, dsts, self.d_base, True, [set()] * len(dsts),
        )
        for dst, paths in zip(dsts, traced):
            self.first_paths[dst] = paths
            self.excl[dst] = {l for p in paths for l in p}
        self._lap("first_paths_ms")

        # masked rows for every destination, chunked like the per-build
        # dispatch; second paths traced from them
        self.dm = np.full((len(dsts), n), INF, dtype=np.int32)
        self.host_dsts: Set[str] = set()
        self._solve_masked_batches(ls, state, dsts, cands_of, transit_blocked)
        self._prime_all(ls)
        self._lap("prime_ms")

        # fast path: keep every destination's edge masks and masked rows
        # resident, so the next event's fused dispatch can re-solve and
        # row-diff them on the device; gated on the same mask-memory
        # budget as the chunked dispatch
        slots = sum(band.rows * band.k for band in graph.bands)
        if (
            _fast_path_enabled(self.device)
            and dsts
            and len(dsts) * 2 * max(1, slots) <= _ss.KSP2_DEVICE_MASK_BUDGET
        ):
            masks_all, _ok = spf_sparse.build_edge_masks(graph, [self.excl[d] for d in dsts])
            up = state.stager.upload([("masks", m) for m in masks_all] + [("rows", self.dm)])
            self.masks_t = tuple(up[:-1])
            self.dm_dev = up[-1]
            self._lap("resident_masks_ms")

        # graph-attribute snapshots for churn diffing
        self.eff_w, self.attr_sig = {}, {}
        for name in graph.node_names:
            if name not in graph.node_index:
                continue
            sigs = self._node_sigs(ls, name)
            weights = self._min_weights(sigs)
            for other, sig in sigs.items():
                self.eff_w[(name, other)] = weights[other]
                self.attr_sig[(name, other)] = sig
        self.pairs_by_node = {}
        for pair in self.eff_w:
            self.pairs_by_node.setdefault(pair[0], set()).add(pair)
            self.pairs_by_node.setdefault(pair[1], set()).add(pair)
        self.ov = {name: ls.is_node_overloaded(name) for name in graph.node_names}
        self.node_label = {
            name: db.node_label for name, db in ls.get_adjacency_databases().items()
        }
        self.ecc_hops = ls.get_max_hops_to_node(self.src_name)
        self.version = ls.topology_version
        self.aversion = ls.attributes_version
        self.valid = True
        _counters()["decision.ksp2_cold_builds"] += 1
        self._lap("snapshot_ms")

    # -- diffing -----------------------------------------------------------

    @staticmethod
    def _node_sigs(ls: LinkState, a: str) -> Dict[str, Tuple]:
        """Materialization-relevant attributes of every (a, other) link
        direction in one pass over a's ordered links: next-hop addresses,
        interfaces, adj labels, and canonical link identity (identity
        changes can reorder the deterministic trace's candidate list).
        One pass, not one scan a pair: per-pair scans made diffing one
        event O(degree^2) on high-degree spines."""
        sigs: Dict[str, List[Tuple]] = {}
        for link in ls.ordered_links_from_node(a):
            if not link.is_up():
                continue
            sigs.setdefault(link.other_node(a), []).append(
                (
                    link.iface_from(a),
                    link.nh_v4_from(a).addr,
                    link.nh_v6_from(a).addr,
                    link.adj_label_from(a),
                    link.metric_from(a),
                )
            )
        return {other: tuple(s) for other, s in sigs.items()}

    @staticmethod
    def _min_weights(sigs: Dict[str, Tuple]) -> Dict[str, int]:
        """Collapsed min-metric per neighbour, from the sig tuples (the
        metric is each sig's last element): the one source of the
        min(metric, INF - 1) reduction."""
        return {
            other: min(min(int(s[-1]), INF - 1) for s in sig_list)
            for other, sig_list in sigs.items()
        }

    def _diff_pairs(
        self, ls: LinkState, affected_nodes: Set[str]
    ) -> Optional[Dict[Tuple[str, str], Tuple]]:
        """Directed pairs incident to the affected nodes whose collapsed
        min-metric or materialization attributes changed: (u, v) ->
        (w_old, w_new, sig_old, sig_new); None when the node set changed.
        Parallel links are first-class: the pair model keeps min weights
        (exact for first-path membership, a lower bound for the masked
        graph's) while the per-link sigs catch sibling-only changes, and
        the per-link ELL slots make every member maskable (reference:
        LinkState.h:82)."""
        changed: Dict[Tuple[str, str], Tuple] = {}
        graph_index = self.state.graph.node_index
        seen_pairs: Set[Tuple[str, str]] = set()
        # one links pass per origin node, not per pair
        sig_cache: Dict[str, Dict[str, Tuple]] = {}
        w_cache: Dict[str, Dict[str, int]] = {}

        def node_view(a: str):
            if a not in sig_cache:
                sig_cache[a] = self._node_sigs(ls, a)
                w_cache[a] = self._min_weights(sig_cache[a])
            return sig_cache[a], w_cache[a]

        for x in affected_nodes:
            if x not in graph_index:
                return None  # node set changed
            neighbors: Set[str] = set()
            for link in ls.links_from_node(x):
                if not link.is_up():
                    continue
                neighbors.add(link.other_node(x))
            # pairs that vanished entirely (link down: neither direction
            # survives), probed through the incident-pair index, not a
            # scan of every pair
            for (u, v) in list(self.pairs_by_node.get(x, ())):
                if (u, v) in seen_pairs:
                    continue
                other = v if u == x else u
                if other not in neighbors:
                    changed[(u, v)] = (self.eff_w.get((u, v), INF), INF, None, None)
                    seen_pairs.add((u, v))
            for other in neighbors:
                for pair in ((x, other), (other, x)):
                    if pair in seen_pairs:
                        continue
                    seen_pairs.add(pair)
                    a, bnode = pair
                    sigs_a, ws_a = node_view(a)
                    w_new = ws_a.get(bnode, INF)
                    sig_new = sigs_a.get(bnode, ())
                    w_old = self.eff_w.get(pair, INF)
                    sig_old = self.attr_sig.get(pair, ())
                    if w_old != w_new or sig_old != sig_new:
                        changed[pair] = (w_old, w_new, sig_old, sig_new)
        return changed

    def _diff_nodes(
        self, ls: LinkState, affected_nodes: Set[str]
    ) -> Tuple[Set[str], Set[str]]:
        ov_flips = {
            x for x in affected_nodes if self.ov.get(x, False) != ls.is_node_overloaded(x)
        }
        dbs = ls.get_adjacency_databases()
        label_flips = {
            x
            for x in affected_nodes
            if self.node_label.get(x, 0) != (dbs[x].node_label if x in dbs else 0)
        }
        return ov_flips, label_flips

    # -- affected-set computation -----------------------------------------

    def _affected_dsts(
        self,
        ls: LinkState,
        graph,
        changed: Dict[Tuple[str, str], Tuple],
        d_new_src: np.ndarray,
        rows_new: Dict[int, np.ndarray],
        rows_old: Dict[int, np.ndarray],
    ) -> Tuple[Set[str], Set[str]]:
        """(first-path affected, masked/second-path affected): split
        because the former invalidates the destination's masks (a fresh
        masked solve) while the latter only needs the second paths
        re-derived."""
        index = graph.node_index
        dst_ids = np.asarray([index[d] for d in self.dsts], dtype=np.int64)
        d_old_src = self.d_base.astype(np.int64)
        d_new = d_new_src  # already int64
        inf = np.int64(INF)

        aff = d_new[dst_ids] != d_old_src[dst_ids]
        aff2_vec = np.zeros(len(self.dsts), dtype=bool)

        dm = self.dm.astype(np.int64, copy=False)
        dm_total = dm[np.arange(len(self.dsts)), dst_ids]

        def eff(w, origin, ov_map):
            if w >= INF:
                return inf
            if ov_map.get(origin, False) and origin != self.src_name:
                return inf
            return np.int64(w)

        ov_new = {x: ls.is_node_overloaded(x) for x in graph.node_names}
        for (u, v), (w_old, w_new, _so, _sn) in changed.items():
            uid, vid = index[u], index[v]
            r_old_v = rows_old[vid].astype(np.int64, copy=False)
            r_new_v = rows_new[vid].astype(np.int64, copy=False)
            wo = eff(w_old, u, self.ov)
            wn = eff(w_new, u, ov_new)
            # first-path DAG membership, old and new graphs (exact)
            if wo < inf:
                lhs = d_old_src[uid] + wo + r_old_v[dst_ids]
                valid = (d_old_src[uid] < inf) & (r_old_v[dst_ids] < inf)
                aff |= valid & (lhs == d_old_src[dst_ids])
            if wn < inf:
                lhs = d_new[uid] + wn + r_new_v[dst_ids]
                valid = (d_new[uid] < inf) & (r_new_v[dst_ids] < inf)
                aff |= valid & (lhs == d_new[dst_ids])
            # masked-graph membership bound (conservative: base distances
            # lower-bound masked ones). A destination with dm_total == INF
            # is disconnected in its masked graph; metric-only churn
            # cannot connect it, so those rows are dirtied only by a link
            # appearing (w: INF -> finite), or the <= test against INF
            # would fire for every disconnected row
            reachable_m = dm_total < inf
            if wo < inf:
                lhs = dm[:, uid] + wo + r_old_v[dst_ids]
                valid = (dm[:, uid] < inf) & (r_old_v[dst_ids] < inf) & reachable_m
                aff2_vec |= valid & (lhs <= dm_total)
            if wn < inf:
                lhs = d_new[uid] + wn + r_new_v[dst_ids]
                valid = (d_new[uid] < inf) & (r_new_v[dst_ids] < inf) & reachable_m
                aff2_vec |= valid & (lhs <= dm_total)
            if wo >= inf and wn < inf:
                # edge usable where it was not (link appeared, or its
                # origin undrained: hence effective weights, not raw):
                # disconnected masked rows may reconnect
                aff2_vec |= ~reachable_m
        aff1 = {self.dsts[i] for i in np.flatnonzero(aff)}
        aff2 = {self.dsts[i] for i in np.flatnonzero(aff2_vec)}
        return aff1, aff2

    # -- recompute ---------------------------------------------------------

    def _retrace_only(
        self, ls: LinkState, graph, dsts: List[str], row_map: Dict[str, np.ndarray]
    ) -> Set[str]:
        """Fast-path update for destinations whose masks are unchanged:
        adopt the speculative masked row (when it moved) and re-trace
        second paths with the current weights. First paths and exclusion
        sets stay as cached.

        Returns the destinations whose row no trace realizes (a finite
        masked total with no path to it, or none where one should be):
        their resident masks drifted from the true exclusion set, so the
        caller recomputes them from scratch (the reference's soak seed
        9013: stale masks gave total 6 where the true masked distance
        was 8, and the trace found nothing)."""
        cands_of = make_cands_of(ls, graph.node_index)
        transit_blocked = _transit_blocked(ls, graph, self.src_name)
        for dst in dsts:
            row = row_map.get(dst)
            if row is not None:
                self.dm[self.dst_pos[dst]] = row
            for path in self.second_paths.get(dst, []):
                for x in _path_nodes(self.src_name, path):
                    users = self.node_users.get(x)
                    if users is not None:
                        users.discard(dst)
        traced = self._trace_many(
            ls, graph, cands_of, transit_blocked, dsts,
            np.ascontiguousarray(self.dm[[self.dst_pos[d] for d in dsts]]),
            False, [self.excl[d] for d in dsts],
        )
        unrealized: Set[str] = set()
        for dst, paths in zip(dsts, traced):
            if not paths:
                # an empty trace: the row is finite but unwalkable, or
                # INF where the true masked graph has a path; a
                # destination with no second path just re-confirms
                unrealized.add(dst)
                continue
            self.second_paths[dst] = paths
            for path in paths:
                for x in _path_nodes(self.src_name, path):
                    self.node_users.setdefault(x, set()).add(dst)
        self._lap("retrace_ms")
        return unrealized

    def _recompute(
        self, ls: LinkState, state, affected: List[str], d_new_src: np.ndarray
    ) -> None:
        graph = state.graph
        cands_of = make_cands_of(ls, graph.node_index)
        transit_blocked = _transit_blocked(ls, graph, self.src_name)
        for dst in affected:
            # drop stale reverse-index entries
            for path in self.first_paths.get(dst, []) + self.second_paths.get(dst, []):
                for x in _path_nodes(self.src_name, path):
                    users = self.node_users.get(x)
                    if users is not None:
                        users.discard(dst)
        traced = self._trace_many(
            ls, graph, cands_of, transit_blocked, affected,
            d_new_src.astype(np.int32), True, [set()] * len(affected),
        )
        for dst, paths in zip(affected, traced):
            self.first_paths[dst] = paths
            self.excl[dst] = {l for p in paths for l in p}
        self._lap("first_paths_ms")
        self.host_dsts -= set(affected)
        self._solve_masked_batches(ls, state, affected, cands_of, transit_blocked)

    def _solve_masked_batches(self, ls, state, dsts, cands_of, transit_blocked) -> None:
        """Masked-SPF rows, second-path traces and dm/node_users updates
        for a destination subset (the cold build's and the incremental
        recompute's one loop)."""
        from openr_tpu_torch.decision import spf_solver as _ss
        from openr_tpu_torch.ops import spf_sparse

        graph = state.graph
        chunk = _ss._ksp2_chunk(graph)
        stats = self.stats

        def _submit(batch):
            """Stage 1: mask build, the masked solve with its readback in
            flight, and on the fast path the scatter of the batch's masks
            and rows into the resident ones, all on the device stream.
            Returns ``(batch, ok, readback)``."""
            # pad to a power-of-two bucket (capped at the chunk), so the
            # batch takes a handful of shapes, not one a set size
            bucket = 8
            while bucket < len(batch):
                bucket *= 2
            bucket = min(bucket, chunk)
            excl_sets = [self.excl[d] for d in batch]
            masks, ok = spf_sparse.build_edge_masks(
                graph, excl_sets + [set()] * (bucket - len(batch))
            )
            stats["mask_bytes"] = stats.get("mask_bytes", 0) + sum(m.nbytes for m in masks)
            items = [("masks", m) for m in masks]
            if self.masks_t is not None:
                items.append(("rows", np.asarray([self.dst_pos[d] for d in batch], np.int32)))
            up = state.stager.upload(items)
            self._lap("masks_ms")
            back = spf_sparse.ell_masked_distances_resident(state, self.sid, up[: len(masks)])
            _counters()["decision.ksp2_device_batches"] += 1
            stats["chunks"] = stats.get("chunks", 0) + 1
            if self.masks_t is not None:
                # fast path: keep the resident masks and masked rows in
                # step, so the next event's speculative solve uses the
                # current exclusions
                ids = up[-1].long()
                for m_res, m_new in zip(self.masks_t, up[: len(masks)]):
                    m_res.index_copy_(0, ids, m_new[: len(batch)])
                self.dm_dev.index_copy_(0, ids, back.tensor[: len(batch)])
            self._lap("solve_ms")
            return batch, ok, back

        def _settle(batch, ok, back):
            """Stage 2: reap the masked rows, settle dm and the fallback
            accounting, trace second paths: host work the next chunk's
            submitted solve overlaps."""
            drows = back.reap()
            self._lap("solve_ms")
            traceable: List[int] = []
            for i, dst in enumerate(batch):
                self.dm[self.dst_pos[dst]] = drows[i]
                if not ok[i]:
                    _counters()["decision.ksp2_host_fallbacks"] += 1
                    self.host_dsts.add(dst)
                    self.second_paths.pop(dst, None)
                    # the (unrepresentable-mask) row is kept anyway: it is
                    # deterministic, so the fast path's row diff stays
                    # quiet for this destination; host_dsts keeps it out
                    # of every cache read
                    continue
                traceable.append(i)
            traced = self._trace_many(
                ls, graph, cands_of, transit_blocked, [batch[i] for i in traceable],
                np.ascontiguousarray(np.asarray(drows)[traceable]),
                False, [self.excl[batch[i]] for i in traceable],
            )
            for i, paths in zip(traceable, traced):
                self.second_paths[batch[i]] = paths
            self._lap("second_paths_ms")

        # one-deep pipeline: chunk i+1's masked solve is submitted before
        # chunk i's rows are reaped. Safe because self.excl is fixed for
        # the whole call and the settle stage touches host mirrors only.
        inflight = None
        for start in range(0, len(dsts), chunk):
            staged = _submit(dsts[start : start + chunk])
            if inflight is not None:
                _settle(*inflight)
            inflight = staged
        if inflight is not None:
            _settle(*inflight)
        for dst in dsts:
            if dst in self.host_dsts:
                continue
            for path in self.first_paths[dst] + self.second_paths.get(dst, []):
                for x in _path_nodes(self.src_name, path):
                    self.node_users.setdefault(x, set()).add(dst)

    def _trace_arrays(self, ls, graph, cands_of, transit_blocked) -> _TraceArrays:
        """The native tracer's int-encoded candidate structure at ``ls``'s
        (topology version, attribute version): one build serves every
        trace site of an event. Kept across events while the graph keeps
        its node ids; a later version re-encodes only the nodes that
        ``ls.affected_since`` reports, and a new node set or a journal
        that cannot say builds it whole. Its host ms are booked to
        ``trace_arrays_ms``."""
        key = (ls.topology_version, ls.attributes_version)
        cached = self._tarrays
        if cached is not None and cached[0] == key and cached[1].node_index is graph.node_index:
            return cached[1]
        t0 = time.perf_counter()
        dirty = None
        if (cached is not None and cached[1].node_index is graph.node_index
                and cached[1].n_pad == graph.n_pad):
            dirty = ls.affected_since(cached[0][0])
        if dirty is None:
            arrays = _TraceArrays(graph, cands_of, transit_blocked)
        else:
            arrays = cached[1]
            arrays.update(cands_of, transit_blocked, dirty)
        self._tarrays = (key, arrays)
        self._lap.carve("trace_arrays_ms", (time.perf_counter() - t0) * 1e3)
        return arrays

    def _trace_many(
        self, ls, graph, cands_of, transit_blocked, dsts, rows, shared_row, excls,
    ) -> List[List[List[Link]]]:
        """The trace front-end of every per-event path enumeration: the
        native batch tracer, or with ``TRACER = "python"`` the Python one a
        destination at a time. ``rows``: one [n_pad] row (``shared_row``)
        or [len(dsts), n_pad]; ``excls``: per-dst exclusion sets (empty
        for first paths). Nothing to trace builds nothing."""
        if not dsts:
            return []
        if self.tracer == "native":
            arrays = self._trace_arrays(ls, graph, cands_of, transit_blocked)
            return arrays.trace(
                self.sid,
                np.asarray([graph.node_index[d] for d in dsts], np.int32),
                rows, shared_row, excls,
            )
        shared_preds: Optional[Dict[str, list]] = {} if shared_row else None
        row_list = rows.tolist() if shared_row else None
        return [
            trace_paths_from_row(
                self.src_name, dst, graph.node_index,
                row_list if shared_row else rows[i].tolist(),
                excls[i], cands_of, transit_blocked,
                preds_cache=(shared_preds if not excls[i] else None),
            )
            for i, dst in enumerate(dsts)
        ]

    # -- priming / view preload -------------------------------------------

    def _prime_all(self, ls: LinkState) -> None:
        for dst in self.dsts:
            if dst in self.host_dsts:
                continue  # LinkState computes these lazily (host SPF)
            ls.prime_kth_paths(self.src_name, dst, 1, self.first_paths[dst])
            ls.prime_kth_paths(self.src_name, dst, 2, self.second_paths.get(dst, []))

    def _preload_view(self, ls, graph, view_srcs, view_packed) -> None:
        self.resident.preload_view(ls, graph, list(view_srcs), np.asarray(view_packed))
