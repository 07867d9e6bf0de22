"""Sliced-ELL shortest paths for large topologies (no dense matrix).

Port note: mirrors the view-solve subset of
``openr_tpu/ops/spf_sparse.py``: ``EllBand``/``EllGraph``, the per-link
in-edge slots, ``compile_ell`` (both directions: per-link in-edge bands
for the SPF views, per-neighbour out-edge bands for the route sweep of
``ops.route_sweep``), ``_as_device_ids``, ``direct_metrics``,
``_ell_relax``, ``_ell_view_batch``, ``_first_hops_from_rows``,
``ell_view_batch_packed`` and ``ell_source_batch``; the resident
incremental state of the churn path: ``ell_patch`` (with ``widen``),
``band_row_edge_changes``/``_delta``, ``pad_increase_edges``,
``_warm_seed``, ``_device_direct_metrics``, the fused churn step
``_ell_reconverge``, ``band_patch_inputs``, ``EllState`` with
``ELL_COUNTERS`` and ``ell_reconverge_step``; and the KSP2 second-path
solve: ``_ell_relax_masked``, ``_ell_masked_fixed_point``,
``build_edge_masks``, ``ell_masked_distances`` (host bands) and
``ell_masked_distances_resident`` (an ``EllState``'s resident bands);
and the incremental KSP2 engine's all-sources solve: ``_ell_fixed_point``,
``ell_distances_from_sources`` and the fused engine dispatches
``ell_all_view_rows`` and ``ell_all_view_rows_masked`` (all-sources
distances, the root's view and the endpoint rows; the latter also the
speculative masked re-solve of every destination, row-diffed on the
device).
The reference's committed dispatches go through the executable cache
here too (``ell_dispatch``, ``ops/aot_cache.py``): ``ell_masked_distances``,
``ell_masked_distances_resident``, ``ell_all_view_rows`` and
``ell_all_view_rows_masked`` run a captured body of a fixed hop budget
whose status (hops, converged) is read once, and re-dispatched with a
larger budget when it ran out; the other fixed points run eagerly. The
plan selector ``set_ell_relax_impl`` ("plan", a variant, "auto") is the
reference's. Each band of a relax step goes through
``ops.ell_relax.ell_band_relax`` (or ``ell_band_relax_masked``:
the hand-written CUDA kernels on the card, their plain torch versions on
the CPU), writing into its column slice of one output instead of
concatenating band parts. The KSP2 edge masks are built bit-packed on
the host (32 slots an int32 word) where the JAX package builds bool
cells. The JAX ``lax.while_loop`` becomes chunks of hops whose changed
count stays on the card (``ops/relax_loop.py``): one host sync a chunk
eagerly, none in a captured body. Where the reference donates its
resident buffers, the port scatters the patched rows into them in place
(``index_copy_``); its
host-to-device copies go through one pinned buffer
(``ops.staging.UploadStager``), and the engine's and the masked solve's
readbacks land in pinned host memory (``ops.staging.Readback``), where the
reference kicks an async copy and reaps it. The tenant plane's
uniform blocks: ``ell_pack_uniform``, ``ell_uniform_rows``,
``_uniform_relax`` (through ``ell_relax.ell_band_relax_worlds``, the
kernel with a world axis, over the rows' live slots that
``ell_relax.live_slots`` counts once a dispatch), ``_uniform_direct``, ``_tenant_view_solve``
(written batched over the tenant axis, where the reference maps one
tenant's solve under ``vmap``) and ``world_view_solve`` (the
reference's unfused entry, which only the tests call: the package runs
``route_engine.world_dispatch``, whose first four outputs are the same
values). Left out for
later slices: ``iter_ell_all_sources``/``ell_all_sources``, the flat
edge-list graph and sharding.

One relaxation step over the class bands costs S x (total slots) work:

    out[s, j] = min(d[s, j], min_slot d[s, src[j, slot]] + w_eff[j, slot])

with ``w_eff = INF`` for edges leaving an overloaded node. Nodes are
ordered by (degree class, name), so every lookup goes through
``EllGraph.node_index``.
"""

from __future__ import annotations

import os
import time
import weakref
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops import autotune
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops import relax_loop
from openr_tpu_torch.ops.aot_cache import _flatten, aot_call
from openr_tpu_torch.ops.ell_relax import (
    ell_band_relax,
    ell_band_relax_masked,
    ell_band_relax_worlds,
    live_slots,
    mask_words,
)
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.ops.spf import _first_hops_from_rows
from openr_tpu_torch.ops.staging import Readback, UploadStager
from openr_tpu_torch.telemetry import get_registry

_NODE_PAD = 128
_ELL_SLOT_PAD = 8

# Churn-path health counters of the resident bands, by the JAX package's
# names, stored in the port's telemetry registry under "decision." (so
# ``decision.spf_solver.get_spf_counters`` and a registry snapshot read the
# same numbers; ``ELL_COUNTERS[k] += 1`` works as on a dict). A change that
# knocks the churn path back to full recompiles shows as
# ell_incremental_syncs staying flat while ell_cold_solves climbs.
ELL_COUNTERS = get_registry().counter_dict(
    [
        "ell_incremental_syncs",  # patches scattered into resident bands
        "ell_warm_solves",  # solves seeded from the previous distances
        "ell_cold_solves",  # solves from the unit init
        "ell_widen_events",  # bands re-uploaded whole after a widen
        "ell_patch_merges",  # stacked patches coalesced warm
        "ell_structural_warm_solves",  # overload/link flips kept warm
    ],
    prefix="decision.",
)


# Sliced-ELL relax plan selector, the sparse twin of ops.spf's min-plus
# selector: "plan" (each kernel's heuristic launch plan), one of the
# autotuner's "ell_relax" variants by name, or "auto", the measured winner
# for the dispatch's (n_pad, k_slot) band geometry (ops.autotune). The
# reference's names "jnp" and "pallas" both mean "plan": the port has one
# formulation on the card, the hand kernels. The committed dispatch tags
# re-key through ``ell_dispatch`` when a variant other than "plan" is
# armed, so flipping the impl never replays a stale capture.
_REFERENCE_IMPLS = {"jnp": "plan", "pallas": "plan"}
_ELL_IMPLS = tuple(c for c in autotune._FAMILY_CANDIDATES["ell_relax"] if c != "plain")


def _impl_setting(name: str, valid: Tuple[str, ...]) -> str:
    impl = _REFERENCE_IMPLS.get(name, name)
    if impl not in valid + ("auto",):
        raise ValueError(f"ell relax impl {name!r}: one of {valid + ('auto',)}")
    return impl


_ELL_IMPL = _impl_setting(os.environ.get("OPENR_ELL_RELAX", "plan"), _ELL_IMPLS)


def set_ell_relax_impl(impl: str) -> None:
    global _ELL_IMPL
    _ELL_IMPL = _impl_setting(impl, _ELL_IMPLS)


def get_ell_relax_impl() -> str:
    return _ELL_IMPL


def _ell_impl_for(n: int, k: int, device) -> str:
    """The concrete plan variant for one (n_pad, k_slot) band geometry:
    "auto" resolves to the measured winner (memoized per shape by the
    autotuner, measured here, outside any capture)."""
    if _ELL_IMPL != "auto":
        return _ELL_IMPL
    return autotune.resolve_ell_relax((int(n), int(k)), device)


def ell_dispatch(tag, fn, dyn_args, statics, shape=None):
    """Committed dispatch of a body that runs the sliced-ELL relaxes
    (``_ell_relax``, ``_ell_relax_masked``, ``route_sweep._rev_relax``):
    the concrete plan variant for the dispatch's band geometry (from
    ``statics`` ``bands`` and ``n``, or ``shape=(n, k)``) is resolved
    first and, when it is not "plan", suffixes the tag (``tag@run4``), so
    it re-keys the executable cache and shows in ``ops.device_ms.<tag>``.
    The kernels inside launch that variant (``autotune.using``)."""
    if shape is None:
        shape = (statics["n"], max(b.k for b in statics["bands"]))
    leaves: List[torch.Tensor] = []
    _flatten(tuple(dyn_args), leaves)
    impl = _ell_impl_for(int(shape[0]), int(shape[1]), leaves[0].device)
    if impl != "plan":
        tag = f"{tag}@{impl}"
    with autotune.using("ell_relax", impl):
        return aot_call(tag, fn, dyn_args, statics)


# hop budget of each budgeted dispatch tag: it starts at one chunk and
# doubles (relax_loop.next_budget) each time a dispatch runs out of hops
_HOP_BUDGET: Dict[str, int] = {}


def _budgeted_dispatch(tag, fn, dyn_args, statics, n: int, shape=None):
    """``ell_dispatch`` of a body that takes a static hop ``budget`` and
    returns its outputs followed by a status row ``[hops, converged, ...]``
    (one pair a fixed point): the status is read (one blocking sync), and
    the body re-dispatched with a larger budget until every fixed point in
    it converged. Returns ``(outputs, hops of the first fixed point)``.
    ``shape`` as in ``ell_dispatch``."""
    return _budgeted_reap(
        tag, fn, dyn_args, statics, n,
        _budgeted_launch(tag, fn, dyn_args, statics, n, shape, kick=False),
        shape,
    )


def _budgeted_launch(tag, fn, dyn_args, statics, n: int, shape=None,
                     kick: bool = True):
    """The launch half of ``_budgeted_dispatch``: one dispatch at the
    tag's current budget, its status staged to the host (``kick_async``)
    rather than read, so the caller can launch other work before
    ``_budgeted_reap`` waits for it. Returns ``(outputs, status, budget)``."""
    budget = min(_HOP_BUDGET.get(tag, relax_loop.HOP_CHUNK), n)
    *out, status = ell_dispatch(tag, fn, dyn_args, dict(statics, budget=budget),
                                shape=shape)
    return out, (da.kick_async(status) if kick else status), budget


def _budgeted_reap(tag, fn, dyn_args, statics, n: int, launched, shape=None):
    """The reap half: reads the status of ``launched`` and, while a fixed
    point ran out of its budget, re-dispatches the body on the same
    untouched ``dyn_args`` with a larger one (each re-dispatch read at
    once). Returns ``(outputs, hops of the first fixed point)``; the
    outputs are ``launched``'s own unless a re-dispatch replaced them."""
    out, status, budget = launched
    st = da.reap_read(status, kicked=True)
    while not (st[1::2].all() or budget >= n):
        budget = relax_loop.next_budget(budget, n)
        _HOP_BUDGET[tag] = budget
        *out, status = ell_dispatch(tag, fn, dyn_args, dict(statics, budget=budget),
                                    shape=shape)
        st = da.reap_read(status)
    return out, int(st[0])


def _status(changed, budget: int, n: int) -> torch.Tensor:
    """The int32 ``[hops, converged]`` of one budgeted fixed point."""
    hops, ok = relax_loop.hop_status(changed, budget, n)
    return torch.stack([hops.to(torch.int32), ok.to(torch.int32)])


def _pad_up(n: int, align: int) -> int:
    return max(align, ((n + align - 1) // align) * align)


@dataclass(frozen=True)
class EllBand:
    """One degree class: nodes [start, start + rows) hold <= k in-edges."""

    start: int
    rows: int
    k: int


@dataclass(frozen=True)
class EllGraph:
    node_names: Tuple[str, ...]  # index == dense id (class-grouped order!)
    node_index: Dict[str, int]
    n: int
    n_pad: int
    bands: Tuple[EllBand, ...]
    src: Tuple[np.ndarray, ...]  # per band [rows, k] int32 (self-loop pad)
    w: Tuple[np.ndarray, ...]  # per band [rows, k] int32 (INF pad)
    overloaded: np.ndarray  # [n_pad] bool
    # band index -> band-local changed row ids, set by ell_patch so a
    # resident consumer scatters only those rows; None == full graph
    changed: Optional[Dict[int, np.ndarray]] = None
    # band indices whose k ell_patch(widen=True) grew (a row outgrew its
    # slot class): node ids are unchanged, but the band's arrays have a
    # new shape, so a resident consumer re-uploads those bands whole
    widened: Optional[frozenset] = None
    # "in": row j holds the edges INTO j (the forward relax layout);
    # "out": row j holds the edges OUT of j (the reversed-graph layout
    # the destination-major route sweep relaxes over)
    direction: str = "in"
    # per-link slot index of an "in" graph: node id -> {link key ->
    # (band, row, slot)}. What makes one member of a parallel group
    # excludable for KSP2. None for an "out" graph.
    slot_of: Optional[Dict[int, Dict[Tuple, Tuple[int, int, int]]]] = None


_EMPTY_SLOTS: dict = {}


def link_key(link) -> Tuple:
    """Canonical per-link identity: Link's (node, iface) pair tuple.
    Parallel links between one node pair differ in their iface pairs."""
    return link.ordered_names


# weakly keyed by the LIVE LinkState, so a recycled id() can never
# serve a dead graph's slots
_IN_SLOTS_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _in_edge_slots(ls, name, index) -> List[Tuple[int, int, Tuple]]:
    """PER-LINK in-edge slots of ``name``: [(origin id, metric, link
    key)], sorted (origin id, key). Parallel links keep their own slots.

    Memoized per live graph x (topology version, node); the id mapping is
    validated by identity on the cached entry. Callers must not mutate
    the list."""
    per_ls = _IN_SLOTS_MEMO.get(ls)
    if per_ls is None:
        per_ls = {}
        _IN_SLOTS_MEMO[ls] = per_ls
    memo_key = (ls.topology_version, name)
    cached = per_ls.get(memo_key)
    if cached is not None and cached[0] is index:
        return cached[1]
    slots: List[Tuple[int, int, Tuple]] = []
    for link in ls.ordered_links_from_node(name):
        if not link.is_up():
            continue
        other = link.other_node(name)
        i = index.get(other)
        if i is None:
            continue
        m = min(int(link.metric_from(other)), int(INF) - 1)
        slots.append((i, m, link_key(link)))
    slots.sort(key=lambda t: (t[0], t[2]))
    while len(per_ls) > 256:
        per_ls.pop(next(iter(per_ls)))
    per_ls[memo_key] = (index, slots)
    return slots


def _in_edges(ls, name, index) -> Dict[int, int]:
    """origin id -> min reverse-direction metric (parallel links: min)."""
    best: Dict[int, int] = {}
    for link in ls.ordered_links_from_node(name):
        if not link.is_up():
            continue
        other = link.other_node(name)
        i = index.get(other)
        if i is None:
            continue
        m = min(int(link.metric_from(other)), int(INF) - 1)
        if i not in best or m < best[i]:
            best[i] = m
    return best


def _out_edges(ls, name, index) -> Dict[int, int]:
    """dst id -> min forward-direction metric (parallel links: min).
    Row ``name`` of an out-ELL graph holds (dst, w(name -> dst)): the
    in-edge bands of the reversed graph."""
    best: Dict[int, int] = {}
    for link in ls.ordered_links_from_node(name):
        if not link.is_up():
            continue
        other = link.other_node(name)
        i = index.get(other)
        if i is None:
            continue
        m = min(int(link.metric_from(name)), int(INF) - 1)
        if i not in best or m < best[i]:
            best[i] = m
    return best


def _fill_row(src_row, w_row, edges) -> None:
    for slot, (i, m) in enumerate(sorted(edges.items())):
        src_row[slot] = i
        w_row[slot] = m


def _as_device_ids(ids, device) -> torch.Tensor:
    """int32 ids on ``device``; a tensor already there passes through
    without a copy or a host sync."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(ids, dtype=np.int32), device=device)


def _band_of(graph: EllGraph, node_id: int) -> Tuple[int, EllBand]:
    for bi, band in enumerate(graph.bands):
        if band.start <= node_id < band.start + band.rows:
            return bi, band
    raise KeyError(node_id)


def _class_k(degree: int) -> int:
    """Slot class: the power of two >= degree, at least _ELL_SLOT_PAD."""
    k = _ELL_SLOT_PAD
    while k < degree:
        k *= 2
    return k


def compile_ell(ls, align: int = _NODE_PAD, direction: str = "in") -> EllGraph:
    """Sliced-ELL compilation from the LinkState: O(E) host work and
    O(E) slots, no dense matrix.

    ``direction="in"`` gives every LINK its own slot (parallel links are
    not min-collapsed; the relax min()s across slots), and ``slot_of``
    records where. ``direction="out"`` builds the reversed-graph bands
    (row j = out-edges of j) that ``ops.route_sweep`` relaxes over, with
    one slot per neighbour holding the min over parallel links: the
    sweep's next-hop counts are per neighbour."""
    if direction not in ("in", "out"):
        raise ValueError(f"compile_ell: direction {direction!r}")
    per_link = direction == "in"
    raw_names = sorted(ls.get_adjacency_databases().keys())
    raw_index = {name: i for i, name in enumerate(raw_names)}
    if per_link:
        degree = {
            name: max(
                1,
                sum(
                    1
                    for link in ls.ordered_links_from_node(name)
                    if link.is_up() and link.other_node(name) in raw_index
                ),
            )
            for name in raw_names
        }
    else:
        degree = {
            name: max(1, len(_out_edges(ls, name, raw_index)))
            for name in raw_names
        }
    names = tuple(sorted(raw_names, key=lambda nm: (_class_k(degree[nm]), nm)))
    index = {name: i for i, name in enumerate(names)}
    n = len(names)
    n_pad = _pad_up(n, align)

    bands: List[EllBand] = []
    srcs: List[np.ndarray] = []
    ws: List[np.ndarray] = []
    slot_of: Dict[int, Dict[Tuple, Tuple[int, int, int]]] = {}
    overloaded = np.zeros(n_pad, dtype=bool)
    i = 0
    while i < n:
        k = _class_k(degree[names[i]])
        j = i
        while j < n and _class_k(degree[names[j]]) == k:
            j += 1
        rows = j - i
        # self-loop padding: inert with w = INF
        src_b = np.tile(np.arange(i, j, dtype=np.int32)[:, None], (1, k))
        w_b = np.full((rows, k), INF, dtype=np.int32)
        for r, name in enumerate(names[i:j]):
            if not per_link:
                _fill_row(src_b[r], w_b[r], _out_edges(ls, name, index))
                continue
            nd: Dict[Tuple, Tuple[int, int, int]] = {}
            for slot, (sid, m, key) in enumerate(_in_edge_slots(ls, name, index)):
                src_b[r, slot] = sid
                w_b[r, slot] = m
                nd[key] = (len(bands), r, slot)
            slot_of[index[name]] = nd
        bands.append(EllBand(start=i, rows=rows, k=k))
        srcs.append(src_b)
        ws.append(w_b)
        i = j
    for name in names:
        overloaded[index[name]] = ls.is_node_overloaded(name)
    return EllGraph(
        node_names=names, node_index=index, n=n, n_pad=n_pad,
        bands=tuple(bands), src=tuple(srcs), w=tuple(ws),
        overloaded=overloaded, direction=direction,
        slot_of=slot_of if per_link else None,
    )


def ell_patch(graph: EllGraph, ls, affected, widen: bool = False) -> Optional[EllGraph]:
    """A new EllGraph with only the affected nodes' band rows
    re-derived; ``changed`` maps band index -> band-local row ids. None
    when the node set changed, or (unless ``widen``) when a row outgrew
    its slot class: the caller then compiles in full, which may
    renumber.

    ``widen=True`` grows an overflowing band's k to the next power of
    two instead, with self-loop/INF padding: node ids stay the same, so
    resident per-node state stays valid, and the band's index goes into
    ``widened`` (its arrays changed shape). ``node_names`` and
    ``node_index`` are passed through as they are: their identity
    survives churn."""
    # node-set check without sorting every name: a removal changes the
    # count; an added (or renamed) node is in ``affected`` and fails the
    # node_index lookup below
    if len(ls.get_adjacency_databases()) != graph.n:
        return None
    per_link = graph.slot_of is not None
    src = list(graph.src)
    w = list(graph.w)
    bands = list(graph.bands)
    overloaded = graph.overloaded.copy()
    slot_of = dict(graph.slot_of) if per_link else None
    changed: Dict[int, List[int]] = {}
    widened: set = set()
    copied: set = set()
    for name in affected:
        i = graph.node_index.get(name)
        if i is None:
            return None
        if per_link:
            slots = _in_edge_slots(ls, name, graph.node_index)
        elif graph.direction == "in":
            edges = _in_edges(ls, name, graph.node_index)
        else:
            edges = _out_edges(ls, name, graph.node_index)
        bi, _ = _band_of(graph, i)
        band = bands[bi]  # may have been widened already this event
        n_entries = len(slots) if per_link else len(edges)
        if n_entries > band.k:
            if not widen:
                return None
            new_k = band.k
            while new_k < n_entries:
                new_k *= 2
            grow = new_k - band.k
            # self-loop src + INF w padding: inert in every relax
            pad_src = np.tile(
                np.arange(band.start, band.start + band.rows, dtype=np.int32)[:, None],
                (1, grow),
            )
            src[bi] = np.concatenate([src[bi], pad_src], axis=1)
            w[bi] = np.concatenate(
                [w[bi], np.full((band.rows, grow), INF, np.int32)], axis=1
            )
            bands[bi] = EllBand(start=band.start, rows=band.rows, k=new_k)
            band = bands[bi]
            widened.add(bi)
            copied.add(bi)  # concatenate made fresh arrays
        if bi not in copied:
            src[bi] = src[bi].copy()
            w[bi] = w[bi].copy()
            copied.add(bi)
        r = i - band.start
        src[bi][r] = i
        w[bi][r] = INF
        if per_link:
            # a fresh inner dict for this node: the outer copy above was
            # shallow, so the old graph keeps its own
            nd: Dict[Tuple, Tuple[int, int, int]] = {}
            for slot, (sid, m, key) in enumerate(slots):
                src[bi][r, slot] = sid
                w[bi][r, slot] = m
                nd[key] = (bi, r, slot)
            slot_of[i] = nd
        else:
            _fill_row(src[bi][r], w[bi][r], edges)
        overloaded[i] = ls.is_node_overloaded(name)
        changed.setdefault(bi, []).append(r)
    return EllGraph(
        node_names=graph.node_names, node_index=graph.node_index,
        n=graph.n, n_pad=graph.n_pad, bands=tuple(bands),
        src=tuple(src), w=tuple(w), overloaded=overloaded,
        changed={bi: np.asarray(sorted(rs), dtype=np.int32) for bi, rs in changed.items()},
        widened=frozenset(widened) if widened else None,
        direction=graph.direction, slot_of=slot_of,
    )


def _collapsed_row(src_row, w_row, head: int) -> Dict[int, int]:
    """tail id -> min weight over the row's slots, padding left out."""
    out: Dict[int, int] = {}
    for s, wv in zip(src_row.tolist(), w_row.tolist()):
        if s == head or wv >= INF:
            continue  # self-loop / INF padding slots
        if wv < out.get(s, INF):
            out[s] = wv
    return out


def band_row_edge_changes(old: EllGraph, patched: EllGraph) -> List[Tuple[int, int, int, int]]:
    """Every directed-edge weight change a patch's changed rows imply:
    ``[(tail id, head id, old weight, new weight)]`` for each (tail,
    head) whose min-over-parallel-slots weight moved (a removal reads as
    old -> INF, an addition as INF -> new). O(changed rows x k) host
    work. The (old, new) pair is what lets the warm-start journal merge
    stacked patches."""
    out: List[Tuple[int, int, int, int]] = []
    for bi, rows in (patched.changed or {}).items():
        band = patched.bands[bi]
        for r in np.asarray(rows).tolist():
            head = band.start + r
            old_w = _collapsed_row(old.src[bi][r], old.w[bi][r], head)
            new_w = _collapsed_row(patched.src[bi][r], patched.w[bi][r], head)
            for s, wo in old_w.items():
                wn = new_w.get(s, INF)
                if wn != wo:
                    out.append((s, head, wo, wn))
            for s, wn in new_w.items():
                if s not in old_w:
                    out.append((s, head, INF, wn))
    return out


def band_row_edge_delta(old: EllGraph, patched: EllGraph) -> List[Tuple[int, int, int]]:
    """The directed-edge weight increases of a patch: ``[(tail id, head
    id, old weight)]`` for each edge whose collapsed weight went up (a
    removal reads as old -> INF). Decreases are left out: a warm start
    only needs the increase-affected cone."""
    return [(s, h, wo) for s, h, wo, wn in band_row_edge_changes(old, patched) if wn > wo]


# an "increase" edge that flags every row's seed for reset (the tight
# test d[0] + 0 == d[0] always holds): a cold restart written as a
# one-edge delta, so warm and cold solves run the same code
_FORCE_RESET_EDGE = (0, 0, 0)


def pad_increase_edges(inc) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """An increase-edge delta as (tails, heads, old weights) int32
    arrays, padded to a power-of-two length (at least 4) with w = INF
    entries, which the tight test masks out."""
    bucket = 4
    while bucket < len(inc):
        bucket *= 2
    tails = np.zeros(bucket, dtype=np.int32)
    heads = np.zeros(bucket, dtype=np.int32)
    ws = np.full(bucket, INF, dtype=np.int32)
    for x, (t, h, wv) in enumerate(inc):
        tails[x] = t
        heads[x] = h
        ws[x] = wv
    return tails, heads, ws


def direct_metrics(graph: EllGraph, src_id: int, node_ids) -> np.ndarray:
    """Host-side direct min-metric src_id -> each node in node_ids (INF
    when not adjacent), read from the in-edge bands."""
    out = np.full(len(node_ids), INF, dtype=np.int32)
    for x, j in enumerate(node_ids):
        bi, band = _band_of(graph, int(j))
        r = int(j) - band.start
        hits = graph.src[bi][r] == src_id
        if hits.any():
            out[x] = graph.w[bi][r][hits].min()
    return out


def _ell_relax(d, bands, srcs_t, ws_t, overloaded) -> torch.Tensor:
    """One masked relaxation over the class bands, [S, n_pad] -> a new
    [S, n_pad]: each band writes its column slice of the output in place;
    the padding columns past the last band are copied through unchanged.
    Edges originating at overloaded nodes never extend paths."""
    out = torch.empty_like(d)
    pos = 0
    for band, s_b, w_b in zip(bands, srcs_t, ws_t):
        if band.start != pos:
            raise ValueError(f"band {band} does not start at column {pos}")
        ell_band_relax(d, s_b, w_b, overloaded, pos, out=out)
        pos += band.rows
    out[:, pos:] = d[:, pos:]
    return out


def _ell_view_batch(srcs_t, ws_t, overloaded, srcs, w_sv, bands, n):
    """Batched {src} + neighbours distances + packed first hops over the
    sliced-ELL graph: the sparse mirror of ops.spf._spf_view_batch.
    w_sv: [B] host-computed direct metric source -> batch node."""
    b = srcs.shape[0]
    dev = overloaded.device
    unit = torch.full((b, n), INF, dtype=torch.int32, device=dev)
    unit.scatter_(1, srcs.long()[:, None], 0)
    # init rows: one UNMASKED relax (overloaded sources still originate)
    d = _ell_relax(unit, bands, srcs_t, ws_t, torch.zeros_like(overloaded))
    d, _ = relax_loop.fixed_point(
        lambda x: _ell_relax(x, bands, srcs_t, ws_t, overloaded), d, n
    )
    fh = _first_hops_from_rows(d, srcs, w_sv, overloaded)
    return torch.cat([d, fh.to(torch.int32)], dim=0)


def _batch_host_args(graph: EllGraph, srcs) -> Tuple[np.ndarray, np.ndarray]:
    """A source batch as int32 ids and the host-computed direct metric
    source -> each batch node (INF where not adjacent)."""
    srcs = np.asarray(srcs, dtype=np.int32)
    w_sv = direct_metrics(graph, int(srcs[0]), srcs)
    # the source itself is never its own neighbour
    w_sv[srcs == srcs[0]] = INF
    return srcs, w_sv


def _batch_args(graph: EllGraph, srcs, device):
    srcs, w_sv = _batch_host_args(graph, srcs)
    return (
        torch.from_numpy(srcs).to(device),
        torch.from_numpy(w_sv).to(device),
    )


def ell_view_batch_packed(graph: EllGraph, srcs, device: torch.device) -> torch.Tensor:
    """Distances + first hops [2B, n_pad] int32 (packed, one transfer)
    for a padded source batch over the sliced-ELL graph, solved on
    ``device`` from the graph's host bands."""
    srcs_dev, w_sv = _batch_args(graph, srcs, device)
    impl = _ell_impl_for(graph.n_pad, max(b.k for b in graph.bands), device)
    with autotune.using("ell_relax", impl):
        return _ell_view_batch(
            tuple(torch.from_numpy(s).to(device) for s in graph.src),
            tuple(torch.from_numpy(w).to(device) for w in graph.w),
            torch.from_numpy(graph.overloaded).to(device),
            srcs_dev, w_sv, graph.bands, graph.n_pad,
        )


def ell_source_batch(graph: EllGraph, ls, src_name: str) -> List[int]:
    """The hot-path source batch over an ELL graph: [src] + sorted
    unique up-neighbour ids, padded by repeating src to a power-of-two
    bucket (>= 8, capped at n_pad)."""
    sid = graph.node_index[src_name]
    nbrs = sorted(
        {
            graph.node_index[link.other_node(src_name)]
            for link in ls.links_from_node(src_name)
            if link.is_up() and link.other_node(src_name) in graph.node_index
        }
    )
    srcs = [sid] + nbrs
    bucket = 8
    while bucket < len(srcs):
        bucket *= 2
    bucket = min(bucket, graph.n_pad)
    return srcs + [sid] * (bucket - len(srcs))


def _ell_relax_masked(d, bands, srcs_t, ws_t, masks_t, overloaded) -> torch.Tensor:
    """One relaxation with a per-batch-row edge mask, [B, n_pad] -> a new
    [B, n_pad]: ``masks_t[bi]`` is the band's packed edge mask
    ([B, ceil(rows * k / 32)] int32 words, ``ell_relax.pack_edge_mask``),
    its bit set where that edge is excluded for that batch row (the KSP2
    edge-disjoint second-path graphs). Each band writes its column slice
    of the output in place, like ``_ell_relax``."""
    out = torch.empty_like(d)
    pos = 0
    for band, s_b, w_b, m_b in zip(bands, srcs_t, ws_t, masks_t):
        if band.start != pos:
            raise ValueError(f"band {band} does not start at column {pos}")
        ell_band_relax_masked(d, s_b, w_b, m_b, overloaded, pos, out=out)
        pos += band.rows
    out[:, pos:] = d[:, pos:]
    return out


def _ell_masked_fixed_point(srcs_t, ws_t, masks_t, overloaded, src_id, bands, n,
                            budget=None):
    """``(distances [B, n], hops)`` from ``src_id`` over B differently
    masked graphs (reference semantics: LinkState.cpp:763 getKthPaths'
    runSpf with linksToIgnore, one graph per destination). The init is
    one relax with no overload mask, so an overloaded source still
    originates; then one relax per hop until a hop changes nothing or
    after ``n`` hops (``relax_loop.fixed_point``: one host sync a chunk).
    With a hop ``budget`` no host sync at all: ``budget`` hops, and
    ``hops`` is the device status ``[hops, converged]`` (``_status``)."""
    b = masks_t[0].shape[0]
    unit = torch.full((b, n), INF, dtype=torch.int32, device=overloaded.device)
    unit[:, src_id] = 0
    d = _ell_relax_masked(
        unit, bands, srcs_t, ws_t, masks_t, torch.zeros_like(overloaded)
    )

    def step(x):
        return _ell_relax_masked(x, bands, srcs_t, ws_t, masks_t, overloaded)

    if budget is None:
        return relax_loop.fixed_point(step, d, n)
    d, changed = relax_loop.run_hops(step, d, budget)
    return d, _status(changed, budget, n)


def build_edge_masks(graph: EllGraph, exclusion_sets, parallel_pairs=None):
    """Per-band packed edge masks from per-batch-row link sets, and
    ``ok [B]``. A band's mask is [B, ceil(rows * k / 32)] int32 words (the
    layout of ``ell_relax.pack_edge_mask``; ``unpack_edge_mask`` gives
    the [B, rows, k] bool mask of the JAX package): the bit of (row r,
    slot) of batch row x is set where that edge is excluded. On a
    per-link-slot graph (``compile_ell`` direction "in") every link,
    parallel group members included, maps to its own slot through
    ``graph.slot_of``, so ``ok[b]`` is False only when an
    exclusion names a node outside the graph (reference semantics:
    LinkState.cpp:763 getKthPaths' linksToIgnore treats each Link as
    first-class, LinkState.h:82). A link that is not in the bands (down
    since the compile) masks nothing.

    Collapsed graphs (no ``slot_of``) mask the first slot from the link's
    other end; members of ``parallel_pairs`` cannot be told apart there
    and flag ok=False."""
    b = len(exclusion_sets)
    parallel_pairs = parallel_pairs or set()
    # (batch row, bit) of each excluded slot, per band; set in bulk below
    hits_of = [([], []) for _ in graph.bands]

    def exclude(bi: int, x: int, r: int, slot: int) -> None:
        hits_of[bi][0].append(x)
        hits_of[bi][1].append(r * graph.bands[bi].k + slot)

    ok = np.ones(b, dtype=bool)
    per_link = graph.slot_of is not None
    for x, links in enumerate(exclusion_sets):
        for link in links:
            if not per_link and frozenset((link.n1, link.n2)) in parallel_pairs:
                ok[x] = False
                break
            key = link_key(link) if per_link else None
            for head in (link.n1, link.n2):
                tail = link.other_node(head)
                hid = graph.node_index.get(head)
                tid = graph.node_index.get(tail)
                if hid is None or tid is None:
                    ok[x] = False
                    break
                if per_link:
                    hit = graph.slot_of.get(hid, _EMPTY_SLOTS).get(key)
                    if hit is not None:
                        bi, r, slot = hit
                        exclude(bi, x, r, slot)
                    continue
                bi, band = _band_of(graph, hid)
                r = hid - band.start
                hits = np.flatnonzero(graph.src[bi][r] == tid)
                if len(hits):
                    exclude(bi, x, r, int(hits[0]))
            if not ok[x]:
                break
    masks = []
    for band, (xs, bits) in zip(graph.bands, hits_of):
        words = np.zeros((b, mask_words(band.rows, band.k)), dtype=np.uint32)
        bits = np.asarray(bits, dtype=np.int64)
        np.bitwise_or.at(words, (np.asarray(xs, dtype=np.int64), bits >> 5),
                         np.left_shift(np.uint32(1), (bits & 31).astype(np.uint32)))
        masks.append(words.view(np.int32))
    return masks, ok


def ell_masked_distances(
    graph: EllGraph, src_id: int, masks, device: DeviceLike = None
) -> np.ndarray:
    """The batched masked solve from ``src_id`` on ``device`` (None =
    CUDA): host [B, n_pad] int32, one row per mask batch row. ``masks``
    are ``build_edge_masks``' packed int32 words, uploaded as they are.
    The bands and the masks are uploaded once per call; the masks are the
    bulk of it ([B, slots / 8] bytes)."""
    dev = resolve_device(device)
    (d,), _ = _budgeted_dispatch(
        "ksp2_masked_host", _ell_masked_fixed_point,
        (
            tuple(torch.from_numpy(s).to(dev) for s in graph.src),
            tuple(torch.from_numpy(w).to(dev) for w in graph.w),
            tuple(torch.from_numpy(m).to(dev) for m in masks),
            torch.from_numpy(graph.overloaded).to(dev),
            int(src_id),
        ),
        dict(bands=graph.bands, n=graph.n_pad), graph.n_pad,
    )
    return da.reap_read(d)


# -- resident incremental state ----------------------------------------------


def _warm_seed(d_prev, inc_tail, inc_head, inc_w, d0) -> torch.Tensor:
    """Seed the fixed point from the previous distance rows, resetting
    only the rows in the increase-affected cone.

    The masked min-relax closure of any seed S with d* <= S <= d0 is d*.
    A previous row d_prev[s] is >= the new d*[s] unless an increased
    edge lay on an old shortest path from s, which is exactly when it
    was tight under the old distances: d_prev[s, head] == d_prev[s,
    tail] + w_old. Tight rows restart from the cold init d0; the others
    seed min(d_prev, d0). int32 min-relaxation has a unique fixed point,
    so the warm solve equals a cold one bit for bit.

    ``d_prev``/``d0`` are ``[S, n]`` with increases ``[E]``, or carry a
    leading world axis, ``[B, S, n]`` with ``[B, E]`` (the tenant plane's
    batched solve: each world's rows against its own increases)."""
    lead = d_prev.shape[:-1]
    e = inc_tail.shape[-1]
    at_tail = torch.gather(d_prev, -1, inc_tail.long().unsqueeze(-2).expand(*lead, e))
    at_head = torch.gather(d_prev, -1, inc_head.long().unsqueeze(-2).expand(*lead, e))
    w_inc = inc_w.unsqueeze(-2)
    tight = (torch.clamp_max(at_tail + w_inc, INF) == at_head) & (w_inc < INF)
    reset = tight.any(dim=-1)
    return torch.where(reset[..., None], d0, torch.minimum(d_prev, d0))


def _device_direct_metrics(srcs_t, ws_t, srcs, bands) -> torch.Tensor:
    """On-device direct min-metric srcs[0] -> each batch node (INF when
    not adjacent, and for the source itself): the resident-band mirror
    of the host ``direct_metrics`` + ``_batch_args``."""
    src_id = srcs[0]
    cols = [
        torch.where(s_b == src_id, w_b, INF).amin(dim=1)
        for _, s_b, w_b in zip(bands, srcs_t, ws_t)
    ]
    w_sv = torch.cat(cols)[srcs.long()]
    return torch.where(srcs == src_id, INF, w_sv).to(torch.int32)


def _scatter_rows(srcs_t, ws_t, patch_ids_t, patch_src_t, patch_w_t) -> None:
    """Write the patched band rows into the band tensors in place."""
    for s, w, ids, ps, pw in zip(srcs_t, ws_t, patch_ids_t, patch_src_t, patch_w_t):
        if ids is not None:
            idx = ids.long()
            s.index_copy_(0, idx, ps)
            w.index_copy_(0, idx, pw)


def _ell_reconverge(srcs_t, ws_t, patch_ids_t, patch_src_t, patch_w_t,
                    inc_tail, inc_head, inc_w, overloaded, d_prev, srcs, bands, n,
                    chunk=relax_loop.HOP_CHUNK):
    """The fused churn step: scatter the patched rows into the resident
    bands, derive the direct metrics on the device, warm-seed the fixed
    point from ``d_prev`` (resetting only the increase cone), relax
    through ``ell_band_relax`` until a hop changes nothing (one host
    sync a ``chunk`` of hops), and pack distances + first hops. Returns ``(packed
    [2B, n], d [B, n], hops)``."""
    _scatter_rows(srcs_t, ws_t, patch_ids_t, patch_src_t, patch_w_t)
    w_sv = _device_direct_metrics(srcs_t, ws_t, srcs, bands)
    b = srcs.shape[0]
    unit = torch.full((b, n), INF, dtype=torch.int32, device=overloaded.device)
    unit.scatter_(1, srcs.long()[:, None], 0)
    # init rows: one UNMASKED relax (overloaded sources still originate)
    d0 = _ell_relax(unit, bands, srcs_t, ws_t, torch.zeros_like(overloaded))
    d = _warm_seed(d_prev, inc_tail, inc_head, inc_w, d0)
    d, hops = relax_loop.fixed_point(
        lambda x: _ell_relax(x, bands, srcs_t, ws_t, overloaded), d, n, chunk
    )
    fh = _first_hops_from_rows(d, srcs, w_sv, overloaded)
    return torch.cat([d, fh.to(torch.int32)], dim=0), d, hops


def band_patch_inputs(resident_src, resident_w, patched: EllGraph, stager: UploadStager,
                      extra: Sequence[Tuple[str, np.ndarray]] = ()):
    """The band patch discipline of every resident-band consumer
    (``EllState.apply_patch`` and ``.reconverge``): per band, the changed
    rows to scatter or, for a WIDENED band (its shape changed), the
    whole band re-uploaded with nothing to scatter. Everything, and the
    ``extra`` host arrays, crosses in one staged copy. Returns ``(in_src,
    in_w, patch_ids, patch_src, patch_w, extra_t)``: the bands to solve
    over (resident tensors, or the re-uploaded ones), the scatter
    triples (None for a band with nothing to scatter) and the extra
    arrays on the device."""
    changed: Dict[int, np.ndarray] = patched.changed or {}
    widened = patched.widened or frozenset()
    items: List[Tuple[str, np.ndarray]] = []
    spots: List[Tuple[bool, int]] = []  # (whole band?, band index)
    for bi in range(len(patched.bands)):
        rows = changed.get(bi)
        if bi in widened:
            spots.append((True, bi))
            items += [("bands", patched.src[bi]), ("bands", patched.w[bi])]
        elif rows is not None and len(rows):
            rows = np.asarray(rows, dtype=np.int32)
            spots.append((False, bi))
            items += [("patch", rows), ("patch", patched.src[bi][rows]),
                      ("patch", patched.w[bi][rows])]
    tensors = iter(stager.upload(items + list(extra)))
    in_src, in_w = list(resident_src), list(resident_w)
    nb = len(patched.bands)
    ids, p_src, p_w = [None] * nb, [None] * nb, [None] * nb
    for whole, bi in spots:
        if whole:
            in_src[bi], in_w[bi] = next(tensors), next(tensors)
        else:
            ids[bi], p_src[bi], p_w[bi] = next(tensors), next(tensors), next(tensors)
    return tuple(in_src), tuple(in_w), tuple(ids), tuple(p_src), tuple(p_w), list(tensors)


class TornStateError(RuntimeError):
    """A resident ``EllState`` whose earlier scatter or solve failed."""


class EllState:
    """Resident band tensors of one graph for the churn loop.

    The bands and the overload mask live on ``device`` (None = CUDA);
    the overload mask is re-uploaded only when it changes. Host-to-device
    copies go through ``stager`` (one pinned buffer, shared with the
    other states of one solver).

    Warm start: the previous solve's distance rows, the source batch
    they belong to, and a MERGEABLE journal of every un-solved patch's
    edge changes, ``(tail, head) -> (w_snapshot, w_current)``: the
    snapshot is the collapsed weight the resident distances were solved
    under (first touch wins), the current side tracks the latest patch.
    The increase delta is emitted against the snapshots at solve time,
    so stacked patches coalesce into one warm solve. Overload flips stay
    warm too: a flipped node's out-edges are journaled at their raw
    weights and the emission compares effective weights (INF where the
    tail was or is masked), so a drain reads as an increase and an
    undrain as a decrease.

    The patched rows are scattered into the resident tensors in place,
    and ``graph`` moves to the patched graph only after the solve
    returns. A solve or scatter that raises leaves the state ``torn``:
    its tensors may be ahead of ``graph``, and every later call raises.
    ``reconverge_ms`` and ``host_overhead_ms`` split the last
    ``reconverge`` by the host clock (the whole call, and the part
    before the relax loop); ``last_hops`` and ``last_warm`` describe its
    solve."""

    def __init__(self, graph: EllGraph, device: DeviceLike = None,
                 stager: Optional[UploadStager] = None):
        self.device = resolve_device(device)
        self.stager = stager if stager is not None else UploadStager(self.device)
        self.graph = graph
        nb = len(graph.bands)
        tensors = self.stager.upload(
            [("bands", a) for a in graph.src] + [("bands", a) for a in graph.w]
            + [("overloaded", graph.overloaded)]
        )
        self.src = tuple(tensors[:nb])
        self.w = tuple(tensors[nb : 2 * nb])
        self.overloaded = tensors[-1].ne(0)
        self._d_dev: Optional[torch.Tensor] = None
        self._warm_key: Optional[Tuple[int, ...]] = None
        self._pending_edges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._ov_solved = np.array(graph.overloaded, copy=True)
        self._pending_structural = False
        self.torn = False
        self.reconverge_ms = 0.0
        self.host_overhead_ms = 0.0
        self.last_hops = 0
        self.last_warm: Optional[bool] = None

    def _check_whole(self) -> None:
        if self.torn:
            raise TornStateError("EllState: a previous scatter or solve failed; "
                                 "the resident bands are torn")

    def _note_patch(self, patched: EllGraph, ov_changed: bool) -> None:
        """Fold one patch's delta into the warm-start journal. An edge
        already journaled keeps its snapshot and only advances its
        current side. Overload flips journal every out-edge of a flipped
        node, read from the pre-patch graph, at its raw weight; link
        up/down reads as a w <-> INF change through
        ``band_row_edge_changes``."""
        if patched.changed:
            ELL_COUNTERS["ell_incremental_syncs"] += 1
        if patched.widened:
            ELL_COUNTERS["ell_widen_events"] += len(patched.widened)
        if self._d_dev is None:
            return
        if ov_changed:
            self._pending_structural = True
            flipped = np.nonzero(self.graph.overloaded != patched.overloaded)[0]
            collapsed: Dict[Tuple[int, int], int] = {}
            pos = 0
            for src_h, w_h in zip(self.graph.src, self.graph.w):
                hit = np.isin(src_h, flipped) & (w_h < INF)
                for r, sl in zip(*np.nonzero(hit)):
                    key = (int(src_h[r, sl]), pos + int(r))
                    wv = int(w_h[r, sl])
                    if wv < collapsed.get(key, INF):
                        collapsed[key] = wv
                pos += src_h.shape[0]
            for key, wv in collapsed.items():
                self._pending_edges.setdefault(key, (wv, wv))
        if not patched.changed:
            return  # mask-only or no-op sync: the raw journal stands
        if self._pending_edges:
            ELL_COUNTERS["ell_patch_merges"] += 1
        structural = False
        for s, h, wo, wn in band_row_edge_changes(self.graph, patched):
            snap, _cur = self._pending_edges.get((s, h), (wo, wo))
            self._pending_edges[(s, h)] = (snap, wn)
            structural = structural or wo >= INF or wn >= INF
        if structural:
            self._pending_structural = True

    def _emit_increases(self, ov_now: np.ndarray) -> List[Tuple[int, int, int]]:
        """The journal's increase delta, effective-weight aware: an entry
        is emitted when its raw weight rose (the origination row: an
        overloaded source still uses its own out-edges) or its masked
        weight rose (transit rows across a drain). The emitted weight is
        the raw snapshot, which every tight step of d_prev used."""
        inc = []
        for (s, h), (snap, cur) in self._pending_edges.items():
            if snap >= INF:
                continue  # unusable at solve time: cannot be tight
            snap_eff = INF if self._ov_solved[s] else snap
            cur_eff = INF if ov_now[s] else cur
            if cur > snap or cur_eff > snap_eff:
                inc.append((s, h, snap))
        return inc

    def apply_patch(self, patched: EllGraph) -> None:
        """Scatter a patched graph's changed rows into the resident bands
        without solving (for consumers that need synced bands only: the
        KSP2 masked batches). A widened band is re-uploaded whole. The
        delta is journaled, so a later ``reconverge`` stays warm."""
        self._check_whole()
        ov_changed = not np.array_equal(self.graph.overloaded, patched.overloaded)
        self._note_patch(patched, ov_changed)
        extra = [("overloaded", patched.overloaded)] if ov_changed else []
        self.torn = True
        in_src, in_w, ids, p_src, p_w, ext = band_patch_inputs(
            self.src, self.w, patched, self.stager, extra
        )
        _scatter_rows(in_src, in_w, ids, p_src, p_w)
        self.src, self.w = in_src, in_w
        if ov_changed:
            self.overloaded = ext[0].ne(0)
        self.graph = replace(patched, changed=None)
        self.torn = False

    def reconverge(self, patched: EllGraph, srcs) -> torch.Tensor:
        """The fused churn step: scatter the patched rows into the
        resident bands and solve the batched view warm-started from the
        previous solve's distances (bit-identical to cold; see
        ``_warm_seed``). Patch rows, increase edges and the source batch
        cross in one staged copy. Returns the packed ``[2B, n_pad]``
        distances + first hops on the device."""
        self._check_whole()
        t0 = time.perf_counter()
        ov_changed = not np.array_equal(self.graph.overloaded, patched.overloaded)
        self._note_patch(patched, ov_changed)
        srcs_key = tuple(int(s) for s in srcs)
        b = len(srcs_key)
        warm = self._d_dev is not None and self._warm_key == srcs_key
        if warm:
            # increases against the snapshot weights the resident
            # distances were solved under; effective-weight aware, so
            # drains and link removals ride the same warm seed
            inc = self._emit_increases(patched.overloaded)
            d_prev = self._d_dev
            ELL_COUNTERS["ell_warm_solves"] += 1
            if self._pending_structural:
                ELL_COUNTERS["ell_structural_warm_solves"] += 1
        else:
            inc = [_FORCE_RESET_EDGE]
            d_prev = (
                self._d_dev
                if self._d_dev is not None and tuple(self._d_dev.shape) == (b, patched.n_pad)
                else None
            )
            ELL_COUNTERS["ell_cold_solves"] += 1
        inc_t, inc_h, inc_w = pad_increase_edges(inc)
        extra = [("view", inc_t), ("view", inc_h), ("view", inc_w),
                 ("view", np.asarray(srcs, dtype=np.int32))]
        if ov_changed:
            extra.append(("overloaded", patched.overloaded))
        self.torn = True
        in_src, in_w, ids, p_src, p_w, ext = band_patch_inputs(
            self.src, self.w, patched, self.stager, extra
        )
        overloaded = ext[4].ne(0) if ov_changed else self.overloaded
        if d_prev is None:
            d_prev = torch.zeros((b, patched.n_pad), dtype=torch.int32, device=self.device)
        t_solve = time.perf_counter()
        impl = _ell_impl_for(patched.n_pad, max(b.k for b in patched.bands), self.device)
        with autotune.using("ell_relax", impl):
            # a warm solve reads its flag after as many hops as the last
            # one took; a cold one after the default chunk
            packed, d, hops = _ell_reconverge(
                in_src, in_w, ids, p_src, p_w, ext[0], ext[1], ext[2], overloaded,
                d_prev, ext[3], patched.bands, patched.n_pad,
                relax_loop.chunk_for(self.last_hops if warm else 0),
            )
        t_end = time.perf_counter()
        self.src, self.w, self.overloaded = in_src, in_w, overloaded
        self._d_dev = d
        self._warm_key = srcs_key
        self._pending_edges = {}
        self._ov_solved = np.array(patched.overloaded, copy=True)
        self._pending_structural = False
        self.graph = replace(patched, changed=None)
        self.torn = False
        self.reconverge_ms = (t_end - t0) * 1e3
        self.host_overhead_ms = (t_solve - t0) * 1e3
        self.last_hops = hops
        self.last_warm = warm
        return packed


def ell_reconverge_step(state: EllState, patched: EllGraph, srcs) -> torch.Tensor:
    """``state.reconverge(patched, srcs)``."""
    return state.reconverge(patched, srcs)


def ell_masked_distances_resident(state: EllState, src_id: int, masks) -> Readback:
    """The batched masked solve from ``src_id`` over an ``EllState``'s
    resident bands and overload mask: [B, n_pad] int32 rows, one a mask
    batch row, returned as their ``Readback`` into pinned host memory, in
    flight (``tensor`` the device rows; ``reap()`` the host array).
    ``masks`` are ``build_edge_masks``' packed words, crossing to the
    device through the state's stager, or tensors already there."""
    state._check_whole()
    if not isinstance(masks[0], torch.Tensor):
        masks = state.stager.upload([("masks", m) for m in masks])
    (d,), _ = _budgeted_dispatch(
        "ksp2_masked_resident", _ell_masked_fixed_point,
        (state.src, state.w, tuple(masks), state.overloaded, int(src_id)),
        dict(bands=state.graph.bands, n=state.graph.n_pad), state.graph.n_pad,
    )
    return Readback(d)


# -- all-sources solve and the KSP2 engine's fused dispatches ----------------


def _ell_fixed_point(srcs_t, ws_t, overloaded, src_ids, bands, n, warm=None,
                     budget=None):
    """``(distances [S, n], hops)`` from a batch of sources over the class
    bands. The init is one relax with no overload mask, so an overloaded
    source still originates; ``warm`` = (d_prev, inc_tail, inc_head,
    inc_w) seeds it from the previous rows through ``_warm_seed`` (the
    same fixed point, fewer hops under churn). Then one relax per hop
    until a hop changes nothing or after ``n`` hops, one host sync a
    chunk of hops; with a hop ``budget``, ``budget`` hops and the device
    status for ``hops``, as in ``_ell_masked_fixed_point``."""
    s = src_ids.shape[0]
    dev = overloaded.device
    unit = torch.full((s, n), INF, dtype=torch.int32, device=dev)
    # a scatter of the scalar: an index_put of 0 would copy a host
    # scalar to the card, which a graph capture refuses
    unit.scatter_(1, src_ids.long()[:, None], 0)
    d = _ell_relax(unit, bands, srcs_t, ws_t, torch.zeros_like(overloaded))
    del unit
    if warm is not None:
        d = _warm_seed(*warm, d)

    def step(x):
        return _ell_relax(x, bands, srcs_t, ws_t, overloaded)

    if budget is None:
        return relax_loop.fixed_point(step, d, n)
    d, changed = relax_loop.run_hops(step, d, budget)
    return d, _status(changed, budget, n)


def ell_distances_from_sources(graph: EllGraph, src_ids, state: Optional[EllState] = None,
                               device: DeviceLike = None) -> torch.Tensor:
    """Distances [S, n_pad] on the device from a batch of sources over
    the ELL graph: over ``state``'s resident bands when one is passed (no
    band upload), else over ``graph``'s bands uploaded to ``device``
    (None = CUDA)."""
    if state is not None:
        state._check_whole()
        srcs_t, ws_t, ov = state.src, state.w, state.overloaded
    else:
        dev = resolve_device(device)
        srcs_t = tuple(torch.from_numpy(s).to(dev) for s in graph.src)
        ws_t = tuple(torch.from_numpy(w).to(dev) for w in graph.w)
        ov = torch.from_numpy(graph.overloaded).to(dev)
    impl = _ell_impl_for(graph.n_pad, max(b.k for b in graph.bands), ov.device)
    with autotune.using("ell_relax", impl):
        d, _ = _ell_fixed_point(srcs_t, ws_t, ov, _as_device_ids(src_ids, ov.device),
                                graph.bands, graph.n_pad)
    return d


def _ell_all_view_rows(srcs_t, ws_t, overloaded, view_srcs, w_sv, ep_ids, d_prev,
                       inc_tail, inc_head, inc_w, bands, n, budget=None):
    """The incremental KSP2 engine's fused step: all-sources distances D
    [n, n] over the bands, warm-seeded from ``d_prev`` (the previous
    step's D) with the increase-edge delta; the root's batched view
    (distances + first hops, the algebra of ``_ell_view_batch``) taken
    from D's rows instead of a second fixed point; and the rows of the
    invalidation endpoints from D and from ``d_prev``. Returns ``(D,
    packed, hops)``, ``packed`` = [view d | view first hops | new
    endpoint rows | old endpoint rows]: one readback. With a hop
    ``budget``, ``hops`` is the device status (``_ell_fixed_point``)."""
    arange = torch.arange(n, dtype=torch.int32, device=overloaded.device)
    d_all, hops = _ell_fixed_point(srcs_t, ws_t, overloaded, arange, bands, n,
                                   warm=(d_prev, inc_tail, inc_head, inc_w),
                                   budget=budget)
    d = d_all[view_srcs.long()]
    fh = _first_hops_from_rows(d, view_srcs, w_sv, overloaded)
    ep = ep_ids.long()
    packed = torch.cat([d, fh.to(torch.int32), d_all[ep], d_prev[ep]], dim=0)
    return d_all, packed, hops


def _changed_row_meta(row_changed, n: int, k_budget: int):
    """The on-device row diff's meta row [n] int32: the first
    ``k_budget`` changed row ids in ascending order, padded with -1, then
    their count at ``k_budget`` and -1 after it; and the ids. A cumsum
    ranks the changed rows and a scatter compacts them, where a nonzero
    would sync with the host and take a data-dependent shape; ranks past
    the budget and unchanged rows land in a spare slot that is dropped."""
    b = row_changed.shape[0]
    dev = row_changed.device
    rank = torch.cumsum(row_changed.to(torch.int64), dim=0) - 1
    slot = torch.where(row_changed & (rank < k_budget), rank,
                       torch.full_like(rank, k_budget))
    ids = torch.full((k_budget + 1,), -1, dtype=torch.int64, device=dev)
    ids.scatter_(0, slot, torch.arange(b, dtype=torch.int64, device=dev))
    ids = ids[:k_budget]
    meta = torch.full((n,), -1, dtype=torch.int32, device=dev)
    meta[:k_budget] = ids.to(torch.int32)
    meta[k_budget] = row_changed.sum().to(torch.int32)
    return meta, ids


def _ell_all_view_rows_masked(srcs_t, ws_t, overloaded, view_srcs, w_sv, ep_ids, d_prev,
                              inc_tail, inc_head, inc_w, masks_t, dm_old, src_id, bands, n,
                              k_budget, budget=None):
    """``_ell_all_view_rows`` plus the speculative masked re-solve of
    every destination's second-path graph against the resident masks
    ``masks_t`` (one batch row a destination, cold: a previous masked row
    is no upper bound once the masks move), diffed on the device against
    ``dm_old``, so the readback carries only the rows that moved. Returns
    ``(D, dm_new, packed, hops)``, ``packed`` = ``_ell_all_view_rows``'
    rows, then the meta row (``_changed_row_meta``), then the changed
    rows (the first ``k_budget``; padding ids gather row 0). With a hop
    ``budget``, ``hops`` is both fixed points' device status, all-sources
    first."""
    d_all, packed, hops = _ell_all_view_rows(
        srcs_t, ws_t, overloaded, view_srcs, w_sv, ep_ids, d_prev,
        inc_tail, inc_head, inc_w, bands, n, budget=budget,
    )
    dm_new, m_hops = _ell_masked_fixed_point(srcs_t, ws_t, masks_t, overloaded, src_id,
                                             bands, n, budget=budget)
    if budget is not None:
        hops = torch.cat([hops, m_hops])
    b = dm_new.shape[0]
    meta, ids = _changed_row_meta((dm_new != dm_old).any(dim=1), n, k_budget)
    changed_rows = dm_new[ids.clamp(0, b - 1)]
    packed = torch.cat([packed, meta[None, :], changed_rows], dim=0)
    return d_all, dm_new, packed, hops


def _inc_args(inc):
    """Host increase-edge triple for the warm-seeded dispatches:
    ``inc=None`` means cold (the reset sentinel flags every row); an
    increase list, even an empty one, starts warm."""
    return pad_increase_edges([_FORCE_RESET_EDGE] if inc is None else list(inc))


def _engine_inputs(state: EllState, view_srcs, w_sv, ep_ids, inc):
    """The fused dispatches' small host inputs in one staged copy."""
    inc_t, inc_h, inc_w = _inc_args(inc)
    return state.stager.upload([
        ("view", np.asarray(view_srcs, dtype=np.int32)),
        ("view", np.asarray(w_sv, dtype=np.int32)),
        ("view", np.asarray(ep_ids, dtype=np.int32)),
        ("view", inc_t), ("view", inc_h), ("view", inc_w),
    ])


def ell_all_view_rows(state: EllState, view_srcs, w_sv, ep_ids, d_prev, inc=None):
    """The fused all-sources + view + endpoint-rows step over ``state``'s
    resident bands. ``view_srcs``, ``w_sv`` and ``ep_ids`` are host
    arrays; ``inc`` is the increase-edge delta [(tail, head, old w)]
    (None: cold). ``d_prev`` is not changed: the caller rebinds its
    resident matrix to the returned D. Returns ``(D, packed, hops)``,
    ``packed`` as its ``Readback`` in flight."""
    state._check_whole()
    srcs_t, w_t, ep_t, inc_t, inc_h, inc_w = _engine_inputs(state, view_srcs, w_sv, ep_ids, inc)
    (d_all, packed), hops = _budgeted_dispatch(
        "ksp2_view_rows", _ell_all_view_rows,
        (state.src, state.w, state.overloaded, srcs_t, w_t, ep_t, d_prev,
         inc_t, inc_h, inc_w),
        dict(bands=state.graph.bands, n=state.graph.n_pad), state.graph.n_pad,
    )
    return d_all, Readback(packed), hops


def ell_all_view_rows_masked(state: EllState, view_srcs, w_sv, ep_ids, d_prev, masks_t,
                             dm_old, src_id: int, k_budget: int, inc=None):
    """``ell_all_view_rows`` plus the speculative masked re-solve against
    the resident ``masks_t`` and its on-device row diff against
    ``dm_old``. Neither ``d_prev`` nor ``dm_old`` is changed. Returns
    ``(D, dm_new, packed, hops)``, ``packed`` as in
    ``ell_all_view_rows``."""
    state._check_whole()
    srcs_t, w_t, ep_t, inc_t, inc_h, inc_w = _engine_inputs(state, view_srcs, w_sv, ep_ids, inc)
    (d_all, dm_new, packed), hops = _budgeted_dispatch(
        "ksp2_view_rows_masked", _ell_all_view_rows_masked,
        (state.src, state.w, state.overloaded, srcs_t, w_t, ep_t, d_prev,
         inc_t, inc_h, inc_w, tuple(masks_t), dm_old, int(src_id)),
        dict(bands=state.graph.bands, n=state.graph.n_pad, k_budget=k_budget),
        state.graph.n_pad,
    )
    return d_all, dm_new, Readback(packed), hops


# -- the tenant plane's uniform blocks ----------------------------------------
#
# A banded EllGraph's shape is a band tuple, so a [B, ...] dispatch over
# banded tensors would be keyed per tenant set. The tenant plane
# (ops.world_batch) therefore packs each tenant into a UNIFORM
# [n_slot, k_slot] ELL block: every row padded to one shared slot width,
# the node axis padded to one shared count, so a whole shape bucket of
# tenants runs one [B, n_slot, k_slot] body whichever tenants occupy it.
# The padding is inert by construction (self-loop src ids with w = INF,
# the trick the banded layout uses inside a slot class), so the
# per-tenant result is bit-identical to the banded single-graph solve:
# the int32 min-relaxation has a unique fixed point and the uniform relax
# computes the same monotone map, with more (INF) slots.


def ell_pack_uniform(
    graph: EllGraph, n_slot: int, k_slot: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a sliced-ELL graph into one uniform [n_slot, k_slot]
    block: (src, w, overloaded). Rows keep their banded ids (node
    numbering is unchanged); slots past a row's band k and rows past
    n_pad are self-loop/INF padding, inert in every relax."""
    assert n_slot >= graph.n_pad, (n_slot, graph.n_pad)
    assert k_slot >= max(b.k for b in graph.bands), k_slot
    src = np.tile(np.arange(n_slot, dtype=np.int32)[:, None], (1, k_slot))
    w = np.full((n_slot, k_slot), INF, dtype=np.int32)
    for band, s_b, w_b in zip(graph.bands, graph.src, graph.w):
        src[band.start : band.start + band.rows, : band.k] = s_b
        w[band.start : band.start + band.rows, : band.k] = w_b
    overloaded = np.zeros(n_slot, dtype=bool)
    overloaded[: len(graph.overloaded)] = graph.overloaded
    return src, w, overloaded


def ell_uniform_rows(graph: EllGraph, ids, k_slot: int) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform-layout (src, w) rows for a set of global node ids: the
    O(rows x k) host prep for scattering a patch into a resident uniform
    block (ops.world_batch's analogue of band_patch_inputs)."""
    ids = np.asarray(ids, dtype=np.int32)
    src = np.tile(ids[:, None], (1, k_slot))
    w = np.full((len(ids), k_slot), INF, dtype=np.int32)
    for x, j in enumerate(ids):
        bi, band = _band_of(graph, int(j))
        r = int(j) - band.start
        src[x, : band.k] = graph.src[bi][r]
        w[x, : band.k] = graph.w[bi][r]
    return src, w


def _uniform_relax(d, src, w, overloaded, live) -> torch.Tensor:
    """One masked relaxation of B worlds over their uniform blocks:
    ``d [B, S, N]``, ``src``/``w [B, N, K]``, ``overloaded [B, N]``, the
    rows' live-slot counts ``live [B, N]`` (``ell_relax.live_slots``) ->
    ``[B, S, N]``, through ``ell_relax.ell_band_relax_worlds`` (one
    uniform band covering every row of each world, its padding past each
    row's live slots skipped; the reference runs ``ell_band_relax`` under
    ``vmap``). Edges originating at overloaded nodes never extend paths."""
    return ell_band_relax_worlds(d, src, w, overloaded, live)


def _uniform_direct(src, w, srcs) -> torch.Tensor:
    """On-device direct min-metric srcs[b, 0] -> each batch node of each
    world over its uniform block (INF when not adjacent, and for the
    source itself): the uniform twin of _device_direct_metrics, so the
    batched dispatch needs no host band reads. ``[B, S]``."""
    src_id = srcs[:, :1]  # [B, 1]
    direct = torch.where(src == src_id[:, :, None], w, INF).amin(dim=2)  # [B, N]
    w_sv = torch.gather(direct, 1, srcs.long())
    return torch.where(srcs == src_id, INF, w_sv).to(torch.int32)


def _scatter_rows_drop(block, rows, vals) -> torch.Tensor:
    """``block [B, N, K]`` with rows ``rows [B, P]`` replaced by ``vals
    [B, P, K]``, out of place; a row id >= N (the padding id ``N``) is
    dropped, as the reference's ``mode="drop"`` scatter does."""
    b, n, k = block.shape
    ext = torch.empty((b, n + 1, k), dtype=block.dtype, device=block.device)
    ext[:, :n] = block
    ext.scatter_(1, rows.long().clamp_max(n)[:, :, None].expand(-1, -1, k), vals)
    return ext[:, :n].contiguous()


def _tenant_view_solve(src, w, overloaded, srcs, p_rows, p_src, p_w,
                       inc_t, inc_h, inc_w, d_prev, budget=None):
    """The tenants' fused view solve over their uniform blocks, batched
    over the leading tenant axis B: scatter the pending patch rows into
    each resident block (``p_rows [B, P]`` carries global row ids padded
    with the out-of-bounds id ``N``, dropped, so padding and idle tenants
    cost nothing), derive the direct metrics on the device, warm-seed the
    fixed point from ``d_prev [B, S, N]`` (``_warm_seed``: reset only the
    increase cone; cold tenants pass the ``_FORCE_RESET_EDGE`` sentinel,
    so warm and cold share one body), iterate to the fixed point, pack
    distances + first hops. Returns ``(packed [B, 2S, N], d, src, w)``,
    the post-patch blocks too (the caller rebinds them as the new
    resident blocks).

    The fixed point runs until every tenant converges, at most ``N``
    hops, as the reference's ``while_loop`` under ``vmap`` does: hops past
    a tenant's own fixed point are identity (the min-relax is idempotent
    there), so a tenant's result never depends on which tenants share
    its bucket. Eagerly (``budget`` None) the changed count is read once
    a chunk of hops; with a hop ``budget`` (a captured body) no host sync:
    ``budget`` hops, and a device status ``[hops, converged]`` follows
    the outputs (``_status``)."""
    n = src.shape[1]
    src = _scatter_rows_drop(src, p_rows, p_src)
    w = _scatter_rows_drop(w, p_rows, p_w)
    w_sv = _uniform_direct(src, w, srcs)
    # every relax of the dispatch stops at each row's last live slot,
    # counted once here, after the patch
    live = live_slots(w)
    b, s = srcs.shape
    unit = torch.full((b, s, n), INF, dtype=torch.int32, device=src.device)
    unit.scatter_(2, srcs.long()[:, :, None], 0)
    # init rows: one UNMASKED relax (overloaded sources still originate)
    d0 = _uniform_relax(unit, src, w, torch.zeros_like(overloaded), live)
    seed = _warm_seed(d_prev, inc_t, inc_h, inc_w, d0)

    def step(x):
        return _uniform_relax(x, src, w, overloaded, live)

    if budget is None:
        d, _ = relax_loop.fixed_point(step, seed, n)
        status = None
    else:
        d, changed = relax_loop.run_hops(step, seed, budget)
        status = _status(changed, budget, n)
    fh = _first_hops_from_rows(d, srcs, w_sv, overloaded)
    packed = torch.cat([d, fh.to(torch.int32)], dim=1)
    if status is None:
        return packed, d, src, w
    return packed, d, src, w, status


def world_view_solve(src, w, overloaded, srcs, p_rows, p_src, p_w,
                     inc_t, inc_h, inc_w, d_prev):
    """The batch-lifted solve, eagerly: every argument carries a leading
    tenant axis ([B, n, k] blocks, [B, R] patch rows (+[B, R, k] values),
    [B, S] source batches, [B, E] increase deltas, [B, S, n] previous
    distances). Returns ``(packed, d, src, w)``. Inactive slots ride
    along as all-INF blocks that converge in zero hops. The production
    entry is ``route_engine.world_dispatch``, which fuses this with the
    tenant-id delta compaction into one body a shape bucket; this unfused
    form is for kernel-level tests."""
    return _tenant_view_solve(src, w, overloaded, srcs, p_rows, p_src, p_w,
                              inc_t, inc_h, inc_w, d_prev)
