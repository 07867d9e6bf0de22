"""Sliced-ELL shortest paths for large topologies (no dense matrix).

Port note: mirrors the cold view-solve subset of
``openr_tpu/ops/spf_sparse.py``: ``EllBand``/``EllGraph``, the per-link
in-edge slots, ``compile_ell`` (both directions: per-link in-edge bands
for the SPF views, per-neighbour out-edge bands for the route sweep of
``ops.route_sweep``), ``_as_device_ids``, ``direct_metrics``,
``_ell_relax``, ``_ell_view_batch``, ``_first_hops_from_rows``,
``ell_view_batch_packed`` and ``ell_source_batch``; and the KSP2
second-path solve: ``_ell_relax_masked``, ``_ell_masked_fixed_point``,
``build_edge_masks`` and the non-resident ``ell_masked_distances``, which
calls the fixed point directly (the reference's jitted entry
``_ell_masked_source_batch`` has no counterpart in eager PyTorch). Each
band of a relax step goes through ``ops.ell_relax.ell_band_relax`` (or
``ell_band_relax_masked``: the hand-written CUDA kernels on the card,
their plain torch versions on the CPU), writing into its column slice of
one output instead of concatenating band parts. The KSP2 edge masks are
built bit-packed on the host (32 slots an int32 word) where the JAX
package builds bool cells. The JAX
``lax.while_loop`` becomes a Python loop with one host sync per hop. Left out for later slices: the resident
incremental state (``EllState``, ``ell_patch``, ``_warm_seed``,
``_ell_reconverge``) and the solves that ride it
(``ell_masked_distances_resident``, ``ell_all_view_rows(_masked)``), the
all-sources solve, the flat edge-list graph, sharding and the
tenant-plane dispatch.

One relaxation step over the class bands costs S x (total slots) work:

    out[s, j] = min(d[s, j], min_slot d[s, src[j, slot]] + w_eff[j, slot])

with ``w_eff = INF`` for edges leaving an overloaded node. Nodes are
ordered by (degree class, name), so every lookup goes through
``EllGraph.node_index``.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops.ell_relax import ell_band_relax, ell_band_relax_masked, mask_words
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.ops.spf import _first_hops_from_rows

_NODE_PAD = 128
_ELL_SLOT_PAD = 8


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
    unit[torch.arange(b, device=dev), srcs.long()] = 0
    # init rows: one UNMASKED relax (overloaded sources still originate)
    d = _ell_relax(unit, bands, srcs_t, ws_t, torch.zeros_like(overloaded))
    for _ in range(n):
        nxt = _ell_relax(d, bands, srcs_t, ws_t, overloaded)
        changed = bool((nxt < d).any())
        d = nxt
        if not changed:
            break
    fh = _first_hops_from_rows(d, srcs, w_sv, overloaded)
    return torch.cat([d, fh.to(torch.int32)], dim=0)


def _batch_args(graph: EllGraph, srcs, device):
    srcs = np.asarray(srcs, dtype=np.int32)
    w_sv = direct_metrics(graph, int(srcs[0]), srcs)
    # the source itself is never its own neighbour
    w_sv[srcs == srcs[0]] = INF
    return (
        torch.from_numpy(srcs).to(device),
        torch.from_numpy(w_sv).to(device),
    )


def ell_view_batch_packed(graph: EllGraph, srcs, device: torch.device) -> torch.Tensor:
    """Distances + first hops [2B, n_pad] int32 (packed, one transfer)
    for a padded source batch over the sliced-ELL graph, solved on
    ``device`` from the graph's host bands."""
    srcs_dev, w_sv = _batch_args(graph, srcs, device)
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


def _ell_masked_fixed_point(srcs_t, ws_t, masks_t, overloaded, src_id, bands, n):
    """``(distances [B, n], hops)`` from ``src_id`` over B differently
    masked graphs (reference semantics: LinkState.cpp:763 getKthPaths'
    runSpf with linksToIgnore, one graph per destination). The init is
    one relax with no overload mask, so an overloaded source still
    originates; then one relax per hop until a hop changes nothing or
    after ``n`` hops, one host sync per hop."""
    b = masks_t[0].shape[0]
    unit = torch.full((b, n), INF, dtype=torch.int32, device=overloaded.device)
    unit[:, src_id] = 0
    d = _ell_relax_masked(
        unit, bands, srcs_t, ws_t, masks_t, torch.zeros_like(overloaded)
    )
    hops = 0
    while hops < n:
        nxt = _ell_relax_masked(d, bands, srcs_t, ws_t, masks_t, overloaded)
        hops += 1
        changed = bool((nxt < d).any())
        d = nxt
        if not changed:
            break
    return d, hops


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
    d, _ = _ell_masked_fixed_point(
        tuple(torch.from_numpy(s).to(dev) for s in graph.src),
        tuple(torch.from_numpy(w).to(dev) for w in graph.w),
        tuple(torch.from_numpy(m).to(dev) for m in masks),
        torch.from_numpy(graph.overloaded).to(dev),
        src_id, graph.bands, graph.n_pad,
    )
    return d.cpu().numpy()
