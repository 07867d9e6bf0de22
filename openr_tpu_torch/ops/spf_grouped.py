"""Block-bipartite grouped SPF: relaxation as per-group min-plus contractions.

Port note: mirrors the cold part of ``openr_tpu/ops/spf_grouped.py``:
``Segment``/``GridBand``/``GroupedGraph`` (with ``out_slots``),
``_signature_groups``, ``compile_grouped`` and ``compile_out_grouped``
(host numpy, copied), ``band_meta``/``device_tensors``, ``_contract``,
``_grouped_relax``, ``_grouped_fixed_point`` in both directions,
``GroupedState``/``grouped_distances_from_sources``, ``_grouped_nh_counts``,
``_grouped_route_block_body``, ``GroupedRouteSweeper`` and
``structure_report``. Every contraction goes through one of the two
hand-written kernels of ``ops.grouped_minplus`` (``batched_minplus`` or
``batched_minplus_t``, chosen by the ``impl`` argument; on the CPU their
plain torch versions). The reference's environment selector is here
(``set_grouped_impl``, ``OPENR_GROUPED_IMPL``): either kernel, or "auto",
the measured winner of one representative block (``ops/autotune.py``);
its ``jnp`` formulation has no counterpart, no torch-op formulation being
a choice on the card, so the reference's names "jnp" and "pallas" mean
``batched_minplus`` and "pallas_t" ``batched_minplus_t``. The churn
engine's pieces (``ops/route_engine.py``'s
grouped engine) are here too: the warm seed of ``_grouped_fixed_point``
(``init=``), ``_grouped_cone_expand`` (plain torch ops, walked over blocks
of destination rows as ``route_sweep._cone_expand`` is), ``slot_table``
and ``grouped_patch`` (host numpy, copied). The hop loops and the cone's
jumps keep their flags on the card (``ops/relax_loop.py``,
``route_sweep.expand_cone``). Not ported yet: the sharded sweeps.

In a multi-tier fabric, nodes overwhelmingly share in-neighbour sets:
nodes sharing a source set form a complete bipartite block with their
common sources, and relaxation over such a block is a small dense
min-plus contraction,

    c[b, g, r] = min_s ( d[b, src[g, s]] + w[g, s, r] )

one small gather per group, then a batched (min, +) product. Nodes are
renumbered (class, group, member) so every segment's output is a
contiguous [B, G, R] reshape. Bands whose structure is not detected
degrade to singleton groups (R = 1), the ELL gather shape. Equality with
the ELL sweep is witnessed by the canonical route-sweep digest, compared
by node name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops import autotune, relax_loop
from openr_tpu_torch.ops import route_sweep as rs
from openr_tpu_torch.ops.grouped_minplus import batched_minplus, batched_minplus_t
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.ops.spf_sparse import (
    _as_device_ids,
    _in_edges,
    _out_edges,
    _pad_up,
)

IMPLS = ("batched_minplus", "batched_minplus_t")
_REFERENCE_IMPLS = {"jnp": "batched_minplus", "pallas": "batched_minplus",
                    "pallas_t": "batched_minplus_t"}

# representative [B, G, S, R] probe block of the "auto" measurement
_AUTO_PROBE_SHAPE = (32, 8, 8, 16)


def _impl_setting(name: str) -> str:
    impl = _REFERENCE_IMPLS.get(name, name)
    if impl not in IMPLS + ("auto",):
        raise ValueError(f"grouped impl {name!r}: one of {IMPLS + ('auto',)}")
    return impl


_GROUPED_IMPL = _impl_setting(os.environ.get("OPENR_GROUPED_IMPL", "batched_minplus"))


def set_grouped_impl(impl: str) -> None:
    global _GROUPED_IMPL
    _GROUPED_IMPL = _impl_setting(impl)


def get_grouped_impl(device: DeviceLike = None) -> str:
    """The selected kernel; "auto" resolves to the measured winner on
    ``device`` (None = CUDA)."""
    if _GROUPED_IMPL != "auto":
        return _GROUPED_IMPL
    return autotune.resolve_grouped(_AUTO_PROBE_SHAPE, resolve_device(device))


def _check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"grouped impl {impl!r}: one of {IMPLS}")
    return impl


def _contract(gath, w, impl):
    """``c[b, g, r] = min_s gath[b, g, s] + w[g, s, r]`` (INF-saturating)
    through the kernel ``impl``, in its own layout: ``[G, B, S]`` for
    ``batched_minplus``, ``[G, S, B]`` for ``batched_minplus_t``."""
    if impl == "batched_minplus":
        c = batched_minplus(gath.permute(1, 0, 2).contiguous(), w)  # [G, B, R]
        return c.permute(1, 0, 2)
    if impl == "batched_minplus_t":
        c = batched_minplus_t(gath.permute(1, 2, 0).contiguous(), w)  # [G, R, B]
        return c.permute(2, 0, 1)
    raise ValueError(f"grouped impl {impl!r}: one of {IMPLS}")


@dataclass(frozen=True)
class Segment:
    """One bipartite block family of a band: groups of ``R`` nodes
    sharing ``S`` sources. ``axis=1``: group index is the grid's major
    axis (contribution lands as [B, G1, G2] directly); ``axis=2``:
    group index is the minor axis (contribution transposes in)."""

    axis: int
    src: np.ndarray  # [G, S] int32 source ids (pad: self-ids, w=INF)
    w: np.ndarray  # [G, S, R] int32 edge metrics, INF padding


@dataclass(frozen=True)
class GridBand:
    start: int  # first node id of the band
    g1: int
    g2: int  # band rows = g1 * g2; id = start + a * g2 + b
    segments: Tuple[Segment, ...]


@dataclass(frozen=True)
class GroupedGraph:
    node_names: Tuple[str, ...]  # index == node id (grid-grouped order)
    node_index: Dict[str, int]
    n: int
    n_pad: int
    bands: Tuple[GridBand, ...]
    overloaded: np.ndarray  # [n_pad] bool
    direction: str  # "in" (forward relax) | "out" (reverse relax)

    def out_slots(self, node_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(neighbour ids, metrics) of this node's band row: for an
        "out" graph, the node's forward out-edges, the slot list the
        route sweep's sample masks are defined over."""
        for band in self.bands:
            rows = band.g1 * band.g2
            if not (band.start <= node_id < band.start + rows):
                continue
            local = node_id - band.start
            a, b = divmod(local, band.g2)
            vs: List[int] = []
            ws: List[int] = []
            for seg in band.segments:
                g, r = (a, b) if seg.axis == 1 else (b, a)
                for s in range(seg.src.shape[1]):
                    if seg.w[g, s, r] < INF:
                        vs.append(int(seg.src[g, s]))
                        ws.append(int(seg.w[g, s, r]))
            return np.asarray(vs, np.int32), np.asarray(ws, np.int32)
        raise KeyError(node_id)


def _signature_groups(rows: List[str], srcs_by_class, cls):
    """Group band rows by their class-``cls`` source-set signature.
    Returns (groups: list of lists of row names, regular: bool)."""
    sig_map: Dict[Tuple[str, ...], List[str]] = {}
    for nm in rows:
        sig = tuple(sorted(srcs_by_class[nm].get(cls, {})))
        sig_map.setdefault(sig, []).append(nm)
    groups = [sorted(v) for v in sig_map.values()]
    groups.sort(key=lambda g: g[0])
    sizes = {len(g) for g in groups}
    regular = len(sizes) == 1 and () not in sig_map
    return groups, regular


def compile_grouped(ls, align: int = 128, direction: str = "in") -> GroupedGraph:
    """Structure-detecting compilation from the LinkState. O(E log E)
    host work; no dense matrix anywhere."""
    if direction not in ("in", "out"):
        raise ValueError(f"compile_grouped: direction {direction!r}")
    edges_of = _in_edges if direction == "in" else _out_edges
    raw_names = sorted(ls.get_adjacency_databases().keys())
    raw_index = {nm: i for i, nm in enumerate(raw_names)}
    # per node: src name -> metric (direction-appropriate)
    edges: Dict[str, Dict[str, int]] = {}
    for nm in raw_names:
        by_id = edges_of(ls, nm, raw_index)
        edges[nm] = {raw_names[i]: w for i, w in by_id.items()}
    # class = EXACT degree, finer than the ELL's power-of-two classes,
    # so fabric tiers land in distinct bands even when their degrees
    # share a power-of-two bucket
    node_class = {nm: max(1, len(edges[nm])) for nm in raw_names}
    # per node: src class -> {src name: metric}
    srcs_by_class: Dict[str, Dict[int, Dict[str, int]]] = {}
    for nm in raw_names:
        per: Dict[int, Dict[str, int]] = {}
        for src, w in edges[nm].items():
            per.setdefault(node_class[src], {})[src] = w
        srcs_by_class[nm] = per

    # band structuring
    classes = sorted({node_class[nm] for nm in raw_names})
    band_plans = []  # (class, (grid_names [G1][G2], seg plans or None))
    for ck in classes:
        rows = sorted(nm for nm in raw_names if node_class[nm] == ck)
        src_classes = sorted({c for nm in rows for c in srcs_by_class[nm]})
        plan = None
        if len(src_classes) == 1:
            groups, regular = _signature_groups(rows, srcs_by_class, src_classes[0])
            if regular:
                plan = (groups, [(src_classes[0], 1)])
        elif len(src_classes) == 2:
            c1, c2 = src_classes
            gr1, reg1 = _signature_groups(rows, srcs_by_class, c1)
            gr2, reg2 = _signature_groups(rows, srcs_by_class, c2)
            if reg1 and reg2 and len(gr1) * len(gr2) == len(rows):
                # product check: every (group1, group2) cell holds
                # exactly one row
                pos1 = {nm: i for i, g in enumerate(gr1) for nm in g}
                pos2 = {nm: j for j, g in enumerate(gr2) for nm in g}
                cells = {(pos1[nm], pos2[nm]) for nm in rows}
                if len(cells) == len(rows):
                    grid = [[None] * len(gr2) for _ in range(len(gr1))]
                    for nm in rows:
                        grid[pos1[nm]][pos2[nm]] = nm
                    plan = (grid, [(c1, 1), (c2, 2)])
        if plan is None:
            # unstructured: singleton groups, R = 1, the ELL shape
            plan = ([[nm] for nm in rows], None)
        band_plans.append((ck, plan))

    # numbering: (class, grid-major)
    names: List[str] = []
    for _ck, (grid, _segs) in band_plans:
        for row in grid:
            names.extend(row)
    names_t = tuple(names)
    index = {nm: i for i, nm in enumerate(names_t)}
    n = len(names_t)
    n_pad = _pad_up(n, align)

    # materialise segments
    bands: List[GridBand] = []
    start = 0
    for _ck, (grid, seg_plan) in band_plans:
        g1 = len(grid)
        g2 = len(grid[0])
        segments: List[Segment] = []
        if seg_plan is None:
            # one generic segment: per-node source table, R = 1
            s_max = max(1, max(len(edges[r[0]]) for r in grid))
            src = np.zeros((g1, s_max), dtype=np.int32)
            w = np.full((g1, s_max, 1), INF, dtype=np.int32)
            for g, row in enumerate(grid):
                nm = row[0]
                src[g, :] = index[nm]  # inert self-pad
                for s, (sn, sw) in enumerate(sorted(edges[nm].items())):
                    src[g, s] = index[sn]
                    w[g, s, 0] = min(int(sw), int(INF) - 1)
            segments.append(Segment(axis=1, src=src, w=w))
        else:
            for cls, axis in seg_plan:
                if axis == 1:
                    groups = grid  # member r at grid[g][r]
                else:
                    groups = [[grid[a][b] for a in range(g1)] for b in range(g2)]
                g_count = len(groups)
                r_count = len(groups[0])
                src_names = [
                    sorted(srcs_by_class[groups[g][0]].get(cls, {}))
                    for g in range(g_count)
                ]
                s_max = max(1, max(len(s) for s in src_names))
                src = np.zeros((g_count, s_max), dtype=np.int32)
                w = np.full((g_count, s_max, r_count), INF, dtype=np.int32)
                for g in range(g_count):
                    src[g, :] = index[groups[g][0]]  # inert pad
                    for s, sn in enumerate(src_names[g]):
                        src[g, s] = index[sn]
                        for r, nm in enumerate(groups[g]):
                            w[g, s, r] = min(
                                int(srcs_by_class[nm][cls][sn]), int(INF) - 1
                            )
                segments.append(Segment(axis=axis, src=src, w=w))
        bands.append(GridBand(start=start, g1=g1, g2=g2, segments=tuple(segments)))
        start += g1 * g2
    if start != n:
        raise AssertionError(f"grouped bands cover {start} of {n} nodes")

    overloaded = np.zeros(n_pad, dtype=bool)
    for nm in names_t:
        overloaded[index[nm]] = ls.is_node_overloaded(nm)
    return GroupedGraph(
        node_names=names_t,
        node_index=index,
        n=n,
        n_pad=n_pad,
        bands=tuple(bands),
        overloaded=overloaded,
        direction=direction,
    )


def compile_out_grouped(ls, align: int = 128) -> GroupedGraph:
    """Out-edge grouped graph for the destination-major route sweep."""
    return compile_grouped(ls, align=align, direction="out")


# ---- device tensors ----------------------------------------------------------


@dataclass(frozen=True)
class _BandMeta:
    """Static shape info of one band."""

    start: int
    g1: int
    g2: int
    seg_axes: Tuple[int, ...]


def band_meta(graph: GroupedGraph) -> Tuple[_BandMeta, ...]:
    return tuple(
        _BandMeta(
            start=b.start, g1=b.g1, g2=b.g2,
            seg_axes=tuple(s.axis for s in b.segments),
        )
        for b in graph.bands
    )


def device_tensors(graph: GroupedGraph, device: torch.device):
    """Flat tuples of per-segment (src, w) tensors on ``device``, in
    band/segment order: the resident state a caller uploads once."""
    srcs = []
    ws = []
    for band in graph.bands:
        for seg in band.segments:
            srcs.append(torch.from_numpy(np.ascontiguousarray(seg.src)).to(device))
            ws.append(torch.from_numpy(np.ascontiguousarray(seg.w)).to(device))
    return tuple(srcs), tuple(ws)


def _grouped_relax(d, meta, srcs_t, ws_t, overloaded, t_ids, impl):
    """One relaxation [B, n_pad] -> a new [B, n_pad] over the grouped
    bands as per-segment contractions. ``t_ids`` None: the forward
    transit mask (edge origin overloaded); else the reverse
    row-dependent mask ``overloaded[v] & (v != t)``. Each band writes
    its column slice of the output; the padding columns are copied."""
    out = torch.empty_like(d)
    b = d.shape[0]
    pos = 0
    si = 0
    for band in meta:
        if band.start != pos:
            raise ValueError(f"band {band} does not start at column {pos}")
        rows = band.g1 * band.g2
        acc = d[:, pos : pos + rows]
        for axis in band.seg_axes:
            src = srcs_t[si]
            w = ws_t[si]
            si += 1
            idx = src.long()
            gath = d[:, idx]  # [B, G, S]: the only gather, G-sized
            blocked = overloaded[idx][None]
            if t_ids is not None:
                blocked = blocked & (src[None] != t_ids[:, None, None])
            gath = gath.masked_fill(blocked, INF)
            c = _contract(gath, w, impl)  # [B, G, R]
            if axis == 2:
                c = c.transpose(1, 2)  # -> [B, G1, G2]
            acc = torch.minimum(acc, c.reshape(b, rows))
        out[:, pos : pos + rows] = acc
        pos += rows
    out[:, pos:] = d[:, pos:]
    return out


def _grouped_fixed_point(meta, srcs_t, ws_t, overloaded, ids, n, reverse, impl,
                         init=None, budget=None, chunk=relax_loop.HOP_CHUNK):
    """``(distance rows [B, n], hops)`` from the unit init.
    ``reverse=False``: rows are SOURCES (forward all-sources; the init
    is one unmasked relax so an overloaded source still originates).
    ``reverse=True``: rows are DESTINATIONS (route-sweep orientation;
    the per-row mask needs no init special case). ``init`` (reverse
    only) warm-seeds the rows with a pointwise upper bound on the fixed
    point; the unit anchor is min-ed in, and the unique fixed point
    keeps the result bit-identical to the cold solve. At most ``n`` hops,
    the changed count read once a ``chunk`` of hops
    (``relax_loop.fixed_point``); with a hop ``budget``, that many hops
    with no host sync and ``hops`` the device pair ``(hops, converged)``,
    as in ``route_sweep._rev_fixed_point``."""
    b = ids.shape[0]
    dev = ids.device
    d = torch.full((b, n), INF, dtype=torch.int32, device=dev)
    d.scatter_(1, ids.long()[:, None], 0)  # no host scalar copy (capturable)
    if reverse:
        if init is not None:
            d = torch.minimum(init, d)
    else:
        if init is not None:
            raise ValueError("the warm seed is a reverse-sweep contract")
        d = _grouped_relax(
            d, meta, srcs_t, ws_t, torch.zeros_like(overloaded), None, impl
        )
    t_ids = ids if reverse else None

    def step(x):
        return _grouped_relax(x, meta, srcs_t, ws_t, overloaded, t_ids, impl)

    if budget is None:
        return relax_loop.fixed_point(step, d, n, chunk)
    d, changed = relax_loop.run_hops(step, d, budget)
    return d, relax_loop.hop_status(changed, budget, n)


class GroupedState:
    """Caller-owned resident tensors of a grouped graph on ``device``
    (None = CUDA), uploaded once."""

    def __init__(self, graph: GroupedGraph, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.graph = graph
        self.meta = band_meta(graph)
        self.src, self.w = device_tensors(graph, self.device)
        self.overloaded = torch.from_numpy(graph.overloaded).to(self.device)


def grouped_distances_from_sources(
    graph: GroupedGraph, src_ids, state: Optional[GroupedState] = None,
    impl: str = "batched_minplus", device: DeviceLike = None,
) -> torch.Tensor:
    """Forward distances [S, n_pad] from a batch of sources over an
    "in" grouped graph, through the contraction kernel ``impl``."""
    st = state if state is not None else GroupedState(graph, device)
    d, _hops = _grouped_fixed_point(
        st.meta, st.src, st.w, st.overloaded,
        _as_device_ids(src_ids, st.device), graph.n_pad, reverse=False,
        impl=_check_impl(impl),
    )
    return d


# ---- destination-major route sweep over grouped bands ------------------------


def _grouped_nh_counts(dr, meta, srcs_t, ws_t, overloaded, t_ids) -> torch.Tensor:
    """Per-node ECMP next-hop slot counts [B, n_pad] over the grouped
    segments: v is a next hop of s toward t iff w(s, v) + DR[t, v] ==
    DR[t, s] and v is not transit-blocked. Segment by segment, so the
    [B, G, S, R] temporaries of one segment are alive at a time."""
    b = dr.shape[0]
    out = torch.zeros_like(dr)
    pos = 0
    si = 0
    for band in meta:
        rows = band.g1 * band.g2
        acc = out[:, pos : pos + rows]
        d_grid = dr[:, pos : pos + rows].reshape(b, band.g1, band.g2)
        for axis in band.seg_axes:
            src = srcs_t[si]
            w = ws_t[si]
            si += 1
            d_g = d_grid if axis == 1 else d_grid.transpose(1, 2)  # [B, G, R]
            idx = src.long()
            blocked = overloaded[idx][None] & (src[None] != t_ids[:, None, None])
            gath = dr[:, idx].masked_fill(blocked, INF)  # [B, G, S]
            total = (gath[:, :, :, None] + w[None]).clamp_max_(INF)  # [B, G, S, R]
            cond = (
                (total == d_g[:, :, None, :])
                & (d_g < INF)[:, :, None, :]
                & (w < INF)[None]
            )
            c = cond.sum(2, dtype=torch.int32)  # [B, G, R]
            if axis == 2:
                c = c.transpose(1, 2)
            acc += c.reshape(b, rows)
        pos += rows
    return out


def _grouped_cone_expand(sel_dr, meta, srcs_t, ws_t, e_u, e_v, e_w_old,
                         e_w_new, max_jumps, cell_limit=None,
                         row_block=rs.ROW_BLOCK, jump_budget=None):
    """Affected-cone mask for a weight-increase delta over the GROUPED
    segment slabs: ``route_sweep._cone_expand``'s seed, growth and
    counters (``route_sweep.expand_cone``), walking each band's
    ``[G, S, R]`` segments instead of ELL slots. Cell j joins when a
    raw-tight segment slot of j (old weights, resident distances) reaches
    a cone cell; axis-2 segments transpose onto the band grid as in
    ``_grouped_relax``. Returns ``(cone, rows, cells, jumps, converged,
    more)`` with ``_cone_expand``'s contract."""
    return rs.expand_cone(sel_dr, e_u, e_v, e_w_old, e_w_new, max_jumps, cell_limit,
                          row_block, grouped_joins(meta, srcs_t, ws_t), jump_budget)


def grouped_joins(meta, srcs_t, ws_t):
    """The grouped growth of one block of cone rows
    (``route_sweep.ell_joins``' contract over the segment slabs)."""

    def joins(d_blk, c_blk, joined_blk):
        b = d_blk.shape[0]
        pos = 0
        si = 0
        for band in meta:
            rows = band.g1 * band.g2
            acc = joined_blk[:, pos : pos + rows]
            d_grid = d_blk[:, pos : pos + rows].reshape(b, band.g1, band.g2)
            for axis in band.seg_axes:
                src = srcs_t[si]
                w = ws_t[si]
                si += 1
                d_g = d_grid if axis == 1 else d_grid.transpose(1, 2)  # [b, G, R]
                idx = src.long()
                total = (d_blk[:, idx][:, :, :, None] + w[None]).clamp_max_(INF)
                tight = (
                    (total == d_g[:, :, None, :])
                    & (d_g < INF)[:, :, None, :]
                    & (w < INF)[None]
                )  # [b, G, S, R]
                j = (tight & c_blk[:, idx][:, :, :, None]).any(2)  # [b, G, R]
                if axis == 2:
                    j = j.transpose(1, 2)
                acc |= j.reshape(b, rows)
            pos += rows

    return joins


def _grouped_route_block_body(srcs_t, ws_t, overloaded, t_ids, samp_ids,
                              samp_v, samp_w, pos_w, meta, n, impl,
                              chunk=relax_loop.HOP_CHUNK):
    """Grouped twin of ``route_sweep._route_block_body``: the same packed
    layout and digest algebra; only the relaxation differs, so the
    canonical digest must agree bit-exactly with the ELL sweep's.
    Returns ``(packed [B, W] int32, relax hops)``."""
    dr, hops = _grouped_fixed_point(
        meta, srcs_t, ws_t, overloaded, t_ids, n, reverse=True, impl=impl, chunk=chunk
    )
    nh_count = _grouped_nh_counts(dr, meta, srcs_t, ws_t, overloaded, t_ids)
    digest = rs._digest_rows(dr, nh_count, pos_w)
    d_s, packed_mask = rs._sample_stats(
        dr, samp_ids, samp_v, samp_w, overloaded, t_ids
    )
    return rs._pack_block(digest, nh_count, d_s, packed_mask), hops


class GroupedRouteSweeper(rs.RouteSweeper):
    """Destination-major route sweeper over an out-edge grouped graph:
    the gather-free backend of ``route_sweep.RouteSweeper``, producing
    the same ``RouteSweepResult`` (canonical digests comparable by name
    across the two backends). ``impl`` names the contraction kernel:
    ``"batched_minplus"`` or ``"batched_minplus_t"``. The block loop and
    result assembly are ``RouteSweeper.sweep``'s."""

    def __init__(self, graph: GroupedGraph, sample_names: Sequence[str],
                 impl: str = "batched_minplus", device: DeviceLike = None):
        if graph.direction != "out":
            raise ValueError("the route sweep needs an out-edge grouped graph")
        self.impl = _check_impl(impl)
        self.device = resolve_device(device)
        self.graph = graph
        self.block_hops: List[int] = []
        self.meta = band_meta(graph)
        self.v_t, self.w_t = device_tensors(graph, self.device)
        self.overloaded = self._upload(graph.overloaded)
        ids = [graph.node_index[nm] for nm in sample_names]
        self._set_samples(sample_names, rs.pack_sample_rows(
            [graph.out_slots(sid) for sid in ids], ids
        ))

    def solve_block(self, t_ids) -> torch.Tensor:
        packed, hops = _grouped_route_block_body(
            self.v_t, self.w_t, self.overloaded,
            _as_device_ids(t_ids, self.device),
            self._samp_ids_dev, self._samp_v_dev, self._samp_w_dev,
            self._pos_w_dev, self.meta, self.graph.n_pad, self.impl,
            relax_loop.chunk_for(self.block_hops[-1] if self.block_hops else 0),
        )
        self.block_hops.append(hops)
        return packed


# ---- incremental weight patching ---------------------------------------------


def slot_table(graph: GroupedGraph) -> Dict[int, List[Tuple]]:
    """node id -> [(segment flat index, g, s, r, src id)] for every REAL
    edge slot of the node's band row, in ``device_tensors`` order.

    Taken at compile time (a real slot has w < INF in the fresh layout),
    so a slot that a later patch removes (set to INF) stays in the table
    and is restorable; the inert self-pad slots are never in it, so a
    patch cannot double-count a pad whose id is also a real neighbour
    (next-hop counts sum over slots)."""
    out: Dict[int, List[Tuple]] = {}
    si = 0
    for band in graph.bands:
        for seg in band.segments:
            gg, ss, rr = np.nonzero(seg.w < INF)
            if seg.axis == 1:
                nodes = band.start + gg * band.g2 + rr
            else:
                nodes = band.start + rr * band.g2 + gg
            sids = seg.src[gg, ss]
            for x in range(len(gg)):
                out.setdefault(int(nodes[x]), []).append(
                    (si, int(gg[x]), int(ss[x]), int(rr[x]), int(sids[x]))
                )
            si += 1
    return out


def grouped_patch(graph: GroupedGraph, ls, affected, slots: Dict[int, List[Tuple]]):
    """In-place weight patch for churn on an existing grouped layout:
    ``(patched GroupedGraph, {segment flat index: [(g, s, r, new_w)]})``,
    or None when the event breaks the layout's structure (the node set
    changed, or a node gained a neighbour its slot signature does not
    carry: a new adjacency needs a recompile).

    Metric changes and edge REMOVALS (slot set to INF, inert in every
    relaxation) patch in place: node ids are untouched, so a resident DR
    keyed by them stays valid, and a removed slot is restored by a later
    patch when the edge returns. The patched layout may differ from a
    fresh compile's, but is exact as a relaxation structure."""
    edges_of = _in_edges if graph.direction == "in" else _out_edges
    names = tuple(sorted(ls.get_adjacency_databases().keys()))
    if len(names) != graph.n or any(nm not in graph.node_index for nm in names):
        # node set changed, a same-count swap included
        return None
    updates: Dict[int, List[Tuple[int, int, int, int]]] = {}
    overloaded = graph.overloaded.copy()
    for nm in affected:
        i = graph.node_index.get(nm)
        if i is None:
            return None
        new_edges = edges_of(ls, nm, graph.node_index)
        my_slots = slots.get(i, [])
        slot_srcs = {sid for (_si, _g, _s, _r, sid) in my_slots}
        if set(new_edges) - slot_srcs:
            return None  # new neighbour: structure change
        for (si, g, s, r, sid) in my_slots:
            # real metrics arrive capped at INF - 1 by edges_of; INF is
            # the removed/pad sentinel. The one update list feeds both
            # the host copy and the device scatter
            updates.setdefault(si, []).append((g, s, r, int(new_edges.get(sid, INF))))
        overloaded[i] = ls.is_node_overloaded(nm)
    seg_list: List[Segment] = []
    for band in graph.bands:
        seg_list.extend(band.segments)
    patched_segs = list(seg_list)
    for si, ups in updates.items():
        w = seg_list[si].w.copy()
        for (g, s, r, wv) in ups:
            w[g, s, r] = wv
        patched_segs[si] = Segment(axis=seg_list[si].axis, src=seg_list[si].src, w=w)
    bands: List[GridBand] = []
    si = 0
    for band in graph.bands:
        k = len(band.segments)
        bands.append(GridBand(start=band.start, g1=band.g1, g2=band.g2,
                              segments=tuple(patched_segs[si : si + k])))
        si += k
    patched = GroupedGraph(
        node_names=graph.node_names, node_index=graph.node_index,
        n=graph.n, n_pad=graph.n_pad, bands=tuple(bands),
        overloaded=overloaded, direction=graph.direction,
    )
    return patched, updates


def structure_report(graph: GroupedGraph) -> dict:
    """How much of the edge volume the structure detection captured:
    per band (g1, g2, segments, slots) and the total gather shrink
    factor against per-node ELL slots."""
    bands = []
    grouped_slots = 0
    row_slots = 0
    for band in graph.bands:
        rows = band.g1 * band.g2
        seg_info = []
        for seg in band.segments:
            g, s, r = seg.w.shape
            seg_info.append({"axis": seg.axis, "g": g, "s": s, "r": r})
            grouped_slots += g * s
            row_slots += g * s * r
        bands.append(
            {"rows": rows, "g1": band.g1, "g2": band.g2, "segments": seg_info}
        )
    return {
        "bands": bands,
        "gather_slots": grouped_slots,
        "ell_equivalent_slots": row_slots,
        "gather_shrink": round(row_slots / max(1, grouped_slots), 1),
    }
