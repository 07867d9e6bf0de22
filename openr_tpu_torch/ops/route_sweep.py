"""Destination-major all-sources route sweep, with route selection on the card.

Port note: mirrors the cold sweep of ``openr_tpu/ops/route_sweep.py``:
``compile_out_ell``, ``_rev_relax``, ``_rev_fixed_point``, ``_nh_counts``,
the canonical digest (``canonical_pos_weights``, ``_digest_rows``,
``host_digest``), ``_sample_stats``, ``_route_block_body`` with its packed
column layout, ``_unpack_blocks``, ``assemble_result``, ``digests_by_name``,
``RouteSweepResult``, ``pack_sample_rows``, ``_sample_bands``,
``RouteSweeper`` and ``all_sources_route_sweep``. Each band of a relax step
goes through ``ops.rev_relax.rev_band_relax`` (the hand-written CUDA kernel
on the card, its plain torch version on the CPU), writing its column slice
of one output. The JAX ``lax.while_loop`` becomes chunks of hops whose
changed count stays on the card (``ops/relax_loop.py``): a sweep's block
reads it once a chunk, counted in ``ops.blocking_syncs``, and an engine
body runs a fixed budget of hops with no sync at all. The hops of each
block are kept on the sweeper. ``_cone_expand`` is the churn engine's
frontier kernel (``ops/route_engine.py``): plain torch ops, its growth
walked over blocks of destination rows so that the ``[rows, band rows,
k]`` gathers of a full-width cone stay bounded, its continue flag and
counters on the card. Not ported yet: the sharded sweeps.

The sweep relaxes the REVERSED graph (an out-edge ELL: row s holds
``(v, w(s -> v))`` for every forward edge), so row t of a block is a
destination column of the forward problem, ``DR[t, s] = d(s -> t)``, and
every node's ECMP next-hop test is local to that row:

    v in nh(s -> t)  iff  w(s, v) + DR[t, v] == DR[t, s]

Per block the card computes each source's next-hop counts, a
position-sensitive uint32 digest of (distances, next-hop counts) per
destination, and full route rows for a few sample nodes; only those cross
back to the host. A forward path ``s -> v1 -> ... -> t`` is blocked iff
some intermediate ``v_i`` is overloaded, so an edge ``s -> v`` is masked
when ``overloaded[v] and v != t``.

The digest is uint32 arithmetic with wrap-around. Torch's uint32 lacks
most arithmetic, so it is computed in int64 and reduced mod 2^32 after
every multiply and after the sum, then reinterpreted as int32 for the
packed block (the reference's ``bitcast_convert_type``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.ops import autotune, relax_loop
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.ops.rev_relax import rev_band_relax
from openr_tpu_torch.ops.spf_sparse import (
    EllGraph,
    _as_device_ids,
    _band_of,
    _ell_impl_for,
    compile_ell,
)

__all__ = [
    "RouteSweepResult",
    "RouteSweeper",
    "all_sources_route_sweep",
    "compile_out_ell",
    "host_digest",
]

_DIGEST_MULT_D = np.uint32(2654435761)  # Knuth multiplicative
_DIGEST_MULT_C = np.uint32(40503)
_DIGEST_POS_A = np.uint32(2246822519)  # xxhash prime
_DIGEST_POS_B = np.uint32(0x9E3779B9)
_DIGEST_ADD = 0x85EBCA6B

_U32 = 0xFFFFFFFF


def compile_out_ell(ls, align: int = 128) -> EllGraph:
    """Out-edge (reversed-graph) sliced-ELL bands for the route sweep."""
    return compile_ell(ls, align=align, direction="out")


def _rev_relax(dr, bands, v_t, w_t, overloaded, t_ids) -> torch.Tensor:
    """One reversed-graph relaxation, [B, n_pad] -> a new [B, n_pad],
    with the row-dependent transit mask: edge (s -> v) may extend a
    v ~> t path unless v is overloaded and v != t. Each band writes its
    column slice of the output in place; the padding columns past the
    last band are copied through unchanged."""
    out = torch.empty_like(dr)
    pos = 0
    for band, v_b, w_b in zip(bands, v_t, w_t):
        if band.start != pos:
            raise ValueError(f"band {band} does not start at column {pos}")
        rev_band_relax(dr, v_b, w_b, t_ids, overloaded, pos, out=out)
        pos += band.rows
    out[:, pos:] = dr[:, pos:]
    return out


def _rev_fixed_point(bands, v_t, w_t, overloaded, t_ids, n, init=None, budget=None,
                     chunk=relax_loop.HOP_CHUNK):
    """``(DR rows [B, n], hops)`` for destination batch ``t_ids`` from
    the unit init. ``init`` optionally warm-seeds the rows with a
    pointwise upper bound on the fixed point; the unit anchor is min-ed
    in, and the int32 min-relaxation's unique fixed point keeps the
    result bit-identical to the cold solve. The loop stops when a hop
    changes nothing or after ``n`` hops, like the reference's
    ``while_loop``, reading its changed count once a ``chunk`` of hops
    (``relax_loop.fixed_point``). With a hop ``budget`` it runs that many
    hops with no host sync, and ``hops`` is the device pair ``(hops,
    converged)`` (``relax_loop.hop_status``)."""
    b = t_ids.shape[0]
    dev = t_ids.device
    dr = torch.full((b, n), INF, dtype=torch.int32, device=dev)
    # a scatter of the scalar: an index_put of 0 would copy a host
    # scalar to the card, which a graph capture refuses
    dr.scatter_(1, t_ids.long()[:, None], 0)
    if init is not None:
        dr = torch.minimum(init, dr)

    def step(x):
        return _rev_relax(x, bands, v_t, w_t, overloaded, t_ids)

    if budget is None:
        return relax_loop.fixed_point(step, dr, n, chunk)
    dr, changed = relax_loop.run_hops(step, dr, budget)
    return dr, relax_loop.hop_status(changed, budget, n)


# destination rows a full-width gather (the cone's growth, the engine's
# route extraction) takes at once: [ROW_BLOCK, band rows, k] int32 is
# 245 MB over the 10 000-node fabric's widest band, where the whole
# 10112 rows would be 2.4 GB. Rows never interact, so the blocks give
# the same bits as one pass.
ROW_BLOCK = 1024


def ell_joins(bands, v_t, w_t):
    """The ELL growth of one block of cone rows: ``joins(d_blk, c_blk,
    joined_blk)`` writes into ``joined_blk`` the cells a raw-tight band
    slot joins to the cone ``c_blk`` (old weights, resident distances)."""

    def joins(d_blk, c_blk, joined_blk):
        pos = 0
        for band, v_b, w_b in zip(bands, v_t, w_t):
            idx = v_b.long()
            d_band = d_blk[:, pos : pos + band.rows]  # [b, rows]
            total = (d_blk[:, idx] + w_b[None]).clamp_max_(INF)
            tight = (
                (total == d_band[:, :, None])
                & (d_band < INF)[:, :, None]
                & (w_b < INF)[None]
            )  # [b, rows, k]
            joined_blk[:, pos : pos + band.rows] = (tight & c_blk[:, idx]).any(2)
            pos += band.rows

    return joins


def _cone_expand(sel_dr, bands, v_t, w_t, e_u, e_v, e_w_old, e_w_new,
                 max_jumps, cell_limit=None, row_block=ROW_BLOCK, jump_budget=None):
    """Affected-cone mask for a weight-increase delta (the frontier
    kernel). Given resident distance rows ``sel_dr`` [B, N] and the
    PRE-patch bands, mark every cell whose tight shortest path crosses
    an increased edge: the cells whose distance may RISE, which a warm
    seed must reset. Seed: cells u where an increased edge
    (u -> v, w_old) was tight; each jump adds cell j when a raw-tight
    band slot of j (old weights, old distances) reaches a cone cell,
    until the cone stops growing. Tightness on RAW weights only
    over-approximates (extra resets stay bit-identical by the
    unique-fixed-point squeeze); INF cells never rise and are left out.

    Returns ``(cone [B, N] bool, rows, cells, jumps, converged, more)``:
    ``rows`` (int32 device scalar) counts rows with a nonempty cone,
    ``cells`` (float32 device scalar, as the reference's sum, so the
    threshold policy takes the same branch) the cone's population,
    ``jumps`` (int32 device scalar) the jumps taken, ``converged`` (bool
    device scalar) False when ``max_jumps`` cut the expansion off or the
    cone overflowed ``cell_limit`` (a float32 device scalar): the cone is
    then an under-approximation and the caller falls back to a coarser
    reset. ``more`` (bool device scalar) is True when ``jump_budget`` (at
    most ``max_jumps`` jumps with no host sync) ran out with the
    expansion still going: the caller re-dispatches with a larger budget.
    Without a budget the jumps run in chunks, one host sync a chunk, and
    ``more`` is False."""
    return expand_cone(sel_dr, e_u, e_v, e_w_old, e_w_new, max_jumps, cell_limit,
                       row_block, ell_joins(bands, v_t, w_t), jump_budget)


# cone jumps an eager expansion runs between two reads of its flag
JUMP_CHUNK = 4


def _within(cells, cell_limit):
    return cells <= cell_limit if cell_limit is not None else torch.ones_like(cells > 0)


def _cone_count(c):
    rows = c.any(1).sum(dtype=torch.int32)
    # float32: the population can pass int32 at 100k nodes; a policy
    # threshold tolerates the rounding
    return rows, c.sum(dtype=torch.float32)


def cone_start(sel_dr, e_u, e_v, e_w_old, e_w_new, cell_limit=None):
    """The cone's seed and the expansion's device state ``(cone, rows,
    cells, grew, jumps, go)``: cells u where an increased edge (u -> v,
    w_old) was tight; ``go`` the reference's loop condition (the last jump
    grew, the cone within ``cell_limit``)."""
    live = sel_dr < INF
    eu, ev = e_u.long(), e_v.long()
    inc_e = (e_w_new > e_w_old) & (e_w_old < INF)
    seed_tight = (
        (sel_dr[:, eu] == (e_w_old[None] + sel_dr[:, ev]).clamp_max(INF))
        & inc_e[None]
        & live[:, eu]
    )  # [B, E]
    hits = torch.zeros(sel_dr.shape, dtype=torch.int32, device=sel_dr.device)
    hits.index_add_(1, eu, seed_tight.to(torch.int32))
    cone = hits > 0
    del hits
    rows, cells = _cone_count(cone)
    grew = cells > 0
    jumps = torch.zeros((), dtype=torch.int32, device=sel_dr.device)
    return cone, rows, cells, grew, jumps, grew & _within(cells, cell_limit)


def cone_run(state, sel_dr, joins, todo, max_jumps, cell_limit=None, row_block=ROW_BLOCK):
    """``todo`` jumps of the expansion ``state`` (``cone_start``'s), with
    no host sync: a jump runs under the device flag ``go``, which drops
    once a jump grows nothing, the cone passes ``cell_limit`` or
    ``max_jumps`` jumps ran; after that every counter stays as it is."""
    cone, rows, cells, grew, jumps, go = state

    def grow(c):
        joined = torch.zeros_like(c)
        for a in range(0, c.shape[0], row_block):
            joins(sel_dr[a : a + row_block], c[a : a + row_block],
                  joined[a : a + row_block])
        return c | joined

    for _ in range(todo):
        nxt = grow(cone)
        n_rows, n_cells = _cone_count(nxt)
        grew = torch.where(go, (nxt & ~cone).any(), grew)
        cone = torch.where(go, nxt, cone)
        rows = torch.where(go, n_rows, rows)
        cells = torch.where(go, n_cells, cells)
        jumps = jumps + go.to(torch.int32)
        go = go & grew & _within(cells, cell_limit) & (jumps < max_jumps)
    return cone, rows, cells, grew, jumps, go


def cone_converged(state, cell_limit=None):
    """False when the expansion was cut off (``max_jumps``) or the cone
    overflowed ``cell_limit``: it is then an under-approximation."""
    _cone, _rows, cells, grew, _jumps, _go = state
    converged = ~grew
    if cell_limit is not None:
        converged = converged & (cells <= cell_limit)
    return converged


def expand_cone(sel_dr, e_u, e_v, e_w_old, e_w_new, max_jumps, cell_limit, row_block,
                joins, jump_budget=None):
    """The cone expansion both backends share: ``cone_start``, then the
    jumps (``cone_run``: a jump budget with no host sync, or chunks of
    ``JUMP_CHUNK`` jumps with one read of the flag each), then the result
    ``(cone, rows, cells, jumps, converged, more)``; ``joins`` is the
    backend's growth of one block of rows (``ell_joins``)."""
    state = cone_start(sel_dr, e_u, e_v, e_w_old, e_w_new, cell_limit)
    if jump_budget is None:
        done = 0
        while done < max_jumps and da.sync_flag(state[5]):
            todo = min(JUMP_CHUNK, max_jumps - done)
            state = cone_run(state, sel_dr, joins, todo, max_jumps, cell_limit, row_block)
            done += todo
        more = torch.zeros((), dtype=torch.bool, device=sel_dr.device)
    else:
        state = cone_run(state, sel_dr, joins, min(jump_budget, max_jumps), max_jumps,
                         cell_limit, row_block)
        more = state[5]
    cone, rows, cells, _grew, jumps, _go = state
    return cone, rows, cells, jumps, cone_converged(state, cell_limit), more


def _blocked(overloaded, v, t_ids) -> torch.Tensor:
    """``[B, *v.shape]`` bool: edge toward ``v`` is transit-blocked for
    the row's destination."""
    shape = (1,) * v.dim()
    return overloaded[v.long()][None] & (
        v[None] != t_ids.view(-1, *shape)
    )


def _nh_counts(dr, bands, v_t, w_t, overloaded, t_ids) -> torch.Tensor:
    """Per-node ECMP next-hop slot counts [B, n_pad]: route selection
    for every source, against its own destination row. Band by band, so
    the [B, rows, k] temporaries of one band are alive at a time."""
    out = torch.zeros_like(dr)
    pos = 0
    for band, v_b, w_b in zip(bands, v_t, w_t):
        w_eff = torch.where(
            _blocked(overloaded, v_b, t_ids), INF, w_b[None]
        )
        total = (dr[:, v_b.long()] + w_eff).clamp_max_(INF)  # [B, rows, k]
        d_row = dr[:, pos : pos + band.rows]  # [B, rows]
        cond = (
            (total == d_row[:, :, None])
            & (d_row < INF)[:, :, None]
            & (w_b < INF)[None]
        )
        out[:, pos : pos + band.rows] = cond.sum(2, dtype=torch.int32)
        pos += band.rows
    return out


def canonical_pos_weights(graph) -> np.ndarray:
    """Per-column digest weights keyed by CANONICAL (name-rank) node
    order, so two graphs over the same node set give comparable digests
    whatever their internal renumbering. Padding columns get weight 0."""
    n_pad = graph.n_pad
    order = np.argsort(np.asarray(graph.node_names))
    ranks = np.empty(len(order), dtype=np.uint32)
    ranks[order] = np.arange(len(order), dtype=np.uint32)
    pos = np.zeros(n_pad, dtype=np.uint32)
    with np.errstate(over="ignore"):
        pos[: len(ranks)] = (
            ranks * _DIGEST_MULT_C + np.uint32(1)
        ) * _DIGEST_POS_A ^ _DIGEST_POS_B
    return pos


def _mul_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 tensors holding values in
    [0, 2^32), without int64 overflow: ``b`` is split into 16-bit
    halves, so each partial product stays below 2^48."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _digest_rows(dr, nh_count, pos_w) -> torch.Tensor:
    """Position-sensitive uint32 fold of (distance, nh count) per row,
    as int64 values in [0, 2^32). ``pos_w`` carries the canonical column
    weights (int64 in [0, 2^32))."""
    # dr <= INF < 2^30, so dr * MULT_D < 2^62 needs no split
    v = (dr.long() * int(_DIGEST_MULT_D) + nh_count.long() + _DIGEST_ADD) & _U32
    return _mul_u32(v, pos_w[None]).sum(1) & _U32


def host_digest(
    d_rows: np.ndarray, nh_counts: np.ndarray,
    pos_w: Optional[np.ndarray] = None,
) -> np.ndarray:
    """NumPy replica of the device digest (the oracle for tests). When
    ``pos_w`` is omitted the columns are taken to be in canonical
    name-rank order already."""
    n = d_rows.shape[1]
    with np.errstate(over="ignore"):
        if pos_w is None:
            pos_w = (
                np.arange(n, dtype=np.uint32) * _DIGEST_MULT_C
                + np.uint32(1)
            ) * _DIGEST_POS_A ^ _DIGEST_POS_B
        v = d_rows.astype(np.uint32) * _DIGEST_MULT_D + (
            nh_counts.astype(np.uint32) + np.uint32(_DIGEST_ADD)
        )
        acc = np.zeros(d_rows.shape[0], dtype=np.uint32)
        for j in range(n):
            acc += v[:, j] * pos_w[j]
    return acc


def _sample_stats(dr, samp_ids, samp_v, samp_w, overloaded, t_ids):
    """Metrics and packed next-hop slot masks of the sample nodes:
    ``([B, S] int32, [B, S, K/32] int64 in [0, 2^32))``. K is a multiple
    of 32."""
    w_eff = torch.where(
        _blocked(overloaded, samp_v, t_ids), INF, samp_w[None]
    )
    total = (dr[:, samp_v.long()] + w_eff).clamp_max_(INF)  # [B, S, K]
    d_s = dr[:, samp_ids.long()]  # [B, S]
    cond = (
        (total == d_s[:, :, None])
        & (d_s < INF)[:, :, None]
        & (samp_w < INF)[None]
    )
    b, s, k = cond.shape
    bits = cond.reshape(b, s, k // 32, 32).long()
    shifts = torch.arange(32, dtype=torch.int64, device=dr.device)
    return d_s, (bits << shifts).sum(3)


def _pack_block(digest, nh_count, d_s, packed_mask) -> torch.Tensor:
    """The packed [B, W] int32 block of ``_route_block_body``:
      col 0             digest (uint32 bits)
      col 1             per-destination total ECMP next-hop count
      cols 2 .. 2+S     sample metrics
      cols 2+S ..       sample packed nh masks (uint32 bits)
    decoded by ``_unpack_blocks``, the one other place that knows it."""
    b = d_s.shape[0]
    return torch.cat(
        [
            _as_int32_bits(digest)[:, None],
            nh_count.sum(1, dtype=torch.int32)[:, None],
            d_s,
            _as_int32_bits(packed_mask).reshape(b, -1),
        ],
        dim=1,
    )


def _route_block_body(v_t, w_t, overloaded, t_ids, samp_ids, samp_v,
                      samp_w, pos_w, bands, n, chunk=relax_loop.HOP_CHUNK):
    """Fixed point and on-device route selection for one destination
    block: ``(packed [B, W] int32, relax hops)``. The block costs one
    device -> host transfer of the packed array."""
    dr, hops = _rev_fixed_point(bands, v_t, w_t, overloaded, t_ids, n, chunk=chunk)
    nh_count = _nh_counts(dr, bands, v_t, w_t, overloaded, t_ids)
    digest = _digest_rows(dr, nh_count, pos_w)
    d_s, packed_mask = _sample_stats(
        dr, samp_ids, samp_v, samp_w, overloaded, t_ids
    )
    return _pack_block(digest, nh_count, d_s, packed_mask), hops


def _unpack_blocks(packed: np.ndarray, s: int, kw: int):
    """Decode the ``_route_block_body`` column layout for ``T`` packed
    rows: (digests [T] uint32, nh_totals [T] int32, metrics [T, S]
    int32, masks [T, S, kw] uint32)."""
    t = packed.shape[0]
    return (
        packed[:, 0].view(np.uint32).copy(),
        packed[:, 1].copy(),
        packed[:, 2 : 2 + s].copy(),
        packed[:, 2 + s :].view(np.uint32).reshape(t, s, kw).copy(),
    )


def assemble_result(
    sweeper, packed: np.ndarray, into: "RouteSweepResult" = None
) -> "RouteSweepResult":
    """A RouteSweepResult from a full [n_pad, W] packed array.

    Delta mode (``into=``): ``packed`` is a compacted [m, 1 + W] delta,
    each row a destination id followed by that row's fresh product, and
    the decoded fields are scattered in place into the existing result
    (ids must be in range)."""
    s = len(sweeper.sample_ids)
    kw = sweeper.samp_v.shape[1] // 32
    if into is not None:
        ids = packed[:, 0]
        dg, nt, sm, sk = _unpack_blocks(
            np.ascontiguousarray(packed[:, 1:]), s, kw
        )
        into.digests[ids] = dg
        into.nh_totals[ids] = nt
        into.sample_metrics[ids] = sm
        into.sample_masks[ids] = sk
        return into
    dg, nt, sm, sk = _unpack_blocks(packed, s, kw)
    return RouteSweepResult(
        graph=sweeper.graph,
        sample_names=sweeper.sample_names,
        sample_ids=sweeper.sample_ids,
        samp_v=sweeper.samp_v,
        samp_w=sweeper.samp_w,
        digests=dg,
        nh_totals=nt,
        sample_metrics=sm,
        sample_masks=sk,
    )


def digests_by_name(result: "RouteSweepResult"):
    """Name-keyed canonical digests: the cross-backend comparison view
    (two layouts number nodes differently; names do not)."""
    idx = result.graph.node_index
    return {
        nm: result.digests[idx[nm]] for nm in result.graph.node_names
    }


@dataclass
class RouteSweepResult:
    """Host-side product of a full destination sweep."""

    graph: object  # out-direction graph (its node order names the axes)
    sample_names: Tuple[str, ...]
    sample_ids: np.ndarray  # [S]
    samp_v: np.ndarray  # [S, K] out-edge dst ids (self-pad)
    samp_w: np.ndarray  # [S, K] out-edge metrics (INF pad)
    digests: np.ndarray  # [n_pad] uint32 per-destination route digest
    nh_totals: np.ndarray  # [n_pad] int32 sum of all sources' ECMP fanout
    sample_metrics: np.ndarray  # [n_pad, S] d(sample -> t) for every t
    sample_masks: np.ndarray  # [n_pad, S, K/32] uint32 packed nh slots

    def routes_from(self, sample_name: str) -> Dict[str, Tuple[int, Set[str]]]:
        """Full route table of one sample node, assembled from the
        sweep: destination name -> (metric, ECMP next-hop node names).
        Unreachable destinations and the node itself are omitted."""
        s = self.sample_names.index(sample_name)
        names = self.graph.node_names
        sid = int(self.sample_ids[s])
        k = self.samp_v.shape[1]
        slots = np.arange(k)
        words = self.sample_masks[: self.graph.n, s, :]  # [n, K/32]
        bits = (words[:, slots // 32] >> (slots % 32).astype(np.uint32)) & 1
        hop_names = [names[int(v)] for v in self.samp_v[s]]
        out: Dict[str, Tuple[int, Set[str]]] = {}
        for t in range(self.graph.n):
            if t == sid:
                continue
            metric = int(self.sample_metrics[t, s])
            if metric >= INF:
                continue
            out[names[t]] = (
                metric, {hop_names[x] for x in np.flatnonzero(bits[t])}
            )
        return out


def pack_sample_rows(rows, sample_ids):
    """Pack per-sample (neighbour ids, metrics) rows into one [S, K]
    pair, K padded to a multiple of 32 (the nh masks pack into uint32
    words; ``RouteSweepResult.routes_from`` decodes this layout). Shared
    by both sweep backends."""
    k_max = max(1, max(len(v) for v, _ in rows))
    k_pad = max(32, ((k_max + 31) // 32) * 32)
    s = len(rows)
    samp_v = np.zeros((s, k_pad), dtype=np.int32)
    samp_w = np.full((s, k_pad), INF, dtype=np.int32)
    for x, (v, w) in enumerate(rows):
        samp_v[x, : len(v)] = v
        samp_v[x, len(v):] = sample_ids[x]  # inert self-pad
        samp_w[x, : len(w)] = w
    return samp_v, samp_w


def _sample_bands(graph: EllGraph, sample_ids: Sequence[int]):
    """Sample nodes' out-edge rows from the ELL bands, packed."""
    rows = []
    for sid in sample_ids:
        bi, band = _band_of(graph, int(sid))
        r = int(sid) - band.start
        v_row = graph.src[bi][r]
        w_row = graph.w[bi][r]
        keep = w_row < INF
        rows.append((v_row[keep], w_row[keep]))
    return pack_sample_rows(rows, sample_ids)


class RouteSweeper:
    """Resident-band runner of the destination-major route sweep over
    an out-edge ELL graph: the bands go to ``device`` once (None = CUDA;
    raises without it unless the caller asks for the CPU); every block
    is one solve and one small readback. ``block_hops`` records the
    relax hops of every block solved, in order."""

    def __init__(self, graph: EllGraph, sample_names: Sequence[str],
                 device: DeviceLike = None):
        if graph.direction != "out":
            raise ValueError("the route sweep needs an out-edge ELL graph")
        self.device = resolve_device(device)
        up = self._upload
        self.graph = graph
        self.block_hops: List[int] = []
        self.v_t = tuple(up(s) for s in graph.src)
        self.w_t = tuple(up(w) for w in graph.w)
        self.overloaded = up(graph.overloaded)
        self._set_samples(sample_names, _sample_bands(
            graph, [graph.node_index[nm] for nm in sample_names]
        ))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _set_samples(self, sample_names, packed_rows) -> None:
        """The sample nodes, their packed out-edge rows
        (``pack_sample_rows``) and the canonical digest weights, on the
        device. Shared with the grouped sweeper, whose graph gives the
        rows another way."""
        up = self._upload
        self.sample_names = tuple(sample_names)
        self.sample_ids = np.asarray(
            [self.graph.node_index[nm] for nm in self.sample_names],
            dtype=np.int32,
        )
        self.samp_v, self.samp_w = packed_rows
        self._samp_ids_dev = up(self.sample_ids)
        self._samp_v_dev = up(self.samp_v)
        self._samp_w_dev = up(self.samp_w)
        self._pos_w_dev = up(
            canonical_pos_weights(self.graph).astype(np.int64)
        )

    def solve_block(self, t_ids) -> torch.Tensor:
        """One destination block -> packed [B, W] int32, still on the
        device (the caller reads it back)."""
        impl = _ell_impl_for(self.graph.n_pad, max(b.k for b in self.graph.bands),
                             self.device)
        with autotune.using("ell_relax", impl):
            packed, hops = _route_block_body(
                self.v_t, self.w_t, self.overloaded,
                _as_device_ids(t_ids, self.device),
                self._samp_ids_dev, self._samp_v_dev, self._samp_w_dev,
                self._pos_w_dev, self.graph.bands, self.graph.n_pad,
                relax_loop.chunk_for(self.block_hops[-1] if self.block_hops else 0),
            )
        self.block_hops.append(hops)
        return packed

    def sweep(self, block: int = 1024) -> RouteSweepResult:
        """Every destination, ``block`` at a time; the last block is
        padded by repeating its last id, so every block has one shape."""
        n = self.graph.n_pad
        s = len(self.sample_ids)
        kw = self.samp_v.shape[1] // 32
        digests = np.zeros(n, dtype=np.uint32)
        nh_totals = np.zeros(n, dtype=np.int32)
        sample_metrics = np.zeros((n, s), dtype=np.int32)
        sample_masks = np.zeros((n, s, kw), dtype=np.uint32)
        id_blocks = []
        for start in range(0, n, block):
            ids = np.arange(start, min(start + block, n), dtype=np.int32)
            if len(ids) < block:
                ids = np.concatenate(
                    [ids, np.full(block - len(ids), ids[-1], np.int32)]
                )
            id_blocks.append((start, _as_device_ids(ids, self.device)))
        for start, ids in id_blocks:
            packed = da.reap_read(da.kick_async(self.solve_block(ids)))
            take = min(block, n - start)
            dg, nt, sm, sk = _unpack_blocks(packed[:take], s, kw)
            digests[start : start + take] = dg
            nh_totals[start : start + take] = nt
            sample_metrics[start : start + take] = sm
            sample_masks[start : start + take] = sk
        return RouteSweepResult(
            graph=self.graph,
            sample_names=self.sample_names,
            sample_ids=self.sample_ids,
            samp_v=self.samp_v,
            samp_w=self.samp_w,
            digests=digests,
            nh_totals=nh_totals,
            sample_metrics=sample_metrics,
            sample_masks=sample_masks,
        )


def all_sources_route_sweep(
    ls, sample_names: Sequence[str], block: int = 1024,
    device: DeviceLike = None,
) -> RouteSweepResult:
    """Compile the out-ELL from a LinkState and run the full destination
    sweep with route selection on ``device`` (None = CUDA)."""
    graph = compile_out_ell(ls)
    return RouteSweeper(graph, sample_names, device=device).sweep(block=block)
