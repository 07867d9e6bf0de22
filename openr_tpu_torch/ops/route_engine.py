"""Incremental destination-major route sweep: churn re-solves only the
affected destinations, on the card.

Port note: the port of ``openr_tpu/ops/route_engine.py``'s single-device
engines. Ported: ``_pack_product``, ``_full_resident_sweep``,
``_detect_rows``, ``_increase_rows``, ``_resolve_and_pack``,
``_compact_changed_body``, ``_churn_step``, ``_frontier_probe``,
``_frontier_step``, ``_overflow_chain``, ``PendingDelta``,
``_Speculation``, ``RouteSweepEngine`` (cold build, bucket-retry ladder,
full-width refresh, frontier probe/step, fused overflow chain, deferred
consume, coalesced windows, speculation, pipelined bursts with their
snapshot and rollback, and the supervised ladder warm -> recover -> cold
-> host) and the grouped engine (``_grouped_full_resident``,
``_patch_segments``, ``_grouped_churn_step``, ``_grouped_frontier_probe``,
``_grouped_frontier_step``, ``_grouped_overflow_chain``,
``GroupedRouteSweepEngine``), and the tenant plane's epilogue
(``compact_rows_with_ids``, the fused ``world_dispatch`` that
``ops.world_batch`` runs). The reference's jitted bodies are
dispatched where the reference dispatches them: through the executable
cache (``ops/aot_cache.py``: a captured CUDA graph on the card), by
``spf_sparse.ell_dispatch`` for the ELL engine and ``aot_call`` for the
grouped one. Every relax goes through the hand-written kernels
(``rev_band_relax``; ``batched_minplus``/``_t`` for the grouped engine,
named by ``impl`` as ``GroupedRouteSweeper`` takes it), and detection,
cone expansion, scatter, extraction and compaction are torch ops.
Full-width extraction runs over blocks of ``route_sweep.ROW_BLOCK``
destination rows, bit-identical to one pass.

A body never syncs with the host: its fixed points run a budget of hops
(``relax_loop``) and the bucketed step's cone a budget of jumps
(``route_sweep.expand_cone``), and it reports ``[hops, converged, more
jumps]`` in the meta row the event reads back anyway (a bucket's row 0,
the overflow chain's policy row) or in a 3-int status beside its product.
A body whose budget ran out is never committed: the host re-dispatches it
with a larger budget (``_budgets``, kept per body, so a warm engine does
not retry), as the bucket-retry ladder re-dispatches a larger bucket. The
full-width cone (``_frontier_probe``, ahead of the overflow chain) runs
``_CONE_CHUNK`` jumps a dispatch and resumes from its state until its
flag drops: a full-width jump is dear, and none runs past the
expansion's end. A warm bucketed event so holds the reference's
contract: one submit run and one read run, and deferred, no blocking
sync.

Left out, each waiting on its item of ROADMAP Queue 1: the sharded bodies
and the ``mesh=`` argument (item 10: the constructor refuses a mesh), the
integrity and state hooks (``audit_*``, ``quarantine``, ``integrity_heal``,
``corrupt_resident``, ``snapshot_resident_state``/
``rehydrate_resident_state``, the ``device.corrupt_resident`` seam and the
auditor registration: item 9).

Nothing resident is changed in place before an event commits: every
dispatch returns fresh tensors (out-of-place ``index_copy``/``index_put``)
and every commit rebinds them. The bucket-retry ladder re-dispatches a
larger bucket against the same untouched ``DR``, digests and packed
product, and a staged speculation is valid only while ``self._dr is
spec.dr_ref``.

The destination-major orientation makes incrementality exact: row t of
``DR`` is an independent single-destination problem (reverse SPF to t),
so re-solving any subset of rows from scratch is correct whatever
changed. Per churn event:

1. host: diff the changed directed edges ``{(u, v): w_old -> w_new}`` and
   overload flips against the resident raw-weight mirrors;
2. device: detect the affected rows against the resident ``DR`` (an edge
   that was tight in the old graph, or ties or improves in the new one),
   scatter the patched band rows, re-solve the affected rows from a warm
   seed (the increase cone reset), extract their route product and
   scatter it into the resident state;
3. readback: the fresh product rows are diffed bit for bit against the
   resident packed product and compacted on the card, so only the rows
   that changed cross to the host, with a 2-int meta row;
4. consume: the compacted readback stays in flight (a pinned copy and an
   event); the host applies event k's delta while event k+1 dispatches
   (``defer_consume=True`` hands the caller the ``PendingDelta``).

An affected count past the largest bucket takes the overflow policy:
the frontier re-solve (the increase cone's cells reset, everything else
kept warm) when the cone converged within ``frontier_threshold`` of the
``[n, n]`` product, else the full-width refresh; neither recompiles the
layout on the host. Only node add/remove (and, in the grouped engine, a
new adjacency) cold-rebuilds.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from openr_tpu_torch.analysis.annotations import (
    committed_dispatch,
    fault_boundary,
    mirrored_by,
    requires_drain,
    resident_buffers,
    solve_window,
)
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.faults.injector import (
    DeviceLostError,
    FaultInjected,
    fault_point,
    is_device_loss,
    register_fault_site,
)
from openr_tpu_torch.faults.supervisor import DegradationSupervisor
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops import host_sweep, relax_loop
from openr_tpu_torch.ops import route_sweep as rs
from openr_tpu_torch.ops import spf_grouped as sg
from openr_tpu_torch.ops.aot_cache import aot_call
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.ops.spf_sparse import (
    TornStateError,
    _out_edges,
    _tenant_view_solve,
    band_patch_inputs,
    compile_ell,
    ell_dispatch,
    ell_patch,
)
from openr_tpu_torch.ops.staging import UploadStager
from openr_tpu_torch.telemetry import get_flight_recorder, get_registry, get_tracer

# degradation-ladder injection sites (armable by name; see
# faults.injector)
FAULT_DISPATCH = register_fault_site("route_engine.dispatch")
FAULT_CONSUME = register_fault_site("route_engine.consume")
FAULT_COLD_BUILD = register_fault_site("route_engine.cold_build")
FAULT_FRONTIER = register_fault_site("route_engine.frontier_resolve")
# the card itself dying under the residents: fires at the dispatch and
# consume crossings, recognised by faults.is_device_loss, recovered by the
# ladder's recover rung (_device_recover)
FAULT_DEVICE_LOST = register_fault_site("device.lost")

ENGINE_MAX_NODES = 12288  # the KSP2 engine's residency envelope
# affected-row solve buckets: the dispatch runs at the hint bucket and
# RETRIES at a larger one on overflow (nothing commits until the count
# fits, so a retry re-detects against the untouched resident state);
# past the largest bucket the event takes the overflow policy
_ROW_BUCKETS = (32, 128, 512, 1024)
# frontier cone-expansion jump cap: past it the bucketed seed degrades to
# the whole-row reset and the overflow path to the full-width refresh,
# both still bit-identical (the cap only ever coarsens the reset)
_FRONTIER_MAX_JUMPS = 16
# cone jumps the bucketed step's first dispatch runs (doubled, up to the
# cap, for a step whose expansion was still going; the engine keeps the
# larger one)
_JUMP_BUDGET = 4
# cone jumps a full-width probe dispatch runs between two reads of its
# flag, after a first dispatch of the seed alone (many overflow events
# expand no jump): a full-width jump costs far more than the read and the
# replay, and a jump run past the expansion's end is wasted work (on an
# H100 at 10 000 nodes, one jump a dispatch took frontier events about
# 30 ms under two)
_CONE_CHUNK = 1
# fraction of the [n, n] product past which a converged frontier still
# takes the full-width refresh (constructor-overridable)
_DEFAULT_FRONTIER_THRESHOLD = 0.5


def _recoverable(exc: BaseException) -> bool:
    """Whether a failure may walk the engine's ladder (or degrade a
    frontier, speculation or burst within its rung): an injected fault, a
    lost device, stale or torn resident state. Anything else (a kernel's
    build or launch error, out of memory) propagates."""
    return isinstance(
        exc, (FaultInjected, DeviceLostError, _DeviceStateInvalid, TornStateError)
    )


def _extract(dr, nh_fn, overloaded, t_ids, samp_ids, samp_v, samp_w, pos_w):
    """The route product of rows ``dr`` (destinations ``t_ids``):
    ``(digests, packed [B, W])``, over blocks of ``rs.ROW_BLOCK`` rows so
    the next-hop gathers of a full-width product stay bounded.
    ``nh_fn(rows, t)`` is the backend's next-hop count."""
    digs, packs = [], []
    for a in range(0, dr.shape[0], rs.ROW_BLOCK):
        rows = dr[a : a + rs.ROW_BLOCK]
        t = t_ids[a : a + rs.ROW_BLOCK]
        nh_count = nh_fn(rows, t)
        d_s, packed_mask = rs._sample_stats(rows, samp_ids, samp_v, samp_w, overloaded, t)
        dg, pk = _pack_product(rows, nh_count, d_s, packed_mask, pos_w)
        digs.append(dg)
        packs.append(pk)
    if len(digs) == 1:
        return digs[0], packs[0]
    return torch.cat(digs), torch.cat(packs)


def _pack_product(dr, nh_count, d_s, packed_mask, pos_w):
    """The ONE packing site of the engine's per-row route product:
    [digest, nh_total, sample metrics, sample masks], shared by every
    cold build and churn dispatch of both backends. Returns (digests,
    packed [B, W])."""
    digests = rs._digest_rows(dr, nh_count, pos_w)
    return digests, rs._pack_block(digests, nh_count, d_s, packed_mask)


def _status_row(hop_status, more=None) -> torch.Tensor:
    """The int32 status ``[hops, converged, more jumps]`` of a budgeted
    body from its fixed point's device ``(hops, converged)`` and its
    cone's ``more`` flag (False without a cone)."""
    hops, ok = hop_status
    if more is None:
        more = torch.zeros((), dtype=torch.bool, device=hops.device)
    return torch.stack([hops.to(torch.int32), ok.to(torch.int32), more.to(torch.int32)])


def _full_resident_sweep(v_t, w_t, overloaded, samp_ids, samp_v, samp_w, pos_w,
                         bands, n, budget):
    """Cold build: solve every destination row (``budget`` hops) and
    extract the route product. Returns (DR, digests, packed, status)."""
    t_ids = torch.arange(n, dtype=torch.int32, device=overloaded.device)
    dr, hs = rs._rev_fixed_point(bands, v_t, w_t, overloaded, t_ids, n, budget=budget)
    digests, packed = _extract(
        dr, lambda rows, t: rs._nh_counts(rows, bands, v_t, w_t, overloaded, t),
        overloaded, t_ids, samp_ids, samp_v, samp_w, pos_w,
    )
    return dr, digests, packed, _status_row(hs)


def _first_k(affected: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` indices where ``affected`` holds, in order, padded
    with 0 (``jnp.nonzero(size=k, fill_value=0)``), without a host sync:
    a cumsum gives each affected row its slot, and a scatter into a
    ``[k + 1]`` buffer drops every row past ``k`` into the last slot."""
    pos = affected.cumsum(0) - 1
    dest = torch.where(affected & (pos < k), pos, torch.full_like(pos, k))
    buf = torch.zeros(k + 1, dtype=torch.int32, device=affected.device)
    buf.scatter_(
        0, dest, torch.arange(affected.shape[0], dtype=torch.int32, device=affected.device)
    )
    return buf[:k]


def _detect_rows(dr, e_u, e_v, e_w_old, e_w_new, k, row_start):
    """Affected-row detection against the RESIDENT pre-patch DR. Raw
    weights make the test conservative (coincidental tightness
    over-selects, never under-selects); overload flips arrive as INF
    transitions from the host.

    Old side: the edge was TIGHT. New side is NON-strict: an edge landing
    exactly on the current best creates new equal-cost next hops.

    Returns (count, local row ids [k], global destination ids [k]);
    padding entries repeat the FIRST affected id, so every duplicate
    scatter index writes an identical fresh row."""
    dr_u = dr[:, e_u.long()]  # [rows, E]
    dr_v = dr[:, e_v.long()]
    tight_old = dr_u == (e_w_old[None] + dr_v).clamp_max(INF)
    ties_or_improves_new = (e_w_new[None] + dr_v).clamp_max(INF) <= dr_u
    usable = (e_w_old < INF) | (e_w_new < INF)
    affected = ((tight_old | ties_or_improves_new) & usable[None]).any(1)  # [rows]
    count = affected.sum(dtype=torch.int32)
    local = _first_k(affected, k)
    valid = torch.arange(k, device=dr.device) < count
    local = torch.where(valid, local, local[0])
    return count, local, local + row_start


def _increase_rows(dr, e_u, e_v, e_w_old, e_w_new):
    """Rows whose resident DR may UNDERESTIMATE the post-patch distances:
    some edge whose weight went up was tight under the old row. Every
    other affected row keeps its old row as a sound warm seed."""
    tight_old = dr[:, e_u.long()] == (e_w_old[None] + dr[:, e_v.long()]).clamp_max(INF)
    return (tight_old & (e_w_new > e_w_old)[None]).any(1)


def _resolve_and_pack(solve_rows, nh_counts, overloaded, ids, local_ids, count, dr,
                      digests, packed_res, samp_ids, samp_v, samp_w, pos_w, n, k,
                      more=None):
    """Re-solve the affected rows, extract their route product, and
    scatter fresh rows/digests/product into NEW resident tensors (the
    inputs stay as they were). Returns (dr, digests, packed_res,
    out [k+1, 1+W]):

      out row 0: [affected_count, changed_count, hops, converged, more
        jumps, 0, ...] (the true affected count drives the retry ladder,
        the status the budget's: ``_status_row`` of the solve and of the
        warm seed's cone flag ``more``);
      out rows 1..changed_count: [dest id, product] for the affected rows
        whose packed product CHANGED bit for bit against the resident
        one, compacted in row order; rows past changed_count are zero.

    Detection padding repeats the first affected id; those duplicates
    fall outside the ``arange(k) < count`` live window, so compacted ids
    are unique. ``solve_rows(ids) -> ([k, n], (hops, converged))`` and
    ``nh_counts(rows, ids)`` are the relaxation backend's."""
    rows, hs = solve_rows(ids)
    row_digests, product = _extract(
        rows, nh_counts, overloaded, ids, samp_ids, samp_v, samp_w, pos_w
    )
    lid = local_ids.long()
    prev = packed_res[lid]
    dr = dr.index_copy(0, lid, rows)
    digests = digests.index_copy(0, lid, row_digests)
    live = torch.arange(k, device=dr.device) < count
    changed = live & (product != prev).any(1)
    ch_count = changed.sum(dtype=torch.int32)
    packed_res = packed_res.index_copy(0, lid, product)
    body = torch.cat([ids[:, None], product], dim=1)
    # prefix-sum compaction: changed rows go to 1..ch_count, the rest to
    # the dropped slot k + 1
    pos = changed.cumsum(0)
    dest = torch.where(changed, pos, torch.full_like(pos, k + 1))
    out = torch.zeros((k + 2, body.shape[1]), dtype=torch.int32, device=dr.device)
    out.index_copy_(0, dest, body)
    out = out[: k + 1]
    out[0, 0] = count
    out[0, 1] = ch_count
    out[0, 2:5] = _status_row(hs, more)
    return dr, digests, packed_res, out


def _compact_changed_body(new_packed, prev_packed, n):
    """Full-width delta epilogue: diff the fresh [n_pad, W] packed product
    bit for bit against the resident previous one and compact the
    changed rows to the front, each prefixed by its destination id.
    Returns (changed_count, out [n_pad, 1+W]): the host reads the scalar,
    then ``out[:changed_count]``. Padding destinations (t >= n) are
    masked out."""
    npad = new_packed.shape[0]
    ids = torch.arange(npad, dtype=torch.int32, device=new_packed.device)
    changed = (ids < n) & (new_packed != prev_packed).any(1)
    ch_count = changed.sum(dtype=torch.int32)
    pos = changed.cumsum(0) - 1
    dest = torch.where(changed, pos, torch.full_like(pos, npad))
    body = torch.cat([ids[:, None], new_packed], dim=1)
    out = torch.zeros((npad + 1, body.shape[1]), dtype=torch.int32, device=new_packed.device)
    out.index_copy_(0, dest, body)
    return ch_count, out[:npad]


def compact_rows_with_ids(new_packed, prev_packed, cap: int):
    """Tenant-batched delta epilogue (consumed by ops.world_batch, and
    fused into ``world_dispatch`` below so it rides the same body as the
    solve it diffs; the reference's traced ``_compact_rows_with_ids``):
    diff a [B, R, N] packed block bit for bit against the resident
    previous one and compact the changed rows to the front, each prefixed
    by a [tenant, row] id column pair, so one readback fans back out to B
    per-tenant host mirrors. Returns ``(changed_count, out [cap+1,
    2+N])``: the host reads the scalar, then ``out[:changed_count]``;
    when the delta overflows ``cap`` the caller falls back to a
    full-block readback (counted, never silent). Row ``cap`` is the
    overflow slot: the reference leaves it unspecified, the port zero."""
    bsz, rows, n = new_packed.shape
    dev = new_packed.device
    changed = (new_packed != prev_packed).any(dim=2).reshape(-1)
    ch_count = changed.sum(dtype=torch.int32)
    flat = new_packed.reshape(bsz * rows, n)
    ids = torch.arange(bsz * rows, dtype=torch.int32, device=dev)
    body = torch.cat([(ids // rows)[:, None], (ids % rows)[:, None], flat], dim=1)
    pos = changed.cumsum(0) - 1
    # unchanged rows and overflow positions (>= cap) land in a spare row
    # past the result, which is dropped (the reference's mode="drop")
    dest = torch.where(changed & (pos < cap), pos, torch.full_like(pos, cap + 1))
    out = torch.zeros((cap + 2, 2 + n), dtype=torch.int32, device=dev)
    out.index_copy_(0, dest, body)
    return ch_count, out[: cap + 1]


def world_dispatch(src, w, ov, srcs, p_rows, p_src, p_w, inc_t, inc_h, inc_w,
                   d_prev, packed_prev, cap, budget=None):
    """The fused per-bucket tenant dispatch: patch scatter + batched view
    solve (``spf_sparse._tenant_view_solve``) + tenant-id delta compaction
    against the resident previous block, one body a shape bucket and
    churn round (one captured graph on the card, through
    ``spf_sparse.ell_dispatch``). Returns ``(packed, d, src, w,
    changed_count, out)`` and, with a hop ``budget``, the solve's device
    status ``[hops, converged]`` last: the first four rebind as the
    bucket's new resident block (the inputs are not changed: the overflow
    fallback, a budget re-dispatch and rehydration re-read them), the
    next two drive the compacted readback as ``compact_rows_with_ids``
    says."""
    res = _tenant_view_solve(src, w, ov, srcs, p_rows, p_src, p_w,
                             inc_t, inc_h, inc_w, d_prev, budget=budget)
    packed = res[0]
    ch_count, out = compact_rows_with_ids(packed, packed_prev, cap)
    return (*res[:4], ch_count, out, *res[4:])


def _pad_pow2(t: torch.Tensor, least: int = 8) -> torch.Tensor:
    """``t`` [m, ...] grown to a power of two of rows (at least ``least``)
    by repeating its first row: a scatter of repeated rows with equal
    values writes the same result, and the padded lengths bound the
    executable cache's keys (a key a distinct patch length otherwise)."""
    m = t.shape[0]
    size = least
    while size < m:
        size *= 2
    if size == m or m == 0:
        return t
    return torch.cat([t, t[:1].expand(size - m, *t.shape[1:])])


def _patch_bands(v_t, w_t, patch_ids_t, patch_v_t, patch_w_t):
    """The patched band rows scattered into NEW band tensors; a band with
    nothing to scatter (None) is passed through."""
    new_v, new_w = [], []
    for v, w, ids, pv, pw in zip(v_t, w_t, patch_ids_t, patch_v_t, patch_w_t):
        if ids is None:
            new_v.append(v)
            new_w.append(w)
            continue
        idx = ids.long()
        new_v.append(v.index_copy(0, idx, pv))
        new_w.append(w.index_copy(0, idx, pw))
    return tuple(new_v), tuple(new_w)


def _meta_row(rows, cells, jumps, ok, status):
    """The float32 policy row ``[rows, cells, jumps, converged]`` and the
    body's ``status`` (``_status_row``) after it (float32: the cell count
    already is; hops and jumps are exact in it)."""
    return torch.cat([
        torch.stack([rows.to(torch.float32), cells, jumps.to(torch.float32),
                     ok.to(torch.float32)]),
        status.to(torch.float32),
    ])


def _churn_step(v_t, w_t, patch_ids_t, patch_v_t, patch_w_t, dr, digests, packed_res,
                e_u, e_v, e_w_old, e_w_new, overloaded_new, samp_ids, samp_v, samp_w,
                pos_w, bands, n, k, budget, jumps):
    """The incremental dispatch: detection against the resident DR, band
    row patch, affected-row re-solve (``budget`` hops; the warm seed's
    cone ``jumps``) and extraction. The resident inputs are never written:
    the retry ladder re-dispatches at a larger bucket or budget against
    the same tensors. Returns (new_v, new_w, dr, digests, packed_res,
    out)."""
    count, local_ids, ids = _detect_rows(dr, e_u, e_v, e_w_old, e_w_new, k, 0)
    # warm seed: pre-patch rows with the increase-affected cone reset
    # cell by cell (rs._cone_expand over the pre-patch bands); past the
    # jump cap the cone under-approximates and the seed degrades to the
    # whole-row reset. Either way the re-solve is bit-identical.
    sel = dr[local_ids.long()]
    cone, _rows, _cells, _jumps, cone_ok, more = rs._cone_expand(
        sel, bands, v_t, w_t, e_u, e_v, e_w_old, e_w_new, _FRONTIER_MAX_JUMPS,
        jump_budget=jumps,
    )
    inc_row = _increase_rows(dr, e_u, e_v, e_w_old, e_w_new)
    warm0 = torch.where(
        cone_ok,
        torch.where(cone, INF, sel),
        torch.where(inc_row[local_ids.long()][:, None], INF, sel),
    )
    new_v, new_w = _patch_bands(v_t, w_t, patch_ids_t, patch_v_t, patch_w_t)
    dr, digests, packed_res, out = _resolve_and_pack(
        lambda t: rs._rev_fixed_point(bands, new_v, new_w, overloaded_new, t, n, init=warm0,
                                      budget=budget),
        lambda rows, t: rs._nh_counts(rows, bands, new_v, new_w, overloaded_new, t),
        overloaded_new, ids, local_ids, count,
        dr, digests, packed_res, samp_ids, samp_v, samp_w, pos_w, n, k, more,
    )
    return new_v, new_w, dr, digests, packed_res, out


def _probe_meta(state, cell_limit):
    """The float32 policy row of a probe chunk's state (``_meta_row``),
    its status ``[1, 1, go]``: whether the expansion goes on."""
    _cone, rows, cells, _grew, jumps, go = state
    ones = torch.ones((), dtype=torch.int32, device=cells.device)
    return _meta_row(rows, cells, jumps, rs.cone_converged(state, cell_limit),
                     _status_row((ones, ones), go))


def _frontier_probe(v_t, w_t, dr, e_u, e_v, e_w_old, e_w_new, cell_limit, state, bands, n,
                    max_jumps, jumps):
    """``jumps`` jumps of the increase-affected cone over the full
    resident DR and the PRE-patch bands, from its seed (``state`` None) or
    from the ``state`` of the previous chunk; returns the new state
    (``route_sweep.cone_start``'s six tensors) and its meta row
    (``_probe_meta``). ``cell_limit`` is a float32 device tensor of shape
    [1]; the expansion stops once the cone overflows it."""
    if state is None:
        state = rs.cone_start(dr, e_u, e_v, e_w_old, e_w_new, cell_limit[0])
    state = rs.cone_run(state, dr, rs.ell_joins(bands, v_t, w_t), jumps, max_jumps,
                        cell_limit[0])
    return (*state, _probe_meta(state, cell_limit[0]))


def _frontier_step(v_t, w_t, cone, dr, overloaded, samp_ids, samp_v, samp_w, pos_w,
                   bands, n, budget):
    """Full-width WARM fixed point (``budget`` hops) over the PATCHED
    bands, seeded from the resident DR with only the cone cells reset to
    INF; the same extraction as the cold build. Returns (dr, digests,
    packed, status)."""
    t_ids = torch.arange(n, dtype=torch.int32, device=dr.device)
    warm0 = torch.where(cone, INF, dr)
    dr2, hs = rs._rev_fixed_point(bands, v_t, w_t, overloaded, t_ids, n, init=warm0,
                                  budget=budget)
    digests, packed = _extract(
        dr2, lambda rows, t: rs._nh_counts(rows, bands, v_t, w_t, overloaded, t),
        overloaded, t_ids, samp_ids, samp_v, samp_w, pos_w,
    )
    return dr2, digests, packed, _status_row(hs)


def _overflow_chain(v_new_t, w_new_t, dr, packed_res, cone, rows, cells, grew, jumps, go,
                    cell_limit, overloaded_new, samp_ids, samp_v, samp_w, pos_w, bands, n,
                    n_real, budget):
    """The overflow decision chain with the policy decided on the card,
    from the probe's cone state (``_frontier_probe``, pre-patch tensors):
    frontier-vs-full-width seed select (the full-width refresh is the
    frontier re-solve with an all-True cone), warm re-solve over the
    patched tensors (``budget`` hops), extraction and delta compaction.
    Returns (dr, digests, packed, ch_count, comp, meta): the meta row
    (``_meta_row``) carries the policy's counters and the body's
    status."""
    state = (cone, rows, cells, grew, jumps, go)
    ok = rs.cone_converged(state, cell_limit[0])
    use_frontier = ok & (cells <= cell_limit[0])
    eff_cone = cone | ~use_frontier
    t_ids = torch.arange(n, dtype=torch.int32, device=dr.device)
    warm0 = torch.where(eff_cone, INF, dr)
    del eff_cone
    dr2, hs = rs._rev_fixed_point(
        bands, v_new_t, w_new_t, overloaded_new, t_ids, n, init=warm0, budget=budget
    )
    del warm0
    meta = _meta_row(rows, cells, jumps, ok, _status_row(hs))
    digests, packed = _extract(
        dr2, lambda r, t: rs._nh_counts(r, bands, v_new_t, w_new_t, overloaded_new, t),
        overloaded_new, t_ids, samp_ids, samp_v, samp_w, pos_w,
    )
    ch_count, comp = _compact_changed_body(packed, packed_res, n_real)
    return dr2, digests, packed, ch_count, comp, meta


class _DeviceStateInvalid(RuntimeError):
    """The resident device state is stale (a host fallback bypassed it):
    the warm rung refuses to run and the ladder walks to the cold
    rebuild, which rederives everything."""


class PendingDelta:
    """Handle to ONE churn event's in-flight delta-compacted readback.

    The device state is already committed when the handle exists; only
    the HOST mirror (engine.result) lags until the delta is consumed.
    ``wait()`` consumes it (through the engine, which owns the order) and
    returns the sorted moved destination names. The changed rows' copy
    (and a full-width event's count, and a fused overflow chain's meta
    row) is kicked at creation (``da.kick_async``: a pinned copy and a
    CUDA event), so the consume normally finds the bytes landed. A fused
    overflow chain's meta row crossed before the commit (it carries the
    body's status); its policy counters are settled at consume time."""

    __slots__ = (
        "_engine", "segs", "counts", "ch_counts", "k", "dslices",
        "fw_count", "consumed", "names", "delta_rows",
        "readback_bytes", "overlap_ms", "meta_host", "meta_limit",
    )

    def __init__(self, engine, segs, counts, ch_counts, k,
                 fw_count=None, meta_host=None, meta_limit=0.0):
        self._engine = engine
        self.segs = segs          # device [k+1, 1+W] (or [n_pad, 1+W]) arrays
        self.counts = counts      # affected counts
        self.ch_counts = ch_counts  # CHANGED counts (None: full width)
        self.k = k
        self.consumed = False
        self.names: List[str] = []
        self.delta_rows = 0
        self.readback_bytes = 0
        self.overlap_ms = 0.0
        self.dslices = [
            da.kick_async(seg[1 : 1 + m]) if m else None
            for seg, m in zip(segs, ch_counts)
        ]
        # full-width mode: the segment's changed rows start at row 0 and
        # their count has not crossed yet; it is kicked now and reaped at
        # consume time
        self.fw_count = da.kick_async(fw_count) if fw_count is not None else None
        # fused-overflow-chain mode: the chain's meta row (read before the
        # commit, for its status) is classified at consume time
        self.meta_host = meta_host
        self.meta_limit = meta_limit

    def wait(self) -> List[str]:
        if not self.consumed:
            self._engine.flush()
        return self.names


class _Speculation:
    """One staged speculative churn dispatch. Everything here is the
    FUNCTIONAL output of _run_bucket (residents are never written), so
    cancelling is dropping this object. ``dr_ref`` pins the exact
    resident DR the dispatch read; every commit rebinds ``_dr``, so an
    identity mismatch at adoption means another event committed
    underneath and the speculation MUST cancel."""

    __slots__ = (
        "union", "version", "aversion", "dr_ref", "ctx", "segments",
        "counts", "ch_counts", "commit_state", "ov_new", "k",
        "new_out", "ov_flips", "structural",
    )


@mirrored_by(
    _dr="re-derived from the LinkState (_build) or the resident band "
        "tensors (_device_recover)",
    _digests_dev="result.digests (delta-applied on every consume)",
    _packed_dev="_packed_host (settle-on-success row scatter)",
)
@resident_buffers("_dr", "_digests_dev", "_packed_dev")
class RouteSweepEngine:
    """Resident incremental network-wide route product on ``device``
    (None = CUDA; raises without it unless the caller asks for the CPU).

    cold build at construction -> ``self.result`` (RouteSweepResult);
    ``churn(ls, affected_nodes)`` -> the sorted moved destination names
    (their rows refreshed in ``self.result``), or None when a deeper
    ladder rung or a cold rebuild answered. Every event class reads back
    only the rows whose packed product changed. ``defer_consume=True``
    returns a PendingDelta instead; ``flush()`` drains it.
    ``churn_coalesced``/``churn_window`` fold a debounce window into one
    dispatch, ``speculate_churn`` stages one ahead of the window, and
    ``churn_burst`` pipelines several windows."""

    def __init__(self, ls, sample_names: Sequence[str], align: int = 128,
                 mesh=None,
                 frontier_threshold: float = _DEFAULT_FRONTIER_THRESHOLD,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "route engine mesh=: the sharded engine is not ported yet "
                "(ROADMAP Queue 1 item 10, multi-device)"
            )
        self.device = resolve_device(device)
        self.sample_names = tuple(sample_names)
        self.mesh = None
        self._align = align
        self._k_hint = _ROW_BUCKETS[0]
        self._pending: Optional[PendingDelta] = None
        self._speculation: Optional[_Speculation] = None
        self._stager = UploadStager(self.device)
        get_registry().gauge(
            "ops.pending_delta_inflight",
            lambda: float(self._pending is not None),
        )
        self.last_delta_rows = 0
        self.last_readback_bytes = 0
        self.last_overlap_ms = 0.0
        self.frontier_threshold = float(frontier_threshold)
        self.last_frontier_rows = -1
        self.last_frontier_jumps = -1
        self.last_frontier_cells = -1.0
        # relax hops of every fixed point the engine ran, in order (a
        # caller reads the tail an event added)
        self.hops_log: List[int] = []
        # each body's (hop, cone jump) budget: grown when a dispatch ran
        # out, so a warm engine dispatches each body once
        self._budgets: Dict[str, Tuple[int, int]] = {}
        # the path the last warm event took: "bucket" (with last_k),
        # "frontier", "full_width", "fused_chain", "cold", "attribute"
        self.last_path = "cold"
        self.last_k = 0
        # the detected affected-row count of the last dispatch read (the
        # largest bucket's when the event overflowed)
        self.last_affected = 0
        self._device_valid = False
        self._device_lost = False
        self.host_fallbacks = 0
        self.device_rebuilds = 0
        self._packed_host: Optional[np.ndarray] = None
        self.supervisor = DegradationSupervisor("route_engine")
        self._build(ls)

    def _max_nodes(self) -> int:
        """Residency bound: the resident DR is [n_pad, n_pad] int32, whole
        on one card."""
        return ENGINE_MAX_NODES

    def _buckets(self) -> List[int]:
        """The solve buckets from the hint up; the largest alone when the
        hint passed every bucket (the hint caps at 1024, the largest
        bucket by default: a caller's smaller ladder ends in its own)."""
        return [b for b in _ROW_BUCKETS if b >= self._k_hint] or [_ROW_BUCKETS[-1]]

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- state -------------------------------------------------------------

    def _compile_backend(self, ls):
        """Backend hook: compile the layout and sweeper for a cold build."""
        graph = compile_ell(ls, align=self._align, direction="out")
        return graph, rs.RouteSweeper(graph, self.sample_names, device=self.device)

    # -- committed dispatch --------------------------------------------------

    # the bodies' dispatch tags (the executable cache's keys)
    _TAG_FULL = "ell_full_resident"
    _TAG_BUCKET = "ell_churn_step"
    _TAG_PROBE = "ell_frontier_probe"
    _TAG_STEP = "ell_frontier_step"
    _TAG_CHAIN = "ell_overflow_chain"
    _PROBE_BODY = staticmethod(_frontier_probe)

    def _dispatch(self, tag, fn, dyn_args, statics):
        """Backend hook: one body through the executable cache (the
        sliced-ELL plan variant resolved into its key)."""
        return ell_dispatch(tag, fn, dyn_args, statics)

    def _budget(self, tag: str) -> Tuple[int, int]:
        h, j = self._budgets.get(tag, (relax_loop.HOP_CHUNK, _JUMP_BUDGET))
        return min(h, self.graph.n_pad), j

    def _needs_more(self, tag: str, status) -> bool:
        """Fold one read status ``[hops, converged, more jumps]`` into
        ``tag``'s budgets; True when the body ran out and must be
        re-dispatched (nothing of it is committed)."""
        h, j = self._budget(tag)
        retry = False
        if not int(status[1]):
            h = relax_loop.next_budget(h, self.graph.n_pad)
            retry = True
        if int(status[2]):
            j = min(2 * j, _FRONTIER_MAX_JUMPS)
            retry = True
        if retry:
            self._budgets[tag] = (h, j)
            get_registry().counter_bump("route_engine.budget_retries")
        return retry

    def _run_budgeted(self, tag, fn, dyn_args, statics, at):
        """Dispatch a full-width body until its hop budget held: its output
        ``at`` ends in the 3-int status; it is read (kicked, then reaped:
        one read phase) after each dispatch. Returns ``(outputs, row)``,
        ``row`` the host copy of output ``at``."""
        while True:
            h, _j = self._budget(tag)
            out = self._dispatch(tag, fn, dyn_args, dict(statics, budget=h))
            row = da.reap_read(da.kick_async(out[at]), kicked=True)
            if not self._needs_more(tag, row[-3:]):
                return out, row

    def _probe_statics(self):
        """Backend hook: the statics of the probe body beside its jump
        cap and chunk."""
        return dict(bands=self.graph.bands, n=self.graph.n_pad)

    def _probe_cone(self, e_dev, lim):
        """The increase cone over the full resident DR and the PRE-patch
        tensors: its seed, then ``_CONE_CHUNK`` jumps a dispatch, the flag
        read after each (kicked, then reaped): ``(state, host meta
        row)``."""
        sw = self.sweeper
        state = None
        while True:
            *state, meta = self._dispatch(
                self._TAG_PROBE, self._PROBE_BODY,
                (sw.v_t, sw.w_t, self._dr, *e_dev, lim, state),
                dict(self._probe_statics(), max_jumps=_FRONTIER_MAX_JUMPS,
                     jumps=0 if state is None else _CONE_CHUNK),
            )
            state = tuple(state)
            row = da.reap_read(da.kick_async(meta), kicked=True)
            if not int(row[-1]):
                return state, row

    def _full_resident(self, graph):
        """Backend hook: the cold full-product dispatch (DR and digests
        resident, the packed product back)."""
        sw = self.sweeper
        (dr, digests, packed, _st), row = self._run_budgeted(
            self._TAG_FULL, _full_resident_sweep,
            (sw.v_t, sw.w_t, sw.overloaded, sw._samp_ids_dev, sw._samp_v_dev,
             sw._samp_w_dev, sw._pos_w_dev),
            dict(bands=graph.bands, n=graph.n_pad), at=3,
        )
        self.hops_log.append(int(row[0]))
        return dr, digests, packed

    @requires_drain("flush")
    def _build(self, ls) -> None:
        # a cold rebuild replaces the whole result: drain any in-flight
        # delta first so a caller-held PendingDelta handle resolves
        self.flush()
        # invalid until this build completes: a failure below leaves the
        # engine torn, and the gate forces every later event through
        # another cold build or the host rung
        self._device_valid = False
        self._speculation = None
        graph, sweeper = self._compile_backend(ls)
        if graph.n_pad > self._max_nodes():
            raise ValueError(
                f"route engine residency bound: {graph.n_pad} > "
                f"{self._max_nodes()} (use the block/mesh sweep, or "
                "a larger mesh)"
            )
        self.graph = graph
        self.sweeper = sweeper
        # RAW collapsed min weights of the directed edges, indexed both
        # ways for O(degree) event diffing. Overload flips never touch
        # these mirrors: effective-weight transitions exist only inside
        # one event's detection list.
        self._w_out: Dict[int, Dict[int, int]] = {}
        self._w_in: Dict[int, Dict[int, int]] = {}
        for nm in graph.node_names:
            u = graph.node_index[nm]
            for v, w in _out_edges(ls, nm, graph.node_index).items():
                self._w_out.setdefault(u, {})[v] = w
                self._w_in.setdefault(v, {})[u] = w
        self._ov_host = {nm: ls.is_node_overloaded(nm) for nm in graph.node_names}
        fault_point(FAULT_COLD_BUILD)
        dr, digests, packed = self._full_resident(graph)
        self._dr = dr
        self._digests_dev = digests
        # the packed product stays RESIDENT: every later dispatch diffs
        # its fresh rows against it to compact the readback
        self._packed_dev = packed
        packed_host = da.reap_read(da.kick_async(packed))
        self.result = rs.assemble_result(self.sweeper, packed_host)
        self._packed_host = np.array(packed_host)
        self.version = ls.topology_version
        self.aversion = ls.attributes_version
        self._device_valid = True
        self.last_path = "cold"
        self.cold_builds = getattr(self, "cold_builds", 0) + 1
        self.incremental_events = getattr(self, "incremental_events", 0)
        self.full_refreshes = getattr(self, "full_refreshes", 0)
        self.coalesced_events = getattr(self, "coalesced_events", 0)
        self.structural_events = getattr(self, "structural_events", 0)
        self.frontier_resolves = getattr(self, "frontier_resolves", 0)
        self.frontier_fallbacks = getattr(self, "frontier_fallbacks", 0)
        get_registry().counter_bump("route_engine.cold_builds")
        get_flight_recorder().note("engine", path="cold_build", n=int(graph.n_pad))

    def _set_sample_rows(self, samp_v, samp_w) -> bool:
        sweeper = self.sweeper
        if samp_v.shape != sweeper.samp_v.shape:
            return False
        sweeper.samp_v = self.result.samp_v = samp_v
        sweeper.samp_w = self.result.samp_w = samp_w
        sweeper._samp_v_dev = self._upload(samp_v)
        sweeper._samp_w_dev = self._upload(samp_w)
        return True

    def _refresh_sample_bands(self, patched, affected_nodes) -> bool:
        """A churn event that touched a SAMPLE node's own adjacencies
        changes the slot tables the next-hop masks are computed over:
        refresh them from the PATCHED graph before the dispatch. False
        when the slot-table shape changed (the packed width moves): the
        caller cold-rebuilds, which rederives them."""
        if not (affected_nodes & set(self.sample_names)):
            return True
        return self._set_sample_rows(*rs._sample_bands(patched, self.sweeper.sample_ids))

    # -- events ------------------------------------------------------------

    def _layout_changed(self, ctx) -> bool:
        """Backend hook: did this event change the static band layout?
        Speculation and bursts refuse such events."""
        return ctx["patched"].bands != self.graph.bands

    def _prepare_patch(self, ls, affected_sorted):
        """Backend hook: the patched graph and the device patch tensors of
        one churn event, as a ctx dict, or None when the event breaks the
        layout (the caller cold-rebuilds). A widened band is re-uploaded
        whole (node ids stay, so the resident DR stays valid)."""
        patched = ell_patch(self.graph, ls, affected_sorted, widen=True)
        if patched is None:
            return None
        in_v, in_w, patch_ids, patch_v, patch_w, _ = band_patch_inputs(
            self.sweeper.v_t, self.sweeper.w_t, patched, self._stager
        )

        def pad(ts):
            return tuple(None if t is None else _pad_pow2(t) for t in ts)

        return {
            "patched": patched,
            "in_v": in_v, "in_w": in_w,
            "patch_ids": pad(patch_ids), "patch_v": pad(patch_v), "patch_w": pad(patch_w),
            "patched_bands": None,
        }

    @solve_window
    @committed_dispatch
    def _run_bucket(self, ctx, k, e_dev, ov_new):
        """Backend hook: one detect+solve dispatch at bucket size k.
        Returns (segments, commit_state): segments are in-flight device
        arrays [k+1, 1+W] whose row 0 carries the counts and the status;
        nothing is read back here."""
        fault_point(FAULT_DISPATCH)
        fault_point(FAULT_DEVICE_LOST)
        graph = ctx["patched"]
        sw = self.sweeper
        h, j = self._budget(self._TAG_BUCKET)
        new_v, new_w, dr, digests, packed_res, packed_dev = self._dispatch(
            self._TAG_BUCKET, _churn_step,
            (ctx["in_v"], ctx["in_w"], ctx["patch_ids"], ctx["patch_v"], ctx["patch_w"],
             self._dr, self._digests_dev, self._packed_dev, *e_dev, ov_new,
             sw._samp_ids_dev, sw._samp_v_dev, sw._samp_w_dev, sw._pos_w_dev),
            dict(bands=graph.bands, n=graph.n_pad, k=k, budget=h, jumps=j),
        )
        # the step already patched the bands: an overflow's
        # _apply_patch_resident adopts these
        ctx["patched_bands"] = (new_v, new_w)
        return [packed_dev], (new_v, new_w, dr, digests, packed_res)

    def _dispatch_patch(self, ctx):
        """Backend hook: the standalone band patch."""
        return _patch_bands(
            ctx["in_v"], ctx["in_w"], ctx["patch_ids"], ctx["patch_v"], ctx["patch_w"]
        )

    @solve_window
    def _commit_device(self, ctx, commit_state, ov_new) -> None:
        """Backend hook: adopt the dispatch's device state."""
        new_v, new_w_t, dr, digests, packed_res = commit_state
        self.sweeper.v_t = new_v
        self.sweeper.w_t = new_w_t
        self.sweeper.overloaded = ov_new
        self._dr = dr
        self._digests_dev = digests
        self._packed_dev = packed_res
        self.graph = self.sweeper.graph = ctx["patched"]

    @solve_window
    def _apply_patch_resident(self, ctx, ov_new) -> None:
        """Backend hook: adopt the event's band patch into the resident
        sweeper tensors without a row re-solve (the full-width refresh
        then runs the cold-build-shaped dispatch over them)."""
        if ctx["patched_bands"] is None:
            ctx["patched_bands"] = self._dispatch_patch(ctx)
        new_v, new_w_t = ctx["patched_bands"]
        self.sweeper.v_t = new_v
        self.sweeper.w_t = new_w_t
        self.sweeper.overloaded = ov_new
        self.graph = self.sweeper.graph = ctx["patched"]

    def _commit_host_mirrors(self, ls, new_out, ov_flips) -> None:
        """Fold one committed event's raw-weight diff and overload flips
        into the host mirrors."""
        for u, seen in new_out.items():
            old = self._w_out.get(u, {})
            for v in set(old) - set(seen):
                self._w_in.get(v, {}).pop(u, None)
            self._w_out[u] = dict(seen)
            for v, w in seen.items():
                self._w_in.setdefault(v, {})[u] = w
        for nm in ov_flips:
            self._ov_host[nm] = ls.is_node_overloaded(nm)

    def _full_refresh(self, ls, ctx, ov_new, new_out, ov_flips, defer=False):
        """Overflow path: keep the patched resident layout and re-solve
        every row in the cold-build-shaped dispatch (no host recompile);
        the readback stays delta-compacted."""
        self._apply_patch_resident(ctx, ov_new)
        dr, digests, packed = self._full_resident(self.graph)
        self.full_refreshes += 1
        self.last_path = "full_width"
        get_registry().counter_bump("route_engine.full_refreshes")
        get_flight_recorder().note("engine", path="full_refresh")
        return self._commit_full_width(ls, dr, digests, packed, new_out, ov_flips,
                                       defer=defer)

    def _reap_full_width(self, comp, m: int) -> List[str]:
        names: List[str] = []
        if m:
            names = self._apply_delta_rows(da.reap_read(da.kick_async(comp[:m])))
        bytes_read = m * comp.shape[1] * 4 + 4  # rows + the scalar
        self.last_delta_rows = m
        self.last_readback_bytes = bytes_read
        self.last_overlap_ms = 0.0
        reg = get_registry()
        reg.observe("ops.delta_rows", float(m))
        reg.observe("ops.readback_bytes", float(bytes_read))
        return sorted(names)

    @committed_dispatch
    def _commit_full_width(self, ls, dr, digests, packed, new_out, ov_flips,
                           defer=False):
        """Shared commit tail of the full-width refresh and the frontier
        re-solve: compact the diff on the card and apply only the changed
        rows. With ``defer=True`` the changed count stays in flight
        (PendingDelta full-width mode)."""
        ch_count, comp = aot_call("compact_changed", _compact_changed_body,
                                  (packed, self._packed_dev), dict(n=self.graph.n))
        self._dr = dr
        self._digests_dev = digests
        self._packed_dev = packed
        self._commit_host_mirrors(ls, new_out, ov_flips)
        self.version = ls.topology_version
        self.aversion = ls.attributes_version
        # events are running wide: start the next at the top bucket
        self._k_hint = _ROW_BUCKETS[-1]
        if defer:
            pending = PendingDelta(self, [comp], [-1], [None], int(comp.shape[0]),
                                   fw_count=ch_count)
            self._pending = pending
            return pending
        m = int(da.reap_read(da.kick_async(ch_count), kicked=True))
        return self._reap_full_width(comp, m)

    @solve_window
    def _dispatch_frontier_probe(self, ctx, e_dev, limit):
        """Backend hook: the affected-cone probe against the PRE-patch
        resident tensors (this runs before _apply_patch_resident).
        Returns (cone, the host meta row)."""
        lim = torch.tensor([limit], dtype=torch.float32, device=self.device)
        state, row = self._probe_cone(e_dev, lim)
        return state[0], row

    @solve_window
    def _frontier_resident(self, cone):
        """Backend hook: the masked full-width dispatch over the ALREADY
        patched resident tensors."""
        sw = self.sweeper
        (dr, digests, packed, _st), row = self._run_budgeted(
            self._TAG_STEP, _frontier_step,
            (sw.v_t, sw.w_t, cone, self._dr, sw.overloaded, sw._samp_ids_dev,
             sw._samp_v_dev, sw._samp_w_dev, sw._pos_w_dev),
            dict(bands=self.graph.bands, n=self.graph.n_pad), at=3,
        )
        self.hops_log.append(int(row[0]))
        return dr, digests, packed

    @solve_window
    def _dispatch_overflow_chain(self, ctx, e_dev, ov_new, limit):
        """Backend hook: the overflow decision chain, or None when the
        event WIDENED the band layout (the split probe/branch path takes
        that one). Returns (dr, digests, packed, ch_count, comp, the host
        meta row)."""
        if ctx["patched"].bands != self.graph.bands:
            return None
        if ctx["patched_bands"] is None:
            ctx["patched_bands"] = self._dispatch_patch(ctx)
        new_v, new_w = ctx["patched_bands"]
        lim = torch.tensor([limit], dtype=torch.float32, device=self.device)
        sw = self.sweeper
        state, _probe = self._probe_cone(e_dev, lim)
        (dr, digests, packed, ch_count, comp, _meta), row = self._run_budgeted(
            self._TAG_CHAIN, _overflow_chain,
            (new_v, new_w, self._dr, self._packed_dev, *state, lim, ov_new,
             sw._samp_ids_dev, sw._samp_v_dev, sw._samp_w_dev, sw._pos_w_dev),
            dict(bands=self.graph.bands, n=self.graph.n_pad, n_real=self.graph.n),
            at=5,
        )
        self.hops_log.append(int(row[4]))
        return dr, digests, packed, ch_count, comp, row

    def _note_frontier_meta(self, meta) -> Tuple[int, int, float, bool]:
        reg = get_registry()
        rows, jumps = int(meta[0]), int(meta[2])
        cells = float(meta[1])
        converged = bool(meta[3])
        self.last_frontier_rows = rows
        self.last_frontier_jumps = jumps
        self.last_frontier_cells = cells
        reg.observe("ops.frontier_rows", float(rows))
        reg.observe("ops.frontier_cells", cells)
        reg.observe("ops.frontier_jumps", float(jumps))
        return rows, jumps, cells, converged

    def _note_overflow_meta(self, meta, limit) -> str:
        """Classify a fused overflow chain's reaped probe meta after the
        fact: the SAME float32 compare the card's seed select made, so the
        frontier/full-width counters match the branch it took."""
        reg = get_registry()
        rows, jumps, cells, converged = self._note_frontier_meta(meta)
        if converged and np.float32(cells) <= np.float32(limit):
            self.frontier_resolves += 1
            self.last_path = "frontier"
            reg.counter_bump("route_engine.frontier_resolves")
            get_flight_recorder().note("engine", path="frontier_resolve")
            return "frontier"
        self.frontier_fallbacks += 1
        reg.counter_bump("ops.frontier_fallbacks")
        get_flight_recorder().note("engine", path="frontier_fallback", rows=rows, jumps=jumps)
        self.full_refreshes += 1
        self.last_path = "full_width"
        reg.counter_bump("route_engine.full_refreshes")
        get_flight_recorder().note("engine", path="full_refresh")
        return "full_width"

    def _commit_overflow_chain(self, ls, chain, ctx, ov_new, new_out, ov_flips, limit,
                               defer=False):
        """Commit tail of the overflow chain: adopt the patch and the
        chain product, then reap (or defer) the compacted delta and the
        policy meta (already on the host)."""
        dr, digests, packed, ch_count, comp, meta = chain
        self._apply_patch_resident(ctx, ov_new)
        self._dr = dr
        self._digests_dev = digests
        self._packed_dev = packed
        self._commit_host_mirrors(ls, new_out, ov_flips)
        self.version = ls.topology_version
        self.aversion = ls.attributes_version
        self._k_hint = _ROW_BUCKETS[-1]
        if defer:
            pending = PendingDelta(
                self, [comp], [-1], [None], int(comp.shape[0]),
                fw_count=ch_count, meta_host=meta, meta_limit=limit,
            )
            self._pending = pending
            return pending
        self._note_overflow_meta(meta, limit)
        m = int(da.reap_read(da.kick_async(ch_count), kicked=True))
        return self._reap_full_width(comp, m)

    @committed_dispatch
    def _overflow_refresh(self, ls, ctx, ov_new, new_out, ov_flips, e_dev, defer=False):
        """Overflow policy: the affected-row count exceeded every solve
        bucket. The warm path is the overflow chain (the branch taken on
        the card); an event that widened the band layout takes the split
        probe/branch path instead. A chain or probe failure (an injected
        one) degrades WITHIN the warm rung to the full-width refresh."""
        reg = get_registry()
        tracer = get_tracer()
        span = tracer.span_active("ops.frontier_resolve")
        rows = jumps = -1
        path = "full_width"
        try:
            # budget in CELLS (re-solve work), not rows: a single link
            # down seeds one cell in nearly every destination row
            limit = self.frontier_threshold * float(self.graph.n) ** 2
            chain = None
            widened = False
            try:
                fault_point(FAULT_FRONTIER)
                chain = self._dispatch_overflow_chain(ctx, e_dev, ov_new, limit)
                widened = chain is None
            except Exception as exc:  # noqa: BLE001 - filtered below
                if not _recoverable(exc):
                    raise
                reg.counter_bump("route_engine.frontier_errors")
            if chain is not None:
                path = "fused_chain"
                got = self._commit_overflow_chain(
                    ls, chain, ctx, ov_new, new_out, ov_flips, limit, defer=defer
                )
                rows = self.last_frontier_rows
                jumps = self.last_frontier_jumps
                return got
            if widened:
                probe = None
                try:
                    probe = self._dispatch_frontier_probe(ctx, e_dev, limit)
                except Exception as exc:  # noqa: BLE001 - filtered below
                    if not _recoverable(exc):
                        raise
                    reg.counter_bump("route_engine.frontier_errors")
                if probe is not None:
                    cone, meta = probe
                    rows, jumps, cells, converged = self._note_frontier_meta(meta)
                    if converged and cells <= limit:
                        path = "frontier"
                        return self._frontier_refresh(
                            ls, ctx, ov_new, new_out, ov_flips, cone, defer=defer
                        )
            self.frontier_fallbacks += 1
            reg.counter_bump("ops.frontier_fallbacks")
            get_flight_recorder().note("engine", path="frontier_fallback", rows=rows,
                                       jumps=jumps)
            return self._full_refresh(ls, ctx, ov_new, new_out, ov_flips, defer=defer)
        finally:
            tracer.end_span_active(span, path=path, frontier_rows=rows, frontier_jumps=jumps)

    def _frontier_refresh(self, ls, ctx, ov_new, new_out, ov_flips, cone, defer=False):
        """Frontier path: adopt the band patch resident, then one masked
        dispatch seeds the cone cells at INF while every other cell keeps
        its resident distance; bit-identical to the cold solve by the
        unique fixed point."""
        self._apply_patch_resident(ctx, ov_new)
        dr, digests, packed = self._frontier_resident(cone)
        self.frontier_resolves += 1
        self.last_path = "frontier"
        get_registry().counter_bump("route_engine.frontier_resolves")
        get_flight_recorder().note("engine", path="frontier_resolve")
        return self._commit_full_width(ls, dr, digests, packed, new_out, ov_flips,
                                       defer=defer)

    def flush(self):
        """Consume the in-flight delta, if any. Returns the consumed
        PendingDelta or None."""
        return self._consume_pending(overlap=False)

    def _apply_delta_rows(self, rows: np.ndarray) -> List[str]:
        """Apply one compacted [m, 1+W] readback into the host result,
        returning the touched destination names. O(m)."""
        rows = rows[rows[:, 0] < self.graph.n]
        if not len(rows):
            return []
        if self._packed_host is not None:
            self._packed_host[rows[:, 0]] = rows[:, 1:]
        rs.assemble_result(self.sweeper, rows, into=self.result)
        names = self.graph.node_names
        return [names[int(t)] for t in rows[:, 0]]

    @committed_dispatch
    def _consume_pending(self, overlap: bool):
        """Drain the pending delta: reap its changed rows (O(changed)) and
        apply them in place. With ``overlap`` it runs inside the next
        event's dispatch window (recorded as
        ops.route_engine.overlap_ms)."""
        p = self._pending
        if p is None:
            return None
        self._pending = None
        # a consume failure drops this delta unapplied; every deeper rung
        # reassembles the whole result
        fault_point(FAULT_CONSUME)
        fault_point(FAULT_DEVICE_LOST)
        if overlap:
            da.note_overlapped_reap()
        if p.meta_host is not None:
            self._note_overflow_meta(p.meta_host, p.meta_limit)
            p.meta_host = None
        tracer = get_tracer()
        span = tracer.span_active("ops.route_engine.delta_consume")
        reg = get_registry()
        t0 = time.perf_counter()
        names: List[str] = []
        total_rows = 0
        total_bytes = 0
        for seg, sl, m in zip(p.segs, p.dslices, p.ch_counts):
            if m is None:
                # full-width pending: reap the count, then pull exactly the
                # changed rows (compacted from row 0, no meta row)
                m = int(da.reap_read(p.fw_count, kicked=True))
                total_bytes += 4
                if m:
                    names.extend(self._apply_delta_rows(da.reap_read(da.kick_async(seg[:m]))))
                    total_rows += m
                    total_bytes += m * seg.shape[1] * 4
                continue
            # the meta row already crossed (retry ladder); count it
            total_bytes += seg.shape[1] * 4
            if m:
                names.extend(self._apply_delta_rows(da.reap_read(sl, kicked=True)))
                total_rows += m
                total_bytes += m * seg.shape[1] * 4
        ms = (time.perf_counter() - t0) * 1000.0
        p.names = sorted(set(names))
        p.consumed = True
        p.delta_rows = total_rows
        p.readback_bytes = total_bytes
        p.overlap_ms = ms if overlap else 0.0
        self.last_delta_rows = total_rows
        self.last_readback_bytes = total_bytes
        self.last_overlap_ms = p.overlap_ms
        reg.observe("ops.delta_rows", float(total_rows))
        reg.observe("ops.readback_bytes", float(total_bytes))
        if overlap:
            reg.observe("ops.route_engine.overlap_ms", ms)
        tracer.end_span_active(span, overlap=overlap, delta_rows=total_rows,
                               readback_bytes=total_bytes)
        return p

    def churn_coalesced(self, ls, affected_sets, defer_consume=False):
        """Fold N patches of one debounce window into ONE dispatch and ONE
        compacted readback; equal to N sequential churn() calls (the
        event diff compares the CURRENT LinkState against the resident
        mirrors, so the union describes the net effect)."""
        union: Set[str] = set()
        for s in affected_sets:
            union |= set(s)
        if len(affected_sets) > 1:
            self.coalesced_events += 1
            get_registry().counter_bump("route_engine.coalesced_events")
        return self.churn(ls, union, defer_consume=defer_consume)

    def churn_window(self, ls, affected_sets, defer_consume=False):
        """One debounce window as one accounting window
        (``ops.host_touches.churn_window``), bit-identical to N
        sequential ``churn()`` calls. A staged speculation that matches
        the window's final composition (same union, same LinkState
        versions, residents untouched since staging) is ADOPTED
        (ops.spec_hits); any mismatch cancels it (ops.spec_cancels) and
        the committed path re-dispatches from the unchanged residents."""
        union: Set[str] = set()
        for s in affected_sets:
            union |= set(s)
        spec = self._speculation
        self._speculation = None
        if spec is not None:
            if (
                spec.union == frozenset(union)
                and spec.version == ls.topology_version
                and spec.aversion == ls.attributes_version
                and spec.dr_ref is self._dr
                and self._device_valid
            ):
                return self._adopt_speculation(ls, spec, affected_sets, defer_consume)
            get_registry().counter_bump("ops.spec_cancels")
            get_flight_recorder().note("engine", path="spec_cancel")
        with da.event_window("churn_window"):
            return self.churn_coalesced(ls, affected_sets, defer_consume=defer_consume)

    def _stage_metas(self, segments):
        """Kick every segment's 20-byte meta row [affected, changed, hops,
        converged, more jumps]."""
        return [da.kick_async(seg[0, :5]) for seg in segments]

    @staticmethod
    def _reap_metas(meta_rows):
        """(affected counts, changed counts, statuses) of the staged rows."""
        metas = [da.reap_read(m, kicked=True) for m in meta_rows]
        return ([int(m[0]) for m in metas], [int(m[1]) for m in metas],
                [m[2:5] for m in metas])

    def _bucket_retry(self, statuses) -> bool:
        """True when a bucket dispatch ran out of its budgets (they grow);
        else the hops of its fixed point go to ``hops_log``."""
        retry = any([self._needs_more(self._TAG_BUCKET, st) for st in statuses])
        if not retry:
            self.hops_log.append(max(int(st[0]) for st in statuses))
        return retry

    def speculate_churn(self, ls, affected_sets) -> bool:
        """Stage a SPECULATIVE dispatch of the debounce backlog's
        most-likely final composition (the union as of now) before the
        window closes. The dispatch is functional, so a wrong guess costs
        only the card's time: churn_window cancels it. Counted:
        ops.spec_dispatches on staging, ops.spec_skips when a composition
        refuses speculation (sample-band mutation, layout widening,
        bucket overflow), ops.spec_cancels on an abandoned attempt (an
        injected fault; any other failure propagates). True when a
        speculation is staged."""
        reg = get_registry()
        union: Set[str] = set()
        for s in affected_sets:
            union |= set(s)
        self._speculation = None
        if not union or not self._device_valid:
            reg.counter_bump("ops.spec_skips")
            return False
        if union & set(self.sample_names):
            # _refresh_sample_bands mutates the slot tables before the
            # dispatch: not cancellable, so such a window never speculates
            reg.counter_bump("ops.spec_skips")
            return False
        try:
            ctx = self._prepare_patch(ls, sorted(union))
            if ctx is None or self._layout_changed(ctx):
                reg.counter_bump("ops.spec_skips")
                return False
            _raw, new_out, ov_flips, changed = self._event_diff(ls, union, self.graph)
            if not changed:
                reg.counter_bump("ops.spec_skips")
                return False
            structural = any(wo >= INF or wn >= INF for (wo, wn) in changed.values())
            ov_new, e_dev = self._upload_event(ctx["patched"], changed)
            k = self._buckets()[0]
            if self._pending is not None:
                da.note_pipelined_dispatch(2)
            segments, commit_state = self._run_bucket(ctx, k, e_dev, ov_new)
            counts, ch_counts, statuses = self._reap_metas(self._stage_metas(segments))
            if max(counts) > k or self._bucket_retry(statuses):
                reg.counter_bump("ops.spec_skips")
                return False
        except Exception as exc:  # noqa: BLE001 - filtered below
            if not _recoverable(exc):
                raise
            # speculation runs OUTSIDE the ladder: an injected failure
            # abandons the attempt and the committed path re-dispatches
            reg.counter_bump("ops.spec_cancels")
            get_flight_recorder().note("engine", path="spec_abandon")
            return False
        spec = _Speculation()
        spec.union = frozenset(union)
        spec.version = ls.topology_version
        spec.aversion = ls.attributes_version
        spec.dr_ref = self._dr
        spec.ctx = ctx
        spec.segments = segments
        spec.counts = counts
        spec.ch_counts = ch_counts
        spec.commit_state = commit_state
        spec.ov_new = ov_new
        spec.k = k
        spec.new_out = new_out
        spec.ov_flips = ov_flips
        spec.structural = structural
        self._speculation = spec
        reg.counter_bump("ops.spec_dispatches")
        return True

    def _adopt_speculation(self, ls, spec, affected_sets, defer_consume):
        """Commit a matched speculation as the window's result: the solve
        already ran, so the window is commit and reap only. Its counters
        equal a committed window's, but for ops.spec_hits."""
        reg = get_registry()
        reg.counter_bump("ops.spec_hits")
        get_flight_recorder().note("engine", path="spec_hit")
        with da.event_window("churn_window"):
            if len(affected_sets) > 1:
                self.coalesced_events += 1
                reg.counter_bump("route_engine.coalesced_events")
            if spec.structural:
                self.structural_events += 1
                reg.counter_bump("route_engine.structural_events")
            self._consume_pending(overlap=True)
            self._commit_device(spec.ctx, spec.commit_state, spec.ov_new)
            self._commit_host_mirrors(ls, spec.new_out, spec.ov_flips)
            self.version = ls.topology_version
            self.aversion = ls.attributes_version
            self.incremental_events += 1
            self.last_path = "bucket"
            self.last_k = spec.k
            self.last_affected = max(spec.counts)
            reg.counter_bump("route_engine.incremental_events")
            self._k_hint = max(_ROW_BUCKETS[0], min(1024, 2 * max(spec.counts)))
            pending = PendingDelta(self, spec.segments, spec.counts, spec.ch_counts, spec.k)
            self._pending = pending
            if defer_consume:
                return pending
            self._consume_pending(overlap=False)
            return pending.names

    def churn_burst(self, ls, apply_events, defer_consume=False):
        """Pipelined multi-event burst: every window's dispatch is
        submitted back to back, each optimistically committed, then all
        reaps settle in one read run. ``apply_events`` is a list of
        callables, each mutating the LinkState and returning its affected
        nodes. Bit-identical to applying the events in sequence; any
        hazard (bucket overflow, layout widening, sample-band mutation,
        an injected fault) rolls back to a pre-burst snapshot and replays
        the net effect as ONE coalesced supervised window
        (ops.burst_cancels). Returns the sorted moved names, or the last
        window's PendingDelta under ``defer_consume=True``."""
        if not apply_events:
            return []
        if not self._device_valid:
            sets = [set(ev()) for ev in apply_events]
            return self.churn_window(ls, sets, defer_consume=defer_consume)
        with da.pipeline_drain("churn_burst"):
            return self._churn_burst_drain(ls, apply_events, defer_consume)

    def _burst_snapshot(self):
        """Pre-burst restore point: device refs (never written in place)
        and copies of the host mirrors the optimistic commits mutate."""
        return dict(
            dr=self._dr, dig=self._digests_dev, packed=self._packed_dev,
            v_t=self.sweeper.v_t, w_t=self.sweeper.w_t,
            ov=self.sweeper.overloaded, graph=self.graph,
            w_out={u: dict(d) for u, d in self._w_out.items()},
            w_in={u: dict(d) for u, d in self._w_in.items()},
            ov_host=dict(self._ov_host),
            version=self.version, aversion=self.aversion, k_hint=self._k_hint,
        )

    def _burst_rollback(self, snap) -> None:
        self._dr = snap["dr"]
        self._digests_dev = snap["dig"]
        self._packed_dev = snap["packed"]
        self.sweeper.v_t = snap["v_t"]
        self.sweeper.w_t = snap["w_t"]
        self.sweeper.overloaded = snap["ov"]
        self.graph = self.sweeper.graph = snap["graph"]
        self._w_out = snap["w_out"]
        self._w_in = snap["w_in"]
        self._ov_host = snap["ov_host"]
        self.version = snap["version"]
        self.aversion = snap["aversion"]
        self._k_hint = snap["k_hint"]

    def _burst_redispatch(self, ls, snap, staged, k) -> None:
        """Roll back to the pre-burst ``snap`` and submit every staged
        window again (its recorded patch and event), each optimistically
        committed as the first pass did."""
        self._burst_rollback(snap)
        for st in staged:
            segments, commit_state = self._run_bucket(st["ctx"], k, st["e_dev"], st["ov_new"])
            st["segments"] = segments
            st["meta_rows"] = self._stage_metas(segments)
            self._commit_device(st["ctx"], commit_state, st["ov_new"])
            self._commit_host_mirrors(ls, st["new_out"], st["ov_flips"])
        self.version = ls.topology_version
        self.aversion = ls.attributes_version

    def _churn_burst_drain(self, ls, apply_events, defer_consume):
        """The drain body: submit every window's dispatch at ONE fixed
        bucket, optimistically committing each, then reap every meta and
        every delta in one read run; any overflow or hazard rolls back
        and replays the burst as one coalesced supervised window."""
        reg = get_registry()
        self._speculation = None
        snap = self._burst_snapshot()
        union: Set[str] = set()
        k = self._buckets()[0]
        staged: List[dict] = []
        cancel = False
        idx = 0
        try:
            while idx < len(apply_events):
                ev = apply_events[idx]
                idx += 1
                aff = set(ev())
                union |= aff
                if not aff:
                    continue
                if aff & set(self.sample_names):
                    cancel = True
                    break
                ctx = self._prepare_patch(ls, sorted(aff))
                if ctx is None or self._layout_changed(ctx):
                    cancel = True
                    break
                _raw, new_out, ov_flips, changed = self._event_diff(ls, aff, self.graph)
                if not changed:
                    self.version = ls.topology_version
                    self.aversion = ls.attributes_version
                    continue
                structural = any(wo >= INF or wn >= INF for (wo, wn) in changed.values())
                ov_new, e_dev = self._upload_event(ctx["patched"], changed)
                if staged or self._pending is not None:
                    da.note_pipelined_dispatch(len(staged) + 1)
                segments, commit_state = self._run_bucket(ctx, k, e_dev, ov_new)
                meta_rows = self._stage_metas(segments)
                if not staged:
                    # the first window drains any pre-burst delta while
                    # the burst solves
                    self._consume_pending(overlap=True)
                # optimistic adoption: window N+1 must read window N's
                # committed state; the snapshot guards the whole prefix
                self._commit_device(ctx, commit_state, ov_new)
                self._commit_host_mirrors(ls, new_out, ov_flips)
                self.version = ls.topology_version
                self.aversion = ls.attributes_version
                staged.append(dict(segments=segments, meta_rows=meta_rows,
                                   structural=structural, ctx=ctx, e_dev=e_dev,
                                   ov_new=ov_new, new_out=new_out, ov_flips=ov_flips))
                da.note_window()
        except Exception as exc:  # noqa: BLE001 - filtered below
            if not _recoverable(exc):
                raise
            # an injected fault mid-burst degrades within the ladder:
            # roll back and let the supervised replay walk it
            cancel = True
        if not cancel and staged:
            while True:
                all_counts: List[List[int]] = []
                all_ch: List[List[int]] = []
                all_st = []
                for st in staged:
                    counts, ch, statuses = self._reap_metas(st["meta_rows"])
                    all_counts.append(counts)
                    all_ch.append(ch)
                    all_st.append(statuses)
                if max(max(c) for c in all_counts) > k:
                    cancel = True
                    break
                retry = any([self._needs_more(self._TAG_BUCKET, x)
                             for statuses in all_st for x in statuses])
                if not retry:
                    self.hops_log.extend(max(int(x[0]) for x in statuses)
                                         for statuses in all_st)
                    break
                # a window's budget ran out: restore the pre-burst state and
                # re-dispatch every window, in order, with the larger budgets
                self._burst_redispatch(ls, snap, staged, k)
        if cancel:
            # one cancel path for every hazard: deliver the remaining
            # mutations, restore the pre-burst state, and replay the net
            # effect as ONE supervised coalesced window
            while idx < len(apply_events):
                union |= set(apply_events[idx]())
                idx += 1
            self._burst_rollback(snap)
            reg.counter_bump("ops.burst_cancels")
            get_flight_recorder().note("engine", path="burst_cancel",
                                       windows=len(apply_events))
            if len(apply_events) > 1:
                self.coalesced_events += 1
                reg.counter_bump("route_engine.coalesced_events")
            return self.churn(ls, union, defer_consume=defer_consume)
        if not staged:
            if not defer_consume:
                self.flush()
            return []
        self._k_hint = max(_ROW_BUCKETS[0], min(1024, 2 * max(max(c) for c in all_counts)))
        self.last_path = "bucket"
        self.last_k = k
        self.last_affected = max(max(c) for c in all_counts)
        names: List[str] = []
        last = len(staged) - 1
        result = None
        for i, st in enumerate(staged):
            self.incremental_events += 1
            reg.counter_bump("route_engine.incremental_events")
            if st["structural"]:
                self.structural_events += 1
                reg.counter_bump("route_engine.structural_events")
            pending = PendingDelta(self, st["segments"], all_counts[i], all_ch[i], k)
            self._pending = pending
            if defer_consume and i == last:
                result = pending
                break
            self._consume_pending(overlap=False)
            names.extend(pending.names)
        if result is not None:
            return result
        return sorted(set(names))

    def churn(self, ls, affected_nodes: Set[str], defer_consume: bool = False):
        """Apply one churn event, SUPERVISED: the ladder walks warm
        incremental re-solve -> device-loss recovery -> drain + cold
        device rebuild -> host NumPy product, each bit-identical, until
        one succeeds (LadderExhausted if none does). Only an injected
        fault, a lost device or stale/torn residents walk it; any other
        failure propagates. Returns the warm path's moved names (or
        PendingDelta), or None from the deeper rungs."""
        with da.event_window("churn"):
            return self._churn_supervised(ls, affected_nodes, defer_consume)

    def _churn_supervised(self, ls, affected_nodes: Set[str], defer_consume: bool = False):
        return self.supervisor.run((
            ("warm", lambda: self._rung_guard(
                self._churn_device, ls, affected_nodes, defer_consume
            )),
            ("recover", lambda: self._rung_guard(
                self._device_recover, ls, affected_nodes, defer_consume
            )),
            ("cold", lambda: self._rung_guard(self._cold_recover, ls)),
            ("host", lambda: self._host_fallback(ls)),
        ), _recoverable)

    def _rung_guard(self, fn, *args):
        """Run one rung, marking the engine device-lost when the failure
        is the card dying (``is_device_loss``); the marker arms the
        recover rung. The exception still propagates."""
        try:
            return fn(*args)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            if is_device_loss(exc):
                self._device_valid = False
                self._device_lost = True
                get_registry().counter_bump("recovery.device_lost")
            raise

    @fault_boundary
    def _cold_recover(self, ls) -> None:
        """Ladder rung 2: drain + cold device rebuild from the LinkState."""
        self._build(ls)
        return None

    def _make_sweeper(self, graph):
        """Backend hook: a fresh sweeper (device uploads) over an
        already-compiled host graph, for the device-loss recovery."""
        return rs.RouteSweeper(graph, self.sample_names, device=self.device)

    @fault_boundary
    @requires_drain("_discard_pending")
    def _device_recover(self, ls, affected_nodes: Set[str], defer_consume: bool = False):
        """Ladder rung 1: after a device loss, re-land the residents from
        ``self.graph`` (host layout intact, no recompile), then run the
        event that observed the loss warm."""
        if not self._device_lost:
            raise _DeviceStateInvalid("no device loss observed (recover rung idle)")
        self._discard_pending()
        reg = get_registry()
        tracer = get_tracer()
        span = tracer.span_active("recovery.device_rebuild")
        self._device_lost = False
        self.sweeper = self._make_sweeper(self.graph)
        dr, digests, packed = self._full_resident(self.graph)
        self._dr = dr
        self._digests_dev = digests
        self._packed_dev = packed
        packed_host = da.reap_read(da.kick_async(packed))
        self.result = rs.assemble_result(self.sweeper, packed_host)
        self._packed_host = np.array(packed_host)
        self._device_valid = True
        self.device_rebuilds += 1
        reg.counter_bump("recovery.device_rebuilds")
        tracer.end_span_active(span, shrunk=False)
        return self._churn_device(ls, affected_nodes, defer_consume)

    def _discard_pending(self) -> None:
        """Drop the in-flight delta WITHOUT the host apply (the host
        fallback replaces the whole result). A caller-held PendingDelta
        resolves empty."""
        p = self._pending
        self._pending = None
        self._speculation = None
        if p is not None:
            p.consumed = True
            get_registry().counter_bump("route_engine.deltas_discarded")

    @fault_boundary
    @requires_drain("_discard_pending")
    def _host_fallback(self, ls) -> None:
        """Ladder rung 3: recompute the whole packed product on the host
        (ops.host_sweep, bit-identical to a cold device sweep) and mark
        the residents invalid; the next walk that the supervisor's
        breaker lets through rebuilds them."""
        self._discard_pending()
        shim, packed = host_sweep.host_route_product(ls, self.sample_names, align=self._align)
        self.result = rs.assemble_result(shim, packed)
        self._device_valid = False
        self._packed_host = None
        self.version = ls.topology_version
        self.aversion = ls.attributes_version
        self.host_fallbacks += 1
        self.last_path = "host"
        get_registry().counter_bump("route_engine.host_fallbacks")
        return None

    def _event_diff(self, ls, affected_nodes: Set[str], graph):
        """Host-side event diff against the resident raw-weight mirrors,
        O(degree) per affected node. Returns ``(raw_changed, new_out,
        ov_flips, changed)``, shared by the committed and the speculative
        paths."""
        raw_changed: Dict[Tuple[int, int], Tuple[int, int]] = {}
        new_out: Dict[int, Dict[int, int]] = {}
        for nm in affected_nodes:
            u = graph.node_index[nm]
            seen = _out_edges(ls, nm, graph.node_index)
            new_out[u] = seen
            old = self._w_out.get(u, {})
            for v, wo in old.items():
                wn = seen.get(v, INF)
                if wn != wo:
                    raw_changed[(u, v)] = (wo, wn)
            for v, wn in seen.items():
                if v not in old:
                    raw_changed[(u, v)] = (INF, wn)
        ov_flips = {
            nm for nm in affected_nodes
            if nm in self._ov_host and ls.is_node_overloaded(nm) != self._ov_host[nm]
        }
        # DETECTION transitions: the raw diffs plus effective-weight flips
        # of the edges whose usability changed with a node's drain state
        # (edges INTO the flipped node: the reverse relax masks on the
        # forward edge's destination)
        changed: Dict[Tuple[int, int], Tuple[int, int]] = dict(raw_changed)
        for nm in ov_flips:
            x = graph.node_index[nm]
            draining = ls.is_node_overloaded(nm)
            for u, wo in self._w_in.get(x, {}).items():
                wn = new_out.get(u, self._w_out.get(u, {})).get(x, wo)
                if draining:
                    changed[(u, x)] = (wo, INF)  # may break paths
                else:
                    changed[(u, x)] = (INF, wn)  # may create paths
        return raw_changed, new_out, ov_flips, changed

    def _upload_event(self, patched, changed):
        """Upload one event's edge-transition list (padded to a power of
        two, at least 32, with inert INF/INF self-loops: the padded lengths
        key the executable cache, and most events fit the least) and the
        patched overload mask. Returns ``(ov_new, e_dev)``."""
        e = np.asarray(
            [(u, v, wo, wn) for (u, v), (wo, wn) in changed.items()], dtype=np.int64
        ).reshape(-1, 4)
        eb = 32
        while eb < len(e):
            eb *= 2
        pad = np.zeros((eb - len(e), 4), dtype=np.int64)
        pad[:, 2:] = INF
        e = np.concatenate([e, pad]).astype(np.int32)
        e_dev = tuple(self._stager.upload([("event", np.ascontiguousarray(e[:, c]))
                                           for c in range(4)]))
        ov_new = self._upload(patched.overloaded)
        return ov_new, e_dev

    @fault_boundary
    @committed_dispatch
    def _churn_device(self, ls, affected_nodes: Set[str], defer_consume: bool = False):
        """Ladder rung 0 (warm): one incremental device event. Returns the
        moved destination names, or None after a cold rebuild (node set or
        sample slot-table change), or a PendingDelta under
        ``defer_consume=True`` (``self.result`` is stale until it is
        consumed by the next churn, ``flush()`` or ``wait()``)."""
        if not self._device_valid:
            raise _DeviceStateInvalid("device residents stale (host fallback active)")
        graph = self.graph
        ctx = self._prepare_patch(ls, sorted(affected_nodes))
        if ctx is None or not self._refresh_sample_bands(ctx["patched"], affected_nodes):
            self._build(ls)
            return None
        patched = ctx["patched"]
        raw_changed, new_out, ov_flips, changed = self._event_diff(ls, affected_nodes, graph)
        if not changed:
            # attribute-only event: nothing route-affecting
            self.version = ls.topology_version
            self.aversion = ls.attributes_version
            self.last_path = "attribute"
            if not defer_consume:
                self.flush()
            return []
        # STRUCTURAL events (link up/down, drain flips) have an INF end in
        # some transition; metric churn never does
        if any(wo >= INF or wn >= INF for (wo, wn) in changed.values()):
            self.structural_events += 1
            get_registry().counter_bump("route_engine.structural_events")
        ov_new, e_dev = self._upload_event(patched, changed)
        buckets = self._buckets()
        was_pending = self._pending is not None
        segments: List = []
        counts: List[int] = []
        ch_counts: List[int] = []
        commit_state = None
        k = None
        overlapped = False
        for k in buckets:
            while True:
                segments, commit_state = self._run_bucket(ctx, k, e_dev, ov_new)
                meta_rows = self._stage_metas(segments)
                if not overlapped:
                    if was_pending:
                        da.note_pipelined_dispatch(2)
                    # the PREVIOUS event's delta is consumed while this
                    # dispatch's copies land
                    self._consume_pending(overlap=True)
                    overlapped = True
                counts, ch_counts, statuses = self._reap_metas(meta_rows)
                # an overflowed bucket retries larger; a budget that ran
                # out retries at the same bucket with the larger budget
                if max(counts) > k or not self._bucket_retry(statuses):
                    break
            self.last_affected = max(counts)
            if max(counts) <= k:
                break
        if max(counts) > k:
            # beyond every bucket: the overflow policy, patched layout kept
            return self._overflow_refresh(
                ls, ctx, ov_new, new_out, ov_flips, e_dev, defer=defer_consume
            )
        self._k_hint = max(_ROW_BUCKETS[0], min(1024, 2 * max(counts)))
        self._commit_device(ctx, commit_state, ov_new)
        self._commit_host_mirrors(ls, new_out, ov_flips)
        self.version = ls.topology_version
        self.aversion = ls.attributes_version
        self.incremental_events += 1
        self.last_path = "bucket"
        self.last_k = k
        get_registry().counter_bump("route_engine.incremental_events")
        pending = PendingDelta(self, segments, counts, ch_counts, k)
        self._pending = pending
        if defer_consume:
            return pending
        self._consume_pending(overlap=False)
        return pending.names


# -- grouped-backend engine ------------------------------------------------


def _grouped_full_resident(v_t, w_t, overloaded, samp_ids, samp_v, samp_w, pos_w, meta,
                           n, impl, budget):
    """Grouped cold build: every destination row through the grouped
    relaxation (``budget`` hops); the same packed layout and digest as the
    ELL engine's. Returns (DR, digests, packed, status)."""
    t_ids = torch.arange(n, dtype=torch.int32, device=overloaded.device)
    dr, hs = sg._grouped_fixed_point(meta, v_t, w_t, overloaded, t_ids, n,
                                     reverse=True, impl=impl, budget=budget)
    digests, packed = _extract(
        dr, lambda rows, t: sg._grouped_nh_counts(rows, meta, v_t, w_t, overloaded, t),
        overloaded, t_ids, samp_ids, samp_v, samp_w, pos_w,
    )
    return dr, digests, packed, _status_row(hs)


def _patch_segments(w_t, upd_g, upd_s, upd_r, upd_w):
    """Per-segment weight updates written into NEW segment tensors; a
    segment without updates (None) is passed through."""
    out = []
    for w, g, s, r, v in zip(w_t, upd_g, upd_s, upd_r, upd_w):
        if g is None:
            out.append(w)
        else:
            out.append(w.index_put((g.long(), s.long(), r.long()), v))
    return tuple(out)


def _grouped_churn_step(v_t, w_t, upd_g, upd_s, upd_r, upd_w, dr, digests, packed_res,
                        e_u, e_v, e_w_old, e_w_new, overloaded_new, samp_ids, samp_v,
                        samp_w, pos_w, meta, n, k, impl, budget):
    """Grouped churn dispatch: detection against the resident DR, the
    segment-slot weight patch, the affected rows re-solved (from the unit
    init, as the reference's; ``budget`` hops) through the grouped
    relaxation, with the same delta-compacted readback as the ELL step.
    Returns (new_w, dr, digests, packed_res, out)."""
    count, local_ids, ids = _detect_rows(dr, e_u, e_v, e_w_old, e_w_new, k, 0)
    new_w = _patch_segments(w_t, upd_g, upd_s, upd_r, upd_w)
    dr, digests, packed_res, out = _resolve_and_pack(
        lambda t: sg._grouped_fixed_point(meta, v_t, new_w, overloaded_new, t, n,
                                          reverse=True, impl=impl, budget=budget),
        lambda rows, t: sg._grouped_nh_counts(rows, meta, v_t, new_w, overloaded_new, t),
        overloaded_new, ids, local_ids, count,
        dr, digests, packed_res, samp_ids, samp_v, samp_w, pos_w, n, k,
    )
    return new_w, dr, digests, packed_res, out


def _grouped_frontier_probe(v_t, w_t, dr, e_u, e_v, e_w_old, e_w_new, cell_limit, state,
                            meta, n, max_jumps, jumps):
    """The grouped twin of _frontier_probe: (state..., meta row)."""
    if state is None:
        state = rs.cone_start(dr, e_u, e_v, e_w_old, e_w_new, cell_limit[0])
    state = rs.cone_run(state, dr, sg.grouped_joins(meta, v_t, w_t), jumps, max_jumps,
                        cell_limit[0])
    return (*state, _probe_meta(state, cell_limit[0]))


def _grouped_frontier_step(v_t, w_t, cone, dr, overloaded, samp_ids, samp_v, samp_w,
                           pos_w, meta, n, impl, budget):
    """The grouped twin of _frontier_step: (dr, digests, packed, status)."""
    t_ids = torch.arange(n, dtype=torch.int32, device=dr.device)
    warm0 = torch.where(cone, INF, dr)
    dr2, hs = sg._grouped_fixed_point(meta, v_t, w_t, overloaded, t_ids, n,
                                      reverse=True, impl=impl, init=warm0, budget=budget)
    digests, packed = _extract(
        dr2, lambda rows, t: sg._grouped_nh_counts(rows, meta, v_t, w_t, overloaded, t),
        overloaded, t_ids, samp_ids, samp_v, samp_w, pos_w,
    )
    return dr2, digests, packed, _status_row(hs)


def _grouped_overflow_chain(v_t, w_new_t, dr, packed_res, cone, rows, cells, grew, jumps,
                            go, cell_limit, overloaded_new, samp_ids, samp_v, samp_w, pos_w,
                            meta, n, n_real, impl, budget):
    """The grouped twin of _overflow_chain: seed select on the card from
    the probe's cone state (pre-patch slabs), warm re-solve on the patched
    slabs, extraction and compaction. Segment shapes never change under
    grouped_patch, so every grouped overflow takes it."""
    state = (cone, rows, cells, grew, jumps, go)
    ok = rs.cone_converged(state, cell_limit[0])
    use_frontier = ok & (cells <= cell_limit[0])
    eff_cone = cone | ~use_frontier
    t_ids = torch.arange(n, dtype=torch.int32, device=dr.device)
    warm0 = torch.where(eff_cone, INF, dr)
    del eff_cone
    dr2, hs = sg._grouped_fixed_point(meta, v_t, w_new_t, overloaded_new, t_ids, n,
                                      reverse=True, impl=impl, init=warm0, budget=budget)
    del warm0
    meta_row = _meta_row(rows, cells, jumps, ok, _status_row(hs))
    digests, packed = _extract(
        dr2, lambda r, t: sg._grouped_nh_counts(r, meta, v_t, w_new_t, overloaded_new, t),
        overloaded_new, t_ids, samp_ids, samp_v, samp_w, pos_w,
    )
    ch_count, comp = _compact_changed_body(packed, packed_res, n_real)
    return dr2, digests, packed, ch_count, comp, meta_row


class GroupedRouteSweepEngine(RouteSweepEngine):
    """The incremental engine over the GROUPED (block-bipartite)
    relaxation, through the contraction kernel ``impl``
    (``"batched_minplus"`` or ``"batched_minplus_t"``, as
    ``GroupedRouteSweeper`` takes it).

    Metric changes, overload flips and edge REMOVALS patch segment weight
    slots in place (``spf_grouped.grouped_patch``: node ids untouched,
    resident DR valid, a removed slot restorable). A NEW adjacency breaks
    the signature grouping and cold-rebuilds. Digests are comparable by
    name with the ELL engine's."""

    _TAG_FULL = "grouped_full_resident"
    _TAG_BUCKET = "grouped_churn_step"
    _TAG_PROBE = "grouped_frontier_probe"
    _TAG_STEP = "grouped_frontier_step"
    _TAG_CHAIN = "grouped_overflow_chain"
    _PROBE_BODY = staticmethod(_grouped_frontier_probe)

    def __init__(self, ls, sample_names: Sequence[str], align: int = 128, mesh=None,
                 frontier_threshold: float = _DEFAULT_FRONTIER_THRESHOLD,
                 impl: Optional[str] = "batched_minplus", device: DeviceLike = None):
        # None: the selector's kernel (spf_grouped.get_grouped_impl)
        self.impl = sg._check_impl(impl if impl is not None else sg.get_grouped_impl(device))
        super().__init__(ls, sample_names, align=align, mesh=mesh,
                         frontier_threshold=frontier_threshold, device=device)

    def _compile_backend(self, ls):
        graph = sg.compile_out_grouped(ls, align=self._align)
        self._slots = sg.slot_table(graph)
        return graph, sg.GroupedRouteSweeper(graph, self.sample_names, impl=self.impl,
                                             device=self.device)

    def _make_sweeper(self, graph):
        # the slot table keys on the layout, which a patch never changes
        return sg.GroupedRouteSweeper(graph, self.sample_names, impl=self.impl,
                                      device=self.device)

    def _dispatch(self, tag, fn, dyn_args, statics):
        return aot_call(tag, fn, dyn_args, statics)

    def _probe_statics(self):
        return dict(meta=self.sweeper.meta, n=self.graph.n_pad)

    def _full_resident(self, graph):
        sw = self.sweeper
        (dr, digests, packed, _st), row = self._run_budgeted(
            self._TAG_FULL, _grouped_full_resident,
            (sw.v_t, sw.w_t, sw.overloaded, sw._samp_ids_dev, sw._samp_v_dev,
             sw._samp_w_dev, sw._pos_w_dev),
            dict(meta=sw.meta, n=graph.n_pad, impl=self.impl), at=3,
        )
        self.hops_log.append(int(row[0]))
        return dr, digests, packed

    def _refresh_sample_bands(self, patched, affected_nodes) -> bool:
        if not (affected_nodes & set(self.sample_names)):
            return True
        rows = [patched.out_slots(int(sid)) for sid in self.sweeper.sample_ids]
        return self._set_sample_rows(*rs.pack_sample_rows(rows, self.sweeper.sample_ids))

    def _layout_changed(self, ctx) -> bool:
        # segment shapes never change under grouped_patch (it returns None
        # on any layout break), so a ctx implies a stable layout
        return False

    def _prepare_patch(self, ls, affected_sorted):
        got = sg.grouped_patch(self.graph, ls, affected_sorted, self._slots)
        if got is None:
            return None
        patched, updates = got
        nseg = len(self.sweeper.w_t)
        items = []
        touched = []
        for si in range(nseg):
            ups = updates.get(si)
            if not ups:
                continue
            arr = np.asarray(ups, dtype=np.int32)
            touched.append(si)
            items += [("patch", np.ascontiguousarray(arr[:, c])) for c in range(4)]
        tensors = iter(self._stager.upload(items))
        upd = [[None] * nseg for _ in range(4)]
        for si in touched:
            for c in range(4):
                upd[c][si] = _pad_pow2(next(tensors))
        return {
            "patched": patched,
            "upd": tuple(tuple(u) for u in upd),
            "patched_segs": None,
        }

    @solve_window
    @committed_dispatch
    def _run_bucket(self, ctx, k, e_dev, ov_new):
        fault_point(FAULT_DISPATCH)
        fault_point(FAULT_DEVICE_LOST)
        graph = ctx["patched"]
        sw = self.sweeper
        h, _j = self._budget(self._TAG_BUCKET)
        new_w, dr, digests, packed_res, packed_dev = self._dispatch(
            self._TAG_BUCKET, _grouped_churn_step,
            (sw.v_t, sw.w_t, *ctx["upd"], self._dr, self._digests_dev, self._packed_dev,
             *e_dev, ov_new, sw._samp_ids_dev, sw._samp_v_dev, sw._samp_w_dev,
             sw._pos_w_dev),
            dict(meta=sw.meta, n=graph.n_pad, k=k, impl=self.impl, budget=h),
        )
        ctx["patched_segs"] = new_w
        return [packed_dev], (new_w, dr, digests, packed_res)

    @solve_window
    def _commit_device(self, ctx, commit_state, ov_new) -> None:
        new_w, dr, digests, packed_res = commit_state
        self.sweeper.w_t = new_w
        self.sweeper.overloaded = ov_new
        self._dr = dr
        self._digests_dev = digests
        self._packed_dev = packed_res
        self.graph = self.sweeper.graph = ctx["patched"]

    @solve_window
    def _apply_patch_resident(self, ctx, ov_new) -> None:
        """Scatter the event's segment-slot updates into the resident
        segment tensors (their shapes never change)."""
        if ctx["patched_segs"] is None:
            ctx["patched_segs"] = self._dispatch_patch(ctx)
        self.sweeper.w_t = ctx["patched_segs"]
        self.sweeper.overloaded = ov_new
        self.graph = self.sweeper.graph = ctx["patched"]

    def _dispatch_patch(self, ctx):
        return _patch_segments(self.sweeper.w_t, *ctx["upd"])

    @solve_window

    @solve_window
    def _frontier_resident(self, cone):
        sw = self.sweeper
        (dr, digests, packed, _st), row = self._run_budgeted(
            self._TAG_STEP, _grouped_frontier_step,
            (sw.v_t, sw.w_t, cone, self._dr, sw.overloaded, sw._samp_ids_dev,
             sw._samp_v_dev, sw._samp_w_dev, sw._pos_w_dev),
            dict(meta=sw.meta, n=self.graph.n_pad, impl=self.impl), at=3,
        )
        self.hops_log.append(int(row[0]))
        return dr, digests, packed

    @solve_window
    def _dispatch_overflow_chain(self, ctx, e_dev, ov_new, limit):
        if ctx["patched_segs"] is None:
            ctx["patched_segs"] = self._dispatch_patch(ctx)
        new_w = ctx["patched_segs"]
        lim = torch.tensor([limit], dtype=torch.float32, device=self.device)
        sw = self.sweeper
        state, _probe = self._probe_cone(e_dev, lim)
        (dr, digests, packed, ch_count, comp, _meta), row = self._run_budgeted(
            self._TAG_CHAIN, _grouped_overflow_chain,
            (sw.v_t, new_w, self._dr, self._packed_dev, *state, lim, ov_new,
             sw._samp_ids_dev, sw._samp_v_dev, sw._samp_w_dev, sw._pos_w_dev),
            dict(meta=sw.meta, n=self.graph.n_pad, n_real=self.graph.n, impl=self.impl),
            at=5,
        )
        self.hops_log.append(int(row[4]))
        return dr, digests, packed, ch_count, comp, row
