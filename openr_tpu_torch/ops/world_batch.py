"""Multi-tenant batched worlds: one device, many graphs, one dispatch.

A route server or controller serving real traffic runs MANY topologies
at once — areas, VRFs, what-if scenarios — while the ELL engines above
are single-graph residents. This module is the tenant plane over them:

- ``WorldManager`` — the arbiter. Tenants (independent LinkState
  worlds) are admitted into **shape buckets**: per-tenant ``n``/``k``/
  source-batch sizes rounded up to shared power-of-two slots, so every
  tenant in a bucket runs the SAME compiled executable
  (``route_engine.world_dispatch``, the ``vmap``-lifted fused view
  solve + patch scatter + delta compaction, with no shape-varying
  static arguments). Tenants joining a warm bucket cost zero retraces
  — the tenancy smoke gate asserts the compile count stays flat.

- ``WorldBucket`` — one ``[B, n_slot, k_slot]`` resident block of B
  tenant slots (uniform-ELL packing, ``spf_sparse.ell_pack_uniform``).
  A dispatch solves every slot in one device round trip
  (``route_engine.world_dispatch``, which fuses the pending patch
  scatter, the batched solve AND the delta compaction into one
  executable); inactive and idle slots are inert by construction
  (all-INF padding converges in zero iterations, and an idle slot
  re-derives its own fixed point — the min-relax is idempotent there —
  so its packed rows never change and never read back). Readback is
  per-tenant delta-compacted: the packed [B, 2S, N] block diffs
  against the resident previous block and only changed rows cross,
  prefixed by a tenant-id column (the
  ``route_engine.compact_rows_with_ids`` epilogue), fanning back out
  to B per-tenant host mirrors.

- **HBM residency** — buckets hold a fixed number of slots; when a
  bucket is full (or the global ``max_resident`` cap is exceeded) the
  least-recently-used tenant is EVICTED to its host snapshot: the host
  keeps the tenant's ``EllGraph``, its packed view mirror (which
  includes the last-solve distance rows) and its un-solved patch
  journal. Re-admission REHYDRATES warm: the uniform block re-packs
  from the graph, the previous distances upload as the warm seed, and
  the journal replays as an increase-edge delta — the first solve
  after rehydration is a warm solve, not a cold one (the
  evict→rehydrate parity test enforces both the bits and the
  warmness). This generalizes the ``SpfSolver._views`` LRU
  from host-side view objects to device-resident engine state.

Churn stays warm exactly the way ``EllState`` keeps it warm: patches
journal (tail, head) -> (weight snapshot, current weight) with
first-touch-wins snapshots, overload flips journal the flipped node's
out-edges at raw weights, and solve time emits the effective-weight
increase delta against the snapshots the resident distances were
solved under (see ``EllState._note_patch`` / ``_emit_increases`` for
the soundness argument — the logic here is the same journal over the
host-side tenant record instead of a device-resident band set).

Observability: ``tenancy.*`` counters (active/resident/evictions/
rehydrations/bucket_compiles/... ) and an ``ops.tenant_dispatch`` span
per bucket dispatch carrying batch occupancy.

Port note: the port of ``openr_tpu/ops/world_batch.py``. A bucket's
blocks are torch tensors on the manager's ``device`` (None = CUDA;
raises without CUDA unless given ``device="cpu"``). ``world_dispatch``
runs through the executable cache (``spf_sparse._budgeted_launch`` and
``_budgeted_reap``: one captured CUDA graph per shape bucket and hop
budget on the card, the same body eagerly on the CPU), its relax through
the hand kernel with a world axis (``ell_relax.ell_band_relax_worlds``);
where the reference's ``while_loop`` runs until every tenant converges,
the body runs a hop budget and reports its status, and a budget that ran
out re-dispatches (nothing of it is committed). ``_dispatch_launch``
stages the status, the change count and the compacted rows to pinned host
memory without waiting, and ``_dispatch_finish`` reads them, so a wave's
buckets run on the card while the host launches the next and settles the
previous. A per-slot write (``_slot_set``) is an upload and an
out-of-place ``index_copy`` outside any captured body; the patch and
increase operands go up through the manager's ``UploadStager`` (pinned,
``non_blocking``) before the dispatch. The
bucket key and "compile" counters keep the reference's names: a new
bucket is a new body key (``ops.aot_compiles`` on the card).

Left out until the integrity plane is ported (ROADMAP Queue 1 item 9):
the ``ResidentEngineContract`` base and ``get_auditor().register``, the
audit surface (``audit_ready``, ``audit_residual``,
``audit_digest_pair``, ``audit_row_count``, ``audit_sample_rows``),
``quarantine``, ``integrity_heal``, ``corrupt_resident`` and the
``FAULT_CORRUPT`` seam at the end of ``solve_views``. The
``tenancy.quarantines`` and ``tenancy.integrity_heals`` counters are
registered and stay 0.
"""

from __future__ import annotations

import base64
import os
import time
import weakref
from dataclasses import replace as _replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openr_tpu_torch.analysis.annotations import committed_dispatch, thread_confined
from openr_tpu_torch.device import DeviceLike, resolve_device
from openr_tpu_torch.faults import fault_point, is_device_loss
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops.minplus import INF
from openr_tpu_torch.ops.route_engine import FAULT_DEVICE_LOST, world_dispatch
from openr_tpu_torch.ops.staging import UploadStager
from openr_tpu_torch.ops.spf_sparse import (
    _FORCE_RESET_EDGE,
    EllGraph,
    _budgeted_launch,
    _budgeted_reap,
    band_row_edge_changes,
    compile_ell,
    ell_pack_uniform,
    ell_patch,
    ell_source_batch,
    ell_uniform_rows,
)
from openr_tpu_torch.telemetry import get_profiler as _get_profiler
from openr_tpu_torch.telemetry import get_registry as _get_registry
from openr_tpu_torch.telemetry import get_tracer as _get_tracer

# per-dispatch increase-delta slots per tenant: ONE fixed shape (no
# pow2 ladder like pad_increase_edges — a ladder would retrace per
# bucket size and break the flat-compile contract). A tenant whose
# journal emits more increases than this takes a forced reset instead:
# still bit-identical, just cold for that one solve.
_INC_SLOTS = 64

# compacted-delta readback rows per dispatch (capped; a bigger delta
# falls back to a full-block readback, counted in delta_overflows)
_DELTA_CAP_MAX = 1024

# pending patch rows carried INTO the fused dispatch per tenant: one
# fixed [B, _PATCH_SLOTS] shape (padded with the out-of-bounds row id,
# dropped by the scatter) so patch application costs no separate
# device dispatch and no extra executable. A tenant accumulating more
# dirty rows than this between solves re-uploads its whole slot
# instead (counted in patch_overflows, never silent).
_PATCH_SLOTS = 32

TENANCY_COUNTERS = _get_registry().counter_dict(
    [
        "active",        # tenants known to the manager (gauge-like)
        "resident",      # tenants currently holding a device slot
        "admissions",    # cold admits (fresh compile_ell worlds)
        "evictions",     # resident -> host-snapshot demotions
        "rehydrations",  # host-snapshot -> warm resident promotions
        "placements",    # slot uploads of any kind (join/rehydrate/resize)
        "bucket_compiles",    # distinct shape buckets materialized
        "bucket_migrations",  # tenant moved between shape buckets
        "graph_shares",       # vantage-view packing: shared-graph reuses
        "override_solves",    # per-vantage override syncs (forced cold)
        "warm_solves",   # tenant solves seeded from previous distances
        "cold_solves",   # tenant solves from the forced-reset sentinel
        "dispatches",    # batched device dispatches (one per bucket)
        "delta_rows",        # compacted rows read back
        "delta_overflows",   # full-block readback fallbacks
        "patch_overflows",   # full-slot re-uploads (patch > row budget)
        "device_loss_recoveries",  # torn dispatches rebuilt from host
        "quarantines",       # integrity audits that poisoned the blocks
        "integrity_heals",   # warm re-placements after a quarantine
        "wave_occupancy",    # gauge-like: last wave's solving/slots pct
        "wave_joins",        # requests that joined an in-flight wave
        "wave_preemptions",  # higher-SLO requests admitted over earlier ones
        "bucket_compactions",  # vacancy-driven bucket shrinks
        "ksp2_views",        # per-tenant second-path view solves
        "park_midflight_carries",  # parked between submit and reap,
                                   # delta still applied to the mirror
        "park_midflight_resets",   # same window, but the record moved
                                   # under the dispatch: forced cold
        "tenant_exports",    # host records serialized for migration
        "tenant_imports",    # migrated records rehydrated here
        "tenant_import_colds",  # imports that could not seed warm
    ],
    prefix="tenancy.",
)

# SLO classes the serve plane stamps on tenants (serve/slo.py owns the
# class table; the tenant plane only carries the label so dispatch
# spans and counters can slice by class without importing serve)
SLO_CLASSES = ("premium", "standard", "bulk")


def _pow2_at_least(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def _upload(val, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(val)).to(device)


def _slot_set(buf: torch.Tensor, slot, val) -> torch.Tensor:
    """``buf`` with ``buf[slot] = val`` (a host array), out of place: an
    upload and an ``index_copy`` outside any captured body, so a slot
    write never changes a tensor an in-flight dispatch still reads (the
    reference's functional ``.at[slot].set``)."""
    idx = torch.tensor([int(slot)], dtype=torch.long, device=buf.device)
    return buf.index_copy(0, idx, _upload(val, buf.device).to(buf.dtype)[None])


class TenantWorld:
    """Host-side record for one tenant: its compiled graph, source
    batch, packed-view mirror (rows [0, 2*s_slot) in bucket layout),
    and the un-solved patch journal. This IS the eviction snapshot —
    nothing device-side is needed to rehydrate warm."""

    __slots__ = (
        "tenant_id", "ls_ref", "root", "graph", "version", "srcs",
        "packed_host", "pending_edges", "pending_rows", "ov_solved",
        "pending_structural", "force_reset", "needs_solve", "solved",
        "slot", "bucket", "last_used", "srcs_dirty", "override", "slo",
    )

    def __init__(self, tenant_id: str, ls, root: str,
                 graph: EllGraph, srcs: List[int]):
        self.tenant_id = tenant_id
        self.ls_ref = weakref.ref(ls)
        self.root = root
        self.graph = graph
        self.version = ls.topology_version
        self.srcs = list(srcs)
        self.packed_host: Optional[np.ndarray] = None
        self.pending_edges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        # global row ids whose device copy is stale (applied in-kernel
        # by the next fused dispatch, or subsumed by a full re-pack)
        self.pending_rows: set = set()
        self.ov_solved = np.array(graph.overloaded, copy=True)
        self.pending_structural = False
        self.force_reset = True
        self.needs_solve = True
        self.solved = False
        self.slot: Optional[int] = None
        self.bucket: Optional["WorldBucket"] = None
        self.last_used = 0
        self.srcs_dirty = True
        # vantage-local overload view ({node: overloaded}); empty =
        # the tenant sees the shared LSDB truth
        self.override: Dict[str, bool] = {}
        # SLO class label (serve plane admission ordering + span attrs)
        self.slo = "standard"

    @property
    def dims(self) -> Tuple[int, int, int]:
        """(s_slot, n_slot, k_slot) shape-bucket key this tenant
        rounds up into. The k floor is deliberately coarse (16): real
        mixed fleets mostly differ in degree, and every extra bucket
        is an extra dispatch per churn round plus an extra executable
        — a few INF slots per row are far cheaper than either."""
        return (
            _pow2_at_least(len(self.srcs), 8),
            _pow2_at_least(self.graph.n_pad, 128),
            _pow2_at_least(max(b.k for b in self.graph.bands), 16),
        )

    def view(self) -> Tuple[EllGraph, List[int], np.ndarray]:
        """(graph, srcs, packed [2b, n_pad]) in exactly the layout
        ``ell_view_batch_packed`` / ``EllState.reconverge`` return —
        sliced out of the bucket-shaped mirror, copied (the mirror
        mutates under later dispatches)."""
        assert self.packed_host is not None and self.solved
        b = len(self.srcs)
        s = self.packed_host.shape[0] // 2
        n_pad = self.graph.n_pad
        return self.graph, list(self.srcs), np.concatenate(
            [
                self.packed_host[:b, :n_pad],
                self.packed_host[s : s + b, :n_pad],
            ],
            axis=0,
        )


class WorldBucket:
    """One shape bucket's resident device block: B tenant slots of
    uniform [n_slot, k_slot] ELL plus the per-slot source batches,
    previous distances (the warm seed) and previous packed views (the
    delta-readback baseline). Invariant: ``packed_dev[slot]`` equals
    ``tenant.packed_host`` for every occupied slot between
    dispatches — placement uploads the mirror, dispatch replaces both
    sides coherently — so the compacted diff is exact per tenant."""

    def __init__(self, slots: int, s: int, n: int, k: int,
                 device: torch.device):
        self.key = (s, n, k)
        self.slots, self.s, self.n, self.k = slots, s, n, k
        i32 = dict(dtype=torch.int32, device=device)
        self.src_dev = (
            torch.arange(n, **i32)[None, :, None].expand(slots, n, k).contiguous()
        )
        self.w_dev = torch.full((slots, n, k), INF, **i32)
        self.ov_dev = torch.zeros((slots, n), dtype=torch.bool, device=device)
        self.srcs_dev = torch.zeros((slots, s), **i32)
        self.d_dev = torch.zeros((slots, s, n), **i32)
        self.packed_dev = torch.zeros((slots, 2 * s, n), **i32)
        self.tenants: List[Optional[TenantWorld]] = [None] * slots
        self.delta_cap = min(slots * 2 * s, _DELTA_CAP_MAX)

    def free_slot(self) -> Optional[int]:
        for i, t in enumerate(self.tenants):
            if t is None:
                return i
        return None

    def occupancy(self) -> int:
        return sum(1 for t in self.tenants if t is not None)


# externally serialized, never internally locked: the serve plane
# drives its manager only under SolverService._mgr_lock, and every
# other instance (tenancy tests, twin replay) lives on one thread.
# The rule merges all instances by class, so cross-role access to one
# instance is impossible by construction — hence "owner" confinement.
@thread_confined(
    "owner",
    "_buckets",
    "_clock",
    "_graph_share",
    "_patch_share",
    "_slo_classes",
    "_tenants",
)
class WorldManager:
    """The residency arbiter + dispatch front end (see module
    docstring). One per process by default (``get_world_manager``) —
    the device blocks it owns are process-global state. ``device``
    (None = CUDA; raises without CUDA) holds every bucket's blocks."""

    def __init__(self, slots_per_bucket: Optional[int] = None,
                 max_resident: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        # the fused dispatch's operands: pinned and non_blocking, so a
        # launch never waits for the buckets already running
        self._stager = UploadStager(self.device)
        if slots_per_bucket is None:
            slots_per_bucket = int(
                os.environ.get("OPENR_WORLD_SLOTS", "8") or 8
            )
        if max_resident is None:
            max_resident = int(
                os.environ.get("OPENR_WORLD_RESIDENT", "64") or 64
            )
        self.slots_per_bucket = _pow2_at_least(
            max(1, slots_per_bucket), 1
        )
        self.max_resident = max(1, max_resident)
        self._buckets: Dict[Tuple[int, int, int], WorldBucket] = {}
        self._tenants: Dict[str, TenantWorld] = {}
        # vantage-view packing: tenants viewing the SAME LinkState share
        # one compiled EllGraph (and one journaled patch per version
        # transition) instead of paying compile_ell/ell_patch N times —
        # the fleet-twin admission path. Weakly keyed so a dead
        # LinkState never pins its graphs.
        self._graph_share: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )
        self._patch_share: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )
        self._clock = 0
        # SLO class labels survive drop/re-admit (a client's class is
        # a property of the tenant NAME, assigned at registration)
        self._slo_classes: Dict[str, str] = {}

    # -- public API --------------------------------------------------------

    def solve_views(self, items) -> List[Tuple]:
        """Sync + batch-solve a set of tenants in as few dispatches as
        buckets allow. ``items``: [(tenant_id, ls, root)] — or
        4-tuples [(tenant_id, ls, root, override)] where ``override``
        is a vantage-local {node: overloaded} view layered over the
        shared LSDB (the twin's per-node what-if seam). Returns the
        aligned [(graph, srcs, packed [2b, n_pad])] views. More
        requested tenants than a bucket has slots are solved in waves
        (each wave fills the bucket, solves, and yields its slots to
        the next — eviction/rehydration do the bookkeeping)."""
        tenants = []
        for item in items:
            tid, ls, root = item[0], item[1], item[2]
            override = item[3] if len(item) > 3 else None
            tenants.append(self._sync(tid, ls, root, override))
        pending = [t for t in tenants if t.needs_solve]
        with da.event_window("world_window"):
            self._solve_waves(tenants, pending)
        self._enforce_residency()
        self._update_gauges()
        return [t.view() for t in tenants]

    def _solve_waves(self, tenants, pending) -> None:
        """The wave loop of ``solve_views``, factored out so the whole
        multi-wave solve runs under ONE committed accounting window
        (``ops.host_touches.world_window``)."""
        waves = 0
        recoveries = 0
        while pending:
            waves += 1
            assert (
                waves <= 2 * len(tenants) + 2 + 2 * recoveries
            ), "tenancy livelock"
            for t in pending:
                self._ensure_resident(t)
            # launch every bucket's fused solve before blocking on the
            # first readback: dispatches are async, so bucket B's
            # compute overlaps bucket A's delta fan-out
            try:
                ctxs = [
                    self._dispatch_launch(bucket)
                    for bucket in {t.bucket for t in pending if t.bucket}
                ]
                ctxs = [ctx for ctx in ctxs if ctx is not None]
                if len(ctxs) > 1:
                    da.note_pipelined_dispatch(len(ctxs))
                for i, ctx in enumerate(ctxs):
                    if i + 1 < len(ctxs):
                        da.note_overlapped_reap()
                    self._dispatch_finish(ctx)
            except Exception as exc:  # noqa: BLE001 - loss triage below
                if not is_device_loss(exc) or recoveries >= 2:
                    raise
                recoveries += 1
                self._recover_device_loss()
            pending = [t for t in pending if t.needs_solve]

    def solve_view(self, tenant_id: str, ls, root: str,
                   override: Optional[Dict[str, bool]] = None):
        return self.solve_views([(tenant_id, ls, root, override)])[0]

    def solve_views_pipelined(self, batches) -> List[List[Tuple]]:
        """Pipelined multi-batch front end: batch i+1's bucket
        dispatches are SUBMITTED before batch i's readbacks are
        reaped, so the whole burst of solve waves costs one drain of
        host turnarounds instead of one per batch. ``batches`` is a
        sequence of ``solve_views`` item lists; returns the aligned
        per-batch view lists, bit-identical to calling ``solve_views``
        per batch in order.

        Hazard rule (the slot-reuse seam): a batch whose placement or
        re-dispatch would touch a bucket with an in-flight readback
        drains the pipeline first — an eviction or journal re-emission
        under an unreaped dispatch would misattribute the compacted
        delta fan-out. Same-ls batches therefore pipeline only when
        their tenants land in disjoint shape buckets; the degenerate
        sequential order is always correct, never silent (the drain
        just shortens)."""
        batches = [list(b) for b in batches]
        results: List[Optional[List[Tuple]]] = [None] * len(batches)
        if not batches:
            return []
        with da.pipeline_drain("world_drain"):
            # in-flight entries: (batch index, synced tenants, launch
            # contexts whose readbacks have not been reaped yet)
            inflight: List[Tuple[int, list, list]] = []
            try:
                for bi, items in enumerate(batches):
                    tenants = []
                    for item in items:
                        tid, ls, root = item[0], item[1], item[2]
                        override = item[3] if len(item) > 3 else None
                        tenants.append(
                            self._sync(tid, ls, root, override)
                        )
                    pending = [t for t in tenants if t.needs_solve]
                    busy = {
                        id(ctx[0])
                        for _pbi, _tn, ctxs in inflight
                        for ctx in ctxs
                    }
                    if busy and any(
                        id(self._buckets.get(t.dims)) in busy
                        or (t.bucket is not None and id(t.bucket) in busy)
                        for t in pending
                    ):
                        self._drain_inflight(inflight, results)
                    for t in pending:
                        self._ensure_resident(t)
                    if any(t.slot is None for t in pending):
                        # a batch wider than its bucket needs the
                        # multi-wave loop; that loop reuses slots, so
                        # it owns the whole device alone
                        self._drain_inflight(inflight, results)
                        self._solve_waves(tenants, pending)
                        results[bi] = [t.view() for t in tenants]
                        da.note_window()
                        continue
                    ctxs = [
                        ctx
                        for ctx in (
                            self._dispatch_launch(bucket)
                            for bucket in {
                                t.bucket for t in pending if t.bucket
                            }
                        )
                        if ctx is not None
                    ]
                    if ctxs and inflight:
                        da.note_pipelined_dispatch(len(inflight) + 1)
                    inflight.append((bi, tenants, ctxs))
                    da.note_window()
                self._drain_inflight(inflight, results)
            except Exception as exc:  # noqa: BLE001 - loss triage below
                if not is_device_loss(exc):
                    raise
                # the in-flight contexts died with the device; recovery
                # demotes everyone to host snapshots and the stragglers
                # re-solve sequentially below (warm rehydration)
                inflight.clear()
                self._recover_device_loss()
        for bi, items in enumerate(batches):
            if results[bi] is None:
                results[bi] = self.solve_views(items)
        self._enforce_residency()
        self._update_gauges()
        return results

    def _drain_inflight(self, inflight, results) -> None:
        """Reap every in-flight launch in submission order and settle
        its batch's views. Reaps drained while later batches' launches
        are still in flight are the double-buffer overlap the
        accounting witnesses."""
        while inflight:
            bi, tenants, ctxs = inflight.pop(0)
            for ctx in ctxs:
                if inflight:
                    da.note_overlapped_reap()
                self._dispatch_finish(ctx)
            results[bi] = [t.view() for t in tenants]

    def ksp2_view(self, tenant_id: str, dsts: Sequence[str]):
        """Second-path (KSP2) view for a SOLVED tenant: first paths
        traced from the resident SP view's root distance row, per-dst
        edge masks over the first paths' links, ONE batched masked
        device solve per pow2 chunk (``ell_masked_distances`` — rides
        the committed ``ksp2_masked_host`` dispatch, so warm waves
        capture nothing new), second paths traced from the masked rows.
        Returns ``{dst: [first_paths..., second_paths...]}`` in exactly
        ``ls.get_kth_paths(root, dst, 1) + (…, 2)`` layout (byte-equal
        traces: same canonical predecessor order). Destinations whose
        exclusion set is unrepresentable in the packed layout are
        answered by the host oracle on a CPU manager — deterministic,
        never silent (counted in ``tenancy.ksp2_host_fallbacks``); a
        manager on the card raises instead, so its answers all come
        from the masked kernel."""
        from openr_tpu_torch.decision.ksp2_engine import (
            make_cands_of,
            trace_paths_from_row,
        )
        from openr_tpu_torch.ops import spf_sparse

        t = self._tenants[tenant_id]
        ls = t.ls_ref()
        if ls is None or not t.solved or t.needs_solve:
            raise RuntimeError(
                f"ksp2_view({tenant_id!r}) requires a settled solve"
            )
        graph, srcs, packed = t.view()
        root = t.root
        sid = srcs[0]
        d_base = packed[0].astype(np.int64)
        cands_of = make_cands_of(ls, graph.node_index)
        transit_blocked = {
            name
            for name in graph.node_names
            if ls.is_node_overloaded(name) and name != root
        }
        out: Dict[str, List] = {}
        excl: Dict[str, set] = {}
        preds_cache: Dict[str, list] = {}
        for dst in dsts:
            firsts = trace_paths_from_row(
                root, dst, graph.node_index, d_base, set(),
                cands_of, transit_blocked, preds_cache,
            )
            out[dst] = list(firsts)
            excl[dst] = {l for p in firsts for l in p}
        TENANCY_COUNTERS["ksp2_views"] += 1
        par = (
            ls.parallel_pairs() if graph.slot_of is None else None
        )
        host_fallbacks = 0
        order = list(dsts)
        for start in range(0, len(order), 64):
            batch = order[start : start + 64]
            bucket = 8
            while bucket < len(batch):
                bucket *= 2
            pad = bucket - len(batch)
            masks, ok = spf_sparse.build_edge_masks(
                graph, [excl[d] for d in batch] + [set()] * pad, par
            )
            drows = spf_sparse.ell_masked_distances(
                graph, sid, masks, device=self.device
            )
            for i, dst in enumerate(batch):
                if not ok[i]:
                    if self.device.type != "cpu":
                        raise RuntimeError(
                            f"ksp2_view({tenant_id!r}): the exclusions of "
                            f"{dst!r} cannot be packed as an edge mask"
                        )
                    host_fallbacks += 1
                    out[dst] = ls.get_kth_paths(
                        root, dst, 1
                    ) + ls.get_kth_paths(root, dst, 2)
                    continue
                out[dst] = out[dst] + trace_paths_from_row(
                    root, dst, graph.node_index,
                    drows[i].astype(np.int64), excl[dst],
                    cands_of, transit_blocked,
                )
        if host_fallbacks:
            _get_registry().counter_bump(
                "tenancy.ksp2_host_fallbacks", host_fallbacks
            )
        return out

    def drop(self, tenant_id: str) -> None:
        t = self._tenants.pop(tenant_id, None)
        if t is not None and t.slot is not None:
            self._detach(t)
        self._update_gauges()

    def park(self, tenant_id: str) -> None:
        """Warm detach: free the tenant's device slot but KEEP its host
        record (mirror + journal), so a later solve rehydrates warm.
        The serve plane's client-disconnect path — a vanished client
        must not poison the bucket its tenants shared, and must not
        cold-solve if it reconnects."""
        t = self._tenants.get(tenant_id)
        if t is not None and t.slot is not None:
            self._detach(t)
        self._update_gauges()

    # -- live migration (fleet plane) --------------------------------------

    def export_tenant(self, tenant_id: str) -> Dict[str, object]:
        """Serialize a tenant's host record for live migration: the
        packed mirror, the un-replayed journal tail, and the solve
        flags — everything ``import_tenant`` needs to rehydrate WARM
        on another manager. The record is valid on the far side
        because ``compile_ell`` is deterministic: a LinkState rebuilt
        from the same adjacency content reproduces the numbering the
        mirror and journal are expressed in. The tenant is parked
        first (slot freed) so the record cannot race a resident
        dispatch; the CALLER owns draining any in-flight wave before
        exporting (the serve plane's quiesce)."""
        t = self._tenants.get(tenant_id)
        if t is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        if t.slot is not None:
            self._detach(t)
            self._update_gauges()
        rec: Dict[str, object] = {
            "tenant_id": t.tenant_id,
            "root": t.root,
            "srcs": [int(s) for s in t.srcs],
            "slo": self._slo_classes.get(tenant_id, t.slo),
            "solved": bool(t.solved),
            "needs_solve": bool(t.needs_solve),
            "force_reset": bool(t.force_reset),
            "pending_structural": bool(t.pending_structural),
            "override": dict(t.override),
            "pending_rows": sorted(int(r) for r in t.pending_rows),
            "pending_edges": [
                [int(s), int(h), int(snap), int(cur)]
                for (s, h), (snap, cur) in sorted(
                    t.pending_edges.items()
                )
            ],
            "ov_solved_b64": base64.b64encode(
                np.ascontiguousarray(
                    t.ov_solved, dtype=bool
                ).tobytes()
            ).decode("ascii"),
            "packed_host": None,
        }
        if t.packed_host is not None:
            ph = np.ascontiguousarray(t.packed_host, dtype=np.int32)
            rec["packed_host"] = {
                "shape": list(ph.shape),
                "b64": base64.b64encode(ph.tobytes()).decode("ascii"),
            }
        TENANCY_COUNTERS["tenant_exports"] += 1
        return rec

    def import_tenant(self, ls, record: Dict[str, object]) -> TenantWorld:
        """Rehydrate an exported record against ``ls`` (a LinkState
        rebuilt from the same adjacency content the exporter held).
        The shipped mirror seeds the next placement warm — the first
        post-migration solve is a warm solve with zero compiles, the
        live-migration no-cold-solve contract. A record whose source
        batch no longer matches (content drift between export and
        import) degrades to a cold admission: bits stay correct, the
        miss is counted (``tenancy.tenant_import_colds``), never
        silent."""
        tid = str(record["tenant_id"])
        self.drop(tid)
        root = str(record["root"])
        graph = self._shared_graph(ls)
        srcs = ell_source_batch(graph, ls, root)
        t = TenantWorld(tid, ls, root, graph, srcs)
        self._tenants[tid] = t
        slo = str(record.get("slo", "standard"))
        self._slo_classes[tid] = slo
        t.slo = slo
        t.version = ls.topology_version
        TENANCY_COUNTERS["admissions"] += 1
        TENANCY_COUNTERS["tenant_imports"] += 1
        ph = record.get("packed_host")
        warm = (
            bool(record.get("solved"))
            and isinstance(ph, dict)
            and [int(s) for s in record.get("srcs", [])]
            == [int(s) for s in srcs]
        )
        if not warm:
            TENANCY_COUNTERS["tenant_import_colds"] += 1
            self._update_gauges()
            return t
        shape = tuple(int(x) for x in ph["shape"])
        t.packed_host = (
            np.frombuffer(base64.b64decode(ph["b64"]), dtype=np.int32)
            .reshape(shape)
            .copy()
        )
        t.ov_solved = np.frombuffer(
            base64.b64decode(record["ov_solved_b64"]), dtype=bool
        ).copy()
        t.pending_edges = {
            (int(s), int(h)): (int(snap), int(cur))
            for s, h, snap, cur in record.get("pending_edges", [])
        }
        t.pending_rows = {
            int(r) for r in record.get("pending_rows", [])
        }
        t.pending_structural = bool(record.get("pending_structural"))
        t.force_reset = bool(record.get("force_reset"))
        t.needs_solve = bool(record.get("needs_solve"))
        t.solved = True
        t.override = {
            str(k): bool(v)
            for k, v in (record.get("override") or {}).items()
        }
        if t.override:
            # a vantage-local override diverges from the shared LSDB
            # truth; the shipped journal cannot vouch for it here —
            # same forced-cold rule as _apply_override
            t.force_reset = True
            t.needs_solve = True
        self._update_gauges()
        return t

    def set_slo_class(self, tenant_id: str, slo: str) -> None:
        """Stamp a tenant's SLO class (serve plane admission input).
        Sticky across drop/re-admit; unknown class names are rejected
        here so a typo never silently lands in ``standard``."""
        if slo not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class: {slo!r}")
        self._slo_classes[tenant_id] = slo
        t = self._tenants.get(tenant_id)
        if t is not None:
            t.slo = slo

    def slo_class(self, tenant_id: str) -> str:
        return self._slo_classes.get(tenant_id, "standard")

    def reset(self) -> None:
        """Release every device block and tenant record (the
        degradation ladder's cold rung — nothing cached across a torn
        dispatch may leak into the recovered state)."""
        self._buckets = {}
        self._tenants = {}
        self._graph_share = weakref.WeakKeyDictionary()
        self._patch_share = weakref.WeakKeyDictionary()
        self._update_gauges()

    def _recover_device_loss(self) -> None:
        """Device-loss fault boundary: every resident block is suspect,
        so demote every tenant to its host snapshot and drop the device
        buckets. The mirrors and journals are pre-dispatch state —
        ``_dispatch_finish`` settles them only on success, so a torn
        dispatch leaves nothing half-committed on the host — and the
        next wave re-places each pending tenant from ``packed_host``
        (a warm rehydration, not a cold solve). Never silent: counted
        in ``tenancy.device_loss_recoveries`` + ``recovery.device_lost``."""
        for t in self._tenants.values():
            if t.slot is not None:
                self._detach(t)
        self._buckets = {}
        TENANCY_COUNTERS["device_loss_recoveries"] += 1
        _get_registry().counter_bump("recovery.device_lost")

    def resident_count(self) -> int:
        return sum(
            1 for t in self._tenants.values() if t.slot is not None
        )

    def bucket_count(self) -> int:
        return len(self._buckets)

    # -- sync / journal ----------------------------------------------------

    def _sync(self, tenant_id: str, ls, root: str,
              override: Optional[Dict[str, bool]] = None) -> TenantWorld:
        self._clock += 1
        t = self._tenants.get(tenant_id)
        if t is not None and (t.ls_ref() is not ls or t.root != root):
            # a new world under an old name: identity goes through the
            # live object, never id()/name reuse
            self.drop(tenant_id)
            t = None
        if t is None:
            graph = self._shared_graph(ls)
            t = TenantWorld(
                tenant_id, ls, root, graph,
                ell_source_batch(graph, ls, root),
            )
            self._tenants[tenant_id] = t
            t.slo = self._slo_classes.get(tenant_id, "standard")
            TENANCY_COUNTERS["admissions"] += 1
        elif t.version != ls.topology_version:
            shared = self._shared_patched(t, ls)
            if shared is None:
                # journal gap or node-set change: recompile from the
                # LinkState; numbering may move, so the old mirror and
                # journal are unusable — cold solve
                graph = self._shared_graph(ls)
                self._reset_world(
                    t, graph, ell_source_batch(graph, ls, root)
                )
            else:
                patched, stripped = shared
                self._apply_patch(t, patched, stripped)
                srcs = ell_source_batch(t.graph, ls, root)
                if srcs != t.srcs:
                    # the source batch moved (neighbor set churn):
                    # same contract as EllState._warm_key — previous
                    # distance rows describe other sources, force the
                    # cold seed
                    t.srcs = list(srcs)
                    t.srcs_dirty = True
                    t.force_reset = True
            t.version = ls.topology_version
            t.needs_solve = True
        self._apply_override(t, ls, override)
        t.last_used = self._clock
        return t

    # -- vantage-view packing ----------------------------------------------

    def _shared_graph(self, ls) -> EllGraph:
        """Version-current compiled EllGraph for ``ls``, shared across
        every tenant viewing the same world: a fleet twin admitting N
        vantages pays ONE ``compile_ell``, and the shared object
        identity is what lets ``_shared_patched`` share the per-version
        patch across those tenants afterwards."""
        entry = self._graph_share.get(ls)
        if entry is not None and entry[0] == ls.topology_version:
            TENANCY_COUNTERS["graph_shares"] += 1
            return entry[1]
        graph = compile_ell(ls)
        self._graph_share[ls] = (ls.topology_version, graph)
        return graph

    def _shared_patched(self, t: TenantWorld, ls):
        """One journaled ``ell_patch`` per (ls, version transition,
        base graph), shared by every tenant whose graph IS that base —
        the common fleet case where all vantages sync in lockstep.
        Returns ``(patched, stripped)`` (with/without the ``changed``
        row map) or None when the journal has a gap or the node set
        moved (caller recompiles via ``_shared_graph``). The stripped
        twin is cached alongside so sharing tenants land on the SAME
        object identity and keep hitting this cache next transition."""
        entries = self._patch_share.get(ls)
        if entries:
            for fv, tv, base, patched, stripped in entries:
                if (
                    fv == t.version
                    and tv == ls.topology_version
                    and base is t.graph
                ):
                    TENANCY_COUNTERS["graph_shares"] += 1
                    return patched, stripped
        affected = ls.affected_since(t.version)
        patched = (
            ell_patch(t.graph, ls, sorted(affected), widen=True)
            if affected is not None
            else None
        )
        if patched is None:
            return None
        stripped = _replace(patched, changed=None)
        # bounded FIFO per ls: staggered fleets (vantages at mixed
        # versions) keep a few transitions live without thrash
        entries = list(entries or [])[-3:]
        entries.append(
            (t.version, ls.topology_version, t.graph, patched, stripped)
        )
        self._patch_share[ls] = entries
        return patched, stripped

    def _base_overloaded(self, t: TenantWorld, ls) -> np.ndarray:
        """The ls-truth overload vector in ``t.graph``'s numbering —
        the baseline per-vantage overrides fold into (and restore
        from)."""
        entry = self._graph_share.get(ls)
        if (
            entry is not None
            and entry[0] == ls.topology_version
            and len(entry[1].overloaded) == len(t.graph.overloaded)
        ):
            return np.array(entry[1].overloaded, copy=True)
        adj = ls.get_adjacency_databases()
        base = np.array(t.graph.overloaded, copy=True)
        for node, i in t.graph.node_index.items():
            db = adj.get(node)
            if db is not None and i < len(base):
                base[i] = bool(db.is_overloaded)
        return base

    def _apply_override(self, t: TenantWorld, ls,
                        override: Optional[Dict[str, bool]]) -> None:
        """Per-node override: a vantage-local overload view layered
        over the shared LSDB (the twin's what-if drain seam). A tenant
        with an active override always solves via the forced-reset
        sentinel — same executable, same dispatch wave, never a
        retrace — because the warm-start journal argues soundness
        against the SHARED overload state, which an override
        deliberately diverges from."""
        ov_map = {str(k): bool(v) for k, v in (override or {}).items()}
        changed = ov_map != t.override
        if changed:
            t.override = ov_map
            t.needs_solve = True
        if not ov_map and not changed:
            return
        ov = self._base_overloaded(t, ls)
        idx = t.graph.node_index
        for node, flag in ov_map.items():
            i = idx.get(node)
            if i is not None and i < len(ov):
                ov[i] = flag
        if not np.array_equal(ov, np.asarray(t.graph.overloaded)):
            t.graph = _replace(t.graph, overloaded=ov)
            if t.slot is not None and t.bucket is not None:
                full = np.zeros(t.bucket.n, dtype=bool)
                full[: len(ov)] = ov
                t.bucket.ov_dev = _slot_set(
                    t.bucket.ov_dev, np.int32(t.slot), full
                )
        # overridden OR just-restored state: the journal cannot vouch
        # for either transition, so the next solve is cold
        t.force_reset = True
        if t.needs_solve:
            TENANCY_COUNTERS["override_solves"] += 1

    def _reset_world(self, t: TenantWorld, graph: EllGraph,
                     srcs: List[int]) -> None:
        old_dims = t.dims
        t.graph = graph
        t.srcs = list(srcs)
        t.packed_host = None
        t.pending_edges = {}
        t.pending_rows = set()
        t.ov_solved = np.array(graph.overloaded, copy=True)
        t.pending_structural = False
        t.force_reset = True
        t.solved = False
        t.srcs_dirty = True
        if t.slot is not None and t.dims != old_dims:
            self._detach(t)

    def _apply_patch(self, t: TenantWorld, patched: EllGraph,
                     stripped: Optional[EllGraph] = None) -> None:
        ov_changed = not np.array_equal(
            t.graph.overloaded, patched.overloaded
        )
        self._journal_patch(t, patched, ov_changed)
        rows = sorted(
            int(patched.bands[bi].start) + int(r)
            for bi, rs in (patched.changed or {}).items()
            for r in np.asarray(rs)
        )
        old_dims = t.dims
        # the caller-provided stripped twin keeps same-ls tenants on
        # ONE graph object (vantage-view packing's identity contract)
        t.graph = (
            stripped if stripped is not None
            else _replace(patched, changed=None)
        )
        # changed rows go STALE on device and ride the next fused
        # dispatch as in-kernel scatter operands (placement's full
        # re-pack subsumes them for non-residents and migrants)
        t.pending_rows.update(rows)
        if t.slot is None:
            return  # non-resident: placement re-packs from the graph
        if t.dims != old_dims:
            # a widened row outgrew the bucket's k: migrate (the warm
            # mirror + journal move with the tenant — placement decides
            # whether the shapes still permit a warm seed)
            self._detach(t)
            TENANCY_COUNTERS["bucket_migrations"] += 1
            return
        bucket = t.bucket
        if ov_changed:
            ov = np.zeros(bucket.n, dtype=bool)
            ov[: len(t.graph.overloaded)] = t.graph.overloaded
            bucket.ov_dev = _slot_set(
                bucket.ov_dev, np.int32(t.slot), ov
            )

    def _journal_patch(self, t: TenantWorld, patched: EllGraph,
                       ov_changed: bool) -> None:
        """EllState._note_patch over the host tenant record: merge the
        patch's edge delta into the warm-start journal (first-touch
        snapshots), journal flipped nodes' out-edges across an
        overload change. Skipped before the first solve — there is
        nothing warm to protect yet."""
        if not t.solved:
            return
        if ov_changed:
            t.pending_structural = True
            flipped = np.nonzero(
                np.asarray(t.graph.overloaded)
                != np.asarray(patched.overloaded)
            )[0]
            collapsed: Dict[Tuple[int, int], int] = {}
            pos = 0
            for src_b, w_b in zip(t.graph.src, t.graph.w):
                hit = np.isin(src_b, flipped) & (w_b < INF)
                for r, sl in zip(*np.nonzero(hit)):
                    key = (int(src_b[r, sl]), pos + int(r))
                    wv = int(w_b[r, sl])
                    if wv < collapsed.get(key, INF):
                        collapsed[key] = wv
                pos += src_b.shape[0]
            for key, wv in collapsed.items():
                t.pending_edges.setdefault(key, (wv, wv))
        if not patched.changed:
            return
        structural = False
        for s, h, wo, wn in band_row_edge_changes(t.graph, patched):
            snap, _cur = t.pending_edges.get((s, h), (wo, wo))
            t.pending_edges[(s, h)] = (snap, wn)
            structural = structural or wo >= INF or wn >= INF
        if structural:
            t.pending_structural = True

    def _emit_increases(self, t: TenantWorld, ov_now: np.ndarray):
        """EllState._emit_increases over the tenant journal (same
        effective-weight soundness argument)."""
        inc = []
        for (s, h), (snap, cur) in t.pending_edges.items():
            if snap >= INF:
                continue
            snap_eff = INF if t.ov_solved[s] else snap
            cur_eff = INF if ov_now[s] else cur
            if cur > snap or cur_eff > snap_eff:
                inc.append((s, h, snap))
        return inc

    # -- placement / residency ---------------------------------------------

    def _bucket_for(self, dims: Tuple[int, int, int]) -> WorldBucket:
        bucket = self._buckets.get(dims)
        if bucket is None:
            bucket = WorldBucket(self.slots_per_bucket, *dims, self.device)
            self._buckets[dims] = bucket
            TENANCY_COUNTERS["bucket_compiles"] += 1
        return bucket

    def _ensure_resident(self, t: TenantWorld) -> None:
        dims = t.dims
        if (
            t.slot is not None
            and t.bucket is not None
            and t.bucket.key == dims
        ):
            return
        if t.slot is not None:
            self._detach(t)
            TENANCY_COUNTERS["bucket_migrations"] += 1
        bucket = self._bucket_for(dims)
        slot = bucket.free_slot()
        if slot is None and bucket.slots < self.slots_per_bucket:
            # a previously compacted bucket refilled: grow it back
            # toward the configured width before evicting anyone
            bucket = self._resize_bucket(bucket, bucket.slots * 2)
            slot = bucket.free_slot()
        if slot is None:
            slot = self._evict_lru(bucket)
        self._place(t, bucket, slot)

    def _resize_bucket(self, bucket: WorldBucket,
                       slots: int) -> WorldBucket:
        """Replace a bucket with a ``slots``-wide twin and warm
        re-place its occupants (mirror + journal ride along — same
        upload path as rehydration, so bits are preserved). A resized
        block is a NEW dispatch shape: the executable for the new B
        compiles once (counted in ``bucket_compiles``), which is why
        compaction only fires past a real vacancy threshold."""
        fresh = WorldBucket(slots, *bucket.key, self.device)
        self._buckets[bucket.key] = fresh
        TENANCY_COUNTERS["bucket_compiles"] += 1
        occupants = [t for t in bucket.tenants if t is not None]
        for t in occupants:
            self._detach(t)
        for t in occupants:
            self._place(t, fresh, fresh.free_slot())
        return fresh

    def compact_buckets(self, vacancy: float = 0.5) -> int:
        """Occupancy-sized dispatch: shrink every bucket whose vacancy
        exceeds ``vacancy`` down to the power-of-two width that fits
        its occupants (empty buckets are dropped outright), so a
        half-empty fleet stops paying full-width solves. Returns the
        number of buckets compacted. The serve plane calls this
        between waves; callers that never compact keep the old
        fixed-width behavior."""
        compacted = 0
        for key in sorted(self._buckets):
            bucket = self._buckets[key]
            occ = bucket.occupancy()
            if occ == 0:
                del self._buckets[key]
                compacted += 1
                TENANCY_COUNTERS["bucket_compactions"] += 1
                continue
            target = _pow2_at_least(occ, 1)
            if target >= bucket.slots or occ > bucket.slots * (
                1.0 - vacancy
            ):
                continue
            self._resize_bucket(bucket, target)
            compacted += 1
            TENANCY_COUNTERS["bucket_compactions"] += 1
        return compacted

    def _place(self, t: TenantWorld, bucket: WorldBucket,
               slot: int) -> None:
        s_slot, n_slot, k_slot = bucket.key
        mirror_shape = (2 * s_slot, n_slot)
        if t.packed_host is None or t.packed_host.shape != mirror_shape:
            # no (shape-compatible) previous view: the warm seed has
            # nothing sound to start from
            t.packed_host = np.zeros(mirror_shape, dtype=np.int32)
            t.force_reset = True
            t.solved = False
        elif t.solved:
            TENANCY_COUNTERS["rehydrations"] += 1
        TENANCY_COUNTERS["placements"] += 1
        src, w, ov = ell_pack_uniform(t.graph, n_slot, k_slot)
        srcs_row = np.full(s_slot, t.srcs[0], dtype=np.int32)
        srcs_row[: len(t.srcs)] = t.srcs
        sl = np.int32(slot)
        bucket.src_dev = _slot_set(bucket.src_dev, sl, src)
        bucket.w_dev = _slot_set(bucket.w_dev, sl, w)
        bucket.ov_dev = _slot_set(bucket.ov_dev, sl, ov)
        bucket.srcs_dev = _slot_set(bucket.srcs_dev, sl, srcs_row)
        bucket.d_dev = _slot_set(
            bucket.d_dev, sl, t.packed_host[:s_slot]
        )
        bucket.packed_dev = _slot_set(
            bucket.packed_dev, sl, t.packed_host
        )
        bucket.tenants[slot] = t
        t.bucket = bucket
        t.slot = slot
        t.srcs_dirty = False
        t.pending_rows = set()  # the full pack above subsumed them

    def _detach(self, t: TenantWorld) -> None:
        """Demote to the host snapshot. The vacated slot's device rows
        stay in place — an unoccupied slot re-solves its stale fixed
        point idempotently (no packed change, no readback) until the
        next occupant's placement overwrites it."""
        if t.bucket is not None and t.slot is not None:
            t.bucket.tenants[t.slot] = None
        t.bucket = None
        t.slot = None

    def _evict_lru(self, bucket: WorldBucket) -> int:
        victims = [
            (t.last_used, slot)
            for slot, t in enumerate(bucket.tenants)
            if t is not None
        ]
        _, slot = min(victims)
        self._detach(bucket.tenants[slot])
        TENANCY_COUNTERS["evictions"] += 1
        return slot

    def _enforce_residency(self) -> None:
        while self.resident_count() > self.max_resident:
            t = min(
                (
                    t
                    for t in self._tenants.values()
                    if t.slot is not None
                ),
                key=lambda t: t.last_used,
            )
            self._detach(t)
            TENANCY_COUNTERS["evictions"] += 1

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, bucket: WorldBucket) -> None:
        ctx = self._dispatch_launch(bucket)
        if ctx is not None:
            self._dispatch_finish(ctx)

    @committed_dispatch
    def _dispatch_launch(self, bucket: WorldBucket):
        """Phase 1 of a bucket dispatch: journal emission, patch-operand
        prep, and the (async) fused device call. Returns the in-flight
        context for _dispatch_finish, which owns the blocking readback
        — solve_views launches EVERY bucket before finishing the first,
        so bucket B's solve overlaps bucket A's readback and host
        fan-out instead of serializing on it."""
        solving = [
            (slot, t)
            for slot, t in enumerate(bucket.tenants)
            if t is not None and t.needs_solve
        ]
        if not solving:
            return None
        _tracer = _get_tracer()
        _span = _tracer.span_active("ops.tenant_dispatch")
        _t0 = time.perf_counter()
        bsz, s, n, k = bucket.slots, bucket.s, bucket.n, bucket.k
        inc_t = np.zeros((bsz, _INC_SLOTS), dtype=np.int32)
        inc_h = np.zeros((bsz, _INC_SLOTS), dtype=np.int32)
        inc_w = np.full((bsz, _INC_SLOTS), INF, dtype=np.int32)
        # in-kernel patch operands; the out-of-bounds row id ``n``
        # marks padding (and untouched slots) — the fused scatter
        # drops it, so idle lanes cost nothing
        p_rows = np.full((bsz, _PATCH_SLOTS), n, dtype=np.int32)
        p_src = np.zeros((bsz, _PATCH_SLOTS, k), dtype=np.int32)
        p_w = np.zeros((bsz, _PATCH_SLOTS, k), dtype=np.int32)
        warm_ct = cold_ct = 0
        for slot, t in solving:
            if t.srcs_dirty:
                srcs_row = np.full(s, t.srcs[0], dtype=np.int32)
                srcs_row[: len(t.srcs)] = t.srcs
                bucket.srcs_dev = _slot_set(
                    bucket.srcs_dev, np.int32(slot), srcs_row
                )
                t.srcs_dirty = False
            if t.pending_rows:
                rows = sorted(t.pending_rows)
                t.pending_rows = set()
                if len(rows) > _PATCH_SLOTS:
                    # patch wider than the in-kernel row budget:
                    # re-upload the whole slot (one warm executable)
                    # instead of growing a scatter-shape ladder
                    TENANCY_COUNTERS["patch_overflows"] += 1
                    src_u, w_u, _ov = ell_pack_uniform(t.graph, n, k)
                    sl = np.int32(slot)
                    bucket.src_dev = _slot_set(
                        bucket.src_dev, sl, src_u
                    )
                    bucket.w_dev = _slot_set(bucket.w_dev, sl, w_u)
                else:
                    ids = np.asarray(rows, dtype=np.int32)
                    src_rows, w_rows = ell_uniform_rows(t.graph, ids, k)
                    p_rows[slot, : len(rows)] = ids
                    p_src[slot, : len(rows)] = src_rows
                    p_w[slot, : len(rows)] = w_rows
            ov_now = np.asarray(t.graph.overloaded)
            edges = None
            if t.solved and not t.force_reset:
                edges = self._emit_increases(t, ov_now)
                if len(edges) > _INC_SLOTS:
                    edges = None  # journal wider than the slot budget
            if edges is None:
                edges = [_FORCE_RESET_EDGE]
                cold_ct += 1
            else:
                warm_ct += 1
            for x, (tt, hh, ww) in enumerate(edges):
                inc_t[slot, x] = tt
                inc_h[slot, x] = hh
                inc_w[slot, x] = ww
        cap = bucket.delta_cap
        fault_point(FAULT_DEVICE_LOST)
        slo_counts = {cls: 0 for cls in SLO_CLASSES}
        for _slot, t in solving:
            slo_counts[t.slo] = slo_counts.get(t.slo, 0) + 1
        # label the sampled device timing with this bucket's shape key
        # and its dominant SLO class, so ops.device_ms.by_bucket.* /
        # by_slo.* attribute the wave per tenant bucket and SLO
        dominant = max(slo_counts, key=slo_counts.get) if solving \
            else "idle"
        with _get_profiler().labels(
            bucket=f"{bucket.s}x{bucket.n}x{bucket.k}", slo=dominant,
        ):
            # the patch and increase operands are staged uploads made
            # here, outside the captured body; the body runs a hop
            # budget whose status is staged with the delta and read in
            # _dispatch_finish (a budget that ran out re-dispatches
            # there against the same untouched inputs)
            dyn_args = (
                bucket.src_dev, bucket.w_dev, bucket.ov_dev,
                bucket.srcs_dev,
                *self._stager.upload([
                    ("patch", p_rows), ("patch", p_src), ("patch", p_w),
                    ("increase", inc_t), ("increase", inc_h),
                    ("increase", inc_w),
                ]),
                bucket.d_dev, bucket.packed_dev,
            )
            launched = _budgeted_launch(
                "world_dispatch", world_dispatch, dyn_args, dict(cap=cap),
                n, shape=(n, k),
            )
        packed, d, src_new, w_new, ch_count, out = launched[0]
        bucket.src_dev = src_new
        bucket.w_dev = w_new
        bucket.d_dev = d
        bucket.packed_dev = packed
        # both readback lanes kicked at submit; _dispatch_finish reaps
        ch_count = da.kick_async(ch_count)
        out = da.kick_async(out)
        # launch-epoch versions: _dispatch_finish may reap AFTER a
        # tenant was parked (fleet migration drains make that window
        # routine) or even re-synced; the finish-side settle must know
        # which world this dispatch actually solved
        launch_ver = {slot: t.version for slot, t in solving}
        return (
            bucket, solving, warm_ct, cold_ct,
            packed, ch_count, out, _span, _t0, slo_counts, launch_ver,
            dyn_args, launched,
        )

    @committed_dispatch
    def _dispatch_finish(self, ctx) -> None:
        """Phase 2: block on the in-flight solve, fan the compacted
        delta back out to the per-tenant host mirrors, and settle the
        journals + counters + span."""
        (
            bucket, solving, warm_ct, cold_ct,
            packed, ch_count, out, _span, _t0, slo_counts, launch_ver,
            dyn_args, launched,
        ) = ctx
        cap = bucket.delta_cap
        outs, _hops = _budgeted_reap(
            "world_dispatch", world_dispatch, dyn_args, dict(cap=cap),
            bucket.n, launched, shape=(bucket.n, bucket.k),
        )
        if outs is not launched[0]:
            # the launch's budget ran out: a re-dispatch solved the
            # same inputs again, and its outputs are the bucket's
            packed, d, src_new, w_new, ch_count, out = outs
            bucket.src_dev = src_new
            bucket.w_dev = w_new
            bucket.d_dev = d
            bucket.packed_dev = packed
            ch_count = da.kick_async(ch_count)
            out = da.kick_async(out)
        mirror_shape = (2 * bucket.s, bucket.n)

        # A tenant parked between submit and reap vacated its
        # bucket.tenants slot, but it is still OWED this dispatch's
        # delta — its journal was emitted into this solve. Dropping
        # the rows while the settle loop below clears the journal
        # would leave a stale mirror marked solved (the un-reaped-
        # delta bug; the fleet migration drain makes the window
        # routine). Attribute vacated slots back to the launch-time
        # occupant, as long as its record still describes the world
        # this dispatch solved (same version, shape-intact mirror).
        launched = dict(solving)

        def _sink_of(slot_i: int) -> Optional[TenantWorld]:
            t = bucket.tenants[slot_i]
            if t is not None:
                return t
            lt = launched.get(slot_i)
            if (
                lt is not None
                and lt.version == launch_ver[slot_i]
                and lt.packed_host is not None
                and lt.packed_host.shape == mirror_shape
            ):
                return lt
            return None  # record moved under the dispatch: drop

        # count + compacted rows were both kicked at launch: reaping
        # them here is the window's single read phase, overlapped with
        # the other buckets' still-running solves
        cnt = int(da.reap_read(ch_count, kicked=True))
        out_host = da.reap_read(out, kicked=True)
        # openr-lint: disable=host-branch-in-chain -- post-reap settle: overflow-vs-delta here picks which already-reaped buffer to copy, not what to submit (audited)
        if cnt > cap:
            TENANCY_COUNTERS["delta_overflows"] += 1
            full = da.reap_read(packed)
            for slot in range(bucket.slots):
                t = _sink_of(slot)
                if t is not None:
                    t.packed_host = np.array(full[slot])
        # openr-lint: disable=host-branch-in-chain -- post-reap settle: the count only sizes the host mirror patch (audited)
        elif cnt:
            rows = out_host[:cnt]
            slots = rows[:, 0]
            for slot in np.unique(slots):
                t = _sink_of(int(slot))
                if t is None:
                    continue  # vacated slot: stale rows, drop
                m = slots == slot
                t.packed_host[rows[m, 1]] = rows[m, 2:]
        TENANCY_COUNTERS["delta_rows"] += cnt
        TENANCY_COUNTERS["dispatches"] += 1
        TENANCY_COUNTERS["warm_solves"] += warm_ct
        TENANCY_COUNTERS["cold_solves"] += cold_ct
        for _slot, t in solving:
            if bucket.tenants[_slot] is not t:
                # parked (or dropped) between submit and reap
                if _sink_of(_slot) is not t:
                    # the record moved under the dispatch (re-synced
                    # or reset): the delta was dropped above, so the
                    # journal must survive and the next admission
                    # must not trust the mirror — cold, never silent
                    TENANCY_COUNTERS["park_midflight_resets"] += 1
                    t.force_reset = True
                    t.solved = False
                    continue
                # mirror received the delta: the host record is
                # current and re-admission rehydrates warm with bits
                TENANCY_COUNTERS["park_midflight_carries"] += 1
            t.pending_edges = {}
            t.pending_structural = False
            t.ov_solved = np.array(t.graph.overloaded, copy=True)
            t.force_reset = False
            t.needs_solve = False
            t.solved = True
        _get_registry().observe(
            "tenancy.dispatch_ms",
            (time.perf_counter() - _t0) * 1000.0,
        )
        TENANCY_COUNTERS["wave_occupancy"] = int(
            round(100 * bucket.occupancy() / bucket.slots)
        )
        _get_tracer().end_span_active(
            _span,
            slots=bucket.slots,
            resident=bucket.occupancy(),
            solving=len(solving),
            warm=warm_ct,
            cold=cold_ct,
            delta_rows=cnt,
            slo_premium=slo_counts.get("premium", 0),
            slo_standard=slo_counts.get("standard", 0),
            slo_bulk=slo_counts.get("bulk", 0),
        )


    def _update_gauges(self) -> None:
        TENANCY_COUNTERS["active"] = len(self._tenants)
        TENANCY_COUNTERS["resident"] = self.resident_count()


# one process-wide arbiter a device (the reference has one a process: its
# device is implicit)
_WORLDS: Dict[str, WorldManager] = {}


def get_world_manager(device: DeviceLike = None) -> WorldManager:
    """Process-wide arbiter on ``device`` (None = CUDA): the device blocks
    are process-global state, like the solvers' resident ELL caches."""
    dev = resolve_device(device)
    mgr = _WORLDS.get(str(dev))
    if mgr is None:
        mgr = _WORLDS[str(dev)] = WorldManager(device=dev)
    return mgr


def reset_world_manager() -> None:
    """Drop every process-wide arbiter and every device block it owns
    (wired into decision.spf_solver.reset_device_caches: the cold rung
    must not leak half-synced tenant state)."""
    for mgr in _WORLDS.values():
        mgr.reset()
    _WORLDS.clear()
