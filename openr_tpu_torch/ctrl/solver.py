"""SolverCtrlHandler: the solver service's wire surface.

Rides the existing ctrl transport (``CtrlServer`` — length-prefixed
JSON frames, duck-typed method dispatch, the same dual-stacked port
Decision's handler serves), so clients reach the solver with the stock
``CtrlClient`` machinery: no new listener, no new framing, TLS for
free. Every method is prefixed ``solver_`` to keep the namespace
disjoint from the OpenrCtrl surface.

Worlds cross the wire as base64 ``utils.wire`` AdjacencyDatabase
blobs — the LSDB's own serialization — and the server builds each
tenant's ``LinkState`` from them (clients stay torch-free and
graph-free; see serve/client.py). Views return as base64 int32 packed
blocks plus the node-name table, which is everything a client needs to
reconstruct per-destination distances/first-hops and everything the
parity gates digest.

Fleet plane (openr_tpu/fleet): the handler is also one *managed
service* in a fleet — three roles ride the same surface:

- **Routing.** A tenant sealed away by a live migration answers every
  later call with a ``CtrlRedirect`` carrying the destination
  (``moved_to``, counted ``fleet.client_redirects``); a tenant frozen
  mid-migration answers ``CtrlRetry`` so the client backs off instead
  of racing the drain.
- **Migration.** ``solver_export`` freezes + drains + serializes
  (host mirror, un-replayed journal tail, world blobs);
  ``solver_import`` rehydrates WARM on the destination and journals
  the tenant into the destination's OWN replica stream;
  ``solver_seal_migration`` drops the source copy and installs the
  redirect. Abort unfreezes, leaving the tenant parked warm.
- **Replication.** A primary appends every adopted mutation to its
  ``FleetJournal``; the standby's handler applies shipped suffixes
  (``solver_replica_apply``, idempotent on replayed prefixes),
  absorbs the solves so it stays hot, and ``solver_promote`` runs the
  one graceful-restart reconcile — per-tenant route-DB diffs against
  the held products, with zero deletes as the no-flap gate.

FIB-level tenant views: ``solver_fib`` returns the tenant's full
``RouteDatabase`` (unicast + MPLS, built through the Decision rib the
same way the digital twin's vantages are), not just the SP/KSP2 view —
so a client can consume route products without owning a graph stack.

The ``serve.slow_client`` fault seam fires on the reply path of
``solver_solve``: an armed delay schedule stalls only THIS client's
connection thread — the wave loop and other clients never feel it.

Port note: a copy of ``openr_tpu/ctrl/solver.py``; the FIB builds run on
the service's device (``SolverService.device``).
"""

from __future__ import annotations

import base64
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from openr_tpu_torch.analysis.annotations import runs_on
from openr_tpu_torch.ctrl.server import (
    CtrlRedirect,
    CtrlRetry,
    current_connection,
    current_trace_context,
)
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.spf_solver import SpfSolver, fleet_preload_views
from openr_tpu_torch.faults import fault_point
from openr_tpu_torch.fleet.journal import FleetJournal, FleetRecord
from openr_tpu_torch.fleet.placement import FLEET_COUNTERS
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.serve.service import FAULT_SLOW_CLIENT, SolverService
from openr_tpu_torch.serve.slo import SLO_TABLE
from openr_tpu_torch.types.lsdb import AdjacencyDatabase, PrefixDatabase
from openr_tpu_torch.utils import wire


def _decode_db(blob: str) -> AdjacencyDatabase:
    return wire.loads(base64.b64decode(blob), AdjacencyDatabase)


def _decode_prefix_db(blob: str) -> PrefixDatabase:
    return wire.loads(base64.b64decode(blob), PrefixDatabase)


def _fnv(data: bytes) -> int:
    """FNV-1a, the same digest the torch-free client computes — one
    digest algorithm across both ends of every parity gate."""
    h = 0x811C9DC5
    for b in data:
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return h


def _path_links(path) -> List[List]:
    """Canonical wire form of one path: per link, the sorted
    ((node, iface), (node, iface)) endpoint key — identical for the
    served trace and a host-oracle trace of the same links."""
    return [
        [end for pair in sorted(
            ((l.n1, l.if1), (l.n2, l.if2))
        ) for end in pair]
        for l in path
    ]


@runs_on("ctrl")
class SolverCtrlHandler:
    """One per service process. Tenants registered over a connection
    are tied to it (``ctrl.server.current_connection``); the server's
    ``connection_closed`` teardown parks them warm through
    ``SolverService.connection_closed``. Every method runs on a
    per-connection ctrl server thread (``@runs_on`` seeds the
    shared-state rule's role inference across the duck-typed
    dispatch).

    ``journal`` arms the primary role: every adopted mutation is
    appended for the standby stream. ``role`` is advisory ("primary" /
    "standby") until a promotion flips it."""

    def __init__(self, service: SolverService,
                 journal: Optional[FleetJournal] = None,
                 role: str = "primary"):
        self._svc = service
        self._lock = threading.RLock()
        self._ls: Dict[str, LinkState] = {}
        self._roots: Dict[str, str] = {}
        # fleet plane state (all under _lock)
        self._journal = journal
        self._role = role
        self._areas: Dict[str, str] = {}
        self._slos: Dict[str, str] = {}
        self._prefix: Dict[str, PrefixState] = {}
        self._prefix_blobs: Dict[str, Dict[str, str]] = {}
        self._moved: Dict[str, Tuple[str, int]] = {}
        self._frozen: Set[str] = set()
        self._applied_seq = 0
        self._fib_solver: Dict[str, SpfSolver] = {}
        self._held_fib: Dict[str, object] = {}

    # -- transport teardown hook (CtrlServer duck-types this) --------------

    def connection_closed(self, conn: int) -> None:
        self._svc.connection_closed(conn)

    # -- fleet routing ------------------------------------------------------

    def _check_routable(self, tenant_id: str) -> None:
        """Every tenant-scoped method passes here first: a sealed-away
        tenant redirects (counted), a frozen one asks for a retry."""
        with self._lock:
            moved = self._moved.get(tenant_id)
            frozen = tenant_id in self._frozen
        if moved is not None:
            FLEET_COUNTERS["client_redirects"] += 1
            raise CtrlRedirect(
                f"tenant {tenant_id!r} migrated", moved[0], moved[1]
            )
        if frozen:
            raise CtrlRetry(
                f"tenant {tenant_id!r} is migrating", 50.0
            )

    def _journal_append(self, kind: str, tenant_id: str,
                        payload: Dict[str, object]) -> None:
        if self._journal is not None:
            self._journal.append(kind, tenant_id, payload)

    # -- methods (JSON-frame dispatched) -----------------------------------

    def solver_hello(self) -> Dict:
        return {
            "classes": sorted(SLO_TABLE),
            "slots_per_bucket": self._svc.manager.slots_per_bucket,
            "role": self._role,
        }

    def solver_register(self, tenant_id: str, slo: str = "standard",
                        area: str = "0") -> Dict:
        self._check_routable(tenant_id)
        self._svc.register(
            tenant_id, slo, conn=current_connection()
        )
        with self._lock:
            if tenant_id not in self._ls:
                self._ls[tenant_id] = LinkState(area=area)
            self._areas[tenant_id] = area
            self._slos[tenant_id] = slo
        self._journal_append(
            "register", tenant_id, {"slo": slo, "area": area}
        )
        return {"tenant_id": tenant_id, "slo": slo}

    def solver_update(self, tenant_id: str, adj_dbs: List[str],
                      root: Optional[str] = None,
                      prefix_dbs: Optional[List[str]] = None) -> Dict:
        """Apply a world snapshot or churn delta: each entry is one
        node's AdjacencyDatabase (b64 wire). The FIRST update must be
        the full snapshot; later calls send only changed nodes.
        ``prefix_dbs`` (b64 PrefixDatabase blobs) feed the FIB-level
        view — optional, per changed node, same delta discipline."""
        self._check_routable(tenant_id)
        with self._lock:
            ls = self._ls[tenant_id]
            for blob in adj_dbs:
                ls.update_adjacency_database(_decode_db(blob))
            if root is not None:
                self._roots[tenant_id] = root
            if prefix_dbs:
                pfx = self._prefix.get(tenant_id)
                if pfx is None:
                    pfx = self._prefix[tenant_id] = PrefixState()
                blobs = self._prefix_blobs.setdefault(tenant_id, {})
                for blob in prefix_dbs:
                    pdb = _decode_prefix_db(blob)
                    pfx.update_prefix_database(pdb)
                    blobs[pdb.this_node_name] = blob
            out = {
                "topology_version": ls.topology_version,
                "nodes": len(ls.get_adjacency_databases()),
            }
        self._journal_append("update", tenant_id, {
            "adj_dbs": list(adj_dbs),
            "prefix_dbs": list(prefix_dbs or []),
            "root": root,
        })
        return out

    def solver_solve(self, tenant_id: str,
                     timeout: float = 60.0) -> Dict:
        self._check_routable(tenant_id)
        with self._lock:
            ls = self._ls[tenant_id]
            root = self._roots.get(tenant_id)
            if root is None:
                root = sorted(ls.get_adjacency_databases())[0]
        graph, srcs, packed = self._svc.solve(
            tenant_id, ls, root, timeout=timeout,
            trace_ctx=current_trace_context(),
        )
        # slow-client seam: a delay schedule armed here models a
        # client draining its reply slowly — only this connection
        # thread stalls, the wave loop has already moved on
        fault_point(FAULT_SLOW_CLIENT)
        packed = np.ascontiguousarray(packed.astype(np.int32))
        names = [
            name
            for name, _i in sorted(
                graph.node_index.items(), key=lambda kv: kv[1]
            )
        ]
        return {
            "root": root,
            "srcs": [int(s) for s in srcs],
            "n_pad": int(graph.n_pad),
            "shape": list(packed.shape),
            "packed_b64": base64.b64encode(packed.tobytes()).decode(),
            "nodes": names,
        }

    def solver_ksp2(self, tenant_id: str, dsts: List[str]) -> Dict:
        self._check_routable(tenant_id)
        paths = self._svc.ksp2(tenant_id, dsts)
        return {
            dst: [_path_links(p) for p in path_list]
            for dst, path_list in paths.items()
        }

    def solver_detach(self, tenant_id: str,
                      warm: bool = True) -> Dict:
        self._check_routable(tenant_id)
        self._svc.detach(tenant_id, warm=warm)
        self._journal_append(
            "detach", tenant_id, {"warm": warm, "moved_to": None}
        )
        return {"tenant_id": tenant_id, "warm": warm}

    # -- FIB-level tenant views --------------------------------------------

    def _build_fib_locked(self, tenant_id: str, view):
        """Route-product build for one tenant (caller holds ``_lock``
        and provides the wave's solved view): preload the view so the
        rib build consumes it with zero further device work — the
        digital twin's fan-in recipe, per tenant."""
        ls = self._ls[tenant_id]
        root = self._roots.get(tenant_id)
        if root is None:
            root = sorted(ls.get_adjacency_databases())[0]
        solver = self._fib_solver.get(tenant_id)
        if solver is None or solver.my_node_name != root:
            solver = SpfSolver(root, backend="device", device=self._svc.device)
            self._fib_solver[tenant_id] = solver
        fleet_preload_views(ls, [view])
        pfx = self._prefix.get(tenant_id)
        if pfx is None:
            pfx = self._prefix[tenant_id] = PrefixState()
        area = self._areas.get(tenant_id, ls.area)
        return solver.build_route_db(root, {area: ls}, pfx)

    def solver_fib(self, tenant_id: str,
                   timeout: float = 60.0) -> Dict:
        """The tenant's full route product: solve (or join the next
        wave), build the Decision rib from the solved view, and return
        the canonical ``RouteDatabase`` (b64 wire) + its FNV digest —
        what the migration/promotion parity gates compare."""
        self._check_routable(tenant_id)
        with self._lock:
            ls = self._ls[tenant_id]
            root = self._roots.get(tenant_id)
            if root is None:
                root = sorted(ls.get_adjacency_databases())[0]
        view = self._svc.solve(
            tenant_id, ls, root, timeout=timeout,
            trace_ctx=current_trace_context(),
        )
        with self._lock:
            ddb = self._build_fib_locked(tenant_id, view)
            if ddb is None:
                raise RuntimeError(
                    f"root {root!r} not in tenant {tenant_id!r} world"
                )
            self._held_fib[tenant_id] = ddb
            rd = ddb.to_route_db(root)
        blob = wire.dumps(rd)
        return {
            "root": root,
            "route_db_b64": base64.b64encode(blob).decode(),
            "digest": _fnv(blob),
            "unicast": len(rd.unicast_routes),
            "mpls": len(rd.mpls_routes),
        }

    # -- live migration (source side) --------------------------------------

    def solver_export(self, tenant_id: str) -> Dict:
        """Freeze + drain + serialize: after this returns, the tenant
        answers every call with retry-later until the migration seals
        (redirect thereafter) or aborts (thaw, parked warm)."""
        with self._lock:
            if tenant_id not in self._ls:
                raise KeyError(f"unknown tenant {tenant_id!r}")
            self._frozen.add(tenant_id)
        try:
            self._svc.quiesce(tenant_id)
            with self._lock:
                record = self._svc.export_tenant(tenant_id)
                ls = self._ls[tenant_id]
                adj_blobs = [
                    base64.b64encode(wire.dumps(db)).decode()
                    for _node, db in sorted(
                        ls.get_adjacency_databases().items()
                    )
                ]
                prefix_blobs = [
                    blob for _node, blob in sorted(
                        self._prefix_blobs.get(tenant_id, {}).items()
                    )
                ]
                return {
                    "record": record,
                    "adj_dbs": adj_blobs,
                    "prefix_dbs": prefix_blobs,
                    "root": self._roots.get(tenant_id),
                    "area": self._areas.get(tenant_id, ls.area),
                    "slo": self._slos.get(
                        tenant_id, str(record.get("slo", "standard"))
                    ),
                }
        except Exception:
            # a failed export must never wedge the tenant: thaw and
            # let the next solve rehydrate it warm where it stands
            with self._lock:
                self._frozen.discard(tenant_id)
            raise

    def solver_seal_migration(self, tenant_id: str, host: str,
                              port: int) -> Dict:
        """Destination confirmed the import: drop the source copy and
        install the redirect. Journaled so the source's standby drops
        its replica too."""
        with self._lock:
            self._frozen.discard(tenant_id)
            self._moved[tenant_id] = (host, int(port))
            self._ls.pop(tenant_id, None)
            self._roots.pop(tenant_id, None)
            self._areas.pop(tenant_id, None)
            self._slos.pop(tenant_id, None)
            self._prefix.pop(tenant_id, None)
            self._prefix_blobs.pop(tenant_id, None)
            self._fib_solver.pop(tenant_id, None)
            self._held_fib.pop(tenant_id, None)
        self._svc.detach(tenant_id, warm=False)
        self._journal_append("detach", tenant_id, {
            "warm": False, "moved_to": [host, int(port)],
        })
        return {"tenant_id": tenant_id, "moved_to": [host, int(port)]}

    def solver_abort_migration(self, tenant_id: str) -> Dict:
        """Import failed: thaw. The tenant sits parked warm (export
        drained it) and the next solve rehydrates in place."""
        with self._lock:
            self._frozen.discard(tenant_id)
        return {"tenant_id": tenant_id, "aborted": True}

    # -- live migration (destination side) ---------------------------------

    def solver_import(self, bundle: Dict) -> Dict:
        """Rehydrate a migrated tenant WARM: rebuild the LinkState
        from the shipped world blobs (``compile_ell`` determinism makes
        the shipped mirror valid against it), import the host record,
        and journal the tenant into THIS service's replica stream so
        its standby replicates the newcomer."""
        record = dict(bundle["record"])
        tenant_id = str(record["tenant_id"])
        area = str(bundle.get("area") or "0")
        slo = str(bundle.get("slo") or "standard")
        root = bundle.get("root")
        adj_blobs = list(bundle.get("adj_dbs", []))
        prefix_blobs = list(bundle.get("prefix_dbs", []))
        ls = LinkState(area=area)
        for blob in adj_blobs:
            ls.update_adjacency_database(_decode_db(blob))
        pfx = PrefixState()
        by_node: Dict[str, str] = {}
        for blob in prefix_blobs:
            pdb = _decode_prefix_db(blob)
            pfx.update_prefix_database(pdb)
            by_node[pdb.this_node_name] = blob
        record["slo"] = slo
        t = self._svc.import_tenant(ls, record)
        self._svc.register(tenant_id, slo, conn=None)
        with self._lock:
            self._ls[tenant_id] = ls
            self._areas[tenant_id] = area
            self._slos[tenant_id] = slo
            if root:
                self._roots[tenant_id] = str(root)
            self._prefix[tenant_id] = pfx
            self._prefix_blobs[tenant_id] = by_node
            self._moved.pop(tenant_id, None)
            self._frozen.discard(tenant_id)
        self._journal_append(
            "register", tenant_id, {"slo": slo, "area": area}
        )
        self._journal_append("update", tenant_id, {
            "adj_dbs": adj_blobs,
            "prefix_dbs": prefix_blobs,
            "root": root,
        })
        return {"tenant_id": tenant_id, "warm": bool(t.solved)}

    # -- hot-standby replication (standby side) ----------------------------

    def _apply_record_locked(self, rec: FleetRecord,
                             dirty: Set[str]) -> List:
        """One journal record onto the replica's maps (caller holds
        ``_lock``); returns deferred service calls to run unlocked."""
        tid = rec.tenant_id
        calls: List = []
        if rec.kind == "register":
            area = str(rec.payload.get("area") or "0")
            slo = str(rec.payload.get("slo") or "standard")
            if tid not in self._ls:
                self._ls[tid] = LinkState(area=area)
            self._areas[tid] = area
            self._slos[tid] = slo
            calls.append(
                lambda: self._svc.register(tid, slo, conn=None)
            )
        elif rec.kind == "update":
            ls = self._ls.get(tid)
            if ls is None:
                ls = self._ls[tid] = LinkState(
                    area=self._areas.get(tid, "0")
                )
            for blob in rec.payload.get("adj_dbs", []):
                ls.update_adjacency_database(_decode_db(blob))
            root = rec.payload.get("root")
            if root:
                self._roots[tid] = str(root)
            pblobs = rec.payload.get("prefix_dbs", [])
            if pblobs:
                pfx = self._prefix.get(tid)
                if pfx is None:
                    pfx = self._prefix[tid] = PrefixState()
                blobs = self._prefix_blobs.setdefault(tid, {})
                for blob in pblobs:
                    pdb = _decode_prefix_db(blob)
                    pfx.update_prefix_database(pdb)
                    blobs[pdb.this_node_name] = blob
            dirty.add(tid)
        elif rec.kind == "detach":
            warm = bool(rec.payload.get("warm", True))
            if not warm:
                # migrated or dropped for good: forget the replica
                self._ls.pop(tid, None)
                self._roots.pop(tid, None)
                self._areas.pop(tid, None)
                self._slos.pop(tid, None)
                self._prefix.pop(tid, None)
                self._prefix_blobs.pop(tid, None)
                self._fib_solver.pop(tid, None)
                self._held_fib.pop(tid, None)
            dirty.discard(tid)
            calls.append(
                lambda: self._svc.detach(tid, warm=warm)
            )
        return calls

    def solver_replica_apply(self, records: List[Dict],
                             absorb: bool = True) -> Dict:
        """Apply a shipped journal suffix in order, idempotent on
        replayed prefixes (records at or below the applied seq are
        skipped, so a retried half-failed ship is safe). ``absorb``
        solves the dirtied tenants and rebuilds their held route
        products immediately — the standby stays HOT, which is what
        makes promotion one reconcile instead of a cold boot."""
        dirty: Set[str] = set()
        deferred: List = []
        with self._lock:
            for frame in records:
                rec = FleetRecord.from_wire(frame)
                if rec.seq <= self._applied_seq:
                    continue
                deferred.extend(
                    self._apply_record_locked(rec, dirty)
                )
                self._applied_seq = rec.seq
            applied = self._applied_seq
        for call in deferred:
            call()
        if absorb and dirty:
            self._absorb(sorted(dirty))
        return {"applied_seq": applied}

    def _absorb(self, tenant_ids: List[str]) -> None:
        """Solve the dirtied replicas as one wave and hold their route
        products — the promotion diff's 'before' side."""
        reqs = []
        with self._lock:
            items = [
                (
                    tid,
                    self._ls[tid],
                    self._roots.get(tid)
                    or sorted(
                        self._ls[tid].get_adjacency_databases()
                    )[0],
                )
                for tid in tenant_ids
                if tid in self._ls
            ]
        for tid, ls, root in items:
            reqs.append(
                (tid, self._svc.request_solve(tid, ls, root))
            )
        for tid, req in reqs:
            view = req.wait(60.0)
            with self._lock:
                if tid not in self._ls:
                    continue
                ddb = self._build_fib_locked(tid, view)
                if ddb is not None:
                    self._held_fib[tid] = ddb

    def solver_promote(self) -> Dict:
        """Graceful-restart takeover: ONE ``sync_fib``-equivalent
        reconcile across every replicated tenant — resolve each, diff
        the new route product against the held one, and count deletes
        (the no-flap gate demands zero: the standby's journal-fed
        state must reproduce the primary's products exactly). Flips
        the role to primary. The promotion happens AT the applied seq
        — the controller owns the never-promote-past-an-un-shipped-
        suffix rule and the counted surrender when the primary died
        with journal in hand."""
        deletes = 0
        digests: Dict[str, int] = {}
        with self._lock:
            tids = sorted(self._ls)
            self._role = "primary"
            applied = self._applied_seq
        # the reconcile diff runs against the held products the
        # ONGOING absorbs built (the standby's data-plane view at the
        # moment the primary died) — NOT a product rebuilt here, which
        # would make the no-flap gate compare a thing to itself
        with self._lock:
            items = [
                (
                    tid,
                    self._ls[tid],
                    self._roots.get(tid)
                    or sorted(
                        self._ls[tid].get_adjacency_databases()
                    )[0],
                )
                for tid in tids
                if tid in self._ls
            ]
        for tid, ls, root in items:
            view = self._svc.solve(tid, ls, root)
            with self._lock:
                if tid not in self._ls:
                    continue
                new_ddb = self._build_fib_locked(tid, view)
                held = self._held_fib.get(tid)
                if new_ddb is None:
                    continue
                if held is not None:
                    delta = held.calculate_update(new_ddb)
                    deletes += len(delta.unicast_routes_to_delete)
                    deletes += len(delta.mpls_routes_to_delete)
                self._held_fib[tid] = new_ddb
                digests[tid] = _fnv(
                    wire.dumps(new_ddb.to_route_db(root))
                )
        return {
            "tenants": tids,
            "deletes": deletes,
            "applied_seq": applied,
            "digests": digests,
            "role": self._role,
        }

    def solver_role(self) -> Dict:
        with self._lock:
            return {
                "role": self._role,
                "applied_seq": self._applied_seq,
                "tenants": sorted(self._ls),
            }

    def solver_journal_stat(self) -> Dict:
        """Primary-side journal introspection (lag tests + the
        controller's hazard accounting)."""
        if self._journal is None:
            return {"last_seq": 0, "horizon_seq": 0, "records": 0}
        return {
            "last_seq": self._journal.last_seq,
            "horizon_seq": self._journal.horizon_seq,
            "records": len(self._journal),
        }

    # -- introspection ------------------------------------------------------

    def solver_counters(self) -> Dict:
        return self._svc.counters()

    def solver_ping(self) -> Dict:
        return {"ok": True, "waves": self._svc.waves()}

    def solver_stage_attribution(self) -> Dict:
        """Per-SLO-class p99 beside the measured per-stage device/host
        costs (``SolverService.stage_attribution``)."""
        return self._svc.stage_attribution()

    def get_flight_record(self, limit: int = 0) -> Dict:
        """Same surface as the OpenrCtrl handler: the flight ring +
        live attribution, so ``breeze monitor flight`` works against a
        solver process too."""
        from openr_tpu_torch.telemetry import get_flight_recorder, get_profiler

        fr = get_flight_recorder()
        prof = get_profiler()
        return {
            "records": fr.records(limit),
            "triggers": fr.trigger_names(),
            "attribution": prof.attribution(),
            "host_overhead_ratio": prof.host_overhead_ratio(),
        }

    def dump_postmortem(self, trigger: str = "manual",
                        reason: str = "") -> Dict:
        from openr_tpu_torch.telemetry import get_flight_recorder

        reason = reason or "operator request"
        ctx = current_trace_context()
        if ctx and ctx.get("span_id"):
            # stamp the requesting client's span so the bundle pairs
            # with the client-side observation that asked for it
            reason = f"{reason} [client span {ctx['span_id']}]"
        path = get_flight_recorder().dump_postmortem(
            trigger=trigger, reason=reason
        )
        return {"path": path}
