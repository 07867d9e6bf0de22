"""The port's fleet plane (``openr_tpu_torch.fleet``) against the JAX
package's, on the CPU.

In the shape of ``tests/test_fleet.py``, with the never-migrated twin
every parity gate compares with being the REFERENCE's solver service
(``openr_tpu.serve`` behind ``openr_tpu.ctrl.solver``, read by the
reference's client over the wire both packages share): the port's fleet,
migrating and promoting, must serve the same SP, KSP2 and FIB digests as
the reference serves without either. The placement tables must equal the
reference's ``PlacementPolicy`` on the same admissions, and the
park-mid-flight oracle is the reference's sequential view. Exact
equality throughout.

The reference file's description:

The gates this file holds shut:

- **Migration bit-parity** — a tenant migrated mid-churn must serve
  the SAME SP view, KSP2 paths, and FIB-level ``RouteDatabase``
  (digest for digest) as a never-migrated twin replaying the same
  schedule, with ZERO cold solves on the destination (the warm-import
  contract).
- **Promotion no-flap** — killing a primary mid-storm and promoting
  its hot standby must produce zero route deletes (graceful-restart
  semantics: one reconcile, no flap) and bit-identical post-promotion
  views vs the oracle continuation.
- **Replica-lag bound** — the journal stream drains to lag 0 after
  churn, and recovers (backoff, counted errors) through an injected
  ``fleet.journal_stream`` seam.
- **Placement admission** — SLO-class-aware spread + capacity
  rejection, pure torch-free policy.
- **Client redirect round-trip** — the fleet-aware client follows
  ``moved_to`` transparently; the plain client surfaces it loudly.
- **Park-mid-flight regression** — a tenant parked between a wave's
  submit and reap keeps (or is loudly refused) its owed delta; never
  a silently stale mirror marked solved.
"""

from __future__ import annotations

from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from openr_tpu.ctrl.server import CtrlServer as JaxCtrlServer
from openr_tpu.ctrl.solver import SolverCtrlHandler as JaxSolverCtrlHandler
from openr_tpu.fleet import PlacementPolicy as JaxPlacementPolicy
from openr_tpu.fleet import ServiceLoad as JaxServiceLoad
from openr_tpu.fleet import placement_table as jax_placement_table
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.load import multi_client as jax_mc
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu.serve.client import SolverClient as JaxSolverClient
from openr_tpu.serve.service import SolverService as JaxSolverService
from openr_tpu.types.lsdb import AdjacencyDatabase as JaxAdjacencyDatabase
from openr_tpu.utils import wire as jax_wire

from openr_tpu_torch.ctrl.server import CtrlClient
from openr_tpu_torch.faults import FaultSchedule, get_injector
from openr_tpu_torch.fleet import (
    FAULT_JOURNAL_STREAM,
    FleetAdmissionError,
    FleetController,
    PlacementPolicy,
    ServiceLoad,
)
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.load.multi_client import TenantSpec, apply_mutation
from openr_tpu_torch.models import topologies
from openr_tpu_torch.ops.spf_sparse import (
    compile_ell,
    ell_source_batch,
    ell_view_batch_packed,
)
from openr_tpu_torch.ops.world_batch import TENANCY_COUNTERS, WorldManager
from openr_tpu_torch.serve.client import SolverClient
from openr_tpu_torch.telemetry import get_registry
from openr_tpu_torch.fleet import placement_table
from openr_tpu_torch.utils import wire

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the tenant worlds here are small, and a loaded
    test run's threads would fight more of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reference_trace_ring_as_found():
    """The reference's solver service finishes a trace a wave into its
    process-wide ring (256 deep); leave the ring as the test found it, so
    a later test in this process that waits for its ring to grow (the
    reference's ``test_perf_events_e2e``) is not handed a full one."""
    from openr_tpu.telemetry import get_tracer as jax_get_tracer

    ring = jax_get_tracer()._ring
    kept = list(ring)
    yield
    ring.clear()
    ring.extend(kept)


@pytest.fixture(autouse=True)
def _clean_faults():
    get_injector().reset()
    yield
    get_injector().reset()


def load(topo):
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    return ls


def _spec(tid: str, kind: str = "mesh", size: int = 5,
          seed: int = 3, slo: str = "standard") -> TenantSpec:
    return TenantSpec(
        tenant_id=tid, kind=kind, size=size, seed=seed, slo=slo
    )


def _drive_round(client, spec, dbs, i):
    """One churn round through a SolverClient: mutate (i>0), solve,
    ksp2, fib. Returns the (sp, ksp2, fib) digest triple."""
    import json as _json

    from openr_tpu_torch.load.multi_client import _digest_text

    if i > 0:
        node = apply_mutation(dbs, spec, i)
        client.update_world(spec.tenant_id, [dbs[node]])
    view = client.solve(spec.tenant_id)
    paths = client.ksp2(spec.tenant_id, sorted(view.nodes[:6]))
    fib = client.fib(spec.tenant_id)
    return (
        view.digest(),
        _digest_text(_json.dumps(paths, sort_keys=True)),
        fib.digest,
    )


def _register(client, spec, dbs):
    client.register(spec.tenant_id, slo=spec.slo)
    client.update_world(
        spec.tenant_id, [dbs[k] for k in sorted(dbs)],
        root=spec.root_of(dbs),
        prefix_dbs=[
            db for _k, db in sorted(spec.build_prefix_dbs().items())
        ],
    )


class _Twin:
    """A never-migrated single service of the REFERENCE replaying the
    same schedule — the oracle for every migration/promotion parity
    gate. ``spec``/``build_dbs`` give its worlds in the reference's
    types."""

    def __init__(self):
        self.service = JaxSolverService().start()
        self.handler = JaxSolverCtrlHandler(self.service)
        self.server = JaxCtrlServer(self.handler, host="127.0.0.1")
        self.server.start()
        self.client = JaxSolverClient("127.0.0.1", self.server.port)

    @staticmethod
    def spec(spec):
        return jax_mc.TenantSpec(**asdict(spec))

    def stop(self):
        self.client.close()
        self.server.stop()
        self.service.stop()


class TestMigrationParity:
    def test_live_migration_bit_parity_and_warm(self):
        """Drive a tenant for 6 churn rounds, migrating it between
        services after round 2: every SP/KSP2/FIB digest must equal
        the never-migrated twin's, the import must land WARM (zero
        cold solves on the destination), and the endpoint must
        actually move."""
        fc = FleetController(device=CPU, services=2, with_standby=False)
        fc.start()
        twin = _Twin()
        try:
            ctrl_port = fc.serve_ctrl("127.0.0.1")
            spec = _spec("mig_t")
            dbs = spec.build_dbs()
            host, port = fc.admit(spec.tenant_id, spec.slo)
            client = SolverClient(
                host, port, controller=("127.0.0.1", ctrl_port)
            )
            _register(client, spec, dbs)

            tspec = twin.spec(spec)
            tdbs = tspec.build_dbs()
            _register(twin.client, tspec, tdbs)

            src = fc.owner_of(spec.tenant_id)
            migr_before = fc.counters().get("fleet.migrations", 0)
            cold_before = int(
                TENANCY_COUNTERS["tenant_import_colds"]
            )
            fleet_digests, twin_digests = [], []
            for i in range(6):
                if i == 3:
                    fc.migrate(spec.tenant_id)
                    assert fc.owner_of(spec.tenant_id) != src
                fleet_digests.append(
                    _drive_round(client, spec, dbs, i)
                )
                twin_digests.append(
                    _drive_round(twin.client, tspec, tdbs, i)
                )
            assert fleet_digests == twin_digests
            # warm import: the destination never cold-solved the
            # migrated world
            assert int(
                TENANCY_COUNTERS["tenant_import_colds"]
            ) == cold_before
            assert client.redirects >= 1
            assert fc.counters().get(
                "fleet.migrations", 0
            ) == migr_before + 1
            ep = client.endpoint_of(spec.tenant_id)
            new = fc.lookup(spec.tenant_id)
            assert ep == (new["host"], new["port"])
            client.close()
        finally:
            twin.stop()
            fc.stop()


class TestPromotion:
    def test_standby_promotion_zero_deletes_mid_storm(self):
        """Kill the primary mid-storm (``device.lost`` from the
        controller's vantage), promote the hot standby, and hold the
        graceful-restart gate: zero route deletes across the
        reconcile, ``fleet.promotions`` == 1, and every
        post-promotion digest bit-identical to the never-promoted
        twin."""
        fc = FleetController(device=CPU, services=1, with_standby=True)
        fc.start()
        twin = _Twin()
        try:
            ctrl_port = fc.serve_ctrl("127.0.0.1")
            spec = _spec("pro_t", kind="grid", size=4, seed=5)
            dbs = spec.build_dbs()
            host, port = fc.admit(spec.tenant_id, spec.slo)
            client = SolverClient(
                host, port, controller=("127.0.0.1", ctrl_port)
            )
            _register(client, spec, dbs)
            tspec = twin.spec(spec)
            tdbs = tspec.build_dbs()
            _register(twin.client, tspec, tdbs)

            base = fc.counters()
            fleet_digests, twin_digests = [], []
            for i in range(3):
                fleet_digests.append(
                    _drive_round(client, spec, dbs, i)
                )
                twin_digests.append(
                    _drive_round(twin.client, tspec, tdbs, i)
                )
            ms = fc.services()["svc0"]
            assert ms.streamer.flush(10.0)
            ms.kill_primary()
            promoted = fc.maybe_failover()
            assert promoted == ["svc0"]
            after = fc.counters()
            assert (
                after["fleet.promotions"]
                - base.get("fleet.promotions", 0) == 1
            )
            # GR semantics: the takeover reconcile deleted nothing
            assert (
                after["fleet.promotion_deletes"]
                - base.get("fleet.promotion_deletes", 0) == 0
            )
            assert (
                after["fleet.failovers_detected"]
                - base.get("fleet.failovers_detected", 0) == 1
            )
            # the storm continues: the client rides the failover via
            # the controller lookup and the views stay bit-identical
            for i in range(3, 6):
                fleet_digests.append(
                    _drive_round(client, spec, dbs, i)
                )
                twin_digests.append(
                    _drive_round(twin.client, tspec, tdbs, i)
                )
            assert fleet_digests == twin_digests
            assert client.reconnects >= 1
            client.close()
        finally:
            twin.stop()
            fc.stop()


class TestReplicaLag:
    def test_replica_lag_bounded_and_drains(self):
        """Churn builds journal records; the streamer must drain lag
        to 0. With the ``fleet.journal_stream`` seam firing, lag grows
        but the streamer recovers through backoff, counted in
        ``fleet.journal_stream_errors`` — never a silent stall."""
        fc = FleetController(device=CPU, services=1, with_standby=True)
        fc.start()
        try:
            spec = _spec("lag_t", kind="ring", size=6, seed=2)
            dbs = spec.build_dbs()
            host, port = fc.admit(spec.tenant_id, spec.slo)
            client = SolverClient(host, port)
            _register(client, spec, dbs)
            for i in range(1, 4):
                node = apply_mutation(dbs, spec, i)
                client.update_world(spec.tenant_id, [dbs[node]])
                client.solve(spec.tenant_id)
            ms = fc.services()["svc0"]
            assert ms.streamer.flush(10.0)
            assert ms.streamer.lag() == 0
            reg = get_registry()
            assert reg.counter_get("fleet.replica_lag") == 0

            errs_before = reg.counter_get(
                "fleet.journal_stream_errors"
            )
            get_injector().arm(
                FAULT_JOURNAL_STREAM, FaultSchedule.fail_n(3)
            )
            for i in range(4, 7):
                node = apply_mutation(dbs, spec, i)
                client.update_world(spec.tenant_id, [dbs[node]])
                client.solve(spec.tenant_id)
            # the seam fired; the stream recovered and drained anyway
            assert ms.streamer.flush(15.0)
            assert ms.streamer.lag() == 0
            assert reg.counter_get(
                "fleet.journal_stream_errors"
            ) >= errs_before + 1
            client.close()
        finally:
            fc.stop()


class TestPlacement:
    def test_slo_class_spread_and_capacity(self):
        """Premium tenants spread across services before doubling up
        on a class; a full fleet refuses admission loudly."""
        a, b = ServiceLoad("a", capacity=3), ServiceLoad(
            "b", capacity=3
        )
        pol = PlacementPolicy()
        assert pol.place([a, b], "p1", "premium").name == "a"
        # second premium avoids the service already holding one even
        # though plain weight would tie after a bulk admit
        assert pol.place([a, b], "p2", "premium").name == "b"
        assert pol.place([a, b], "b1", "bulk").name in ("a", "b")
        # occupancy-weighted: the lighter service wins for standard
        lighter = min((a, b), key=lambda s: s.weight())
        assert pol.place(
            [a, b], "s1", "standard"
        ).name == lighter.name
        pol.place([a, b], "s2", "standard")
        pol.place([a, b], "s3", "standard")
        with pytest.raises(FleetAdmissionError):
            pol.place([a, b], "s4", "standard")
        # exclusion (the migration path) never returns the source,
        # even when the source is the emptiest service in the fleet
        x, y = ServiceLoad("x", capacity=3), ServiceLoad(
            "y", capacity=3
        )
        y.admit("held", "premium")
        assert pol.place(
            [x, y], "m1", "bulk", exclude={"x"}
        ).name == "y"

    def test_controller_admission_by_class(self):
        fc = FleetController(device=CPU, services=2, with_standby=False)
        fc.start()
        try:
            placed_before = fc.counters().get("fleet.placements", 0)
            eps = {
                tid: fc.admit(tid, slo)
                for tid, slo in [
                    ("t_p1", "premium"), ("t_p2", "premium"),
                    ("t_b1", "bulk"),
                ]
            }
            owners = {
                tid: fc.owner_of(tid) for tid in eps
            }
            # the two premiums never co-locate while a peer is empty
            assert owners["t_p1"] != owners["t_p2"]
            table = fc.placement()
            assert fc.counters().get(
                "fleet.placements", 0
            ) == placed_before + 3
            for tid, ep in eps.items():
                row = table[owners[tid]]
                assert tuple(row["endpoint"]) == ep
        finally:
            fc.stop()


class TestClientRedirect:
    def test_redirect_round_trip_and_plain_client_loud(self):
        """After a seal, the old endpoint answers ``moved_to``: the
        fleet-aware client chases it (counted both ends); the plain
        ``CtrlClient`` raises — never a silent wrong-service answer."""
        fc = FleetController(device=CPU, services=2, with_standby=False)
        fc.start()
        try:
            reg = get_registry()
            spec = _spec("rdr_t", kind="grid", size=3, seed=1)
            dbs = spec.build_dbs()
            host, port = fc.admit(spec.tenant_id, spec.slo)
            client = SolverClient(host, port)
            _register(client, spec, dbs)
            before_view = client.solve(spec.tenant_id)
            redirects_before = reg.counter_get(
                "fleet.client_redirects"
            )
            fc.migrate(spec.tenant_id)
            # plain client on the OLD endpoint: loud error carrying
            # the move
            plain = CtrlClient(host, port)
            with pytest.raises(RuntimeError, match="migrated"):
                plain.call(
                    "solver_solve", tenant_id=spec.tenant_id
                )
            plain.close()
            # fleet-aware client: same call chases moved_to and the
            # view survives the hop bit-identically
            after_view = client.solve(spec.tenant_id)
            assert after_view.digest() == before_view.digest()
            assert client.redirects >= 1
            assert client.endpoint_of(spec.tenant_id) != (host, port)
            assert reg.counter_get(
                "fleet.client_redirects"
            ) >= redirects_before + 1
            client.close()
        finally:
            fc.stop()


class TestParkMidflight:
    def _mk(self, tid="pk_t"):
        mgr = WorldManager(device=CPU, slots_per_bucket=4, max_resident=8)
        topo = topologies.random_mesh(12, 3, seed=9)
        ls = load(topo)
        root = sorted(ls.get_adjacency_databases())[0]
        return mgr, ls, root, tid

    def _oracle(self, ls, root):
        """The reference's sequential view of the same databases, equal
        to the port's own first."""
        graph = compile_ell(ls)
        srcs = ell_source_batch(graph, ls, root)
        port = ell_view_batch_packed(graph, srcs, CPU).numpy()
        jls = JaxLinkState(area=ls.area)
        for name, db in sorted(ls.get_adjacency_databases().items()):
            jls.update_adjacency_database(
                jax_wire.loads(wire.dumps(db), JaxAdjacencyDatabase)
            )
        jgraph = jax_sparse.compile_ell(jls)
        want = np.asarray(jax_sparse.ell_view_batch_packed(
            jgraph, jax_sparse.ell_source_batch(jgraph, jls, root)
        )).astype(np.int32)
        assert np.array_equal(port, want)
        return want

    def test_park_between_submit_and_reap_keeps_delta(self):
        """Regression for the un-reaped-delta drop: a tenant parked
        after the wave's submit but before its reap still receives
        the dispatch's delta (its journal was in the solve), so the
        next admission rehydrates WARM and bit-identical."""
        mgr, ls, root, tid = self._mk()
        mgr.solve_view(tid, ls, root)  # resident + solved
        db = ls.get_adjacency_databases()[root]
        adjs = list(db.adjacencies)
        adjs[0] = replace(adjs[0], metric=9)
        ls.update_adjacency_database(
            replace(db, adjacencies=tuple(adjs))
        )
        t = mgr._sync(tid, ls, root)
        mgr._ensure_resident(t)
        assert t.needs_solve
        carries = int(TENANCY_COUNTERS["park_midflight_carries"])
        colds = int(TENANCY_COUNTERS["cold_solves"])
        ctx = mgr._dispatch_launch(t.bucket)
        assert ctx is not None
        mgr.park(tid)  # vacates the slot MID-FLIGHT
        mgr._dispatch_finish(ctx)
        assert int(
            TENANCY_COUNTERS["park_midflight_carries"]
        ) == carries + 1
        # the delta landed: the parked record is solved and current
        assert t.solved and not t.needs_solve
        # re-admission is warm (no cold solve) and bit-identical
        view = mgr.solve_view(tid, ls, root)
        assert int(TENANCY_COUNTERS["cold_solves"]) == colds
        assert np.array_equal(view[2], self._oracle(ls, root))

    def test_park_midflight_moved_record_resets_loudly(self):
        """If the record moved under the dispatch (version changed),
        the stale delta is dropped and the tenant is forced COLD —
        counted, never a silently stale mirror marked solved."""
        mgr, ls, root, tid = self._mk("pk_r")
        mgr.solve_view(tid, ls, root)
        db = ls.get_adjacency_databases()[root]
        adjs = list(db.adjacencies)
        adjs[0] = replace(adjs[0], metric=7)
        ls.update_adjacency_database(
            replace(db, adjacencies=tuple(adjs))
        )
        t = mgr._sync(tid, ls, root)
        mgr._ensure_resident(t)
        resets = int(TENANCY_COUNTERS["park_midflight_resets"])
        ctx = mgr._dispatch_launch(t.bucket)
        assert ctx is not None
        mgr.park(tid)
        t.version += 1  # the record moved under the dispatch
        mgr._dispatch_finish(ctx)
        assert int(
            TENANCY_COUNTERS["park_midflight_resets"]
        ) == resets + 1
        assert t.force_reset and not t.solved
        # the next solve re-derives from scratch and is still right
        view = mgr.solve_view(tid, ls, root)
        assert np.array_equal(view[2], self._oracle(ls, root))


_ADMISSIONS = (
    ("p0", "premium"), ("s0", "standard"), ("b0", "bulk"), ("p1", "premium"),
    ("b1", "bulk"), ("s1", "standard"), ("p2", "premium"), ("s2", "standard"),
    ("b2", "bulk"), ("b3", "bulk"),
)


@pytest.mark.parametrize("services,capacity", [(2, 8), (3, 4), (4, 16)])
def test_placement_table_equals_the_reference(services, capacity):
    """The same admission sequence placed by both packages' policies
    gives the same owners, the same refusals and the same tables."""
    loads = [ServiceLoad(f"svc{i}", capacity=capacity) for i in range(services)]
    jloads = [JaxServiceLoad(f"svc{i}", capacity=capacity) for i in range(services)]
    pol, jpol = PlacementPolicy(), JaxPlacementPolicy()
    for tid, slo in _ADMISSIONS:
        try:
            got = pol.place(loads, tid, slo).name
        except FleetAdmissionError:
            got = None
        try:
            want = jpol.place(jloads, tid, slo).name
        except Exception as exc:  # the reference's admission error
            assert type(exc).__name__ == "FleetAdmissionError"
            want = None
        assert got == want, tid
    assert placement_table(loads) == jax_placement_table(jloads)


def test_fleet_controller_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetController(services=1, with_standby=False)
    fc = FleetController(services=1, with_standby=False, device="cpu")
    assert all(ms.service.device == CPU for ms in fc.services().values())
