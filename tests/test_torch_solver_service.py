"""The port's solver service (``openr_tpu_torch.serve``, ``ctrl.solver``,
``load.multi_client``) against the JAX package's, on the CPU.

In the shape of ``tests/test_solver_service.py``: every view the port
serves equals the reference's sequential oracle (``openr_tpu``'s
``ell_view_batch_packed`` over the same databases, carried through the
wire codec both packages share) and the port's own; the oracle digests
of ``multi_client`` equal the reference's; and across packages, the
reference's ``SolverClient`` reads the port's service and the port's
client reads the reference's service, with equal views. Exact int32
equality throughout.

The reference file's description:

Covers the continuous-batching contract end to end: bucket-join bit
parity vs per-tenant sequential solves, SLO-class admission ordering
and preemption under a seeded mixed-class storm, client disconnect
mid-wave detaching the tenant WARM (no poisoned bucket), the
slow-client seam stalling only its own connection, occupancy-driven
bucket compaction/regrow round trips, the tenant plane's KSP2 view
parity vs the host oracle, the KSP2 committed-dispatch window
accounting, and a small multi-process client smoke through the real
ctrl wire.
"""

from __future__ import annotations

import threading
import time
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

from openr_tpu.ctrl.server import CtrlServer as JaxCtrlServer
from openr_tpu.ctrl.solver import SolverCtrlHandler as JaxSolverCtrlHandler
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.load import multi_client as jax_mc
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu.ops.world_batch import WorldManager as JaxWorldManager
from openr_tpu.serve.client import SolverClient as JaxSolverClient
from openr_tpu.serve.service import SolverService as JaxSolverService
from openr_tpu.types.lsdb import AdjacencyDatabase as JaxAdjacencyDatabase
from openr_tpu.utils import wire as jax_wire

from openr_tpu_torch.ctrl.server import CtrlServer
from openr_tpu_torch.ctrl.solver import SolverCtrlHandler
from openr_tpu_torch.faults import FaultSchedule, get_injector
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.load import multi_client
from openr_tpu_torch.models import topologies
from openr_tpu_torch.ops.spf_sparse import (
    compile_ell,
    ell_source_batch,
    ell_view_batch_packed,
)
from openr_tpu_torch.ops.world_batch import TENANCY_COUNTERS, WorldManager
from openr_tpu_torch.serve.client import SolverClient
from openr_tpu_torch.serve.service import SolverService
from openr_tpu_torch.serve.slo import SLO_TABLE, order_requests
from openr_tpu_torch.telemetry import get_registry
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


def _mutate_metric(ls, node, i, metric):
    db = ls.get_adjacency_databases()[node]
    adjs = list(db.adjacencies)
    adjs[i] = replace(adjs[i], metric=metric)
    ls.update_adjacency_database(replace(db, adjacencies=tuple(adjs)))


def _tenants(n=6, seed=0):
    """n mixed-size worlds (two shape buckets)."""
    topos = [
        topologies.grid(3),
        topologies.grid(4),
        topologies.ring(8),
        topologies.random_mesh(20, 3, seed=7 + seed),
        topologies.random_mesh(24, 3, seed=11 + seed),
        topologies.random_mesh(30, 4, seed=13 + seed),
    ][:n]
    lss = [load(t) for t in topos]
    return [
        (f"t{i}", ls, sorted(ls.get_adjacency_databases())[0])
        for i, ls in enumerate(lss)
    ]


def _jax_ls(ls):
    """The reference's LinkState of the same databases (carried over
    the wire codec both packages share, byte for byte)."""
    jls = JaxLinkState(area=ls.area)
    for name in sorted(ls.get_adjacency_databases()):
        db = ls.get_adjacency_databases()[name]
        jls.update_adjacency_database(
            jax_wire.loads(wire.dumps(db), JaxAdjacencyDatabase)
        )
    return jls


def _oracle(ls, root):
    """The reference's sequential view of the same world, checked equal
    to the port's own sequential view first."""
    graph = compile_ell(ls)
    srcs = ell_source_batch(graph, ls, root)
    port = ell_view_batch_packed(graph, srcs, CPU).numpy()
    jls = _jax_ls(ls)
    jgraph = jax_sparse.compile_ell(jls)
    jsrcs = jax_sparse.ell_source_batch(jgraph, jls, root)
    want = np.asarray(jax_sparse.ell_view_batch_packed(jgraph, jsrcs)).astype(np.int32)
    assert jsrcs == srcs and np.array_equal(port, want)
    return want


def _jax_specs(specs):
    return [jax_mc.TenantSpec(**asdict(s)) for s in specs]


def _assert_view_parity(view, ls, root, tag=""):
    graph, srcs, packed = view
    oracle = _oracle(ls, root)
    assert packed.shape == oracle.shape, tag
    assert np.array_equal(packed, oracle), tag


class TestWaveParity:
    def test_wave_join_bit_parity_vs_sequential(self):
        """Tenants submitted from many threads coalesce into waves;
        every served view must equal the sequential single-graph
        oracle byte for byte, across churn rounds."""
        svc = SolverService(
            manager=WorldManager(device=CPU, slots_per_bucket=4, max_resident=16)
        ).start()
        try:
            items = _tenants(6)
            for tid, _ls, _root in items:
                svc.register(tid)
            for rnd in range(3):
                if rnd:
                    for i, (tid, ls, root) in enumerate(items):
                        node = sorted(
                            ls.get_adjacency_databases()
                        )[rnd % 2]
                        _mutate_metric(
                            ls, node, 0, 2 + ((rnd + i) % 7)
                        )
                reqs = {}
                threads = []

                def _go(tid, ls, root):
                    reqs[tid] = svc.request_solve(tid, ls, root)

                for tid, ls, root in items:
                    th = threading.Thread(
                        target=_go, args=(tid, ls, root)
                    )
                    th.start()
                    threads.append(th)
                for th in threads:
                    th.join()
                for tid, ls, root in items:
                    view = reqs[tid].wait(60)
                    _assert_view_parity(
                        view, ls, root, f"round {rnd} {tid}"
                    )
        finally:
            svc.stop()

    def test_latest_wins_coalescing_serves_all_waiters(self):
        """Two requests for one tenant before its wave runs: the later
        supersedes the earlier, and BOTH waiters get the wave's view."""
        svc = SolverService(
            manager=WorldManager(device=CPU, slots_per_bucket=4)
        )
        items = _tenants(1)
        tid, ls, root = items[0]
        r1 = svc.request_solve(tid, ls, root)
        r2 = svc.request_solve(tid, ls, root)
        assert r1 in r2.superseded
        svc.start()
        try:
            v1 = r1.wait(60)
            v2 = r2.wait(60)
            assert np.array_equal(v1[2], v2[2])
            _assert_view_parity(v2, ls, root)
        finally:
            svc.stop()


class TestSloOrdering:
    def test_order_requests_class_then_arrival(self):
        """Seeded mixed-class storm: admission order is (class
        priority, arrival seq), and late premium arrivals preempt
        earlier bulk/standard ones (counted)."""
        import random

        rng = random.Random(20260806)
        storm = []
        for seq in range(64):
            storm.append(
                (rng.choice(list(SLO_TABLE)), seq)
            )
        before = TENANCY_COUNTERS["wave_preemptions"]
        ordered = order_requests(storm)
        # class blocks in priority order...
        pri = [SLO_TABLE[c].priority for c, _ in ordered]
        assert pri == sorted(pri)
        # ...and FIFO inside each class
        for cls in SLO_TABLE:
            seqs = [s for c, s in ordered if c == cls]
            assert seqs == sorted(seqs)
        # the storm interleaves classes, so preemptions must fire
        assert TENANCY_COUNTERS["wave_preemptions"] > before

    def test_wave_budget_prefers_premium(self):
        """With a wave budget of 2, a premium request entering the
        queue last still rides the first wave; surplus bulk rides the
        next wave (absorbing the vacancy) rather than being dropped."""
        svc = SolverService(
            manager=WorldManager(device=CPU, slots_per_bucket=4),
            wave_budget=2,
        )
        items = _tenants(3)
        (t0, ls0, r0), (t1, ls1, r1), (t2, ls2, r2) = items
        svc.register(t0, "bulk")
        svc.register(t1, "bulk")
        svc.register(t2, "premium")
        ra = svc.request_solve(t0, ls0, r0)
        rb = svc.request_solve(t1, ls1, r1)
        rc = svc.request_solve(t2, ls2, r2)
        with svc._cv:
            batch = svc._admit_locked()
            assert [r.tenant_id for r in batch] == [t2, t0]
            # leftovers stay pending for the next wave
            assert t1 in svc._pending
            # put the inspected batch back so the wave loop serves it
            for r in batch:
                svc._pending[r.tenant_id] = r
        svc.start()
        try:
            for r, (tid, ls, root) in zip(
                (ra, rb, rc), items
            ):
                _assert_view_parity(r.wait(60), ls, root, tid)
        finally:
            svc.stop()


class TestFaultSeams:
    def test_disconnect_mid_wave_detaches_warm(self):
        """serve.client_disconnect at delivery: the hit tenant is
        parked WARM (slot freed, mirror kept), its waiter gets a
        ConnectionError, the co-bucketed tenant's view stays
        bit-correct, and the re-solve after reconnect rehydrates."""
        svc = SolverService(
            manager=WorldManager(device=CPU, slots_per_bucket=4)
        ).start()
        try:
            items = _tenants(2)
            (t0, ls0, r0), (t1, ls1, r1) = items
            for tid, ls, root in items:
                svc.register(tid)
                _assert_view_parity(
                    svc.solve(tid, ls, root), ls, root
                )
            get_injector().arm(
                "serve.client_disconnect", FaultSchedule.fail_once()
            )
            # same wave: one delivery trips the seam, the other — and
            # the shared bucket — must be unharmed
            ra = svc.request_solve(t0, ls0, r0)
            rb = svc.request_solve(t1, ls1, r1)
            errors = 0
            for r, ls, root in ((ra, ls0, r0), (rb, ls1, r1)):
                try:
                    _assert_view_parity(r.wait(60), ls, root)
                except ConnectionError:
                    errors += 1
            assert errors == 1
            hit = t0 if ra.error is not None else t1
            t = svc.manager._tenants[hit]
            assert t.slot is None  # detached...
            assert t.packed_host is not None and t.solved  # ...warm
            rehyd0 = TENANCY_COUNTERS["rehydrations"]
            ls, root = (ls0, r0) if hit == t0 else (ls1, r1)
            # churn + re-solve: the parked tenant re-places WARM from
            # its host mirror (rehydration, not a cold solve)
            _mutate_metric(
                ls, sorted(ls.get_adjacency_databases())[0], 0, 11
            )
            _assert_view_parity(svc.solve(hit, ls, root), ls, root)
            assert TENANCY_COUNTERS["rehydrations"] > rehyd0
        finally:
            svc.stop()

    def test_slow_client_stalls_only_its_connection(self):
        """serve.slow_client (delay schedule) on the ctrl reply path:
        the slow client's reply is late; a second client served by the
        same service completes while the first is still stalled."""
        svc = SolverService(
            manager=WorldManager(device=CPU, slots_per_bucket=4)
        ).start()
        srv = CtrlServer(SolverCtrlHandler(svc))
        srv.start()
        try:
            spec = multi_client.TenantSpec("slow", "grid", 3)
            dbs = spec.build_dbs()
            c_slow = SolverClient("127.0.0.1", srv.port)
            c_fast = SolverClient("127.0.0.1", srv.port)
            for c, tid in ((c_slow, "slow"), (c_fast, "fast")):
                c.register(tid)
                c.update_world(
                    tid, [dbs[k] for k in sorted(dbs)],
                    root=spec.root_of(dbs),
                )
                c.solve(tid)  # warmup (compiles out of the way)
            get_injector().arm(
                "serve.slow_client",
                FaultSchedule.delay(1.0, n=1),
            )
            t0 = time.perf_counter()
            done = {}

            def _slow():
                c_slow.solve("slow")
                done["slow"] = time.perf_counter() - t0

            th = threading.Thread(target=_slow)
            th.start()
            time.sleep(0.1)
            c_fast.solve("fast")
            done["fast"] = time.perf_counter() - t0
            th.join(30)
            assert done["slow"] >= 1.0
            assert done["fast"] < done["slow"]
            c_slow.close()
            c_fast.close()
        finally:
            srv.stop()
            svc.stop()


class TestCompaction:
    def test_occupancy_compaction_and_regrow_roundtrip(self):
        """8 same-shape tenants -> park 6 -> compaction shrinks the
        bucket to the occupancy's pow2 (counted) -> remaining tenants
        still solve bit-correct -> re-admitting all 8 regrows the
        bucket, parity throughout."""
        mgr = WorldManager(device=CPU, slots_per_bucket=8, max_resident=64)
        items = [
            (f"g{i}", load(topologies.grid(3)), "node-0")
            for i in range(8)
        ]
        mgr.solve_views(items)
        (bucket,) = mgr._buckets.values()
        assert bucket.slots == 8 and bucket.occupancy() == 8
        for tid, _ls, _root in items[2:]:
            mgr.park(tid)
        before = TENANCY_COUNTERS["bucket_compactions"]
        assert mgr.compact_buckets(vacancy=0.5) == 1
        assert TENANCY_COUNTERS["bucket_compactions"] == before + 1
        (bucket,) = mgr._buckets.values()
        assert bucket.slots == 2 and bucket.occupancy() == 2
        for tid, ls, root in items[:2]:
            _assert_view_parity(
                mgr.solve_view(tid, ls, root), ls, root, tid
            )
        # churn + full re-admission: the compacted bucket regrows
        for i, (tid, ls, _root) in enumerate(items):
            _mutate_metric(ls, "node-0", 0, 3 + i % 5)
        views = mgr.solve_views(items)
        for view, (tid, ls, root) in zip(views, items):
            _assert_view_parity(view, ls, root, tid)
        (bucket,) = mgr._buckets.values()
        assert bucket.slots == 8 and bucket.occupancy() == 8

    def test_compaction_drops_empty_buckets(self):
        mgr = WorldManager(device=CPU, slots_per_bucket=4)
        items = _tenants(2)
        mgr.solve_views(items)
        for tid, _ls, _root in items:
            mgr.drop(tid)
        assert mgr.bucket_count() >= 1
        mgr.compact_buckets()
        assert mgr.bucket_count() == 0


class TestKsp2View:
    def test_ksp2_view_parity_vs_host_oracle(self):
        """The tenant plane's second-path view must trace byte-equal
        to ls.get_kth_paths(root, dst, 1) + (…, 2) for every
        destination."""
        mgr = WorldManager(device=CPU, slots_per_bucket=4)
        for topo in (
            topologies.grid(4),
            topologies.random_mesh(24, 3, seed=11),
        ):
            ls = load(topo)
            root = sorted(ls.get_adjacency_databases())[0]
            tid = f"k-{topo.name}"
            mgr.solve_view(tid, ls, root)
            dsts = [
                n
                for n in sorted(ls.get_adjacency_databases())
                if n != root
            ]
            before = TENANCY_COUNTERS["ksp2_views"]
            got = mgr.ksp2_view(tid, dsts)
            assert TENANCY_COUNTERS["ksp2_views"] == before + 1
            for dst in dsts:
                want = ls.get_kth_paths(root, dst, 1) + \
                    ls.get_kth_paths(root, dst, 2)
                assert got[dst] == want, (topo.name, dst)

    def test_ksp2_view_requires_settled_solve(self):
        mgr = WorldManager(device=CPU, slots_per_bucket=4)
        ls = load(topologies.grid(3))
        mgr.solve_view("a", ls, "node-0")
        _mutate_metric(ls, "node-0", 0, 5)
        mgr._sync("a", ls, "node-0")  # dirty, not solved
        with pytest.raises(RuntimeError):
            mgr.ksp2_view("a", ["node-1"])


class TestCtrlWire:
    def test_ctrl_round_trip_parity_and_disconnect(self):
        """Full wire round trip: register/update/solve digests match
        the oracle replay; closing the client connection
        parks its tenants warm via the transport teardown hook."""
        svc = SolverService(
            manager=WorldManager(device=CPU, slots_per_bucket=4)
        ).start()
        srv = CtrlServer(SolverCtrlHandler(svc))
        srv.start()
        try:
            specs = [
                multi_client.TenantSpec("w0", "grid", 3, seed=1),
                multi_client.TenantSpec(
                    "w1", "mesh", 20, seed=3, slo="premium"
                ),
            ]
            oracle = multi_client.oracle_digests(specs, 2, CPU)
            assert oracle == jax_mc.oracle_digests(_jax_specs(specs), 2)
            client = SolverClient("127.0.0.1", srv.port)
            worlds = {}
            for spec in specs:
                dbs = spec.build_dbs()
                worlds[spec.tenant_id] = (spec, dbs)
                client.register(spec.tenant_id, slo=spec.slo)
                client.update_world(
                    spec.tenant_id,
                    [dbs[k] for k in sorted(dbs)],
                    root=spec.root_of(dbs),
                )
            for i in range(2):
                for tid, (spec, dbs) in worlds.items():
                    if i > 0:
                        node = multi_client.apply_mutation(
                            dbs, spec, i
                        )
                        client.update_world(tid, [dbs[node]])
                    view = client.solve(tid)
                    assert view.digest() == oracle[tid][i], (tid, i)
            client.close()
            deadline = time.time() + 5
            while (
                svc.manager.resident_count() > 0
                and time.time() < deadline
            ):
                time.sleep(0.05)
            assert svc.manager.resident_count() == 0
            # warm records survive the disconnect
            for spec in specs:
                t = svc.manager._tenants[spec.tenant_id]
                assert t.solved and t.packed_host is not None
        finally:
            srv.stop()
            svc.stop()


class TestMultiProcess:
    def test_multi_process_client_smoke(self, tmp_path):
        """Two OS-process torch-free clients drive disjoint tenants
        through one service over the real wire; digests match the
        oracle replay and no child reports errors. (The >=3-process
        B>=64 version is the serve-smoke gate.)"""
        svc = SolverService(
            manager=WorldManager(device=CPU, slots_per_bucket=4)
        ).start()
        srv = CtrlServer(SolverCtrlHandler(svc))
        srv.start()
        try:
            client_specs = {
                "c0": [
                    multi_client.TenantSpec("p0", "grid", 3, seed=1),
                    multi_client.TenantSpec(
                        "p1", "ring", 8, seed=2, slo="bulk"
                    ),
                ],
                "c1": [
                    multi_client.TenantSpec(
                        "p2", "mesh", 20, seed=3, slo="premium"
                    ),
                ],
            }
            rounds = 2
            procs = multi_client.spawn_clients(
                "127.0.0.1", srv.port, client_specs, rounds,
                str(tmp_path),
            )
            results = multi_client.harvest(procs)
            all_specs = [
                s for specs in client_specs.values() for s in specs
            ]
            oracle = multi_client.oracle_digests(all_specs, rounds, CPU)
            assert oracle == jax_mc.oracle_digests(_jax_specs(all_specs), rounds)
            for res in results:
                assert not res["errors"], res
                assert res["rounds"] == rounds
                for tid, digs in res["digests"].items():
                    assert digs == oracle[tid], tid
        finally:
            srv.stop()
            svc.stop()


class TestTelemetrySurface:
    def test_histogram_percentile_accessor(self):
        reg = get_registry()
        h = reg.histogram("test.serve.pctl", window=16)
        for v in range(1, 11):
            h.observe(float(v))
        assert h.percentile(0.5) == 5.0 or h.percentile(0.5) == 6.0
        assert reg.percentile("test.serve.pctl", 0.99) == 10.0
        assert reg.percentile("test.serve.empty", 0.99) == 0.0

    def test_serve_counters_exist_after_wave(self):
        svc = SolverService(
            manager=WorldManager(device=CPU, slots_per_bucket=4)
        ).start()
        try:
            tid, ls, root = _tenants(1)[0]
            svc.register(tid, "premium")
            svc.solve(tid, ls, root)
            snap = svc.counters()
            assert snap["serve.waves"] >= 1
            assert snap["serve.requests"] >= 1
            assert "tenancy.wave_occupancy" in snap
            assert svc.class_p99("premium") > 0.0
        finally:
            svc.stop()


def _drive(client, specs, rounds):
    """Register ``specs`` through ``client`` and run their churn
    schedule: per tenant, the digest of every round's view."""
    worlds, digests = {}, {}
    for spec in specs:
        dbs = spec.build_dbs()
        worlds[spec.tenant_id] = (spec, dbs)
        client.register(spec.tenant_id, slo=spec.slo)
        client.update_world(
            spec.tenant_id, [dbs[k] for k in sorted(dbs)], root=spec.root_of(dbs)
        )
    for i in range(rounds):
        for tid, (spec, dbs) in worlds.items():
            if i > 0:
                node = spec.mutation(dbs, i)[0]
                dbs[node] = spec.mutation(dbs, i)[1]
                client.update_world(tid, [dbs[node]])
            digests.setdefault(tid, []).append(client.solve(tid).digest())
    return digests


_CROSS_SPECS = (
    ("x0", "grid", 4, 1, "premium"),
    ("x1", "mesh", 24, 3, "standard"),
    ("x2", "ring", 9, 5, "bulk"),
)


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_cross_package_client_and_server_read_equal_views(direction):
    """The wire is the reference's: the reference's client against the
    port's service, and the port's client against the reference's
    service, read the digests of the reference's own oracle replay."""
    rounds = 3
    port_specs = [multi_client.TenantSpec(*s) for s in _CROSS_SPECS]
    jax_specs = _jax_specs(port_specs)
    want = jax_mc.oracle_digests(jax_specs, rounds)
    if direction == "jax_client_port_server":
        svc = SolverService(manager=WorldManager(device=CPU, slots_per_bucket=4)).start()
        srv = CtrlServer(SolverCtrlHandler(svc))
        client_cls, specs = JaxSolverClient, jax_specs
    else:
        svc = JaxSolverService(manager=JaxWorldManager(slots_per_bucket=4)).start()
        srv = JaxCtrlServer(JaxSolverCtrlHandler(svc))
        client_cls, specs = SolverClient, port_specs
    srv.start()
    try:
        client = client_cls("127.0.0.1", srv.port)
        got = _drive(client, specs, rounds)
        client.close()
        assert got == want
    finally:
        srv.stop()
        svc.stop()


def test_service_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SolverService()
    svc = SolverService(device="cpu")
    assert svc.device == CPU
