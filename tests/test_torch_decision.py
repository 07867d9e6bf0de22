"""The port's Decision module against ``openr_tpu``'s, fed the same
publications.

Both modules are driven synchronously: a publication goes through each
module's queue handler (``_on_publication``: processing, ``prewarm``, the
debounce and its terminal speculation), and ``fire`` runs each module's
debounce timer at once, as the event base would when it expires. The two
packages get the same wire bytes, each in its own ``Publication`` and
``Value`` types. After every step the route updates each module emitted,
its installed ``route_db``, and its ``decision.*`` counters (the module's
own, the solver's and the ladder's, as deltas from the start of the test)
must be equal. The ``ops.*`` counters are exempt: the reference counts a
JAX window's submits and reaps, while the port's relax loops sync once a
hop and count each kernel launch (none on the CPU), so their touch counts
differ by design; the speculation counters ``ops.spec_*`` are the
exception and are compared where a test drives speculation. Route
entries compare field by field (no tolerance: routes are exact).

Scenarios: ``tests/test_decision_module.py``'s pipeline cases, its SP
route reuse and KSP2 engine cases through the module;
``tests/test_decision_parity.py``'s ``TestDecisionModuleBehaviors`` and
``TestDecisionPendingUpdates``; ``tests/test_degradation_ladder.py``'s
``TestDecisionLadder`` (warm fault to cold, cold fault to native, breaker
and probe, the ladder span); and ``prewarm`` and ``speculate_views`` in
the sparse regime. A few tests run the port's event base thread, with
every wait bounded.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from dataclasses import replace

import pytest
import torch

from openr_tpu.decision import decision as jax_decision
from openr_tpu.decision import spf_solver as jax_solver
from openr_tpu.faults import FaultSchedule as JaxFaultSchedule
from openr_tpu.faults import get_injector as jax_injector
from openr_tpu.faults.supervisor import DegradationSupervisor as JaxSupervisor
from openr_tpu.messaging.queue import ReplicateQueue as JaxQueue
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.telemetry import get_registry as jax_registry
from openr_tpu.types import Publication as JaxPublication
from openr_tpu.types import Value as JaxValue
from openr_tpu.types.lsdb import PrefixForwardingAlgorithm as JaxAlgo
from openr_tpu.types.lsdb import PrefixForwardingType as JaxFwdType
from openr_tpu.utils import keys as jax_keys
from openr_tpu.utils import wire as jax_wire
from openr_tpu_torch.decision import decision as port_decision
from openr_tpu_torch.decision import spf_solver as port_solver
from openr_tpu_torch.decision.decision import Decision, DecisionPendingUpdates
from openr_tpu_torch.faults import FaultSchedule, get_injector
from openr_tpu_torch.faults.injector import FaultInjected
from openr_tpu_torch.faults.supervisor import DegradationSupervisor, HealthState, LadderExhausted
from openr_tpu_torch.graph import native_spf
from openr_tpu_torch.graph.native_spf import NativeBuildError
from openr_tpu_torch.graph.linkstate import LinkStateChange
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.messaging.queue import QueueTimeoutError, ReplicateQueue
from openr_tpu_torch.ops import spf as port_spf
from openr_tpu_torch.telemetry import get_registry, get_tracer, reset_flight_recorder
from openr_tpu_torch.types import IpPrefix, PerfEvents, Publication, Value
from openr_tpu_torch.utils import keys as keyutil
from openr_tpu_torch.utils import wire

KSP2 = dict(forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP, forwarding_type=JaxFwdType.SR_MPLS)
SP_MPLS = dict(forwarding_algorithm=JaxAlgo.SP_ECMP, forwarding_type=JaxFwdType.SR_MPLS)


@pytest.fixture(autouse=True)
def _fresh_port_singletons(tmp_path):
    """The port's process-wide fault injector and flight recorder, fresh
    for each test (the reference's are reset by the
    conftest)."""
    get_injector().reset()
    jax_injector().reset()
    reset_flight_recorder(dump_dir=str(tmp_path / "port-flight"))
    yield
    get_injector().reset()
    jax_injector().reset()
    reset_flight_recorder()
    # CPU tensors run the plain versions: no kernel launch is counted
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


# -- canonical forms ---------------------------------------------------------


def canon(x):
    """A package-independent form of a tree of dataclasses, enums and
    containers: equal trees give equal forms."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, canon(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (list, tuple)):
        return tuple(canon(i) for i in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted((canon(i) for i in x), key=repr))
    if isinstance(x, dict):
        return tuple(sorted(((canon(k), canon(v)) for k, v in x.items()), key=repr))
    return x


def update_form(u):
    """A route update without its perf events and trace (timestamps)."""
    return (
        canon(u.unicast_routes_to_update),
        tuple(sorted((canon(p) for p in u.unicast_routes_to_delete), key=repr)),
        tuple(sorted((canon(m) for m in u.mpls_routes_to_update), key=repr)),
        tuple(sorted(u.mpls_routes_to_delete)),
    )


def db_form(db):
    return canon(db.unicast_routes), canon(db.mpls_routes)


def _counters(reg):
    return dict(reg._counters)


def _decision_deltas(now, then):
    return {k: v - then.get(k, 0) for k, v in now.items()
            if k.startswith("decision.") and v != then.get(k, 0)}


# -- the pair ------------------------------------------------------------------


class Pair:
    """One node's Decision in each package, each on its own queues,
    driven with the same publications."""

    def __init__(self, node="a", backend="device", jax_extra=None, port_extra=None, **kwargs):
        self.node = node
        self.kv_queues = {"jax": JaxQueue(name="kv"), "port": ReplicateQueue(name="kv")}
        self.jax = jax_decision.Decision(
            node, kvstore_updates_queue=self.kv_queues["jax"],
            route_updates_queue=JaxQueue(name="routes"), solver_backend=backend,
            **kwargs, **(jax_extra or {}))
        self.port = Decision(
            node, kvstore_updates_queue=self.kv_queues["port"],
            route_updates_queue=ReplicateQueue(name="routes"), solver_backend=backend,
            device="cpu", **kwargs, **(port_extra or {}))
        self.jax_reader = self.jax.route_updates_queue.get_reader("test")
        self.port_reader = self.port.route_updates_queue.get_reader("test")
        self.versions = {}
        self._jax0 = _counters(jax_registry())
        self._port0 = _counters(get_registry())
        self._jax_gc0 = self.jax._collect_counters()
        self._port_gc0 = self.port._collect_counters()

    # publications
    def publish(self, key_vals, expired=(), area="0"):
        """``key_vals``: key -> (originator, wire bytes or None)."""
        jax_kv, port_kv = {}, {}
        for key, (orig, raw) in key_vals.items():
            v = self.versions[key] = self.versions.get(key, 0) + 1
            jax_kv[key] = JaxValue(version=v, originator_id=orig, value=raw)
            port_kv[key] = Value(version=v, originator_id=orig, value=raw)
        self.jax._on_publication(JaxPublication(key_vals=jax_kv, expired_keys=list(expired), area=area))
        self.port._on_publication(Publication(key_vals=port_kv, expired_keys=list(expired), area=area))

    def publish_adj(self, db):
        self.publish({jax_keys.adj_key(db.this_node_name): (db.this_node_name, jax_wire.dumps(db))},
                     area=db.area)

    def publish_prefixes(self, db):
        self.publish({jax_keys.prefix_db_key(db.this_node_name): (db.this_node_name, jax_wire.dumps(db))},
                     area=db.area)

    def publish_topology(self, topo):
        kv = {}
        for db in topo.adj_dbs.values():
            kv[jax_keys.adj_key(db.this_node_name)] = (db.this_node_name, jax_wire.dumps(db))
        for db in topo.prefix_dbs.values():
            kv[jax_keys.prefix_db_key(db.this_node_name)] = (db.this_node_name, jax_wire.dumps(db))
        self.publish(kv, area=topo.area)

    def publish_backlog(self, dbs):
        """Push one publication per adjacency DB into each module's KvStore
        queue, then deliver them as the event base does: each handler call
        takes the next one off the module's reader, whose remaining depth
        the admission path reads (and drains, past its shed depth). Each
        module's event base forwards its reader from a thread of its own;
        those threads are stopped first, so this thread alone reads."""
        for d in (self.jax, self.port):
            d.evb._stop_requested.set()
            for t in d.evb._reader_threads:
                t.join(timeout=5.0)
                assert not t.is_alive()
        pubs = []
        for db in dbs:
            key = jax_keys.adj_key(db.this_node_name)
            v = self.versions[key] = self.versions.get(key, 0) + 1
            pubs.append((key, v, db.this_node_name, jax_wire.dumps(db), db.area))
        for d, q, pub_cls, val_cls in (
                (self.jax, self.kv_queues["jax"], JaxPublication, JaxValue),
                (self.port, self.kv_queues["port"], Publication, Value)):
            for key, v, orig, raw, area in pubs:
                q.push(pub_cls(
                    key_vals={key: val_cls(version=v, originator_id=orig, value=raw)}, area=area))
            while True:
                pub = d._kv_reader.try_get()
                if pub is None:
                    break
                d._on_publication(pub)

    # the debounce timer
    def fire(self):
        """Run each module's pending debounce at once (what its event base
        does when the timer expires); nothing when none is pending."""
        fired = []
        for d in (self.jax, self.port):
            deb = d._rebuild_debounced
            fired.append(deb.is_scheduled())
            if deb.is_scheduled():
                deb._handle.cancel()
                deb._fire()
        assert fired[0] == fired[1]
        return fired[0]

    def rebuild(self, event="TEST"):
        for d in (self.jax, self.port):
            d.rebuild_routes(event)

    def updates(self):
        """Both modules' emitted updates since the last call: equal."""
        got = []
        for reader in (self.jax_reader, self.port_reader):
            out = []
            while True:
                u = reader.try_get()
                if u is None:
                    break
                out.append(u)
            got.append(out)
        jax_u, port_u = got
        assert [update_form(u) for u in port_u] == [update_form(u) for u in jax_u]
        return port_u

    def check(self, spec=False):
        """Installed route DBs and decision.* counters equal."""
        assert db_form(self.port.route_db) == db_form(self.jax.route_db)
        jax_d = _decision_deltas(_counters(jax_registry()), self._jax0)
        port_d = _decision_deltas(_counters(get_registry()), self._port0)
        # the reference's counters the port has no code path for
        # (the mesh and the multi-area world batch) never move here
        assert port_d == jax_d
        jax_g = self.jax._collect_counters()
        port_g = self.port._collect_counters()
        for k in port_g:
            if k.startswith("ops."):
                continue  # touch counts differ by design (module docstring)
            assert k in jax_g, k
            assert port_g[k] - self._port_gc0.get(k, 0) == jax_g[k] - self._jax_gc0.get(k, 0), k
        if spec:
            for k in ("ops.spec_dispatches", "ops.spec_hits", "ops.spec_cancels", "ops.spec_skips"):
                assert (get_registry().counter_get(k) - self._port0.get(k, 0)
                        == jax_registry().counter_get(k) - self._jax0.get(k, 0)), k

    def step(self, spec=False):
        """Fire, then hold updates, route DBs and counters equal."""
        self.fire()
        ups = self.updates()
        self.check(spec)
        return ups

    def routes_from(self, node):
        """The any-source route DB of ``node`` from both (the module's
        ``get_decision_route_db`` body, on this thread)."""
        got = []
        for d in (self.jax, self.port):
            got.append(d.spf_solver.build_route_db(node, d.area_link_states, d.prefix_state))
        assert db_form(got[1]) == db_form(got[0])
        return got[1]


def line_topology():
    return jax_topologies.build_topology("line", [("a", "b", 1), ("b", "c", 2)])


def _pfx(topo, node):
    return IpPrefix.from_str(topo.prefix_dbs[node].prefix_entries[0].prefix.to_str())


def _pfx_form(topo, node):
    return canon(topo.prefix_dbs[node].prefix_entries[0].prefix)


def _bump(db, metric, i=0):
    adjs = list(db.adjacencies)
    adjs[i] = replace(adjs[i], metric=metric)
    return replace(db, adjacencies=tuple(adjs))


def _unicast_forms(db):
    return {canon(p) for p in db.unicast_routes}


# -- the pipeline (tests/test_decision_module.py:95-240) ----------------------


class TestDecisionPipeline:
    def test_initial_convergence(self):
        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        ups = p.step()
        assert len(ups) == 1 and ups[0].perf_events is not None
        assert {_pfx_form(topo, "b"), _pfx_form(topo, "c")} <= _unicast_forms(p.port.route_db)

    def test_incremental_prefix_update(self):
        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        p.step()
        from openr_tpu.types import IpPrefix as JaxIpPrefix
        from openr_tpu.types import PrefixDatabase as JaxPrefixDatabase
        from openr_tpu.types import PrefixEntry as JaxPrefixEntry

        extra = JaxIpPrefix.from_str("fd00:100::/64")
        pdb = topo.prefix_dbs["c"]
        p.publish_prefixes(JaxPrefixDatabase(
            this_node_name="c", prefix_entries=pdb.prefix_entries + (JaxPrefixEntry(prefix=extra),),
            area=topo.area))
        (up,) = p.step()
        assert not p.port.pending.needs_full_rebuild()
        touched = {canon(k) for k in up.unicast_routes_to_update}
        assert canon(extra) in touched and _pfx_form(topo, "b") not in touched

    def test_adjacency_change_triggers_full_rebuild(self):
        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        p.step()
        db = topo.adj_dbs["b"]
        adjs = tuple(replace(a, metric=40) if a.other_node_name == "c" else a
                     for a in db.adjacencies)
        p.publish_adj(replace(db, adjacencies=adjs))
        assert p.port.pending.needs_full_rebuild()
        p.step()
        c_entry = p.port.route_db.unicast_routes[_pfx(topo, "c")]
        (nh,) = c_entry.nexthops
        assert nh.metric == 41

    def test_node_down_deletes_routes(self):
        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        p.step()
        from openr_tpu.types import AdjacencyDatabase as JaxAdj
        from openr_tpu.types import PrefixDatabase as JaxPdb

        p.publish({
            jax_keys.adj_key("c"): ("c", jax_wire.dumps(JaxAdj(this_node_name="c", area=topo.area))),
            jax_keys.prefix_db_key("c"): ("c", jax_wire.dumps(JaxPdb(this_node_name="c", area=topo.area))),
        })
        p.step()
        assert _pfx(topo, "c") not in p.port.route_db.unicast_routes

    def test_expired_keys_delete_routes(self):
        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        p.step()
        p.publish({}, expired=[keyutil.adj_key("c"), keyutil.prefix_db_key("c")])
        (up,) = p.step()
        assert _pfx(topo, "c") in up.unicast_routes_to_delete

    def test_any_source_route_computation(self):
        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        p.step()
        routes_c = p.routes_from("c")
        (nh,) = routes_c.unicast_routes[_pfx(topo, "a")].nexthops
        assert nh.neighbor_node_name == "b" and nh.metric == 3

    def test_per_prefix_keys(self):
        p = Pair()
        topo = line_topology()
        kv = {jax_keys.adj_key(n): (n, jax_wire.dumps(db)) for n, db in topo.adj_dbs.items()}
        p.publish(kv)
        b_pfx = topo.prefix_dbs["b"].prefix_entries[0].prefix
        from openr_tpu.types import PrefixDatabase as JaxPdb
        from openr_tpu.types import PrefixEntry as JaxEntry

        key = jax_keys.per_prefix_key("b", topo.area, b_pfx)
        assert key == keyutil.per_prefix_key("b", topo.area, _pfx(topo, "b"))
        pdb = JaxPdb(this_node_name="b", prefix_entries=(JaxEntry(prefix=b_pfx),), area=topo.area)
        p.publish({key: ("b", jax_wire.dumps(pdb))})
        p.step()
        assert _pfx(topo, "b") in p.port.route_db.unicast_routes
        # withdrawn by a per-prefix delete
        p.publish({key: ("b", jax_wire.dumps(replace(pdb, delete_prefix=True)))})
        p.step()
        assert _pfx(topo, "b") not in p.port.route_db.unicast_routes

    def test_debounce_coalesces_churn(self):
        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        p.step()
        from openr_tpu.types import IpPrefix as JaxIpPrefix
        from openr_tpu.types import PrefixDatabase as JaxPdb
        from openr_tpu.types import PrefixEntry as JaxEntry

        extra = JaxIpPrefix.from_str("fd00:200::/64")
        runs = p.port.counters["decision.route_build_runs"]
        folds = get_registry().counter_get("decision.coalesced_publications")
        for i in range(10):
            p.publish_prefixes(JaxPdb(
                this_node_name="c",
                prefix_entries=topo.prefix_dbs["c"].prefix_entries
                + (JaxEntry(prefix=extra),)[: i % 2 + 1],
                area=topo.area))
        p.step()
        assert p.port.counters["decision.route_build_runs"] - runs == 1
        # the fold is counted: nine publications joined the window
        assert get_registry().counter_get("decision.coalesced_publications") - folds == 9


# -- SP reuse and the KSP2 engine through the module ---------------------------


def _churn(p, topo, node, steps, base=0):
    adj_dbs = p.adj_dbs = getattr(p, "adj_dbs", dict(topo.adj_dbs))
    for step in range(steps):
        adj_dbs[node] = _bump(adj_dbs[node], 2 + (base + step) % 5)
        p.publish_adj(adj_dbs[node])
        p.step()


def _fabric_names(topo, prefix):
    return sorted(k for k in topo.adj_dbs if k.startswith(prefix))


def test_sp_reuse_through_the_module():
    topo = jax_topologies.fat_tree_nodes(120, **SP_MPLS)
    rsw, fsw = _fabric_names(topo, "rsw")[0], _fabric_names(topo, "fsw")[0]
    p = Pair(rsw)
    p.publish_topology(topo)
    p.step()
    _churn(p, topo, fsw, 2)
    before = port_solver.SPF_COUNTERS["decision.sp_route_reuses"]
    _churn(p, topo, fsw, 3, base=2)
    assert port_solver.SPF_COUNTERS["decision.sp_route_reuses"] - before > 100


def test_ksp2_engine_through_the_module(monkeypatch):
    monkeypatch.setattr(jax_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    monkeypatch.setattr(port_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    topo = jax_topologies.fat_tree_nodes(60, **KSP2)
    rsw, fsw = _fabric_names(topo, "rsw")[0], _fabric_names(topo, "fsw")[0]
    p = Pair(rsw)
    p.publish_topology(topo)
    p.step()
    _churn(p, topo, fsw, 3)
    before = dict(port_solver.SPF_COUNTERS)
    _churn(p, topo, fsw, 3, base=3)
    counters = port_solver.SPF_COUNTERS
    assert counters["decision.ksp2_incremental_syncs"] - before["decision.ksp2_incremental_syncs"] >= 3
    assert counters["decision.ksp2_route_reuses"] > before["decision.ksp2_route_reuses"]
    (engine,) = p.port.spf_solver._ksp2_engines.values()
    assert engine.tracer == "native"


# -- module behaviours (tests/test_decision_parity.py:408) ---------------------


class TestDecisionModuleBehaviors:
    def test_no_spf_on_irrelevant_publication(self):
        p = Pair()
        p.publish_topology(line_topology())
        p.step()
        runs = p.port.counters["decision.route_build_runs"]
        p.publish({"unrelated:xyz": ("x", b"junk")})
        assert not p.fire()
        p.check()
        assert p.port.counters["decision.route_build_runs"] == runs

    def test_no_spf_on_duplicate_publication(self):
        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        p.step()
        runs = p.port.counters["decision.route_build_runs"]
        p.publish_adj(topo.adj_dbs["b"])
        p.publish_prefixes(topo.prefix_dbs["c"])
        assert not p.fire()
        p.check()
        assert p.port.counters["decision.route_build_runs"] == runs

    def test_duplicate_prefixes_failover(self):
        from openr_tpu.types import IpPrefix as JaxIpPrefix
        from openr_tpu.types import PrefixDatabase as JaxPdb
        from openr_tpu.types import PrefixEntry as JaxEntry

        p = Pair()
        topo = line_topology()
        p.publish_topology(topo)
        anycast = JaxIpPrefix.from_str("fd00:aaaa::/64")
        for node in ("b", "c"):
            p.publish_prefixes(JaxPdb(
                this_node_name=node,
                prefix_entries=topo.prefix_dbs[node].prefix_entries + (JaxEntry(prefix=anycast),),
                area=topo.area))
        p.step()
        port_any = IpPrefix.from_str("fd00:aaaa::/64")
        assert {nh.neighbor_node_name for nh in p.port.route_db.unicast_routes[port_any].nexthops} == {"b"}
        p.publish_prefixes(topo.prefix_dbs["b"])
        p.step()
        assert p.port.route_db.unicast_routes[port_any].nexthops == \
            p.port.route_db.unicast_routes[_pfx(topo, "c")].nexthops

    def test_counters_gauges(self):
        p = Pair()
        p.publish_topology(line_topology())
        p.step()
        c = p.port._collect_counters()
        assert c["decision.adj_db_update"] == 3 and c["decision.prefix_db_update"] == 3
        assert c["decision.route_build_runs"] == 1 and c["decision.publications"] == 1
        assert c["decision.num_nodes"] == 3
        assert c["decision.num_complete_adjacencies"] == 2
        assert c["decision.num_partial_adjacencies"] == 0
        assert c["decision.num_prefixes"] == 3
        assert c["decision.num_conflicting_prefixes"] == 0
        for name in ("ops.host_dispatches", "ops.blocking_syncs"):
            assert name in c


class TestDecisionPendingUpdates:
    """tests/test_decision_parity.py:829, on the port's class."""

    def test_needs_full_rebuild_on_topology_change(self):
        p = DecisionPendingUpdates("me")
        assert not p.needs_full_rebuild() and not p.needs_route_update()
        p.apply_link_state_change("other", LinkStateChange(topology_changed=True))
        assert p.needs_full_rebuild() and p.needs_route_update()
        p.reset()
        assert not p.needs_full_rebuild()

    def test_link_attributes_only_matter_for_self(self):
        p = DecisionPendingUpdates("me")
        p.apply_link_state_change("other", LinkStateChange(link_attributes_changed=True))
        assert not p.needs_full_rebuild()
        p.apply_link_state_change("me", LinkStateChange(link_attributes_changed=True))
        assert p.needs_full_rebuild()

    def test_updated_prefixes_accumulate_without_full_rebuild(self):
        p = DecisionPendingUpdates("me")
        pfx1, pfx2 = IpPrefix.from_str("fd00:1::/64"), IpPrefix.from_str("fd00:2::/64")
        p.apply_prefix_state_change({pfx1})
        p.apply_prefix_state_change({pfx2})
        assert not p.needs_full_rebuild() and p.needs_route_update()
        assert p.updated_prefixes == {pfx1, pfx2}
        p.reset()
        assert p.updated_prefixes == set()

    def test_perf_events_keep_oldest_chain(self):
        p = DecisionPendingUpdates("me")
        old = PerfEvents()
        old.add("n1", "FIRST")
        time.sleep(0.01)
        new = PerfEvents()
        new.add("n2", "SECOND")
        p.apply_prefix_state_change({IpPrefix.from_str("fd00:1::/64")}, new)
        p.apply_prefix_state_change({IpPrefix.from_str("fd00:2::/64")}, old)
        events = p.move_out_events()
        assert "FIRST" in [e.event_descr for e in events.events]
        assert p.move_out_events() is None

    def test_trace_spans_close_on_reset(self):
        p = DecisionPendingUpdates("me")
        trace = get_tracer().start("kvstore.publish")
        p.adopt_trace(trace)
        p.adopt_trace(get_tracer().start("kvstore.publish"))
        p.reset()
        (span,) = [s for s in trace.spans if s.name == "decision.debounce"]
        assert span.closed and span.attrs["aborted"]


# -- the degradation ladder (tests/test_degradation_ladder.py:494) -------------


def _ladder_topo():
    return jax_topologies.build_topology(
        "grid", [("a", "b", 1), ("b", "c", 2), ("a", "c", 5), ("c", "d", 1)])


def _arm(schedule_name, *args):
    get_injector().arm("decision.spf_solve", getattr(FaultSchedule, schedule_name)(*args))
    jax_injector().arm("decision.spf_solve", getattr(JaxFaultSchedule, schedule_name)(*args))


def _healthy_pair():
    topo = _ladder_topo()
    p = Pair("a")
    p.publish_topology(topo)
    p.step()
    assert p.port.supervisor.state is HealthState.HEALTHY
    return topo, p


def _states(p):
    assert int(p.port.supervisor.state) == int(p.jax.supervisor.state)
    assert p.port.spf_solver.backend == p.jax.spf_solver.backend
    return p.port.supervisor.state, p.port.spf_solver.backend


def _oracle(topo, adj_dbs):
    """A fault-free native-backend port Decision over the final topology."""
    o = Pair("a", backend="native")
    o.publish_topology(replace(topo, adj_dbs=adj_dbs))
    o.step()
    return db_form(o.port.route_db)


class TestDecisionLadder:
    def test_warm_fault_falls_to_cold(self):
        topo, p = _healthy_pair()
        db2 = _bump(topo.adj_dbs["b"], 7)
        _arm("fail_once")
        p.publish_adj(db2)
        p.step()
        assert _states(p) == (HealthState.DEGRADED, "device")
        assert get_registry().snapshot()["decision.health"] == float(HealthState.DEGRADED)
        assert db_form(p.port.route_db) == _oracle(topo, {**topo.adj_dbs, "b": db2})

    def test_cold_fault_falls_to_native(self):
        topo, p = _healthy_pair()
        db2 = _bump(topo.adj_dbs["b"], 9)
        _arm("fail_n", 5)
        p.publish_adj(db2)
        p.step()
        assert _states(p) == (HealthState.FALLBACK, "native")
        assert get_registry().counter_get("decision.fallbacks") - p._port0.get(
            "decision.fallbacks", 0) == 1
        assert db_form(p.port.route_db) == _oracle(topo, {**topo.adj_dbs, "b": db2})

    def test_fail_once_then_fail_two_reaches_native_and_self_heals(self):
        """The sequence the card's ``decision-ladder`` phase runs: a
        rebuild on the cold rung, one on the native rung, then disarmed,
        one back on the device."""
        topo, p = _healthy_pair()
        p.jax.supervisor = JaxSupervisor("decision", backoff_min_s=0.05, backoff_max_s=0.1,
                                         backoff_jitter=False)
        p.port.supervisor = DegradationSupervisor("decision", backoff_min_s=0.05,
                                                  backoff_max_s=0.1, backoff_jitter=False)
        adj_dbs = dict(topo.adj_dbs)
        rungs = []
        for metric, arm in ((7, ("fail_once",)), (9, ("fail_n", 2)), (11, None)):
            if arm is None:
                get_injector().reset()
                jax_injector().reset()
                time.sleep(0.25)  # the breaker's backoff elapses
            else:
                _arm(*arm)
            adj_dbs["b"] = _bump(topo.adj_dbs["b"], metric)
            p.publish_adj(adj_dbs["b"])
            p.step()
            rungs.append(_states(p))
            assert db_form(p.port.route_db) == _oracle(topo, adj_dbs)
        assert rungs == [(HealthState.DEGRADED, "device"), (HealthState.FALLBACK, "native"),
                         (HealthState.HEALTHY, "device")]
        assert get_registry().counter_get("decision.self_heals") - p._port0.get(
            "decision.self_heals", 0) == 1

    def test_breaker_holds_then_probe_self_heals(self):
        topo, p = _healthy_pair()
        p.jax.supervisor = JaxSupervisor("decision", backoff_min_s=0.25, backoff_max_s=1.0)
        p.port.supervisor = DegradationSupervisor("decision", backoff_min_s=0.25, backoff_max_s=1.0)
        _arm("fail_n", 5)
        p.publish_adj(_bump(topo.adj_dbs["b"], 9))
        p.step()
        assert _states(p)[0] is HealthState.FALLBACK
        get_injector().reset()
        jax_injector().reset()
        p.publish_adj(_bump(topo.adj_dbs["b"], 11))
        p.step()
        assert _states(p) == (HealthState.FALLBACK, "native")
        time.sleep(0.8)
        db4 = _bump(topo.adj_dbs["b"], 13)
        p.publish_adj(db4)
        p.step()
        assert _states(p) == (HealthState.HEALTHY, "device")
        assert db_form(p.port.route_db) == _oracle(topo, {**topo.adj_dbs, "b": db4})

    def test_ladder_span_in_rebuild_trace(self):
        topo, p = _healthy_pair()
        trace = get_tracer().start("kvstore.publish")
        _arm("fail_once")
        p.publish_adj(_bump(topo.adj_dbs["b"], 7))
        p.port.pending.adopt_trace(trace)
        p.step()
        names = [s.name for s in trace.spans]
        assert "decision.rebuild" in names
        (ladder,) = [s for s in trace.spans if s.name == "decision.ladder"]
        assert ladder.closed and ladder.attrs["rung"] == "cold"
        assert ladder.attrs["health"] == "DEGRADED"
        (rebuild,) = [s for s in trace.spans if s.name == "decision.rebuild"]
        # the dispatch accounting's counts ride the span
        assert {"host_touches", "host_dispatches", "blocking_syncs"} <= set(rebuild.attrs)
        get_tracer().finish(trace, ok=True)

    def test_exhausted_ladder_raises_and_keeps_pending(self):
        topo, p = _healthy_pair()

        def fail_native(backend):
            # the native rung fails too, on a fault the ladder takes
            raise FaultInjected("decision.spf_solve")

        p.port.spf_solver.set_backend = fail_native
        _arm("fail_n", 5)
        port_pub = Publication(key_vals={keyutil.adj_key("b"): Value(
            version=99, originator_id="b", value=jax_wire.dumps(_bump(topo.adj_dbs["b"], 9)))})
        p.port.process_publication(port_pub)
        with pytest.raises(LadderExhausted):
            p.port.rebuild_routes("TEST")
        assert p.port.pending.needs_route_update()
        assert get_registry().counter_get("decision.ladder_exhausted") - p._port0.get(
            "decision.ladder_exhausted", 0) == 1

    @pytest.mark.parametrize("where", ["kernel_launch", "native_build"])
    def test_unrecoverable_failure_propagates_and_never_reaches_the_host(
            self, where, monkeypatch):
        """Only an injected fault or torn resident state goes down the
        ladder. A kernel's launch failure on the warm rung, or a failed
        native build on the last rung, leaves ``rebuild_routes`` as it is:
        no deeper rung runs, the health state does not move, no fallback is
        counted, and the publication stays pending."""
        topo, p = _healthy_pair()
        native_calls = []

        def native_fails(snap, *a, **k):
            native_calls.append(snap)
            raise NativeBuildError("g++ not found: the native SPF core cannot be built")

        monkeypatch.setattr(native_spf, "all_pairs_distances", native_fails)
        if where == "kernel_launch":
            def launch_fails(a, b):
                raise RuntimeError("CUDA error: an illegal memory access was encountered")

            monkeypatch.setattr(port_spf, "minplus", launch_fails)
            raised = RuntimeError
        else:
            _arm("fail_n", 5)
            raised = NativeBuildError
        p.port.process_publication(Publication(key_vals={keyutil.adj_key("b"): Value(
            version=99, originator_id="b", value=jax_wire.dumps(_bump(topo.adj_dbs["b"], 9)))}))
        reg = get_registry()
        before = _counters(reg)
        with pytest.raises(raised) as got:
            p.port.rebuild_routes("TEST")
        assert not isinstance(got.value, LadderExhausted)
        assert len(native_calls) == (0 if where == "kernel_launch" else 1)
        assert p.port.supervisor.state is HealthState.HEALTHY
        moved = {k: v - before.get(k, 0) for k, v in _counters(reg).items()
                 if k.startswith("decision.") and v != before.get(k, 0)}
        # the injected faults took the warm and cold rungs; nothing else
        # counted a rung's failure, a fallback or an exhausted ladder
        faulted = {} if where == "kernel_launch" else {
            "decision.rung_failures.warm": 1, "decision.rung_failures.cold": 1}
        assert {k: v for k, v in moved.items() if "rung_failures" in k} == faulted
        assert not [k for k in moved if k in (
            "decision.fallbacks", "decision.degradations", "decision.ladder_exhausted")], moved
        assert p.port.pending.needs_route_update()


# -- prewarm and speculation in the sparse regime --------------------------------


@pytest.fixture
def sparse(monkeypatch):
    monkeypatch.setattr(jax_solver, "SPARSE_NODE_THRESHOLD", 8)
    monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", 8)


def test_prewarm_and_speculation_counters_match_reference(sparse):
    topo = jax_topologies.fat_tree_nodes(60)
    rsw = _fabric_names(topo, "rsw")[0]
    fsws = _fabric_names(topo, "fsw")
    p = Pair(rsw)
    p.publish_topology(topo)
    p.step(spec=True)
    adj_dbs = dict(topo.adj_dbs)
    # windows of 1 to 9 publications: past 5 the debounce saturates and
    # the terminal speculation stages the view; later joins cancel it
    for burst in (1, 3, 6, 9):
        for i in range(burst):
            node = fsws[i % len(fsws)]
            adj_dbs[node] = _bump(adj_dbs[node], 2 + (burst + i) % 7)
            p.publish_adj(adj_dbs[node])
        p.step(spec=True)
    reg = get_registry()
    assert reg.counter_get("decision.ell_prewarms") - p._port0.get("decision.ell_prewarms", 0) > 0
    assert reg.counter_get("ops.spec_dispatches") - p._port0.get("ops.spec_dispatches", 0) > 0
    assert reg.counter_get("ops.spec_hits") - p._port0.get("ops.spec_hits", 0) > 0
    # every rebuild after the first synced the resident bands by patch
    assert reg.counter_get("decision.ell_full_compiles") - p._port0.get(
        "decision.ell_full_compiles", 0) == 1


def test_speculation_stands_down_while_a_fault_is_armed(sparse):
    topo = jax_topologies.fat_tree_nodes(60)
    rsw = _fabric_names(topo, "rsw")[0]
    fsw = _fabric_names(topo, "fsw")[0]
    p = Pair(rsw)
    p.publish_topology(topo)
    p.step(spec=True)
    get_injector().arm("device.lost", FaultSchedule.fail_once())
    jax_injector().arm("device.lost", JaxFaultSchedule.fail_once())
    db = topo.adj_dbs[fsw]
    for i in range(7):
        db = _bump(db, 2 + i % 5)
        p.publish_adj(db)
    p.step(spec=True)
    assert get_registry().counter_get("ops.spec_skips") - p._port0.get("ops.spec_skips", 0) > 0


def test_prewarm_failure_is_counted_and_the_rebuild_compiles(sparse, monkeypatch):
    topo = jax_topologies.fat_tree_nodes(60)
    rsw, fsw = _fabric_names(topo, "rsw")[0], _fabric_names(topo, "fsw")[0]
    d = Decision(rsw, ReplicateQueue(), ReplicateQueue(), device="cpu")
    kv = {keyutil.adj_key(n): Value(1, n, jax_wire.dumps(db)) for n, db in topo.adj_dbs.items()}
    kv.update({keyutil.prefix_db_key(n): Value(1, n, jax_wire.dumps(db))
               for n, db in topo.prefix_dbs.items()})
    d.process_publication(Publication(key_vals=kv))
    d.rebuild_routes("TEST")
    state = d.spf_solver._resident._cache[next(iter(d.area_link_states.values()))][1]

    def torn(*a, **k):
        raise RuntimeError("scatter failed")

    monkeypatch.setattr(state, "apply_patch", torn)
    reg = get_registry()
    before = _counters(reg)
    d._on_publication(Publication(key_vals={keyutil.adj_key(fsw): Value(
        2, fsw, jax_wire.dumps(_bump(topo.adj_dbs[fsw], 9)))}))
    assert reg.counter_get("decision.ell_prewarm_failures") - before.get(
        "decision.ell_prewarm_failures", 0) == 1
    d.rebuild_routes("TEST")
    assert reg.counter_get("decision.ell_full_compiles") - before.get(
        "decision.ell_full_compiles", 0) == 1


@pytest.mark.parametrize("burst", [2, 4, 9], ids=["shallow", "deep", "shed"])
def test_admission_matches_reference(sparse, burst):
    """``Decision(admission=...)``: a backlog below the shed depth is
    delivered a publication at a time, one at or past it is drained and
    coalesced (superseded versions of a key shed), the debounce ceiling
    widens under the backlog and narrows after it, and a deep backlog skips
    the prewarm. Updates, route DBs, the ``decision.*`` counters (the
    ``decision.admission.*`` ones among them) and the ceiling equal the
    reference's after every round."""
    from openr_tpu.load.admission import AdmissionConfig as JaxAdmissionConfig
    from openr_tpu.load.admission import AdmissionControl as JaxAdmissionControl
    from openr_tpu_torch.load.admission import AdmissionConfig, AdmissionControl

    knobs = dict(shed_depth=4, widen_depth=3, narrow_depth=1, cap_s=1.0, prewarm_depth_limit=2)
    topo = jax_topologies.fat_tree_nodes(60)
    rsw = _fabric_names(topo, "rsw")[0]
    fsws = _fabric_names(topo, "fsw")
    p = Pair(rsw, jax_extra=dict(admission=JaxAdmissionControl(JaxAdmissionConfig(**knobs))),
             port_extra=dict(admission=AdmissionControl(AdmissionConfig(**knobs))))
    p.publish_topology(topo)
    p.step()
    adj_dbs = dict(topo.adj_dbs)
    for rnd in range(4):
        dbs = []
        for i in range(burst if rnd < 3 else 1):
            # two fabric switches a round, each bumped again and again:
            # a coalesced backlog keeps only each key's last version
            node = fsws[(rnd + i) % 2]
            adj_dbs[node] = _bump(adj_dbs[node], 2 + (rnd * burst + i) % 7)
            dbs.append(adj_dbs[node])
        p.publish_backlog(dbs)
        p.step(spec=True)
        assert (p.port._admission.controller.current_max_s
                == p.jax._admission.controller.current_max_s)
    assert db_form(p.port.route_db) == _oracle_db(topo, rsw, adj_dbs)
    moved = {k: v - p._port0.get(k, 0) for k, v in _counters(get_registry()).items()
             if k.startswith("decision.admission.") or k.startswith("decision.debounce_")}
    # the depth the first delivery of a round sees: the rest of the burst
    depth = burst - 1
    if depth >= knobs["shed_depth"]:
        assert moved.get("decision.admission.sheds", 0) == 3
        assert moved.get("decision.admission.shed_keys", 0) > 0
    else:
        assert moved.get("decision.admission.sheds", 0) == 0
    if knobs["prewarm_depth_limit"] < depth < knobs["shed_depth"]:
        assert moved.get("decision.admission.prewarm_skipped", 0) == 3
    if depth >= knobs["widen_depth"]:
        # widened under the backlog, narrowed once it drained (the exact
        # counts are the reference's: ``step`` compared them)
        assert moved.get("decision.debounce_widenings", 0) > 0
        assert moved.get("decision.debounce_narrowings", 0) > 0


def _oracle_db(topo, root, adj_dbs):
    """The host backend's route DB, through a port Decision on its own."""
    o = Pair(root, backend="host")
    o.publish_topology(replace(topo, adj_dbs=adj_dbs))
    o.step()
    return db_form(o.port.route_db)


# -- the event base thread ----------------------------------------------------------


def _wait_update(reader, timeout=20.0):
    return reader.get(timeout=timeout)


@pytest.mark.parametrize("pipelined", [False, True], ids=["eager", "pipelined"])
def test_event_base_thread_publications_to_route_updates(pipelined):
    topo = line_topology()
    kv_q, route_q = ReplicateQueue(name="kv"), ReplicateQueue(name="routes")
    reader = route_q.get_reader("test")
    d = Decision("a", kv_q, route_q, device="cpu", pipelined_emit=pipelined)
    d.start()
    try:
        kv = {keyutil.adj_key(n): Value(1, n, jax_wire.dumps(db)) for n, db in topo.adj_dbs.items()}
        kv.update({keyutil.prefix_db_key(n): Value(1, n, jax_wire.dumps(db))
                   for n, db in topo.prefix_dbs.items()})
        kv_q.push(Publication(key_vals=kv))
        up = _wait_update(reader)
        assert _pfx(topo, "c") in up.unicast_routes_to_update
        db = _bump(topo.adj_dbs["b"], 40, i=1)
        kv_q.push(Publication(key_vals={keyutil.adj_key("b"): Value(2, "b", jax_wire.dumps(db))}))
        up = _wait_update(reader)
        assert _pfx(topo, "c") in up.unicast_routes_to_update
        got = d.get_decision_route_db()
        assert got.unicast_routes.keys() == d.evb.call_and_wait(lambda: d.route_db.unicast_routes.keys())
        assert d.get_counters()["decision.route_build_runs"] == 2
    finally:
        d.stop()
    with pytest.raises(QueueTimeoutError):
        reader.get(timeout=0.05)


def test_decision_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decision("a", ReplicateQueue(), ReplicateQueue())
    d = Decision("a", ReplicateQueue(), ReplicateQueue(), device="cpu")
    assert d.spf_solver.device == torch.device("cpu")


def test_wire_resolves_port_types():
    topo = line_topology()
    raw = jax_wire.dumps(topo.adj_dbs["a"])
    from openr_tpu_torch.types import AdjacencyDatabase

    db = wire.loads(raw, AdjacencyDatabase)
    assert type(db) is AdjacencyDatabase
    assert wire.dumps(db) == raw
    assert port_decision.wire is wire
