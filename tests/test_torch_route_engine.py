"""The port's route sweep engines against the JAX package's, event by event.

Each network is held by both packages (``Twin``); an event is a list of
adjacency databases set on both link states, and the same call goes to the
reference engine (``openr_tpu.ops.route_engine`` on the CPU, its relax
through the Pallas kernels in interpret mode or its jnp formulation) and to
the port's (``device="cpu"``: the plain versions of the hand kernels).
After every event the two must agree exactly: the moved destination names,
the whole route product (digests, next-hop totals, sample metrics and
masks) and each sample's ``routes_from``, ``last_delta_rows`` and the
readback bytes, the engines' own counters and the registry's
(``route_engine.*``, ``ops.spec_*``, ``ops.burst_cancels``,
``ops.frontier_*``, the ladder's), and the ``ops.delta_rows`` /
``ops.readback_bytes`` / ``ops.frontier_*`` histograms. The event script
covers metric changes, overload flips, link down and up, a link add that
widens an ELL band, buckets that overflow with frontier thresholds 0 and
1, a coalesced window, deferred consume, a pipelined burst, a speculation
hit and a cancel, and the ladder's rungs under armed faults; the reference
tests' topologies: ``ring(16)``, ``fat_tree(pods=3, ssw_per_plane=2,
fsw_per_pod=2, rsw_per_pod=4)`` and ``random_mesh(24, degree=3, seed=7,
max_metric=9)``. At the end the port's product also equals a cold sweep.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.faults import injector as jax_injector
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import route_engine as jax_engine
from openr_tpu.ops import route_sweep as jax_sweep
from openr_tpu.telemetry import get_registry as jax_registry
from openr_tpu_torch import carry
from openr_tpu_torch.faults import injector as port_injector
from openr_tpu_torch.ops import dispatch_accounting as da
from openr_tpu_torch.ops import relax_loop as port_relax_loop
from openr_tpu_torch.ops import route_engine as port_engine
from openr_tpu_torch.ops import route_sweep as port_sweep
from openr_tpu_torch.ops import spf_grouped as port_grouped
from openr_tpu_torch.telemetry import get_registry as port_registry
from tests.test_torch_solver import Twin

CPU = torch.device("cpu")
FIELDS = ("digests", "nh_totals", "sample_metrics", "sample_masks")
ENGINE_ATTRS = (
    "cold_builds", "incremental_events", "full_refreshes", "frontier_resolves",
    "frontier_fallbacks", "structural_events", "coalesced_events", "host_fallbacks",
    "device_rebuilds", "last_delta_rows", "last_readback_bytes", "last_frontier_rows",
    "last_frontier_jumps", "last_frontier_cells", "_k_hint", "version", "aversion",
    "_device_valid",
)
COUNTERS = (
    "route_engine.cold_builds", "route_engine.incremental_events",
    "route_engine.full_refreshes", "route_engine.frontier_resolves",
    "route_engine.structural_events", "route_engine.coalesced_events",
    "route_engine.host_fallbacks", "route_engine.frontier_errors",
    "route_engine.deltas_discarded", "ops.frontier_fallbacks", "ops.spec_dispatches",
    "ops.spec_hits", "ops.spec_cancels", "ops.spec_skips", "ops.burst_cancels",
    "recovery.device_lost", "recovery.device_rebuilds", "route_engine.ladder_walks",
    "route_engine.fallbacks", "route_engine.degradations", "route_engine.self_heals",
    "route_engine.rung_failures.warm", "route_engine.rung_failures.recover",
    "route_engine.rung_failures.cold",
)
HISTOGRAMS = ("ops.delta_rows", "ops.readback_bytes", "ops.frontier_rows",
              "ops.frontier_cells", "ops.frontier_jumps")
KINDS = ("ell", "grouped")


def fat_tree():
    return jax_topologies.fat_tree(pods=3, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=4)


TOPOLOGIES = {
    "ring": lambda: jax_topologies.ring(16),
    "fat_tree": fat_tree,
    "mesh": lambda: jax_topologies.random_mesh(24, degree=3, seed=7, max_metric=9),
}


def port_db(jax_db):
    (db,), _ = carry.lsdb_from_plain([carry.to_plain(jax_db)], [])
    return db


class Ev:
    """One event: adjacency databases (JAX form) set in order, and the
    affected node set the engine is told."""

    def __init__(self, dbs, affected):
        self.dbs = list(dbs)
        self.affected = set(affected)


class Side:
    """One package's engine and link state."""

    def __init__(self, name, engine, ls):
        self.name = name
        self.engine = engine
        self.ls = ls

    def apply(self, ev: Ev):
        for db in ev.dbs:
            self.ls.update_adjacency_database(db if self.name == "jax" else port_db(db))
        return set(ev.affected)

    def applier(self, ev: Ev):
        return lambda: self.apply(ev)


def _counters(reg):
    return {name: reg.counter_get(name) for name in COUNTERS}


def _hists(reg):
    out = {}
    for name in HISTOGRAMS:
        h = reg.histogram_if_exists(name)
        out[name] = (0, 0.0) if h is None else (h._count, h._sum)
    return out


def _norm(result):
    if result is None or isinstance(result, list):
        return result
    return ("pending", type(result).__name__)


def arm(site, schedule_name, *args):
    for mod in (jax_injector, port_injector):
        mod.get_injector().arm(site, getattr(mod.FaultSchedule, schedule_name)(*args))


def disarm_all():
    for mod in (jax_injector, port_injector):
        mod.get_injector().reset()


class Pair:
    """The reference engine and the port's on one twinned network."""

    def __init__(self, topo, kind, samples=None, **kw):
        self.twin = Twin(topo)
        self.kind = kind
        names = sorted(self.twin.ls.get_adjacency_databases())
        self.names = names
        self.samples = samples or [names[0], names[len(names) // 2]]
        jcls = jax_engine.RouteSweepEngine if kind == "ell" else jax_engine.GroupedRouteSweepEngine
        pcls = port_engine.RouteSweepEngine if kind == "ell" else port_engine.GroupedRouteSweepEngine
        # the port's registry counter deltas over every compared step
        self.totals = {k: 0 for k in COUNTERS}
        before = self._state()
        self.jax = Side("jax", jcls(self.twin.jax_ls, self.samples, **kw), self.twin.jax_ls)
        self.port = Side("port", pcls(self.twin.ls, self.samples, device="cpu", **kw),
                         self.twin.ls)
        self.check("cold build", None, None, before)

    # -- the state both sides are compared on ------------------------------
    def _state(self):
        return {"jax": (_counters(jax_registry()), _hists(jax_registry())),
                "port": (_counters(port_registry()), _hists(port_registry()))}

    def check(self, tag, rj, rp, before):
        after = self._state()
        assert _norm(rj) == _norm(rp), (tag, rj, rp)
        je, pe = self.jax.engine, self.port.engine
        for attr in ENGINE_ATTRS:
            assert getattr(je, attr) == getattr(pe, attr), (tag, attr, getattr(je, attr),
                                                            getattr(pe, attr))
        assert (je._pending is None) == (pe._pending is None), tag
        jc = {k: after["jax"][0][k] - before["jax"][0][k] for k in COUNTERS}
        pc = {k: after["port"][0][k] - before["port"][0][k] for k in COUNTERS}
        assert jc == pc, (tag, {k: (jc[k], pc[k]) for k in COUNTERS if jc[k] != pc[k]})
        for k in COUNTERS:
            self.totals[k] += pc[k]
        for name in HISTOGRAMS:
            jn, js = (a - b for a, b in zip(after["jax"][1][name], before["jax"][1][name]))
            pn, ps = (a - b for a, b in zip(after["port"][1][name], before["port"][1][name]))
            assert (jn, js) == (pn, ps), (tag, name, jn, pn, js, ps)
        self.same_product(tag)

    def same_product(self, tag):
        a, b = self.jax.engine.result, self.port.engine.result
        assert tuple(a.graph.node_names) == tuple(b.graph.node_names), tag
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{tag}: {f}")
        for s in self.samples:
            assert a.routes_from(s) == b.routes_from(s), (tag, s)

    # -- driving ---------------------------------------------------------------
    def step(self, tag, call, *events):
        """Apply ``events`` (each side to its own link state) through
        ``call(side, appliers)`` and compare."""
        before = self._state()
        rj = call(self.jax, [self.jax.applier(e) for e in events])
        rp = call(self.port, [self.port.applier(e) for e in events])
        self.check(tag, rj, rp, before)
        return rj, rp

    def churn(self, tag, *events, **kw):
        def call(side, appliers):
            aff = set()
            for ap in appliers:
                aff |= ap()
            return side.engine.churn(side.ls, aff, **kw)

        return self.step(tag, call, *events)

    def both(self, fn):
        for side in (self.jax, self.port):
            fn(side.engine)

    def wait_breakers(self):
        """The supervisor's breaker reopens on the wall clock: wait until
        both allow a probe, so the walks stay comparable."""
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if all(s.engine.supervisor.breaker.can_try_now() for s in (self.jax, self.port)):
                return
            time.sleep(0.02)
        raise AssertionError("the breakers did not reopen")

    # -- events (built from the current JAX-side databases) ----------------
    def db(self, node):
        return self.twin.jax_ls.get_adjacency_databases()[node]

    def metric(self, node, i, metric):
        db = self.db(node)
        adjs = list(db.adjacencies)
        adjs[i] = replace(adjs[i], metric=metric)
        return Ev([replace(db, adjacencies=tuple(adjs))], {node, adjs[i].other_node_name})

    def overload(self, node, on):
        return Ev([replace(self.db(node), is_overloaded=on)], {node})

    def link_down(self, a, b):
        dbs = []
        for x, y in ((a, b), (b, a)):
            db = self.db(x)
            dbs.append(replace(db, adjacencies=tuple(
                adj for adj in db.adjacencies if adj.other_node_name != y)))
        return Ev(dbs, {a, b})

    def link_up(self, a, b, metric=1, link_idx=5):
        dbs = []
        for x, y in ((a, b), (b, a)):
            db = self.db(x)
            adj = jax_topologies._mk_adj(x, 0, y, 0, metric, link_idx=link_idx)
            dbs.append(replace(db, adjacencies=db.adjacencies + (adj,)))
        return Ev(dbs, {a, b})

    def plain(self):
        """Nodes whose events leave the samples' own adjacencies alone
        (such an event refuses speculation and bursts)."""
        return [n for n in self.names if n not in self.samples
                and _neighbor(self, n) not in self.samples]

    def restore(self, nodes, saved):
        return Ev([saved[n] for n in nodes], set(nodes))

    def finish(self):
        """The port's product equals a cold sweep of the same network, by
        node name."""
        self.port.engine.flush()
        self.jax.engine.flush()
        self.same_product("final flush")
        cold = port_sweep.all_sources_route_sweep(self.twin.ls, self.samples, block=64,
                                                  device=CPU)
        assert port_sweep.digests_by_name(self.port.engine.result) == \
            port_sweep.digests_by_name(cold)


@pytest.fixture(autouse=True)
def _clean_faults():
    disarm_all()
    yield
    disarm_all()


def _set_buckets(monkeypatch, buckets):
    monkeypatch.setattr(jax_engine, "_ROW_BUCKETS", buckets)
    monkeypatch.setattr(port_engine, "_ROW_BUCKETS", buckets)


def _hub(pair):
    """The node with the most neighbours (ties by name)."""
    return max(pair.names, key=lambda n: (len(pair.db(n).adjacencies), n))


def _neighbor(pair, node, i=0):
    return pair.db(node).adjacencies[i].other_node_name


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("kind", KINDS)
def test_event_script_matches_reference(kind, topo, monkeypatch):
    p = Pair(TOPOLOGIES[topo](), kind)
    names = p.names
    q = p.plain()
    a, b, c = q[0], q[-1], q[len(q) // 3]
    hub = _hub(p)
    bands0 = p.port.engine.graph.bands
    # metric changes, one way and the other
    p.churn("metric up", p.metric(a, 0, 7))
    p.churn("metric down", p.metric(b, 0, 2))
    # overload flip and back
    p.churn("drain", p.overload(c, True))
    p.churn("undrain", p.overload(c, False))
    # link down and up (the grouped layout restores the slot in place)
    x = _neighbor(p, a)
    saved = {n: p.db(n) for n in (a, x)}
    p.churn("link down", p.link_down(a, x))
    p.churn("link up", p.restore((a, x), saved))
    # buckets that overflow: full width at threshold 0, frontier at 1
    _set_buckets(monkeypatch, (2,))
    p.both(lambda e: setattr(e, "_k_hint", 2))
    p.both(lambda e: setattr(e, "frontier_threshold", 0.0))
    p.churn("overflow, full width", p.metric(hub, 0, 5))
    p.both(lambda e: setattr(e, "frontier_threshold", 1.0))
    p.churn("overflow, frontier", p.metric(hub, 0, 9))
    y = _neighbor(p, hub)
    saved = {n: p.db(n) for n in (hub, y)}
    p.churn("overflow, frontier, link down", p.link_down(hub, y))
    p.churn("overflow, frontier, link up", p.restore((hub, y), saved))
    monkeypatch.undo()
    # a coalesced window of three metric events
    p.step("window", lambda side, aps: side.engine.churn_window(
        side.ls, [ap() for ap in aps]),
        p.metric(a, 0, 4), p.metric(q[2], 0, 6), p.metric(c, 0, 3))
    # deferred consume: three events left in flight, then a flush
    p.churn("deferred 1", p.metric(a, 0, 8), defer_consume=True)
    p.churn("deferred 2", p.metric(q[3], 0, 2), defer_consume=True)
    p.churn("deferred 3", p.metric(c, 0, 5), defer_consume=True)
    p.step("flush", lambda side, aps: _norm(side.engine.flush()))
    # a pipelined burst of three events
    p.step("burst", lambda side, aps: side.engine.churn_burst(side.ls, aps),
           p.metric(a, 0, 2), p.metric(q[4], 0, 7), p.metric(b, 0, 6))
    # a speculation that hits, and one that is cancelled
    def spec_hit(side, aps):
        aff = aps[0]()
        staged = side.engine.speculate_churn(side.ls, [aff])
        return [staged] + side.engine.churn_window(side.ls, [aff])

    p.step("speculation hit", spec_hit, p.metric(q[5], 0, 3))

    def spec_cancel(side, aps):
        aff1 = aps[0]()
        staged = side.engine.speculate_churn(side.ls, [aff1])
        aff2 = aps[1]()
        return [staged] + side.engine.churn_window(side.ls, [aff1, aff2])

    p.step("speculation cancelled", spec_cancel, p.metric(q[6], 0, 4), p.metric(q[7], 0, 5))
    # a link add that widens the ELL band of its node (a new adjacency:
    # the grouped engine cold-rebuilds)
    known = {adj.other_node_name for adj in p.db(b).adjacencies}
    far = [n for n in names if n != b and n not in known]
    added = set()
    for i in range(max(0, 9 - len(known))):
        # each from the databases the previous one left
        ev = p.link_up(b, far[i], metric=3 + i, link_idx=3)
        for side in (p.jax, p.port):
            added |= side.apply(ev)
    p.churn("link add (widen)", Ev([], added))
    if kind == "ell":
        # the same node ids, a wider slot class
        assert [bd.k for bd in p.port.engine.graph.bands] > [bd.k for bd in bands0]
        assert p.port.engine.cold_builds == 1
    # the ladder: a dispatch fault lands on the cold rung, dispatch and
    # cold-build faults on the host rung, a lost device on the recover
    # rung; then unarmed events heal back to the warm rung
    arm("route_engine.dispatch", "fail_once")
    p.churn("ladder: cold rung", p.metric(a, 0, 6))
    arm("route_engine.dispatch", "fail_once")
    arm("route_engine.cold_build", "fail_once")
    p.churn("ladder: host rung", p.metric(b, 0, 4))
    disarm_all()
    p.wait_breakers()
    p.churn("ladder: probe back to cold", p.metric(a, 0, 3))
    p.churn("ladder: warm again", p.metric(b, 0, 5))
    arm("device.lost", "fail_once")
    p.churn("ladder: recover rung", p.metric(a, 0, 2))
    disarm_all()
    p.churn("ladder: warm after recovery", p.metric(q[2], 0, 9))
    p.finish()
    # every path of the script ran (the reference's counts are equal)
    eng, t = p.port.engine, p.totals
    assert eng.full_refreshes >= 1 and eng.frontier_resolves >= 1
    assert eng.frontier_fallbacks >= 1 and eng.structural_events >= 4
    assert eng.coalesced_events >= 2 and eng.host_fallbacks == 1
    assert eng.device_rebuilds == 1
    assert eng.cold_builds == (4 if kind == "grouped" else 3)
    assert t["ops.spec_hits"] == 1 and t["ops.spec_cancels"] == 1
    assert t["ops.burst_cancels"] == 0 and t["route_engine.self_heals"] == 2
    assert t["route_engine.fallbacks"] == 1 and t["route_engine.degradations"] == 3


@pytest.mark.parametrize("kind", KINDS)
def test_bucket_retry_and_overtaken_speculation_stay_bit_identical(kind, monkeypatch):
    """An overflowing bucket retried at a larger one re-dispatches
    against the untouched residents; a speculation whose residents
    another event replaced is cancelled, never adopted."""
    p = Pair(fat_tree(), kind)
    _set_buckets(monkeypatch, (2, 1024))
    p.both(lambda e: setattr(e, "_k_hint", 2))
    ssw = next(n for n in p.names if n.startswith("ssw"))
    p.churn("retry", p.metric(ssw, 0, 9))
    assert p.port.engine.last_path == "bucket" and p.port.engine.last_k == 1024
    e1 = p.metric(p.names[1], 0, 5)
    e2 = p.metric(p.names[-2], 0, 7)

    def overtaken(side, aps):
        aff1 = aps[0]()
        staged = side.engine.speculate_churn(side.ls, [aff1])
        spec = side.engine._speculation
        moved = side.engine.churn(side.ls, aps[1]())
        # the event committed under the staged speculation rebound DR
        assert spec is None or spec.dr_ref is not side.engine._dr
        return [staged] + moved + ["|"] + side.engine.churn_window(side.ls, [aff1])

    p.step("overtaken speculation", overtaken, e1, e2)
    assert port_registry().counter_get("ops.spec_cancels") > 0
    p.finish()


@pytest.mark.parametrize("kind", KINDS)
def test_consume_fault_walks_the_ladder(kind):
    """A fault at the consume of a deferred delta drops it; the next
    rung reassembles the whole result."""
    p = Pair(fat_tree(), kind)
    p.churn("deferred", p.metric(p.names[1], 0, 5), defer_consume=True)
    arm("route_engine.consume", "fail_once")
    p.churn("consume fault", p.metric(p.names[2], 0, 6))
    disarm_all()
    p.finish()


def _cone_inputs(seed, kind):
    """A twinned network, its resident DR rows (the port's cold engine),
    and a seeded edge-transition list with increases, decreases and a
    removal."""
    p = Pair(jax_topologies.random_mesh(24, degree=3, seed=7, max_metric=9), kind)
    eng = p.port.engine
    rng = np.random.default_rng(seed)
    n = eng.graph.n
    es = []
    for u in rng.choice(n, size=6, replace=False):
        outs = eng._w_out.get(int(u), {})
        if not outs:
            continue
        v = sorted(outs)[rng.integers(len(outs))]
        wo = outs[v]
        wn = [wo + 4, max(1, wo - 1), port_engine.INF][rng.integers(3)]
        es.append((int(u), int(v), wo, wn))
    e = np.asarray(es, dtype=np.int32)
    return p, eng._dr.numpy().copy(), e


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_jumps,cell_limit", [(16, None), (1, None), (16, 40.0)])
def test_cone_expand_matches_reference(kind, seed, max_jumps, cell_limit):
    import jax.numpy as jnp

    from openr_tpu.ops import spf_grouped as jax_grouped

    p, dr, e = _cone_inputs(seed, kind)
    rows = np.arange(0, dr.shape[0], 3)
    sel = dr[rows]
    je, pe = p.jax.engine, p.port.engine
    j_lim = None if cell_limit is None else jnp.float32(cell_limit)
    p_lim = None if cell_limit is None else torch.tensor(cell_limit, dtype=torch.float32)
    jargs = [jnp.asarray(e[:, c]) for c in range(4)]
    pargs = [torch.from_numpy(np.ascontiguousarray(e[:, c])) for c in range(4)]
    if kind == "ell":
        want = jax_sweep._cone_expand(jnp.asarray(sel), je.graph.bands, je.sweeper.v_t,
                                      je.sweeper.w_t, *jargs, max_jumps, cell_limit=j_lim)
        got = port_sweep._cone_expand(torch.from_numpy(sel), pe.graph.bands, pe.sweeper.v_t,
                                      pe.sweeper.w_t, *pargs, max_jumps, cell_limit=p_lim,
                                      row_block=4)
    else:
        want = jax_grouped._grouped_cone_expand(
            jnp.asarray(sel), je.sweeper.meta, je.sweeper.v_t, je.sweeper.w_t, *jargs,
            max_jumps, cell_limit=j_lim)
        got = port_grouped._grouped_cone_expand(
            torch.from_numpy(sel), pe.sweeper.meta, pe.sweeper.v_t, pe.sweeper.w_t, *pargs,
            max_jumps, cell_limit=p_lim, row_block=4)
    cone_j, rows_j, cells_j, jumps_j, ok_j = (np.asarray(x) for x in want)
    cone_p, rows_p, cells_p, jumps_p, ok_p, more_p = got
    np.testing.assert_array_equal(cone_j, cone_p.numpy())
    assert int(rows_j) == int(rows_p)
    assert np.float32(cells_j) == np.float32(cells_p.item())
    assert int(jumps_j) == int(jumps_p)
    assert bool(ok_j) == bool(ok_p)
    # without a jump budget the expansion runs to its end on the host's
    # chunked reads: nothing is left for a re-dispatch
    assert not bool(more_p)


def test_residency_bound_is_refused(monkeypatch):
    topo = fat_tree()
    twin = Twin(topo)
    names = sorted(twin.ls.get_adjacency_databases())
    monkeypatch.setattr(port_engine, "ENGINE_MAX_NODES", 64)
    monkeypatch.setattr(jax_engine, "ENGINE_MAX_NODES", 64)
    for cls in (port_engine.RouteSweepEngine, port_engine.GroupedRouteSweepEngine):
        with pytest.raises(ValueError, match="residency bound: 128 > 64"):
            cls(twin.ls, names[:1], device="cpu")
    with pytest.raises(ValueError, match="residency bound: 128 > 64"):
        jax_engine.RouteSweepEngine(twin.jax_ls, names[:1])


def test_mesh_is_refused_and_the_card_is_the_default(monkeypatch):
    twin = Twin(jax_topologies.ring(6))
    names = sorted(twin.ls.get_adjacency_databases())
    with pytest.raises(NotImplementedError, match="item 10"):
        port_engine.RouteSweepEngine(twin.ls, names[:1], mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (port_engine.RouteSweepEngine, port_engine.GroupedRouteSweepEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(twin.ls, names[:1])


def test_sweep_counts_a_sync_per_hop_and_per_readback():
    """One CPU sweep: ``ops.blocking_syncs`` rises by one read of each
    block's changed-hop count a chunk of hops (``relax_loop.chunk_for``,
    not one a hop) plus one readback a block, for both backends."""
    twin = Twin(fat_tree())
    names = sorted(twin.ls.get_adjacency_databases())
    reg = port_registry()
    graphs = [
        port_sweep.RouteSweeper(port_sweep.compile_out_ell(twin.ls), names[:2], device=CPU),
        port_grouped.GroupedRouteSweeper(port_grouped.compile_out_grouped(twin.ls), names[:2],
                                         device=CPU),
    ]
    for sweeper in graphs:
        before = reg.counter_get("ops.blocking_syncs")
        with da.event_window("sweep") as w:
            sweeper.sweep(block=32)
        blocks = len(sweeper.block_hops)
        assert blocks == -(-sweeper.graph.n_pad // 32)
        # a block reads its count after as many hops as the block before
        # it took (the first after HOP_CHUNK)
        chunks = [port_relax_loop.chunk_for(h) for h in [0] + sweeper.block_hops[:-1]]
        want = sum((h - 1) // c + 1 for h, c in zip(sweeper.block_hops, chunks)) + blocks
        assert want < sum(sweeper.block_hops) + blocks
        assert reg.counter_get("ops.blocking_syncs") - before == want
        assert w.blocking_syncs == want


def test_kick_and_reap_count_an_async_reap():
    reg = port_registry()
    t = torch.arange(6, dtype=torch.int32)
    before = (reg.counter_get("ops.async_reaps"), reg.counter_get("ops.blocking_syncs"))
    with da.event_window("probe") as w:
        got = da.reap_read(da.kick_async(t), kicked=True)
        plain = da.reap_read(t[:2])
    np.testing.assert_array_equal(got, t.numpy())
    np.testing.assert_array_equal(plain, [0, 1])
    assert reg.counter_get("ops.async_reaps") - before[0] == 1
    assert reg.counter_get("ops.blocking_syncs") - before[1] == 1
    assert w.async_reaps == 1 and w.blocking_syncs == 1 and w.read_phases == 1
    with da.pipeline_drain("burst") as d:
        with da.event_window("inner") as inner:
            assert inner is d
        da.note_window(2)
    assert d.windows == 3 and d.drain


def test_route_server_demo_runs_on_both_backends(tmp_path):
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    for extra in ([], ["--grouped"]):
        proc = subprocess.run(
            [sys.executable, "-m", "tools.torch_route_server_demo", "--nodes", "80",
             "--device", "cpu", *extra],
            cwd=repo, capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "PYTHONPATH": str(repo)},
        )
        assert proc.returncode == 0, proc.stderr
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["backend"] == ("grouped" if extra else "ell")
        assert out["events"] == ["metric", "link-down"] and out["parity"] is True
        # both events incremental, as the reference demo's test holds
        assert out["cold_builds"] == 1 and None not in out["moved"]


def test_chip_smoke_engine_phases_rehearsed_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s new phases at a small size on the CPU: the
    engine script on three engines with the ladder (buckets lowered so
    events overflow into the frontier path), the kernel
    shape checks, and the sweep that runs at 100 000 nodes on the card."""
    import json

    import chip_smoke
    from openr_tpu_torch.graph.linkstate import LinkState
    from openr_tpu_torch.models import topologies as port_topologies

    monkeypatch.setattr(port_engine, "_ROW_BUCKETS", (8, 32))
    chip_smoke.engine_phase(CPU, "engine-rehearsal", 100, True, 64, True)
    line = json.loads([x for x in capsys.readouterr().out.splitlines()
                       if '"engine-rehearsal"' in x][-1])
    paths = {rec["path"] for ev in line["events"] for rec in ev["engines"].values()}
    assert {"bucket", "frontier", "cold"} <= paths, paths
    assert [s["step"] for s in line["ladder"]] == ["cold rung", "host rung", "healed: probe",
                                                   "healed: warm"]
    assert line["ladder"][-1]["warm"]
    for label, eng in line["engines"].items():
        assert eng["host_fallbacks"] == 1, label
    chip_smoke.sweep_huge_phase(CPU, 300, 64, 16, 1, phase="sweep-rehearsal")
    topo = port_topologies.fat_tree_nodes(150)
    ls = LinkState(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])

    def compare(name, got, want, what):
        assert torch.equal(got, want), (name, what)

    rows = chip_smoke.engine_kernel_shapes(CPU, ls, np.random.default_rng(0), compare)
    assert set(rows) == {"rev_band_relax", "batched_minplus", "batched_minplus_t"}
    assert all(set(cells) == {"b32", "b1024", "full"} for cells in rows.values())
