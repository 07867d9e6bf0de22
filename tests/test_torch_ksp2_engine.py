"""The port's incremental KSP2 engine against the JAX package's.

The scenarios of ``tests/test_ksp2_engine.py`` (a link-metric cycle on a
fabric, random metric churn on a grid, link down and up, a transit
overload flip, a drained advertiser, node-label changes, an undrain that
reconnects a masked second path, a mixed SP/KSP2 advertiser, two areas, a
LAG fabric, a band widening; the reference's two soak regressions, seeds
9013 and 40018, are in ``tests/test_torch_ksp2_engine_soak.py``) run
through three solvers on their own copies of
the databases: ``openr_tpu``'s device solver (its engine), ``openr_tpu``'s
host backend (the oracle) and the port's device solver on the CPU (its
engine), each with ``OPENR_KSP2_FAST`` at 1 and at 0 for both packages.
After every event the port's route database must equal the host
backend's, and the JAX engine's (none of these events is one where the
JAX engine is known to disagree with its host backend); and the KSP2
counters of the event must equal the JAX engine's, except that where the
root's overload bit flipped the port reuses no more KSP2 routes than the
reference (it re-derives the root's prefixes; see ``tests/
test_torch_ksp2.py``'s ``ENGINE_FAULTS``).

The pieces are held against the reference one by one: the all-sources
fixed point (warm against cold), ``ell_all_view_rows`` and
``ell_all_view_rows_masked`` with the whole packed buffer (the on-device
row diff below, at and above its budget), and the engines' affected sets
and cached paths (as link keys, handed across by ``carry``). Everything
is int32 or exact path lists: no tolerance applies.
"""

from __future__ import annotations

import random
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision import ksp2_engine as jax_ksp2
from openr_tpu.decision import spf_solver as jax_solver
from openr_tpu.decision.prefix_state import PrefixState as JaxPrefixState
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu.types import Adjacency as JaxAdjacency
from openr_tpu.types import AdjacencyDatabase as JaxAdjacencyDatabase
from openr_tpu.types.lsdb import PrefixForwardingAlgorithm as JaxAlgo
from openr_tpu.types.lsdb import PrefixForwardingType as JaxFwdType
from openr_tpu_torch import carry
from openr_tpu_torch.decision import ksp2_engine as port_ksp2
from openr_tpu_torch.decision import spf_solver as port_solver
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.ops import spf_sparse as port_sparse
from openr_tpu_torch.ops.ell_relax import pack_edge_mask
from openr_tpu_torch.ops.staging import Readback

KSP2 = dict(forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP, forwarding_type=JaxFwdType.SR_MPLS)
# the scenarios' fabric: fat_tree_nodes(60), 64 nodes in 3 pods (the
# reference's tests use fat_tree_nodes(120), 112 nodes in 6 pods; the
# soak regressions keep that one)
FABRIC_NODES = 60
COUNTERS = (
    "decision.ksp2_device_batches",
    "decision.ksp2_host_fallbacks",
    "decision.ksp2_cold_builds",
    "decision.ksp2_incremental_syncs",
    "decision.ksp2_warm_dispatches",
    "decision.ksp2_affected_dsts",
    "decision.ksp2_route_reuses",
)


@pytest.fixture(autouse=True)
def _device_ksp2_everywhere(monkeypatch):
    monkeypatch.setattr(jax_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    monkeypatch.setattr(port_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    yield
    # CPU tensors run the plain versions: no kernel launch is counted
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


@pytest.fixture(params=["1", "0"], ids=["fast", "slow"])
def fast(request, monkeypatch):
    monkeypatch.setenv("OPENR_KSP2_FAST", request.param)
    return request.param == "1"


# -- three solvers, each on its own databases --------------------------------


def _counts(counters):
    return [int(counters[name]) for name in COUNTERS]


def _plain(route_db, root):
    return carry.route_db_to_plain(route_db.to_route_db(root))


class Trio:
    """One network held three times: the JAX engine's, the JAX host
    oracle's and the port engine's link-state and prefix databases, and a
    solver on each. Every change is made to a JAX database and handed to
    the port through ``carry``."""

    def __init__(self, topos, extra, root):
        self.root = root
        self.jax = self._world(topos, extra, True)
        self.host = self._world(topos, extra, True)
        self.port = self._world(topos, extra, False)
        self.jax_solver = jax_solver.SpfSolver(root, backend="device")
        self.host_solver = jax_solver.SpfSolver(root, backend="host")
        self.port_solver = port_solver.SpfSolver(root, backend="device", device="cpu")
        self.root_ov = self._root_ov()
        self.steps = 0

    @staticmethod
    def _world(topos, extra, jax):
        areas = {t.area: (JaxLinkState if jax else LinkState)(area=t.area) for t in topos}
        ps = JaxPrefixState() if jax else PrefixState()
        world = (areas, ps)
        for topo in topos:
            for name in sorted(topo.adj_dbs):
                Trio._set_adj(world, topo.adj_dbs[name], jax)
        for db in extra:
            Trio._set_adj(world, db, jax)
        for topo in topos:
            for name in sorted(topo.prefix_dbs):
                Trio._set_prefixes(world, topo.prefix_dbs[name], jax)
        return world

    @staticmethod
    def _set_adj(world, jax_db, jax):
        db = jax_db if jax else carry.lsdb_from_plain([carry.to_plain(jax_db)], [])[0][0]
        world[0][jax_db.area].update_adjacency_database(db)

    @staticmethod
    def _set_prefixes(world, jax_db, jax):
        db = jax_db if jax else carry.lsdb_from_plain([], [carry.to_plain(jax_db)])[1][0]
        world[1].update_prefix_database(db)

    def adj(self, node, area=None):
        areas = self.host[0]
        return areas[area or next(iter(areas))].get_adjacency_databases()[node]

    def set_adj(self, jax_db) -> None:
        for world, jax in ((self.jax, True), (self.host, True), (self.port, False)):
            self._set_adj(world, jax_db, jax)

    def set_prefixes(self, jax_db) -> None:
        for world, jax in ((self.jax, True), (self.host, True), (self.port, False)):
            self._set_prefixes(world, jax_db, jax)

    def _root_ov(self):
        return tuple(ls.is_node_overloaded(self.root) for _, ls in sorted(self.host[0].items()))

    def step(self, event) -> None:
        """Build all three; the port must equal the host oracle and the
        JAX engine, and count what the JAX engine counts."""
        root = self.root
        jax_c, port_c = _counts(jax_solver.SPF_COUNTERS), _counts(port_solver.SPF_COUNTERS)
        want = _plain(self.jax_solver.build_route_db(root, *self.jax), root)
        oracle = _plain(self.host_solver.build_route_db(root, *self.host), root)
        got = _plain(self.port_solver.build_route_db(root, *self.port), root)
        jax_d = [a - b for a, b in zip(_counts(jax_solver.SPF_COUNTERS), jax_c)]
        port_d = [a - b for a, b in zip(_counts(port_solver.SPF_COUNTERS), port_c)]
        assert got == oracle, f"port != openr_tpu host after {event}"
        assert got == want, f"port != openr_tpu engine after {event}"
        root_ov = self._root_ov()
        if root_ov != self.root_ov:
            # the port re-derives the routes of the root's prefixes
            assert port_d[:-1] == jax_d[:-1], (event, port_d, jax_d)
            assert port_d[-1] <= jax_d[-1], (event, port_d, jax_d)
        else:
            assert port_d == jax_d, (event, dict(zip(COUNTERS, port_d)), jax_d)
        self.root_ov = root_ov
        self.steps += 1


def _drive(trio, events):
    trio.step("initial build")
    for event in events:
        trio.step(event)
    return trio


def _fabric(nodes=FABRIC_NODES):
    return [jax_topologies.fat_tree_nodes(nodes, **KSP2)]


def _grid(n=5):
    return [jax_topologies.grid(n, **KSP2)]


def _names(topos, prefix):
    return sorted(k for t in topos for k in t.adj_dbs if k.startswith(prefix))


def _metric(trio, node, i, metric, area=None):
    db = trio.adj(node, area)
    adjs = list(db.adjacencies)
    adjs[i] = replace(adjs[i], metric=metric)
    trio.set_adj(replace(db, adjacencies=tuple(adjs)))


def _overload(trio, node, on):
    trio.set_adj(replace(trio.adj(node), is_overloaded=on))


def _label(trio, node, label):
    trio.set_adj(replace(trio.adj(node), node_label=label))


# -- the reference's churn scenarios ------------------------------------------


def _metric_cycle():
    topos = _fabric()
    fsw, rsw = _names(topos, "fsw")[0], _names(topos, "rsw")[0]

    def events(trio):
        for step in range(8):
            _metric(trio, fsw, 0, 2 + step % 5)
            yield f"{fsw} metric {2 + step % 5}"

    return topos, [], rsw, events


def _random_grid():
    topos = _grid()
    nodes = sorted(topos[0].adj_dbs)

    def events(trio):
        rng = random.Random(13)
        for step in range(15):
            victim, metric = rng.choice(nodes), rng.randint(1, 9)
            adjs = trio.adj(victim).adjacencies
            if adjs:
                _metric(trio, victim, step % len(adjs), metric)
            yield f"step {step}: {victim} metric {metric}"

    return topos, [], "node-0", events


def _link_down_up():
    topos = _fabric()
    fsw, rsw = _names(topos, "fsw")[0], _names(topos, "rsw")[0]

    def events(trio):
        _metric(trio, fsw, 0, 4)
        yield "metric"
        db = trio.adj(fsw)
        dropped = db.adjacencies[0]
        trio.set_adj(replace(db, adjacencies=db.adjacencies[1:]))
        yield "link down"
        _metric(trio, fsw, 0, 4)
        yield "metric"
        db = trio.adj(fsw)
        trio.set_adj(replace(db, adjacencies=db.adjacencies + (dropped,)))
        yield "link up"

    return topos, [], rsw, events


def _transit_overload():
    topos = _fabric()
    fsws, rsw = _names(topos, "fsw"), _names(topos, "rsw")[0]

    def events(trio):
        _overload(trio, fsws[0], True)
        yield "transit drained"
        _metric(trio, fsws[1], 0, 3)
        yield "metric"
        _overload(trio, fsws[0], False)
        yield "transit undrained"

    return topos, [], rsw, events


def _advertiser_drain():
    topos = _fabric()
    rsws = _names(topos, "rsw")

    def events(trio):
        _overload(trio, rsws[5], True)
        yield "advertiser drained"
        _overload(trio, rsws[5], False)
        yield "advertiser undrained"

    return topos, [], rsws[0], events


def _label_change():
    topos = _fabric()
    fsws, rsw = _names(topos, "fsw"), _names(topos, "rsw")[0]

    def events(trio):
        _label(trio, fsws[0], 60000)
        yield "transit label"
        # the root's own label enters no KSP2 route
        _label(trio, rsw, 60001)
        yield "root label"

    return topos, [], rsw, events


def _undrain_reconnect():
    # every fsw drained but two: first paths ride one, the only second
    # path the other; draining it disconnects many masked graphs, and the
    # undrain must reconnect them
    topos = _fabric()
    fsws, rsw = _names(topos, "fsw"), _names(topos, "rsw")[0]

    def events(trio):
        # two at a time: each drain stays an incremental sync
        for i in range(2, len(fsws), 2):
            for f in fsws[i : i + 2]:
                _overload(trio, f, True)
            yield f"{fsws[i:i + 2]} drained"
        _overload(trio, fsws[1], True)
        yield "last second-path fsw drained"
        _overload(trio, fsws[1], False)
        yield "last second-path fsw undrained"

    return topos, [], rsw, events


def _mixed_sp():
    # node-12 advertises SP_ECMP over IP: outside the engine's tracked
    # set, so its routes are never reused from the engine's affected set
    topos = _grid()
    pdb = topos[0].prefix_dbs["node-12"]
    sp_pdb = replace(pdb, prefix_entries=tuple(
        replace(e, forwarding_type=JaxFwdType.IP, forwarding_algorithm=JaxAlgo.SP_ECMP)
        for e in pdb.prefix_entries
    ))

    def events(trio):
        trio.set_prefixes(sp_pdb)
        yield "node-12 SP_ECMP"
        _metric(trio, "node-7", 0, 9)
        _metric(trio, "node-11", 0, 9)
        yield "churn toward node-12"

    return topos, [], "node-0", events


def _border_adj(node, other, metric=1):
    return JaxAdjacency(other_node_name=other, if_name=f"if_{node}_{other}",
                        other_if_name=f"if_{other}_{node}", metric=metric)


def _multi_area():
    grid = jax_topologies.grid(4, area="a", **KSP2)
    fabric = jax_topologies.fat_tree_nodes(FABRIC_NODES, area="b", **KSP2)
    rsw = _names([fabric], "rsw")[0]
    fsw = _names([fabric], "fsw")[0]
    rsw_db = fabric.adj_dbs[rsw]
    extra = [
        JaxAdjacencyDatabase(this_node_name="node-0", adjacencies=(_border_adj("node-0", rsw),),
                             node_label=9000, area="b"),
        replace(rsw_db, adjacencies=rsw_db.adjacencies + (_border_adj(rsw, "node-0"),)),
    ]

    def events(trio):
        for step in range(3):
            _metric(trio, fsw, 0, 2 + step, area="b")
            yield f"b-{step}"
        for step in range(3):
            _metric(trio, "node-2", 0, 3 + step, area="a")
            yield f"a-{step}"

    return [grid, fabric], extra, "node-0", events


def _lag():
    # 2-tier leaf/spine, every leaf-spine pair a 2-member LAG (metrics 1
    # and 2): both members of leaf-1 <-> spine-0 churn, then a member of
    # the root's down and up
    edges = []
    for leaf in range(4):
        for spine in range(2):
            edges.append((f"leaf-{leaf}", f"spine-{spine}", 1))
            edges.append((f"leaf-{leaf}", f"spine-{spine}", 2))
    topos = [jax_topologies.build_topology("lag-fabric", edges, **KSP2)]

    def events(trio):
        for s in range(6):
            _metric(trio, "leaf-1", 0, 1 + s % 3)
            yield f"member 0 metric {1 + s % 3}"
            _metric(trio, "leaf-1", 1, 2 + s % 4)
            yield f"member 1 metric {2 + s % 4}"
        db = trio.adj("leaf-0")
        trio.set_adj(replace(db, adjacencies=db.adjacencies[1:]))
        yield "root member down"
        trio.set_adj(db)
        yield "root member up"

    return topos, [], "leaf-0", events


def _band_widening():
    # a rack switch gains enough new adjacencies to outgrow its slot
    # class: the resident band widens in place, the engine re-seeds
    topos = _fabric()
    rsws, fsw = _names(topos, "rsw"), _names(topos, "fsw")[0]
    a, root = rsws[0], rsws[1]
    targets = [r for r in rsws if r not in (a, root)][:9]

    def events(trio):
        for v in targets:
            for u, w in ((a, v), (v, a)):
                db = trio.adj(u)
                link = JaxAdjacency(other_node_name=w, if_name=f"xw-{u}-{w}", metric=2,
                                    other_if_name=f"xw-{w}-{u}")
                trio.set_adj(replace(db, adjacencies=db.adjacencies + (link,)))
        yield "links added"
        for step in range(3):
            _metric(trio, fsw, 0, 3 + step)
            yield f"metric {step}"

    return topos, [], root, events


def _soak(seed, topos, steps=60):
    """The reference soak's mutation stream (``tools/soak_ksp2.py``):
    metric wiggles, overload flips, link pulls and restores, node-label
    changes, drawn from ``random.Random(seed)``."""
    names = sorted(topos[0].adj_dbs)
    root = next((k for k in names if k.startswith("rsw")), names[0])

    def events(trio):
        rng = random.Random(seed)
        pulled = {}
        for step in range(steps):
            node = rng.choice(names)
            db = trio.adj(node)
            r = rng.random()
            if r < 0.5 and db.adjacencies:
                i = rng.randrange(len(db.adjacencies))
                adjs = list(db.adjacencies)
                adjs[i] = replace(adjs[i], metric=1 + rng.randrange(9))
                trio.set_adj(replace(db, adjacencies=tuple(adjs)))
            elif r < 0.7:
                trio.set_adj(replace(db, is_overloaded=not db.is_overloaded))
            elif r < 0.85 and db.adjacencies:
                if node in pulled:
                    trio.set_adj(replace(db, adjacencies=db.adjacencies + (pulled.pop(node),)))
                else:
                    i = rng.randrange(len(db.adjacencies))
                    adjs = list(db.adjacencies)
                    pulled[node] = adjs.pop(i)
                    trio.set_adj(replace(db, adjacencies=tuple(adjs)))
            else:
                trio.set_adj(replace(db, node_label=51000 + rng.randrange(500)))
            yield f"step {step}"

    return topos, [], root, events


SCENARIOS = {
    "metric_cycle": _metric_cycle,
    "random_grid": _random_grid,
    "link_down_up": _link_down_up,
    "transit_overload": _transit_overload,
    "advertiser_drain": _advertiser_drain,
    "label_change": _label_change,
    "undrain_reconnect": _undrain_reconnect,
    "mixed_sp": _mixed_sp,
    "multi_area": _multi_area,
    "lag": _lag,
    "band_widening": _band_widening,
}
# the reference's soak regressions (tests/test_torch_ksp2_engine_soak.py)
SOAKS = {
    "soak_9013": lambda: _soak(9013, _fabric(120)),
    "soak_40018": lambda: _soak(40018, _grid()),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_route_db_parity_through_churn(scenario, fast):
    topos, extra, root, events = SCENARIOS[scenario]()
    trio = Trio(topos, extra, root)
    syncs = port_solver.SPF_COUNTERS["decision.ksp2_incremental_syncs"]
    _drive(trio, events(trio))
    # the engines ran, each on its own resident state
    assert trio.port_solver._ksp2_engines
    if scenario in ("metric_cycle", "lag", "multi_area", "undrain_reconnect"):
        assert port_solver.SPF_COUNTERS["decision.ksp2_incremental_syncs"] > syncs
    for engine in trio.port_solver._ksp2_engines.values():
        assert (engine.masks_t is not None) == fast


def test_band_widening_reseeds_the_engine_on_the_patch_path(monkeypatch):
    monkeypatch.setenv("OPENR_KSP2_FAST", "1")
    topos, extra, root, events = _band_widening()
    trio = Trio(topos, extra, root)
    trio.step("initial build")
    (ls,) = trio.port[0].values()
    bands = trio.port_solver._resident.state_for(ls).graph.bands
    before = dict(port_solver.SPF_COUNTERS)
    it = events(trio)
    trio.step(next(it))
    after = trio.port_solver._resident.state_for(ls).graph.bands
    assert [(x.start, x.rows) for x in after] == [(x.start, x.rows) for x in bands]
    assert any(x.k > y.k for x, y in zip(after, bands))
    assert port_solver.SPF_COUNTERS["decision.ell_full_compiles"] == before[
        "decision.ell_full_compiles"]
    assert port_solver.SPF_COUNTERS["decision.ksp2_cold_builds"] == before[
        "decision.ksp2_cold_builds"] + 1
    (engine,) = trio.port_solver._ksp2_engines.values()
    assert engine.masks_t[0].shape[0] == len(engine.dsts)
    assert tuple(m.shape[1] for m in engine.masks_t) == tuple(
        -(-b.rows * b.k // 32) for b in after)


def test_fast_path_metric_churn_costs_no_masked_dispatch(monkeypatch):
    # steady-state metric churn that keeps the churned link off every
    # first path: the speculative re-solve in the fused dispatch covers
    # it, in both packages (the reference's dispatch-economy test)
    monkeypatch.setenv("OPENR_KSP2_FAST", "1")
    topos = _fabric()
    fsw, rsw = _names(topos, "fsw")[0], _names(topos, "rsw")[0]
    trio = Trio(topos, [], rsw)
    trio.step("initial build")
    for step in range(5):
        _metric(trio, fsw, 0, 2 + step % 5)
        trio.step(step)
    for metric in (4, 5):
        _metric(trio, fsw, 0, metric)
        before = dict(port_solver.SPF_COUNTERS)
        trio.step(metric)
        assert port_solver.SPF_COUNTERS["decision.ksp2_incremental_syncs"] == before[
            "decision.ksp2_incremental_syncs"] + 1
        assert port_solver.SPF_COUNTERS["decision.ksp2_device_batches"] == before[
            "decision.ksp2_device_batches"]
    (engine,) = trio.port_solver._ksp2_engines.values()
    assert engine.last_rows_changed == 0


def test_no_op_rebuild_reuses_every_ksp2_route():
    topos = _fabric()
    trio = Trio(topos, [], _names(topos, "rsw")[0])
    trio.step("initial build")
    before = port_solver.SPF_COUNTERS["decision.ksp2_route_reuses"]
    trio.step("again")
    # every prefix: all advertisers tracked, none affected
    assert port_solver.SPF_COUNTERS["decision.ksp2_route_reuses"] - before == len(
        trio.port[1].prefixes())


def test_prefix_withdrawal_is_not_served_from_the_route_cache():
    topos = _fabric()
    rsws = _names(topos, "rsw")
    trio = Trio(topos, [], rsws[0])
    trio.step("initial build")
    for world in (trio.jax, trio.host, trio.port):
        world[1].delete_prefix_database(rsws[3], topos[0].area)
    trio.step("withdrawn")


# -- engine state, destination by destination --------------------------------


def _engines(trio):
    (jax_engine,) = trio.jax_solver._ksp2_engines.values()
    (port_engine,) = trio.port_solver._ksp2_engines.values()
    return jax_engine, port_engine


def _same_engine_state(jax_engine, port_engine):
    assert port_engine.dsts == jax_engine.dsts
    np.testing.assert_array_equal(port_engine.d_base, jax_engine.d_base)
    np.testing.assert_array_equal(port_engine.dm, np.asarray(jax_engine.dm))
    for attr in ("first_paths", "second_paths"):
        assert carry.paths_to_keys(getattr(port_engine, attr)) == carry.paths_to_keys(
            getattr(jax_engine, attr)), attr
    assert port_engine.host_dsts == jax_engine.host_dsts
    assert port_engine.node_users == jax_engine.node_users
    assert port_engine.eff_w == jax_engine.eff_w
    assert port_engine.attr_sig == jax_engine.attr_sig
    n = port_engine.state.graph.n_pad
    np.testing.assert_array_equal(port_engine.d_prev_dev.numpy()[:n],
                                  np.asarray(jax_engine.d_prev_dev)[:n])


def test_affected_sets_and_cached_paths_match_reference(fast):
    # a few changes, each: the pair diff, the distance test's affected
    # sets on the same distance rows, the sync's affected set, and every
    # destination's cached first and second paths
    topos = _fabric()
    fsws, rsws = _names(topos, "fsw"), _names(topos, "rsw")
    trio = Trio(topos, [], rsws[0])
    trio.step("initial build")
    _same_engine_state(*_engines(trio))
    changes = [
        lambda: _metric(trio, fsws[3], 0, 7),
        lambda: _metric(trio, rsws[-5], 1, 5),
        lambda: _overload(trio, fsws[5], True),
        lambda: _label(trio, fsws[6], 61000),
    ]
    for change in changes:
        jax_engine, port_engine = _engines(trio)
        change()
        (jax_ls,) = trio.jax[0].values()
        (port_ls,) = trio.port[0].values()
        nodes = set(port_ls.affected_since(port_engine.version)) | set(
            port_ls.attr_affected_since(port_engine.aversion))
        assert nodes == set(jax_ls.affected_since(jax_engine.version)) | set(
            jax_ls.attr_affected_since(jax_engine.aversion))
        changed = port_engine._diff_pairs(port_ls, nodes)
        assert changed == jax_engine._diff_pairs(jax_ls, nodes)
        # the same rows for both: all-sources distances of the new graph
        # and the engine's resident matrix of the old one
        state = trio.port_solver._resident.state_for(port_ls)
        graph = state.graph
        d_new = port_sparse.ell_distances_from_sources(
            graph, np.arange(graph.n_pad), state=state).numpy()
        d_old = port_engine.d_prev_dev.numpy()
        ep = {graph.node_index[x] for pair in changed for x in pair}
        rows_new = {i: d_new[i] for i in ep}
        rows_old = {i: d_old[i] for i in ep}
        d_src = d_new[port_engine.sid].astype(np.int64)
        jax_graph = jax_solver._ELL_RESIDENT.state_for(jax_ls).graph
        assert jax_graph.node_names == graph.node_names
        got = port_engine._affected_dsts(port_ls, graph, changed, d_src, rows_new, rows_old)
        want = jax_engine._affected_dsts(jax_ls, jax_graph, changed, d_src, rows_new, rows_old)
        assert got == want
        trio.step("change")
        assert port_engine.last_affected == jax_engine.last_affected
        _same_engine_state(jax_engine, port_engine)


# -- the pieces: all-sources fixed point and the fused dispatches ------------


def _pair(topos=None):
    """(JAX LinkState, port LinkState, JAX graph, port graph) of one
    fabric, both compiled from the same databases."""
    topos = topos or [jax_topologies.fat_tree(3, ssw_per_plane=2, rsw_per_pod=3, **KSP2)]
    trio = Trio(topos, [], "rsw-0-0")
    (jax_ls,) = trio.host[0].values()
    (port_ls,) = trio.port[0].values()
    return trio, jax_ls, port_ls, jax_sparse.compile_ell(jax_ls), port_sparse.compile_ell(port_ls)


def _jax_bands(graph):
    return (tuple(map(jnp.asarray, graph.src)), tuple(map(jnp.asarray, graph.w)),
            jnp.asarray(graph.overloaded))


def _port_bands(graph):
    return (tuple(map(torch.from_numpy, graph.src)), tuple(map(torch.from_numpy, graph.w)),
            torch.from_numpy(graph.overloaded))


def _churned(trio, jax_ls, port_ls, jax_graph, port_graph):
    """A metric increase, a link down and a drain: the patched graphs and
    the port's increase-edge delta against the old ones."""
    version = port_ls.topology_version
    _metric(trio, "fsw-1-0", 0, 9)
    db = trio.adj("fsw-2-1")
    trio.set_adj(replace(db, adjacencies=db.adjacencies[1:]))
    _overload(trio, "ssw-0-0", True)
    affected = sorted(port_ls.affected_since(version))
    new_port = port_sparse.ell_patch(port_graph, port_ls, affected, widen=True)
    new_jax = jax_sparse.ell_patch(jax_graph, jax_ls, affected, widen=True)
    inc = port_sparse.band_row_edge_delta(port_graph, new_port)
    # the drained node's out-edges read as increases of their raw weights
    drained = port_graph.node_index["ssw-0-0"]
    for bi, (src, w) in enumerate(zip(port_graph.src, port_graph.w)):
        for r, slot in zip(*np.nonzero((src == drained) & (w < port_sparse.INF))):
            inc.append((drained, port_graph.bands[bi].start + int(r), int(w[r, slot])))
    return new_jax, new_port, inc


def test_all_sources_fixed_point_matches_reference_warm_and_cold():
    trio, jax_ls, port_ls, jax_graph, port_graph = _pair()
    n = port_graph.n_pad
    ids = np.arange(n, dtype=np.int32)
    cold, hops = port_sparse._ell_fixed_point(
        *_port_bands(port_graph), torch.from_numpy(ids), port_graph.bands, n)
    want = np.asarray(jax_sparse._ell_fixed_point(
        *_jax_bands(jax_graph), jnp.asarray(ids), jax_graph.bands, n))
    np.testing.assert_array_equal(cold.numpy(), want)
    assert 1 <= hops < n
    np.testing.assert_array_equal(
        port_sparse.ell_distances_from_sources(port_graph, ids, device="cpu").numpy(), want)
    new_jax, new_port, inc = _churned(trio, jax_ls, port_ls, jax_graph, port_graph)
    inc_t, inc_h, inc_w = map(torch.from_numpy, port_sparse.pad_increase_edges(inc))
    warm, warm_hops = port_sparse._ell_fixed_point(
        *_port_bands(new_port), torch.from_numpy(ids), new_port.bands, n,
        warm=(cold, inc_t, inc_h, inc_w))
    fresh, fresh_hops = port_sparse._ell_fixed_point(
        *_port_bands(new_port), torch.from_numpy(ids), new_port.bands, n)
    want = np.asarray(jax_sparse._ell_fixed_point(
        *_jax_bands(new_jax), jnp.asarray(ids), new_jax.bands, n,
        warm=(jnp.asarray(cold.numpy()), *map(jnp.asarray, (inc_t.numpy(), inc_h.numpy(),
                                                            inc_w.numpy())))))
    np.testing.assert_array_equal(warm.numpy(), fresh.numpy())
    np.testing.assert_array_equal(warm.numpy(), want)
    assert warm_hops <= fresh_hops
    state = port_sparse.EllState(new_port, "cpu")
    np.testing.assert_array_equal(
        port_sparse.ell_distances_from_sources(new_port, ids, state=state).numpy(), want)


def _view_inputs(graph, ls):
    view_srcs = port_sparse.ell_source_batch(graph, ls, "rsw-0-0")
    srcs, w_sv = port_sparse._batch_host_args(graph, view_srcs)
    ep = sorted({graph.node_index[x] for x in ("fsw-1-0", "rsw-1-0", "ssw-0-0")})
    return srcs, w_sv, port_ksp2._pad_ids(ep)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_ell_all_view_rows_matches_reference(warm):
    trio, jax_ls, port_ls, jax_graph, port_graph = _pair()
    n = port_graph.n_pad
    d_prev = port_sparse.ell_distances_from_sources(
        port_graph, np.arange(n), device="cpu").numpy()
    inc = None
    if warm:
        jax_graph, port_graph, inc = _churned(trio, jax_ls, port_ls, jax_graph, port_graph)
    srcs, w_sv, ep = _view_inputs(port_graph, port_ls)
    state = port_sparse.EllState(port_graph, "cpu")
    d_all, back, hops = port_sparse.ell_all_view_rows(
        state, srcs, w_sv, ep, torch.from_numpy(d_prev), inc=inc)
    assert isinstance(back, Readback)
    packed = back.reap()
    want_all, want = jax_sparse.ell_all_view_rows(
        jax_sparse.EllState(jax_graph), srcs, w_sv, ep, jnp.asarray(d_prev), inc=inc)
    np.testing.assert_array_equal(d_all.numpy(), np.asarray(want_all))
    np.testing.assert_array_equal(packed, np.asarray(want))
    assert packed.shape == (2 * len(srcs) + 2 * len(ep), n) and hops >= 1


@pytest.mark.parametrize("moved", [0, 3, 64, 70], ids=["none", "below", "at", "above"])
def test_ell_all_view_rows_masked_matches_reference(moved):
    # the speculative masked re-solve's row diff against dm_old with 0, 3,
    # 64 (the engine's row budget) and 70 moved rows of the 111
    # destinations of a 112-node fabric: the whole packed buffer, meta row
    # (first ids, count) included
    k_budget = port_ksp2.ENGINE_ROW_BUDGET
    assert k_budget == jax_ksp2.ENGINE_ROW_BUDGET == 64
    trio, jax_ls, port_ls, jax_graph, port_graph = _pair(_fabric(120))
    n = port_graph.n_pad
    root = "rsw-0-0"
    d_prev = port_sparse.ell_distances_from_sources(
        port_graph, np.arange(n), device="cpu").numpy()
    jax_graph, port_graph, inc = _churned(trio, jax_ls, port_ls, jax_graph, port_graph)
    dsts = [x for x in sorted(port_ls.get_adjacency_databases()) if x != root]
    excl_port = [{l for p in port_ls.get_kth_paths(root, d, 1) for l in p} for d in dsts]
    excl_jax = [{l for p in jax_ls.get_kth_paths(root, d, 1) for l in p} for d in dsts]
    masks_p, _ = port_sparse.build_edge_masks(port_graph, excl_port)
    masks_j, _ = jax_sparse.build_edge_masks(jax_graph, excl_jax)
    sid = port_graph.node_index[root]
    dm_true, _ = port_sparse._ell_masked_fixed_point(
        *_port_bands(port_graph)[:2], tuple(map(torch.from_numpy, masks_p)),
        torch.from_numpy(port_graph.overloaded), sid, port_graph.bands, n)
    dm_old = dm_true.numpy().copy()
    rng = np.random.default_rng(moved)
    rows = rng.choice(len(dsts), size=moved, replace=False)
    dm_old[rows, rng.integers(0, n, size=moved)] ^= 1
    srcs, w_sv, ep = _view_inputs(port_graph, port_ls)
    state = port_sparse.EllState(port_graph, "cpu")
    d_all, dm_new, back, _ = port_sparse.ell_all_view_rows_masked(
        state, srcs, w_sv, ep, torch.from_numpy(d_prev), tuple(map(torch.from_numpy, masks_p)),
        torch.from_numpy(dm_old), sid, k_budget, inc=inc)
    packed = back.reap()
    want_all, want_dm, want = jax_sparse.ell_all_view_rows_masked(
        jax_sparse.EllState(jax_graph), srcs, w_sv, ep, jnp.asarray(d_prev),
        tuple(map(jnp.asarray, masks_j)), jnp.asarray(dm_old), sid, k_budget, inc=inc)
    np.testing.assert_array_equal(d_all.numpy(), np.asarray(want_all))
    np.testing.assert_array_equal(dm_new.numpy(), np.asarray(want_dm))
    np.testing.assert_array_equal(dm_new.numpy(), dm_true.numpy())
    np.testing.assert_array_equal(packed, np.asarray(want))
    meta = packed[2 * len(srcs) + 2 * len(ep)]
    assert meta[k_budget] == moved
    assert list(meta[: min(moved, k_budget)]) == sorted(rows)[:k_budget]
    assert (meta[min(moved, k_budget) : k_budget] == -1).all()
    # the port's packed masks are the reference's bool masks, bit-packed
    for m_p, m_j in zip(masks_p, masks_j):
        np.testing.assert_array_equal(pack_edge_mask(torch.from_numpy(m_j)).numpy(), m_p)


# -- the engine's helpers and its solver hooks ---------------------------------


def test_helpers_match_reference(monkeypatch):
    for ids in ([5], [3, 1, 4, 1, 5, 9, 2, 6], [7] * 9, list(range(20))):
        np.testing.assert_array_equal(port_ksp2._pad_ids(ids), jax_ksp2._pad_ids(ids))
    for name in ("ENGINE_MAX_NODES", "ENGINE_MAX_CHANGED_PAIRS", "ENGINE_MAX_ENDPOINTS",
                 "ENGINE_FULL_REBUILD_FRACTION", "ENGINE_ROW_BUDGET"):
        assert getattr(port_ksp2, name) == getattr(jax_ksp2, name), name
    assert port_ksp2.engine_max_nodes() == jax_ksp2.engine_max_nodes()
    _, jax_ls, port_ls, _, _ = _pair()
    for dst in ("rsw-2-2", "ssw-1-1"):
        (jax_path, *_), (port_path, *_) = (jax_ls.get_kth_paths("rsw-0-0", dst, 1),
                                           port_ls.get_kth_paths("rsw-0-0", dst, 1))
        assert port_ksp2._path_nodes("rsw-0-0", port_path) == jax_ksp2._path_nodes(
            "rsw-0-0", jax_path)
    monkeypatch.delenv("OPENR_KSP2_FAST", raising=False)
    assert not port_ksp2._fast_path_enabled(torch.device("cpu"))
    assert port_ksp2._fast_path_enabled(torch.device("cuda", 0))
    for value, on in (("1", True), ("0", False)):
        monkeypatch.setenv("OPENR_KSP2_FAST", value)
        assert port_ksp2._fast_path_enabled(torch.device("cpu")) is on
        assert port_ksp2._fast_path_enabled(torch.device("cuda", 0)) is on
        assert jax_ksp2._fast_path_enabled() is on


def test_engine_view_is_preloaded_and_consumed_once():
    trio, _, port_ls, _, _ = _pair()
    solver = trio.port_solver
    root = trio.root
    solver._prefetch_ksp2_paths(root, *trio.port)
    resident = solver._resident
    assert resident.has_preloaded(port_ls, root)
    assert not resident.has_preloaded(port_ls, "rsw-1-0")
    # the view takes the sparse path, consuming the preload: no solve
    view = solver._view("0", port_ls, root)
    assert isinstance(view._snap, port_solver._SparseIndexAdapter)
    assert not resident.has_preloaded(port_ls, root)
    host = port_ls.get_spf_result(root)
    for node, res in host.items():
        assert view.metric_to(node) == res.metric
        assert view.next_hops_toward(node) == set(res.next_hops)
    # a preloaded view of an older version is never handed out
    resident.preload_view(port_ls, *resident.view_packed(port_ls, root))
    _metric(trio, "fsw-1-0", 0, 6)
    assert not resident.has_preloaded(port_ls, root)


def test_reset_and_backend_switch_drop_the_engines():
    trio, _, port_ls, _, _ = _pair()
    solver = trio.port_solver
    trio.step("initial build")
    assert solver._ksp2_engines and solver._ksp2_tracked
    for s in (solver, trio.jax_solver):
        s.reset_device_state()
    assert not solver._ksp2_engines and not solver._ksp2_tracked
    assert not solver._resident.has_preloaded(port_ls, trio.root)
    trio.step("after a reset")
    assert solver._ksp2_engines
    for s in (solver, trio.jax_solver):
        s.set_backend("host")
    assert not solver._ksp2_engines
    for s in (solver, trio.jax_solver):
        s.set_backend("device")
    before = port_solver.SPF_COUNTERS["decision.ksp2_cold_builds"]
    trio.step("after a backend switch")
    assert port_solver.SPF_COUNTERS["decision.ksp2_cold_builds"] == before + 1


def test_readback_copies_on_the_cpu():
    t = torch.arange(12, dtype=torch.int32).view(3, 4)
    back = Readback(t)
    t.zero_()
    np.testing.assert_array_equal(back.reap(), np.arange(12).reshape(3, 4))
    assert back.tensor is t
