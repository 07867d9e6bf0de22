"""KSP2_ED_ECMP route builds of the PyTorch port against the JAX package.

The same databases (made with the JAX package's topology generators and
handed to the port through ``openr_tpu_torch.carry``) go through
``openr_tpu``'s device and host solvers and the port's device and host
solvers, each on its own ``LinkState``; the host solvers are the
independent oracles. The kth-path cache lives on the ``LinkState``, so
no two solvers share one: a shared cache would hand the device's primed
second paths to the oracle. Route databases must be equal, exactly,
after every event of a churn sequence. The JAX device solver runs in
both of its KSP2 modes: its incremental engine (the default at these
sizes) and its per-build chunked masked dispatch
(``ksp2_engine.ENGINE_MAX_NODES`` set to 0 for the test), and so does the
port's, the two packages in the same mode. The port must equal the JAX
host backend after every event, and the JAX device solver after every
event outside ``ENGINE_FAULTS``, which names the one event where the
reference engine disagrees with its own package's host backend; the port's
engine does not. The KSP2 counters must match too: under the chunked mode
over the whole run, under the engine mode event by event (outside
``ENGINE_FAULTS``). Both packages' ``KSP2_DEVICE_MIN_DSTS`` are set to 1
so that small graphs take the device path.

The pieces are held against the reference one by one as well: the masked
fixed point, ``build_edge_masks`` band by band (per-link slots and the
collapsed-graph branch; the port's masks are bit-packed, and
``unpack_edge_mask`` of them must equal the reference's bool masks) and
``trace_paths_from_row``. Everything is int32
or exact path lists: no tolerance applies.
"""

from __future__ import annotations

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
from openr_tpu_torch.ops.ell_relax import mask_words, pack_edge_mask, unpack_edge_mask

KSP2 = dict(
    forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP,
    forwarding_type=JaxFwdType.SR_MPLS,
)
COUNTERS = ("decision.ksp2_device_batches", "decision.ksp2_host_fallbacks")
# the incremental engine's counters besides those
ENGINE_COUNTERS = COUNTERS + (
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


# -- networks held by both packages ------------------------------------------


def _border_adj(node, other, metric=1):
    return JaxAdjacency(
        other_node_name=other,
        if_name=f"if_{node}_{other}",
        other_if_name=f"if_{other}_{node}",
        metric=metric,
    )


def _network(kind):
    """(JAX topologies, extra JAX adjacency databases, root)."""
    if kind == "fat_tree":
        return [jax_topologies.fat_tree(3, ssw_per_plane=2, rsw_per_pod=3, **KSP2)], [], "rsw-0-0"
    if kind == "grid":
        return [jax_topologies.grid(4, metric=2, **KSP2)], [], "node-5"
    if kind in ("lag_equal", "lag_unequal"):
        # 2-tier leaf/spine; every leaf-spine pair is a 2-member LAG
        metric2 = 1 if kind == "lag_equal" else 2
        edges = []
        for leaf in range(4):
            for spine in range(2):
                edges.append((f"leaf-{leaf}", f"spine-{spine}", 1))
                edges.append((f"leaf-{leaf}", f"spine-{spine}", metric2))
        return [jax_topologies.build_topology("lag", edges, **KSP2)], [], "leaf-0"
    if kind == "two_area":
        # a grid in area "a" and a fabric in area "b"; the root node-0 is
        # in both, linked into area b through one rack switch
        grid = jax_topologies.grid(3, area="a", **KSP2)
        fabric = jax_topologies.fat_tree(2, ssw_per_plane=2, rsw_per_pod=3, area="b", **KSP2)
        rsw = "rsw-0-0"
        rsw_db = fabric.adj_dbs[rsw]
        extra = [
            JaxAdjacencyDatabase(
                this_node_name="node-0",
                adjacencies=(_border_adj("node-0", rsw),),
                node_label=9000,
                area="b",
            ),
            replace(rsw_db, adjacencies=rsw_db.adjacencies + (_border_adj(rsw, "node-0"),)),
        ]
        return [grid, fabric], extra, "node-0"
    raise ValueError(kind)


class World:
    """One (possibly multi-area) network on one package's own LinkStates:
    ``jax`` holds JAX objects; otherwise the port's, fed by ``carry``."""

    def __init__(self, topos, extra, jax: bool):
        self.jax = jax
        self.areas = {
            t.area: (JaxLinkState if jax else LinkState)(area=t.area) for t in topos
        }
        self.ps = JaxPrefixState() if jax else PrefixState()
        for topo in topos:
            for name in sorted(topo.adj_dbs):
                self.set_adj(topo.adj_dbs[name])
        for db in extra:
            self.set_adj(db)
        for topo in topos:
            for name in sorted(topo.prefix_dbs):
                db = topo.prefix_dbs[name]
                if not jax:
                    _, (db,) = carry.lsdb_from_plain([], [carry.to_plain(db)])
                self.ps.update_prefix_database(db)

    def set_adj(self, jax_db) -> None:
        db = jax_db
        if not self.jax:
            (db,), _ = carry.lsdb_from_plain([carry.to_plain(jax_db)], [])
        self.areas[jax_db.area].update_adjacency_database(db)


class Twin:
    """The JAX device world, the JAX host world, the port's device world
    and the port's host-oracle world: every event goes to all four."""

    def __init__(self, kind):
        topos, extra, self.root = _network(kind)
        self.jax = World(topos, extra, jax=True)
        self.jax_host = World(topos, extra, jax=True)
        self.dev = World(topos, extra, jax=False)
        self.host = World(topos, extra, jax=False)

    def adj(self, area, node):
        return self.jax.areas[area].get_adjacency_databases()[node]

    def set_adj(self, jax_db) -> None:
        for world in (self.jax, self.jax_host, self.dev, self.host):
            world.set_adj(jax_db)


def _set_metric(twin, area, node, i, metric):
    db = twin.adj(area, node)
    adjs = list(db.adjacencies)
    adjs[i] = replace(adjs[i], metric=metric)
    twin.set_adj(replace(db, adjacencies=tuple(adjs)))


def _events(twin):
    """Churn in every area: metric bumps (one on a LAG member where there
    is one), the root's first link down and up, a transit node's overload
    on and off, and a drained advertiser (a leaf overloaded); then the
    root drains."""
    for area, jls in sorted(twin.jax.areas.items()):
        dbs = jls.get_adjacency_databases()
        nodes = sorted(n for n in dbs if n != twin.root)
        degree = {n: len(dbs[n].adjacencies) for n in nodes}
        transit = max(nodes, key=lambda n: (degree[n], n))
        leaf = min(nodes, key=lambda n: (degree[n], n))
        _set_metric(twin, area, transit, 0, 3)
        yield f"{area}: metric {transit}"
        _set_metric(twin, area, transit, len(dbs[transit].adjacencies) - 1, 4)
        yield f"{area}: metric on {transit}'s last adjacency"
        if twin.root in dbs:
            root_db = twin.adj(area, twin.root)
            twin.set_adj(replace(root_db, adjacencies=root_db.adjacencies[1:]))
            yield f"{area}: root link down"
            twin.set_adj(root_db)
            yield f"{area}: root link up"
        twin.set_adj(replace(twin.adj(area, transit), is_overloaded=True))
        yield f"{area}: {transit} overloaded"
        twin.set_adj(replace(twin.adj(area, transit), is_overloaded=False))
        yield f"{area}: {transit} back"
        twin.set_adj(replace(twin.adj(area, leaf), is_overloaded=True))
        yield f"{area}: advertiser {leaf} drained"
    # last, the root itself drains: it still originates its paths
    for area in sorted(twin.jax.areas):
        if twin.root in twin.jax.areas[area].get_adjacency_databases():
            twin.set_adj(replace(twin.adj(area, twin.root), is_overloaded=True))
            yield f"{area}: root drained"


def _plain(route_db, root):
    return carry.route_db_to_plain(route_db.to_route_db(root))


def _counts(counters, names=COUNTERS):
    return tuple(int(counters[name]) for name in names)


# Where openr_tpu's incremental KSP2 engine disagrees with openr_tpu's own
# host backend (a fault of the reference, not of the port): after the root
# drains in area "a" of the two-area network, the engine's route reuse keeps
# the absent route of fd00::/128, which the root and fsw-0-0 (area "b")
# both advertise; the host backend and the chunked dispatch route it through
# area "b". The root's drain cold-builds area "a"'s engine, whose affected
# set (all its destinations) never holds the root, so the root-advertised
# prefix passes the reuse gate. The port's engine path puts the root into
# the affected set when its overload bit flips: there the port is held
# against the host backend, and the reference engine's divergence is
# asserted, so a fix of the reference shows here.
ENGINE_FAULTS = {("two_area", "a: root drained")}


def _set_modes(mode, monkeypatch):
    if mode == "chunked":
        monkeypatch.setattr(jax_ksp2, "ENGINE_MAX_NODES", 0)
        monkeypatch.setattr(port_ksp2, "ENGINE_MAX_NODES", 0)


@pytest.mark.parametrize("mode", ["engine", "chunked"])
@pytest.mark.parametrize("kind", ["fat_tree", "grid", "lag_equal", "lag_unequal", "two_area"])
def test_ksp2_route_db_parity_through_churn(kind, mode, monkeypatch):
    _set_modes(mode, monkeypatch)
    twin = Twin(kind)
    root = twin.root
    jax_dev = jax_solver.SpfSolver(root, backend="device")
    jax_host = jax_solver.SpfSolver(root, backend="host")
    port_dev = port_solver.SpfSolver(root, backend="device", device="cpu")
    port_host = port_solver.SpfSolver(root, backend="host", device="cpu")
    jax_before = _counts(jax_solver.SPF_COUNTERS)
    port_before = _counts(port_solver.SPF_COUNTERS)
    ksp2_routes = 0
    faults = set()

    def compare(event):
        nonlocal ksp2_routes
        jax_c = _counts(jax_solver.SPF_COUNTERS, ENGINE_COUNTERS)
        port_c = _counts(port_solver.SPF_COUNTERS, ENGINE_COUNTERS)
        want = _plain(jax_dev.build_route_db(root, twin.jax.areas, twin.jax.ps), root)
        want_host = _plain(
            jax_host.build_route_db(root, twin.jax_host.areas, twin.jax_host.ps), root
        )
        got = _plain(port_dev.build_route_db(root, twin.dev.areas, twin.dev.ps), root)
        oracle = _plain(port_host.build_route_db(root, twin.host.areas, twin.host.ps), root)
        assert got == want_host, f"{kind}/{mode}: port device != openr_tpu host after {event}"
        assert oracle == want_host, f"{kind}/{mode}: port host != openr_tpu host after {event}"
        jax_d = [a - b for a, b in zip(_counts(jax_solver.SPF_COUNTERS, ENGINE_COUNTERS), jax_c)]
        port_d = [a - b for a, b in zip(_counts(port_solver.SPF_COUNTERS, ENGINE_COUNTERS), port_c)]
        if want != want_host:
            faults.add((kind, event))
        else:
            assert got == want, f"{kind}/{mode}: port device != openr_tpu after {event}"
        if mode == "engine" and event.endswith("root drained"):
            # the port re-derives the root's prefixes, which the reference
            # reuses across the root's drain
            assert port_d[:-1] == jax_d[:-1], f"{kind}: KSP2 counters after {event}"
            assert port_d[-1] <= jax_d[-1] - ((kind, event) in ENGINE_FAULTS), event
        elif mode == "engine":
            assert port_d == jax_d, f"{kind}: KSP2 counters after {event}"
        ksp2_routes += len(got[1])

    compare("initial build")
    events = 1
    for event in _events(twin):
        compare(event)
        events += 1
    assert ksp2_routes > 0
    # the chunked dispatch always agrees with the host backend
    assert faults == ({f for f in ENGINE_FAULTS if f[0] == kind} if mode == "engine" else set())
    port_delta = tuple(
        a - b for a, b in zip(_counts(port_solver.SPF_COUNTERS), port_before)
    )
    if mode == "chunked":
        # one masked batch per area and build, no destination left to the host
        assert port_delta == (events * len(twin.dev.areas), 0)
        jax_delta = tuple(
            a - b for a, b in zip(_counts(jax_solver.SPF_COUNTERS), jax_before)
        )
        assert port_delta == jax_delta


def test_ksp2_engine_fault_is_not_reproduced():
    # two_area, the root drained in area "a": the reference engine keeps
    # the absent route of fd00::/128; the port's engine gives the host
    # backend's route through area "b"
    twin = Twin("two_area")
    root = twin.root
    jax_dev = jax_solver.SpfSolver(root, backend="device")
    jax_host = jax_solver.SpfSolver(root, backend="host")
    port_dev = port_solver.SpfSolver(root, backend="device", device="cpu")

    def builds():
        return (
            port_dev.build_route_db(root, twin.dev.areas, twin.dev.ps),
            jax_dev.build_route_db(root, twin.jax.areas, twin.jax.ps),
            jax_host.build_route_db(root, twin.jax_host.areas, twin.jax_host.ps),
        )

    def route(route_db, prefix):
        hits = [r for r in route_db.to_route_db(root).unicast_routes
                if r.dest.to_str() == prefix]
        return carry.route_db_to_plain(
            replace(route_db.to_route_db(root), unicast_routes=hits, mpls_routes=[]))[1]

    builds()
    for event in _events(twin):
        got, want, want_host = builds()
        if event == "a: root drained":
            break
    assert _plain(got, root) == _plain(want_host, root) != _plain(want, root)
    assert len(route(got, "fd00::/128")) == 1
    assert route(got, "fd00::/128") == route(want_host, "fd00::/128")
    assert route(want, "fd00::/128") == ()
    assert ("two_area", event) in ENGINE_FAULTS


def _second_paths_from_the_device_batch(mode, monkeypatch):
    _set_modes(mode, monkeypatch)
    twin = Twin("fat_tree")
    root = twin.root
    port_dev = port_solver.SpfSolver(root, backend="device", device="cpu")
    port_dev.build_route_db(root, twin.dev.areas, twin.dev.ps)
    (ls,) = twin.dev.areas.values()
    dsts = [n for n in ls.get_adjacency_databases() if n != root]
    assert all((root, dst, 2) in ls._kth_path_cache for dst in dsts)
    stats = port_dev.ksp2_stats
    assert stats["dsts"] == len(dsts) and stats["chunks"] == 1
    # one chunk's packed masks: a bit a slot and destination row; the
    # chunked dispatch pads the chunk to _ksp2_chunk rows, the engine to
    # the power of two at or above the destinations (at least 8)
    graph = port_sparse.compile_ell(ls)
    rows = port_solver._ksp2_chunk(graph)
    if mode == "engine":
        rows = min(rows, 1 << max(3, (len(dsts) - 1).bit_length()))
    assert stats["mask_bytes"] == 4 * rows * sum(mask_words(b.rows, b.k) for b in graph.bands)
    for key in ("hop_gate_ms", "graph_ms", "first_paths_ms", "masks_ms", "solve_ms",
                "second_paths_ms"):
        assert stats[key] >= 0
    return port_dev, stats


def test_ksp2_second_paths_come_from_the_device_batch(monkeypatch):
    # the device solver primes every destination's second paths before
    # the prefix loop; the host solver leaves them to get_kth_paths. The
    # first build cold-builds the area's engine
    _port_dev, stats = _second_paths_from_the_device_batch("engine", monkeypatch)
    assert stats["cold"] == 1
    for key in ("dispatch_ms", "prime_ms", "snapshot_ms"):
        assert stats[key] >= 0
    twin = Twin("fat_tree")
    root = twin.root
    port_host = port_solver.SpfSolver(root, backend="host", device="cpu")
    port_host.build_route_db(root, twin.host.areas, twin.host.ps)
    assert port_host.ksp2_stats == {}


def test_ksp2_chunked_dispatch_solves_one_chunk(monkeypatch):
    port_dev, stats = _second_paths_from_the_device_batch("chunked", monkeypatch)
    assert "cold" not in stats and not port_dev._ksp2_engines


def test_ksp2_engine_stats_split_an_incremental_sync(monkeypatch):
    # a metric bump far from the root: the engine syncs incrementally and
    # splits the sync into its host-clock parts
    twin = Twin("fat_tree")
    root = twin.root
    port_dev = port_solver.SpfSolver(root, backend="device", device="cpu")
    port_dev.build_route_db(root, twin.dev.areas, twin.dev.ps)
    before = _counts(port_solver.SPF_COUNTERS, ENGINE_COUNTERS)
    _set_metric(twin, "0", "rsw-2-2", 0, 3)
    port_dev.build_route_db(root, twin.dev.areas, twin.dev.ps)
    delta = dict(zip(ENGINE_COUNTERS, (
        a - b for a, b in zip(_counts(port_solver.SPF_COUNTERS, ENGINE_COUNTERS), before))))
    assert delta["decision.ksp2_incremental_syncs"] == 1
    assert delta["decision.ksp2_cold_builds"] == 0
    stats = port_dev.ksp2_stats
    assert stats["cold"] == 0 and "hop_gate_ms" not in stats
    assert stats["affected"] == delta["decision.ksp2_affected_dsts"]
    for key in ("graph_ms", "diff_ms", "dispatch_ms", "affected_ms", "prime_ms"):
        assert stats[key] >= 0


def test_ksp2_below_min_dsts_stays_on_the_host(monkeypatch):
    monkeypatch.setattr(port_solver, "KSP2_DEVICE_MIN_DSTS", 10_000)
    monkeypatch.setattr(jax_solver, "KSP2_DEVICE_MIN_DSTS", 10_000)
    twin = Twin("grid")
    root = twin.root
    before = _counts(port_solver.SPF_COUNTERS)
    got = port_solver.SpfSolver(root, backend="device", device="cpu").build_route_db(
        root, twin.dev.areas, twin.dev.ps
    )
    want = jax_solver.SpfSolver(root, backend="device").build_route_db(
        root, twin.jax.areas, twin.jax.ps
    )
    assert _plain(got, root) == _plain(want, root)
    assert _counts(port_solver.SPF_COUNTERS) == before


@pytest.mark.parametrize("mode", ["engine", "chunked"])
def test_ksp2_high_diameter_area_stays_on_the_host(mode, monkeypatch):
    # a 10 x 10 grid's corner is 18 hops from the far corner: past
    # KSP2_DEVICE_MAX_HOPS, so both packages leave the area to the host
    _set_modes(mode, monkeypatch)
    topo = jax_topologies.grid(10, **KSP2)
    jax_world = World([topo], [], jax=True)
    port_world = World([topo], [], jax=False)
    before = _counts(port_solver.SPF_COUNTERS)
    jax_before = _counts(jax_solver.SPF_COUNTERS)
    got = port_solver.SpfSolver("node-0", backend="device", device="cpu").build_route_db(
        "node-0", port_world.areas, port_world.ps
    )
    want = jax_solver.SpfSolver("node-0", backend="device").build_route_db(
        "node-0", jax_world.areas, jax_world.ps
    )
    assert _plain(got, "node-0") == _plain(want, "node-0")
    assert _counts(port_solver.SPF_COUNTERS) == before
    assert _counts(jax_solver.SPF_COUNTERS) == jax_before


def test_ksp2_without_sr_mpls_gives_no_route():
    # KSP2 needs SR-MPLS tunnels: with IP forwarding the prefix gets no
    # route in either package (reference Decision.cpp:908)
    topo = jax_topologies.build_topology(
        "sq", [("a", "b", 1), ("b", "d", 1), ("a", "c", 2), ("c", "d", 2)],
        forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP, forwarding_type=JaxFwdType.IP,
    )
    jax_world = World([topo], [], jax=True)
    port_world = World([topo], [], jax=False)
    got = port_solver.SpfSolver("a", backend="device", device="cpu").build_route_db(
        "a", port_world.areas, port_world.ps
    )
    want = jax_solver.SpfSolver("a", backend="device").build_route_db(
        "a", jax_world.areas, jax_world.ps
    )
    assert _plain(got, "a") == _plain(want, "a")
    assert not got.unicast_routes
    assert got.mpls_routes  # node-label routes are still built


# -- the pieces, one by one -----------------------------------------------------


def _graphs(kind):
    """(JAX LinkState, port LinkState, JAX in-edge graph, port in-edge
    graph, root) of one single-area network."""
    topos, extra, root = _network(kind)
    jax_ls = next(iter(World(topos, extra, jax=True).areas.values()))
    port_ls = next(iter(World(topos, extra, jax=False).areas.values()))
    return jax_ls, port_ls, jax_sparse.compile_ell(jax_ls), port_sparse.compile_ell(port_ls), root


def _keys(links):
    return sorted(port_sparse.link_key(link) for link in links)


def _first_path_links(ls, root):
    out = []
    for dst in sorted(ls.get_adjacency_databases()):
        links = set()
        for path in ls.get_kth_paths(root, dst, 1):
            links.update(path)
        out.append(links)
    return out


def _same_graph(jax_graph, port_graph):
    assert port_graph.node_names == jax_graph.node_names
    assert [(b.start, b.rows, b.k) for b in port_graph.bands] == [
        (b.start, b.rows, b.k) for b in jax_graph.bands
    ]


@pytest.mark.parametrize("kind", ["fat_tree", "grid", "lag_unequal"])
def test_build_edge_masks_matches_reference_band_by_band(kind):
    jax_ls, port_ls, jax_graph, port_graph, root = _graphs(kind)
    _same_graph(jax_graph, port_graph)
    jax_excl = _first_path_links(jax_ls, root)
    port_excl = _first_path_links(port_ls, root)
    assert [_keys(x) for x in port_excl] == [_keys(x) for x in jax_excl]
    # random link sets of the JAX graph, handed across as link keys
    rng = np.random.default_rng(len(kind))
    all_links = sorted(jax_ls.all_links(), key=port_sparse.link_key)
    random_sets = [
        {all_links[i] for i in rng.choice(len(all_links), size=size, replace=False)}
        for size in (1, 3, len(all_links) // 2, len(all_links))
    ]
    jax_excl += random_sets
    port_excl += carry.links_from_keys(port_ls, [_keys(x) for x in random_sets])
    # an empty set and a link to a node outside the graph (ok=False)
    other_topo = jax_topologies.build_topology("o", [("x", "y", 1)])
    outside = [next(iter(World([other_topo], [], jax=j).areas.values())).all_links() for j in (True, False)]
    jax_excl += [set(), set(outside[0])]
    port_excl += [set(), set(outside[1])]
    jax_masks, jax_ok = jax_sparse.build_edge_masks(jax_graph, jax_excl)
    port_masks, port_ok = port_sparse.build_edge_masks(port_graph, port_excl)
    np.testing.assert_array_equal(port_ok, jax_ok)
    assert not port_ok[-1] and port_ok[:-1].all()
    assert len(port_masks) == len(jax_masks)
    unpacked = _unpacked(port_graph, port_masks)
    for got, want in zip(unpacked, jax_masks):
        np.testing.assert_array_equal(got, want)
    # every link masked both ways, LAG members one by one
    total = sum(int(m[:-2].sum()) for m in unpacked)
    assert total == 2 * sum(len(x) for x in port_excl[:-2])
    with pytest.raises(KeyError):
        carry.links_from_keys(port_ls, [[("no", "such", "link")]])


@pytest.mark.parametrize("kind", ["fat_tree", "lag_unequal"])
def test_build_edge_masks_collapsed_graph_matches_reference(kind):
    # a graph without per-link slots masks the first slot from the link's
    # other end, and cannot express one member of a parallel group
    jax_ls, port_ls, jax_graph, port_graph, root = _graphs(kind)
    jax_graph = replace(jax_graph, slot_of=None)
    port_graph = replace(port_graph, slot_of=None)
    jax_masks, jax_ok = jax_sparse.build_edge_masks(
        jax_graph, _first_path_links(jax_ls, root), jax_ls.parallel_pairs()
    )
    port_masks, port_ok = port_sparse.build_edge_masks(
        port_graph, _first_path_links(port_ls, root), port_ls.parallel_pairs()
    )
    np.testing.assert_array_equal(port_ok, jax_ok)
    if kind == "lag_unequal":
        assert not port_ok.all()
    for got, want in zip(_unpacked(port_graph, port_masks), jax_masks):
        np.testing.assert_array_equal(got, want)


def _unpacked(graph, masks):
    """The port's packed masks as [B, rows, k] bool arrays, after checking
    each is int32 words [B, ceil(rows * k / 32)] with no bit set past the
    band's slots (packing the bool mask again gives the same words)."""
    out = []
    for m, band in zip(masks, graph.bands):
        assert m.dtype == np.int32 and m.shape[1] == mask_words(band.rows, band.k)
        got = unpack_edge_mask(torch.from_numpy(m), band.rows, band.k)
        np.testing.assert_array_equal(pack_edge_mask(got).numpy(), m)
        out.append(got.numpy())
    return out


def _masked_inputs(jax_ls, port_ls, jax_graph, port_graph, root):
    jax_masks, _ = jax_sparse.build_edge_masks(jax_graph, _first_path_links(jax_ls, root))
    port_masks, _ = port_sparse.build_edge_masks(port_graph, _first_path_links(port_ls, root))
    return jax_masks, port_masks


@pytest.mark.parametrize("kind", ["fat_tree", "grid", "lag_equal"])
def test_masked_fixed_point_matches_reference_source_batch(kind):
    jax_ls, port_ls, _, _, root = _graphs(kind)
    # the root drains: its init relax must still originate (the init
    # runs with no overload mask), and a transit node drains too
    nodes = sorted(n for n in jax_ls.get_adjacency_databases() if n != root)
    for ls in (jax_ls, port_ls):
        dbs = ls.get_adjacency_databases()
        for node in (root, nodes[len(nodes) // 2]):
            ls.update_adjacency_database(replace(dbs[node], is_overloaded=True))
    jax_graph = jax_sparse.compile_ell(jax_ls)
    port_graph = port_sparse.compile_ell(port_ls)
    sid = port_graph.node_index[root]
    assert port_graph.overloaded[sid]
    jax_masks, port_masks = _masked_inputs(jax_ls, port_ls, jax_graph, port_graph, root)
    want = np.asarray(
        jax_sparse._ell_masked_source_batch(
            tuple(map(jnp.asarray, jax_graph.src)), tuple(map(jnp.asarray, jax_graph.w)),
            tuple(map(jnp.asarray, jax_masks)), jnp.asarray(jax_graph.overloaded),
            sid, jax_graph.bands, jax_graph.n_pad,
        )
    )
    tensors = (
        tuple(map(torch.from_numpy, port_graph.src)),
        tuple(map(torch.from_numpy, port_graph.w)),
        tuple(map(torch.from_numpy, port_masks)),
        torch.from_numpy(port_graph.overloaded),
        sid, port_graph.bands, port_graph.n_pad,
    )
    got, hops = port_sparse._ell_masked_fixed_point(*tensors)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 <= hops <= port_graph.n_pad
    np.testing.assert_array_equal(
        port_sparse.ell_masked_distances(port_graph, sid, port_masks, device="cpu"), want
    )
    # the overloaded root still reaches its neighbours in every masked graph
    nbr = port_graph.node_index[
        next(iter(port_ls.links_from_node(root))).other_node(root)
    ]
    assert (got[:, sid] == 0).all() and (got[:, nbr] < port_sparse.INF).any()


@pytest.mark.parametrize("kind", ["fat_tree", "grid", "lag_unequal"])
def test_trace_paths_from_row_matches_reference(kind):
    jax_ls, port_ls, jax_graph, port_graph, root = _graphs(kind)
    sid = port_graph.node_index[root]
    jax_excl = _first_path_links(jax_ls, root)
    port_excl = _first_path_links(port_ls, root)
    jax_masks, port_masks = _masked_inputs(jax_ls, port_ls, jax_graph, port_graph, root)
    rows = port_sparse.ell_masked_distances(port_graph, sid, port_masks, device="cpu")
    jax_cands = jax_ksp2.make_cands_of(jax_ls, jax_graph.node_index)
    port_cands = port_ksp2.make_cands_of(port_ls, port_graph.node_index)
    blocked = {"no-such-node"}
    traced = 0
    for i, dst in enumerate(sorted(port_ls.get_adjacency_databases())):
        for excl_j, excl_p, blk in ((set(), set(), set()), (jax_excl[i], port_excl[i], blocked)):
            want = jax_ksp2.trace_paths_from_row(
                root, dst, jax_graph.node_index, rows[i], excl_j, jax_cands, blk
            )
            got = port_ksp2.trace_paths_from_row(
                root, dst, port_graph.node_index, rows[i].tolist(), excl_p, port_cands, blk
            )
            assert [[port_sparse.link_key(l) for l in p] for p in got] == [
                [jax_sparse.link_key(l) for l in p] for p in want
            ]
            traced += len(got)
    assert traced > 0
    assert port_ksp2.trace_paths_from_row(root, "nobody", port_graph.node_index, rows[0], set(),
                                          port_cands, set()) == []


@pytest.mark.parametrize("budget", [32_000_000, 100_000, 1])
def test_ksp2_chunk_matches_reference(budget, monkeypatch):
    monkeypatch.setattr(jax_solver, "KSP2_DEVICE_MASK_BUDGET", budget)
    monkeypatch.setattr(port_solver, "KSP2_DEVICE_MASK_BUDGET", budget)
    _, _, jax_graph, port_graph, _ = _graphs("fat_tree")
    assert port_solver._ksp2_chunk(port_graph) == jax_solver._ksp2_chunk(jax_graph)


def test_sparse_view_and_ksp2_share_one_compiled_graph(monkeypatch):
    # one compile, shared by the sparse view and the masked solve through
    # the solver's resident bands; an overload flip is a new version,
    # patched into the same resident state without a second compile
    monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", 3)
    twin = Twin("grid")
    compiles = []
    real = port_sparse.compile_ell
    monkeypatch.setattr(port_sparse, "compile_ell", lambda ls: compiles.append(ls) or real(ls))
    solver = port_solver.SpfSolver(twin.root, backend="device", device="cpu")
    (ls,) = twin.dev.areas.values()
    solver.build_route_db(twin.root, twin.dev.areas, twin.dev.ps)
    assert len(compiles) == 1
    first = solver._resident.state_for(ls).graph
    solver.build_route_db(twin.root, twin.dev.areas, twin.dev.ps)
    assert len(compiles) == 1
    version = ls.topology_version
    twin.set_adj(replace(twin.adj("0", "node-6"), is_overloaded=True))
    assert ls.topology_version != version
    solver.build_route_db(twin.root, twin.dev.areas, twin.dev.ps)
    assert len(compiles) == 1
    second = solver._resident.state_for(ls).graph
    assert second is not first
    assert second.node_names is first.node_names
    assert second.overloaded[second.node_index["node-6"]]
    assert not first.overloaded[first.node_index["node-6"]]
    assert isinstance(solver._view("0", ls, twin.root)._snap, port_solver._SparseIndexAdapter)
