"""SP_ECMP route reuse of the PyTorch port against the JAX package.

The scenarios of ``tests/test_sp_route_reuse.py`` (and a mixed soak in
the shape of ``tools/soak_sp_reuse.py``), each run dense and sparse (the
sliced-ELL branch is reached at test size by lowering
``SPARSE_NODE_THRESHOLD`` in both packages). The same mutation stream
goes to ``openr_tpu``'s device solver, the port's device solver (on the
CPU) and the port's host solver, each on its own copy of the databases
(the JAX package's are the source; each update is handed to the port
through ``openr_tpu_torch.carry``). After every build the three route
databases must be equal, exactly, and the build's
``decision.sp_route_reuses`` delta must equal the reference's. Both
packages' KSP2 paths run in their per-build chunked mode
(``ksp2_engine.ENGINE_MAX_NODES`` set to 0 in both), whose KSP2 prefixes
are re-derived on every build, so the SP reuse is held alone (the KSP2
engine's reuse: ``tests/test_torch_ksp2_engine.py``).
"""

from __future__ import annotations

import random
from dataclasses import replace

import pytest

from openr_tpu.decision import ksp2_engine as jax_ksp2
from openr_tpu.decision import spf_solver as jax_solver
from openr_tpu.decision.prefix_state import PrefixState as JaxPrefixState
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.types import Adjacency as JaxAdjacency
from openr_tpu.types import AdjacencyDatabase as JaxAdjacencyDatabase
from openr_tpu.types import BinaryAddress as JaxBinaryAddress
from openr_tpu.types.lsdb import PrefixForwardingAlgorithm as JaxAlgo
from openr_tpu.types.lsdb import PrefixForwardingType as JaxFwdType
from openr_tpu_torch import carry
from openr_tpu_torch.decision import ksp2_engine as port_ksp2
from openr_tpu_torch.decision import spf_solver as port_solver
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.types import BinaryAddress

REUSES = "decision.sp_route_reuses"


@pytest.fixture(params=["dense", "sparse"])
def regime(request, monkeypatch):
    monkeypatch.setattr(jax_ksp2, "ENGINE_MAX_NODES", 0)
    monkeypatch.setattr(port_ksp2, "ENGINE_MAX_NODES", 0)
    if request.param == "sparse":
        monkeypatch.setattr(jax_solver, "SPARSE_NODE_THRESHOLD", 3)
        monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", 3)
    yield request.param
    # CPU tensors run the plain versions: no kernel launch is counted
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


def _topology(kind: str, n: int, area: str = "0", ftype=JaxFwdType.SR_MPLS,
              algo=JaxAlgo.SP_ECMP):
    kwargs = dict(area=area, forwarding_algorithm=algo, forwarding_type=ftype)
    if kind == "grid":
        return jax_topologies.grid(n, **kwargs)
    if kind == "fabric":
        return jax_topologies.fat_tree_nodes(n, **kwargs)
    # random_mesh prefixes are SP_ECMP over IP
    return jax_topologies.random_mesh(n, degree=4, seed=7, max_metric=9, area=area)


class Worlds:
    """The reference device solver and the port's device and host
    solvers, each over its own databases of the same areas."""

    def __init__(self, topos, root=None, lfa=False):
        self.topos = topos
        self.jax_areas = {}
        self.areas = {}
        self.host_areas = {}
        self.jax_ps, self.ps, self.host_ps = JaxPrefixState(), PrefixState(), PrefixState()
        for area, topo in topos.items():
            self.jax_areas[area] = JaxLinkState(area=area)
            self.areas[area] = LinkState(area=area)
            self.host_areas[area] = LinkState(area=area)
            for name in sorted(topo.adj_dbs):
                self.set_adj(area, topo.adj_dbs[name])
        for topo in topos.values():
            for name in sorted(topo.prefix_dbs):
                self.set_prefixes(topo.prefix_dbs[name])
        if root is None:
            names = sorted(next(iter(topos.values())).adj_dbs)
            root = next((k for k in names if k.startswith("rsw")), names[0])
        self.root = root
        kw = dict(compute_lfa_paths=lfa)
        self.jax_dev = jax_solver.SpfSolver(root, backend="device", **kw)
        self.dev = port_solver.SpfSolver(root, backend="device", device="cpu", **kw)
        self.host = port_solver.SpfSolver(root, backend="host", device="cpu", **kw)
        self.builds = 0

    def set_adj(self, area, jax_db) -> None:
        self.jax_areas[area].update_adjacency_database(jax_db)
        for ls in (self.areas[area], self.host_areas[area]):
            (db,), _ = carry.lsdb_from_plain([carry.to_plain(jax_db)], [])
            ls.update_adjacency_database(db)

    def set_prefixes(self, jax_db) -> None:
        self.jax_ps.update_prefix_database(jax_db)
        for ps in (self.ps, self.host_ps):
            _, (db,) = carry.lsdb_from_plain([], [carry.to_plain(jax_db)])
            ps.update_prefix_database(db)

    def adj(self, area, node):
        return self.jax_areas[area].get_adjacency_databases()[node]

    def edit(self, area, node, **changes) -> None:
        self.set_adj(area, replace(self.adj(area, node), **changes))

    def set_metric(self, area, node, i, metric) -> None:
        adjs = list(self.adj(area, node).adjacencies)
        adjs[i] = replace(adjs[i], metric=metric)
        self.edit(area, node, adjacencies=tuple(adjs))

    def static_mpls(self, update, delete) -> None:
        """``update``: label -> next-hop address strings."""
        self.jax_dev.update_static_mpls_routes(
            {lab: [jax_solver.make_next_hop(JaxBinaryAddress.from_str(a), None, 0, None)
                   for a in addrs] for lab, addrs in update.items()}, delete)
        for solver in (self.dev, self.host):
            solver.update_static_mpls_routes(
                {lab: [port_solver.make_next_hop(BinaryAddress.from_str(a), None, 0, None)
                       for a in addrs] for lab, addrs in update.items()}, delete)

    def step(self) -> int:
        """One build of each solver: the route databases must be equal;
        returns the port's reuse delta, which must equal the
        reference's."""
        j0, p0 = jax_solver.SPF_COUNTERS[REUSES], port_solver.SPF_COUNTERS[REUSES]
        want = self.jax_dev.build_route_db(self.root, self.jax_areas, self.jax_ps)
        got = self.dev.build_route_db(self.root, self.areas, self.ps)
        oracle = self.host.build_route_db(self.root, self.host_areas, self.host_ps)
        j1, p1 = jax_solver.SPF_COUNTERS[REUSES], port_solver.SPF_COUNTERS[REUSES]
        self.builds += 1
        want_p = carry.route_db_to_plain(want.to_route_db(self.root))
        assert carry.route_db_to_plain(got.to_route_db(self.root)) == want_p, self.builds
        assert carry.route_db_to_plain(oracle.to_route_db(self.root)) == want_p, self.builds
        assert p1 - p0 == j1 - j0, (self.builds, p1 - p0, j1 - j0)
        return p1 - p0


def _fabric(n=120, **kw):
    return Worlds({"0": _topology("fabric", n, **kw)})


def _first(w, prefix, area="0"):
    return next(k for k in sorted(w.topos[area].adj_dbs) if k.startswith(prefix))


def test_noop_rebuild_reuses_everything(regime):
    w = _fabric()
    w.step()
    w.step()  # the second build stores and populates
    assert w.step() > 100  # steady state: nearly every prefix


def test_remote_metric_churn_parity(regime):
    w = _fabric()
    fsw = _first(w, "fsw")
    w.step()
    w.step()
    total = 0
    for step in range(6):
        w.set_metric("0", fsw, 0, 2 + step % 5)
        total += w.step()
    # remote churn must not turn reuse off for untouched advertisers
    assert total > 0


def test_overload_flip_not_reused_stale(regime):
    # draining an advertiser changes its routes through
    # maybeFilterDrainedNodes even where distances stay the same
    w = _fabric()
    target = sorted(k for k in w.topos["0"].adj_dbs if k.startswith("rsw"))[-1]
    w.step()
    w.step()
    w.edit("0", target, is_overloaded=True)
    w.step()
    w.edit("0", target, is_overloaded=False)
    w.step()


def test_node_label_change_not_reused_stale(regime):
    # an SR PUSH route embeds the advertiser's node label
    w = _fabric()
    target = sorted(k for k in w.topos["0"].adj_dbs if k.startswith("rsw"))[-1]
    w.step()
    w.step()
    w.edit("0", target, node_label=60123)
    w.step()
    w.edit("0", target, node_label=60124)
    w.step()


def test_local_link_churn_parity(regime):
    # the root's own link metrics enter every materialized next hop
    w = _fabric()
    w.step()
    w.step()
    for m in (3, 4, 1):
        w.set_metric("0", w.root, 0, m)
        w.step()


def test_link_down_up_parity(regime):
    w = _fabric()
    fsw = _first(w, "fsw")
    w.step()
    w.step()
    db = w.adj("0", fsw)
    w.edit("0", fsw, adjacencies=db.adjacencies[1:])
    w.step()
    w.set_adj("0", db)
    w.step()


def test_prefix_version_change_invalidates(regime):
    # a prefix database update moves the version meta: no stale routes
    w = Worlds({"0": _topology("grid", 5)})
    w.step()
    w.step()
    node = sorted(w.topos["0"].prefix_dbs)[-1]
    pdb = w.topos["0"].prefix_dbs[node]
    w.set_prefixes(replace(pdb, prefix_entries=tuple(
        replace(e, forwarding_type=JaxFwdType.IP) for e in pdb.prefix_entries)))
    w.step()
    w.step()


def test_ip_forwarding_grid_parity(regime):
    w = Worlds({"0": _topology("grid", 6, ftype=JaxFwdType.IP)})
    w.step()
    w.step()
    assert w.step() > 20
    for step in range(4):
        w.set_metric("0", "node-21", 0, 2 + step)
        w.step()


def test_static_mpls_update_invalidates(regime):
    # _add_best_paths merges static MPLS next hops into self-advertised
    # anycast routes: a static-route change with the same graph and
    # prefixes must not serve the stale cached route
    w = Worlds({"0": _topology("grid", 5)})
    pdb = w.topos["0"].prefix_dbs[w.root]
    w.set_prefixes(replace(pdb, prefix_entries=tuple(
        replace(e, prepend_label=70001) for e in pdb.prefix_entries)))
    w.step()
    w.step()
    w.static_mpls({70001: ["fe80::99"]}, [])
    w.step()
    w.static_mpls({}, [70001])
    w.step()


def _multi_area():
    """Two areas with a border root: area "b" gains node-0, linked to
    its first rack switch (the multi-area world of the reference's
    scenario)."""
    w = Worlds({"a": _topology("grid", 4, area="a"), "b": _topology("fabric", 120, area="b")},
               root="node-0")
    rsw = _first(w, "rsw", "b")

    def adj(node, other):
        return JaxAdjacency(other_node_name=other, if_name=f"if_{node}_{other}",
                            other_if_name=f"if_{other}_{node}", metric=1)

    w.set_adj("b", JaxAdjacencyDatabase(this_node_name="node-0", adjacencies=(adj("node-0", rsw),),
                                        node_label=9000, area="b"))
    w.edit("b", rsw, adjacencies=w.adj("b", rsw).adjacencies + (adj(rsw, "node-0"),))
    return w


def test_multi_area_parity_and_reuse(regime):
    # per-area dirty signatures union; churn in one area leaves the
    # other area's prefixes reusable
    w = _multi_area()
    w.step()
    w.step()
    fsw = _first(w, "fsw", "b")
    total = 0
    for step in range(3):
        w.set_metric("b", fsw, 0, 2 + step)
        total += w.step()
    for step in range(3):
        w.set_metric("a", "node-2", 0, 3 + step)
        total += w.step()
    assert total > 0


def test_label_collision_churn_parity(regime):
    # node-label collisions through the patched label-route map: the
    # smaller name wins; the winner relabeled hands the label over,
    # a loser joins, the collision dissolves
    w = Worlds({"0": _topology("grid", 5)})
    nodes = sorted(w.topos["0"].adj_dbs)
    a, b, c = nodes[2], nodes[7], nodes[11]
    w.step()
    w.step()
    a_label = w.adj("0", a).node_label
    w.edit("0", b, node_label=a_label)
    w.step()
    w.step()
    w.edit("0", a, node_label=61001)
    w.step()
    w.step()
    w.edit("0", c, node_label=a_label)
    w.step()
    w.step()
    w.edit("0", b, node_label=61002)
    w.step()
    w.edit("0", c, node_label=61003)
    w.step()
    w.set_metric("0", nodes[-1], 0, 7)
    assert w.step() >= 0


def _soak(w, seed: int, steps: int) -> int:
    """The mutation classes of ``tools/soak_sp_reuse.py`` in random
    order: metric wiggles, overload flips, node labels, link drop and
    restore, prefix forwarding-type flips, static MPLS changes."""
    rng = random.Random(seed)
    pulled = {}
    total = 0
    for _ in range(steps):
        area = rng.choice(sorted(w.areas))
        node = rng.choice(sorted(w.topos[area].adj_dbs))
        db = w.adj(area, node)
        pick = rng.random()
        if pick < 0.45 and db.adjacencies:
            w.set_metric(area, node, rng.randrange(len(db.adjacencies)), 1 + rng.randrange(9))
        elif pick < 0.6:
            w.edit(area, node, is_overloaded=not db.is_overloaded)
        elif pick < 0.7:
            w.edit(area, node, node_label=50000 + rng.randrange(1000))
        elif pick < 0.85 and db.adjacencies:
            if (area, node) in pulled:
                w.edit(area, node, adjacencies=db.adjacencies + (pulled.pop((area, node)),))
            else:
                adjs = list(db.adjacencies)
                pulled[(area, node)] = adjs.pop(rng.randrange(len(adjs)))
                w.edit(area, node, adjacencies=tuple(adjs))
        elif pick < 0.95:
            pdb = w.topos[area].prefix_dbs[node]
            ftype = rng.choice([JaxFwdType.IP, JaxFwdType.SR_MPLS])
            w.set_prefixes(replace(pdb, prefix_entries=tuple(
                replace(e, forwarding_type=ftype) for e in pdb.prefix_entries)))
        else:
            label = 70000 + rng.randrange(4)
            if rng.random() < 0.5:
                w.static_mpls({label: [f"fe80::{rng.randrange(1, 99):x}"]}, [])
            else:
                w.static_mpls({}, [label])
        total += w.step()
    return total


@pytest.mark.parametrize("seed,kind", [(0, "grid"), (1, "fabric"), (2, "mesh"), (3, "multi")])
def test_soak_mixed_churn_parity(regime, seed, kind):
    if kind == "multi":
        w = _multi_area()
    else:
        w = Worlds({"0": _topology(kind, {"grid": 6, "fabric": 120, "mesh": 40}[kind])})
    w.step()
    assert _soak(w, seed, 24) > 0


def test_lfa_disables_sp_reuse(regime):
    # LFA reads neighbour rows the dirty test does not compare: an LFA
    # solver never reuses
    w = Worlds({"0": _topology("grid", 5)}, lfa=True)
    for _ in range(3):
        assert w.step() == 0


def test_ksp2_prefixes_always_rederived(regime, monkeypatch):
    # every fourth node's prefixes ask for KSP2_ED_ECMP: those are
    # re-derived on every build (no KSP2 engine reports what moved),
    # the SP ones reuse as before
    monkeypatch.setattr(jax_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    monkeypatch.setattr(port_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    topo = _topology("fabric", 120)
    names = sorted(topo.prefix_dbs)
    for name in names[::4]:
        pdb = topo.prefix_dbs[name]
        topo.prefix_dbs[name] = replace(pdb, prefix_entries=tuple(
            replace(e, forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP) for e in pdb.prefix_entries))
    w = Worlds({"0": topo})
    w.step()
    w.step()
    reused = w.step()
    ksp2 = len(names[::4]) - (w.root in names[::4])
    assert 0 < reused <= len(names) - 1 - ksp2
    fsw = _first(w, "fsw")
    for step in range(3):
        w.set_metric("0", fsw, 0, 2 + step)
        w.step()
