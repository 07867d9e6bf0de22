"""Route-build parity of the PyTorch port against the JAX package.

The same link-state and prefix databases (made with the JAX package's
topology generators, handed to the port through ``openr_tpu_torch.carry``)
go through three solvers: ``openr_tpu``'s device backend, the port's
device backend and the port's host (Dijkstra) backend. Their route
databases must be equal, exactly, after every event of a churn sequence
of metric changes, link down/up and overload toggles. The sparse regime
is reached at test size by lowering ``SPARSE_NODE_THRESHOLD`` in both
packages for the duration of a test.
"""

from __future__ import annotations

from dataclasses import replace

import pytest

from openr_tpu.decision import spf_solver as jax_solver
from openr_tpu.decision.prefix_state import PrefixState as JaxPrefixState
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.types import BinaryAddress as JaxBinaryAddress
from openr_tpu.types import IpPrefix as JaxIpPrefix
from openr_tpu.types import NextHop as JaxNextHop
from openr_tpu.types import PrefixEntry as JaxPrefixEntry
from openr_tpu.types.lsdb import PrefixForwardingAlgorithm as JaxAlgo
from openr_tpu.types.lsdb import PrefixForwardingType as JaxFwdType
from openr_tpu_torch import carry
from openr_tpu_torch.decision import spf_solver as port_solver
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.types import BinaryAddress, NextHop


class Twin:
    """One network held by both packages: JAX-side databases are the
    source; each update is converted to plain form and fed to the port."""

    def __init__(self, topo):
        self.area = topo.area
        self.jax_ls = JaxLinkState(area=topo.area)
        self.ls = LinkState(area=topo.area)
        self.jax_ps = JaxPrefixState()
        self.ps = PrefixState()
        for name in sorted(topo.adj_dbs):
            self.set_adj(topo.adj_dbs[name])
        for name in sorted(topo.prefix_dbs):
            self.set_prefixes(topo.prefix_dbs[name])

    def set_adj(self, jax_db) -> None:
        self.jax_ls.update_adjacency_database(jax_db)
        (db,), _ = carry.lsdb_from_plain([carry.to_plain(jax_db)], [])
        self.ls.update_adjacency_database(db)

    def set_prefixes(self, jax_db) -> None:
        self.jax_ps.update_prefix_database(jax_db)
        _, (db,) = carry.lsdb_from_plain([], [carry.to_plain(jax_db)])
        self.ps.update_prefix_database(db)

    def adj(self, node):
        return self.jax_ls.get_adjacency_databases()[node]


def _decorate(topo, root: str):
    """Give the topology what the route build reads beyond plain SP
    routes: adjacency labels on the root's links, v4 prefixes, an
    anycast prefix with a min-nexthop bound, an SR_MPLS prefix with a
    prepend label, and a drained (overloaded) anycast advertiser."""
    nodes = sorted(topo.adj_dbs)
    root_db = topo.adj_dbs[root]
    topo.adj_dbs[root] = replace(
        root_db,
        adjacencies=tuple(
            replace(a, adj_label=60000 + i)
            for i, a in enumerate(root_db.adjacencies)
        ),
    )
    anycast = JaxIpPrefix.from_str("fd00:aaaa::/64")
    sr = JaxIpPrefix.from_str("fd00:bbbb::/64")
    far = [n for n in nodes if n != root]
    drained = far[len(far) // 2]
    topo.adj_dbs[drained] = replace(topo.adj_dbs[drained], is_overloaded=True)
    for i, node in enumerate(far[-3:] + [drained]):
        db = topo.prefix_dbs[node]
        extra = [
            JaxPrefixEntry(prefix=anycast, min_nexthop=1),
            JaxPrefixEntry(prefix=JaxIpPrefix.from_str(f"10.{i}.0.0/24")),
        ]
        if i == 0:
            extra.append(
                JaxPrefixEntry(
                    prefix=sr,
                    forwarding_type=JaxFwdType.SR_MPLS,
                    prepend_label=70000,
                )
            )
        topo.prefix_dbs[node] = replace(
            db, prefix_entries=db.prefix_entries + tuple(extra)
        )
    return topo


def _topology(kind: str):
    if kind == "fat_tree":
        return jax_topologies.fat_tree(2, ssw_per_plane=2, rsw_per_pod=4), "rsw-0-0"
    if kind == "grid":
        return jax_topologies.grid(4, metric=3), "node-5"
    if kind == "mesh":
        return jax_topologies.random_mesh(24, degree=4, seed=7), "node-3"
    if kind == "lag":
        edges = [("a", "b", 1), ("a", "b", 1), ("b", "c", 2), ("a", "d", 5),
                 ("d", "c", 1), ("c", "e", 1), ("b", "e", 4), ("b", "e", 4)]
        return jax_topologies.build_topology("lag", edges), "a"
    raise ValueError(kind)


def _events(twin: Twin, root: str):
    """The churn sequence: each yields after one LSDB change."""
    nodes = sorted(twin.jax_ls.get_adjacency_databases())
    far = [n for n in nodes if n != root]
    a = far[0]
    b = far[len(far) // 3]
    db = twin.adj(a)
    adj0 = db.adjacencies[0]
    # metric change on one direction of one link
    twin.set_adj(replace(db, adjacencies=(replace(adj0, metric=9),) + db.adjacencies[1:]))
    yield "metric"
    # the root's first link goes down (one side withdraws it), then up
    root_db = twin.adj(root)
    twin.set_adj(replace(root_db, adjacencies=root_db.adjacencies[1:]))
    yield "link down"
    twin.set_adj(root_db)
    yield "link up"
    # node overload toggles
    twin.set_adj(replace(twin.adj(b), is_overloaded=True))
    yield "overload on"
    twin.set_adj(replace(twin.adj(b), is_overloaded=False))
    yield "overload off"
    # a drained link (adjacency-level overload) and a metric restore
    db = twin.adj(a)
    twin.set_adj(
        replace(db, adjacencies=(replace(db.adjacencies[0], is_overloaded=True, metric=adj0.metric),)
                + db.adjacencies[1:])
    )
    yield "adjacency overload"
    # the root itself drains
    twin.set_adj(replace(twin.adj(root), is_overloaded=True))
    yield "root overload"


def _plain(route_db, root):
    return None if route_db is None else carry.route_db_to_plain(
        route_db.to_route_db(root)
    )


def _check_churn(kind: str, lfa: bool) -> int:
    topo, root = _topology(kind)
    twin = Twin(_decorate(topo, root))
    kw = dict(enable_v4=True, compute_lfa_paths=lfa)
    jax_dev = jax_solver.SpfSolver(root, backend="device", **kw)
    port_dev = port_solver.SpfSolver(root, backend="device", device="cpu", **kw)
    port_host = port_solver.SpfSolver(root, backend="host", device="cpu", **kw)
    areas = {twin.area: twin.jax_ls}
    port_areas = {twin.area: twin.ls}
    checked = 0
    port_solver.SPF_COUNTERS["decision.spf_host_fallback"] = 0

    def compare(event):
        want = _plain(jax_dev.build_route_db(root, areas, twin.jax_ps), root)
        got = _plain(port_dev.build_route_db(root, port_areas, twin.ps), root)
        oracle = _plain(port_host.build_route_db(root, port_areas, twin.ps), root)
        assert got == want, f"{kind}: port device != openr_tpu after {event}"
        assert oracle == want, f"{kind}: port host != openr_tpu after {event}"
        assert want is not None and want[1] and want[2]

    compare("initial build")
    checked += 1
    for event in _events(twin, root):
        compare(event)
        checked += 1
    # every LFA distance came from the device batch, none from a host SPF
    assert port_solver.SPF_COUNTERS["decision.spf_host_fallback"] == 0
    return checked


@pytest.mark.parametrize("lfa", [False, True], ids=["ecmp", "lfa"])
@pytest.mark.parametrize("kind", ["fat_tree", "grid", "mesh", "lag"])
def test_dense_route_db_parity_through_churn(kind, lfa):
    assert _check_churn(kind, lfa) == 8


@pytest.mark.parametrize("lfa", [False, True], ids=["ecmp", "lfa"])
@pytest.mark.parametrize("kind", ["fat_tree", "grid", "mesh", "lag"])
def test_sparse_route_db_parity_through_churn(kind, lfa, monkeypatch):
    # both packages take the sliced-ELL branch at test size
    monkeypatch.setattr(jax_solver, "SPARSE_NODE_THRESHOLD", 3)
    monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", 3)
    assert _check_churn(kind, lfa) == 8


def test_sparse_branch_is_taken_above_threshold(monkeypatch):
    topo, root = _topology("grid")
    twin = Twin(topo)
    monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", 3)
    view = port_solver.SpfView(
        twin.ls, root, "device",
        port_solver.SnapshotCache("cpu"),
    )
    assert isinstance(view._snap, port_solver._SparseIndexAdapter)
    monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", 4096)
    view = port_solver.SpfView(
        twin.ls, root, "device", port_solver.SnapshotCache("cpu")
    )
    assert not isinstance(view._snap, port_solver._SparseIndexAdapter)


@pytest.mark.parametrize("threshold", [3, 4096], ids=["sparse", "dense"])
def test_metric_between_outside_batch_is_counted(threshold, monkeypatch):
    # a node that is neither the root nor a neighbour is answered by the
    # host Dijkstra in both packages, and counted as a host fallback
    monkeypatch.setattr(jax_solver, "SPARSE_NODE_THRESHOLD", threshold)
    monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", threshold)
    topo, root = _topology("grid")
    twin = Twin(topo)
    dbs = twin.ls.get_adjacency_databases()
    nbrs = sorted({adj.other_node_name for adj in dbs[root].adjacencies})
    far = next(n for n in sorted(dbs) if n != root and n not in nbrs)
    view = port_solver.SpfView(twin.ls, root, "device", port_solver.SnapshotCache("cpu"))
    jax_view = jax_solver.SpfView(twin.jax_ls, root, "device")
    port_solver.SPF_COUNTERS["decision.spf_host_fallback"] = 0
    jax_before = jax_solver.SPF_COUNTERS["decision.spf_host_fallback"]
    got = view.metric_between(far, root)
    assert got == jax_view.metric_between(far, root) is not None
    assert port_solver.SPF_COUNTERS["decision.spf_host_fallback"] == 1
    assert jax_solver.SPF_COUNTERS["decision.spf_host_fallback"] == jax_before + 1
    nbr = nbrs[0]
    assert view.metric_between(nbr, far) == jax_view.metric_between(nbr, far)
    assert port_solver.SPF_COUNTERS["decision.spf_host_fallback"] == 1


def test_static_mpls_routes_and_anycast_prepend_parity():
    topo, root = _topology("fat_tree")
    # the root advertises the anycast prefix with a prepend label whose
    # static route the solver merges into the route
    db = topo.prefix_dbs[root]
    topo.prefix_dbs[root] = replace(
        db,
        prefix_entries=db.prefix_entries
        + (JaxPrefixEntry(prefix=JaxIpPrefix.from_str("fd00:cccc::/64"),
                          prepend_label=65001),),
    )
    for node in ("rsw-1-0", "rsw-1-1"):
        db = topo.prefix_dbs[node]
        topo.prefix_dbs[node] = replace(
            db,
            prefix_entries=db.prefix_entries
            + (JaxPrefixEntry(prefix=JaxIpPrefix.from_str("fd00:cccc::/64")),),
        )
    twin = Twin(topo)
    jax_dev = jax_solver.SpfSolver(root, backend="device")
    port_dev = port_solver.SpfSolver(root, backend="device", device="cpu")
    jax_nh = [JaxNextHop(address=JaxBinaryAddress.from_str("fe80::9", "eth9"))]
    port_nh = [NextHop(address=BinaryAddress.from_str("fe80::9", "eth9"))]
    jax_dev.update_static_mpls_routes({65001: jax_nh, 65002: jax_nh}, [])
    port_dev.update_static_mpls_routes({65001: port_nh, 65002: port_nh}, [])
    jax_dev.update_static_mpls_routes({}, [65002])
    port_dev.update_static_mpls_routes({}, [65002])
    want = _plain(jax_dev.build_route_db(root, {"0": twin.jax_ls}, twin.jax_ps), root)
    got = _plain(port_dev.build_route_db(root, {"0": twin.ls}, twin.ps), root)
    assert got == want
    labels = [r[0] for r in got[2]]
    assert any(("top_label", 65001) in r for r in labels)
    assert not any(("top_label", 65002) in r for r in labels)


def test_root_absent_gives_no_route_db():
    topo, _root = _topology("grid")
    twin = Twin(topo)
    port_dev = port_solver.SpfSolver("nobody", backend="device", device="cpu")
    jax_dev = jax_solver.SpfSolver("nobody", backend="device")
    assert port_dev.build_route_db("nobody", {"0": twin.ls}, twin.ps) is None
    assert jax_dev.build_route_db("nobody", {"0": twin.jax_ls}, twin.jax_ps) is None


def test_ksp2_prefix_raises_not_implemented():
    # KSP2_ED_ECMP is ported now (tests/test_torch_ksp2.py): a KSP2 prefix
    # no longer raises. Without SR-MPLS it gets no route, as in openr_tpu
    topo = jax_topologies.grid(3, forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP)
    twin = Twin(topo)
    solver = port_solver.SpfSolver("node-0", backend="device", device="cpu")
    got = solver.build_route_db("node-0", {"0": twin.ls}, twin.ps)
    want = jax_solver.SpfSolver("node-0", backend="device").build_route_db(
        "node-0", {"0": twin.jax_ls}, twin.jax_ps
    )
    assert _plain(got, "node-0") == _plain(want, "node-0")
    assert not got.unicast_routes and got.mpls_routes
