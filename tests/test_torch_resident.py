"""The port's resident incremental sliced-ELL state against the JAX package.

In the shape of ``tests/test_incremental_parity.py`` and
``tests/test_churn_smoke.py``: the same LinkState (made with the JAX
package's topology generators and handed to the port through
``openr_tpu_torch.carry``) is compiled, patched and re-solved by both
packages on the CPU.

- ``ell_patch`` (with and without ``widen``), ``band_row_edge_changes``,
  ``band_row_edge_delta`` and ``pad_increase_edges`` on the same
  (graph, LinkState) pairs must equal the reference's, array for array.
- ``EllState.reconverge`` through a churn sequence (metric up and down,
  link down and up, drain and undrain, a widen, and two stacked
  ``apply_patch`` calls before one ``reconverge``): at every step the
  port's packed view must equal the reference ``EllState``'s and the
  port's cold ``ell_view_batch_packed`` over the same graph, and the
  ``ELL_COUNTERS`` deltas must equal the reference's.
- ``SpfSolver`` in the sparse regime through churn, SP and KSP2 (the
  reference in its chunked KSP2 mode): route databases equal, and the
  deltas of ``decision.ell_full_compiles``, ``decision.ell_patches``
  and the six ``ELL_COUNTERS`` equal the reference's.

Everything is int32: equality is exact.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from openr_tpu.decision import ksp2_engine as jax_ksp2
from openr_tpu.decision import spf_solver as jax_solver
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.models import topologies as jax_topologies
from openr_tpu.ops import spf_sparse as jax_sparse
from openr_tpu.types.lsdb import PrefixForwardingAlgorithm as JaxAlgo
from openr_tpu.types.lsdb import PrefixForwardingType as JaxFwdType
from openr_tpu_torch import carry
from openr_tpu_torch.decision import ksp2_engine as port_ksp2
from openr_tpu_torch.decision import spf_solver as port_solver
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.ops import spf_sparse as port_sparse
from tests.test_torch_sp_reuse import Worlds

CPU = torch.device("cpu")
ELL_KEYS = tuple(port_sparse.ELL_COUNTERS)
SOLVER_KEYS = ("decision.ell_full_compiles", "decision.ell_patches") + tuple(
    "decision." + k for k in ELL_KEYS
)


@pytest.fixture(autouse=True)
def _no_launches():
    yield
    # CPU tensors run the plain versions: no kernel launch is counted
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


class Pair:
    """One network held by both packages' LinkStates."""

    def __init__(self, topo):
        self.jax_ls = JaxLinkState(area=topo.area)
        self.ls = LinkState(area=topo.area)
        for name in sorted(topo.adj_dbs):
            self.set_adj(topo.adj_dbs[name])

    def set_adj(self, jax_db) -> None:
        self.jax_ls.update_adjacency_database(jax_db)
        (db,), _ = carry.lsdb_from_plain([carry.to_plain(jax_db)], [])
        self.ls.update_adjacency_database(db)

    def adj(self, node):
        return self.jax_ls.get_adjacency_databases()[node]

    def edit(self, node, **changes) -> None:
        self.set_adj(replace(self.adj(node), **changes))

    def set_metric(self, node, i, metric) -> None:
        adjs = list(self.adj(node).adjacencies)
        adjs[i] = replace(adjs[i], metric=metric)
        self.edit(node, adjacencies=tuple(adjs))

    def drop(self, node, i):
        adjs = list(self.adj(node).adjacencies)
        dropped = adjs.pop(i)
        self.edit(node, adjacencies=tuple(adjs))
        return dropped

    def restore(self, node, adj) -> None:
        self.edit(node, adjacencies=self.adj(node).adjacencies + (adj,))

    def fan_in(self, node, peers, metric=2) -> None:
        """Link ``node`` to each of ``peers`` (both directions): its
        in-degree grows past its slot class."""
        base = self.adj(node).adjacencies[0]
        for peer in peers:
            pdb = self.adj(peer)
            self.set_adj(replace(pdb, adjacencies=pdb.adjacencies + (replace(
                pdb.adjacencies[0], other_node_name=node, if_name=f"if_{peer}_{node}",
                other_if_name=f"if_{node}_{peer}", metric=metric),)))
        self.edit(node, adjacencies=self.adj(node).adjacencies + tuple(
            replace(base, other_node_name=peer, if_name=f"if_{node}_{peer}",
                    other_if_name=f"if_{peer}_{node}", metric=metric)
            for peer in peers))


def _assert_graph_equal(got, want) -> None:
    assert list(got.node_names) == list(want.node_names)
    assert got.n == want.n and got.n_pad == want.n_pad
    assert [(b.start, b.rows, b.k) for b in got.bands] == [
        (b.start, b.rows, b.k) for b in want.bands
    ]
    for a, b in zip(got.src + got.w, want.src + want.w):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got.overloaded, np.asarray(want.overloaded))
    assert (got.changed is None) == (want.changed is None)
    if got.changed is not None:
        assert sorted(got.changed) == sorted(want.changed)
        for bi in got.changed:
            np.testing.assert_array_equal(got.changed[bi], want.changed[bi])
    assert got.widened == want.widened
    assert got.slot_of == want.slot_of


def _topology(kind):
    if kind == "mesh":
        return jax_topologies.random_mesh(18, degree=4, seed=4, max_metric=9), "node-0"
    if kind == "grid":
        return jax_topologies.grid(4, metric=3), "node-0"
    return jax_topologies.fat_tree(2, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=3), "rsw-0-0"


def _events(p: Pair, root: str):
    """A churn sequence: yields (event, affected node names) after each
    change. The widen fans new links into one node of the smallest slot
    class, past its k, away from the root (whose source batch stays)."""
    nodes = sorted(p.jax_ls.get_adjacency_databases())
    a, b, c = nodes[2], nodes[len(nodes) // 2], nodes[-2]

    def other(node, i=0):
        return p.adj(node).adjacencies[i].other_node_name

    p.set_metric(a, 0, 15)
    yield "metric up", {a, other(a)}
    p.set_metric(a, 0, 1)
    yield "metric down", {a, other(a)}
    o = other(b)
    dropped = p.drop(b, 0)
    yield "link down", {b, o}
    p.restore(b, dropped)
    yield "link up", {b, o}
    p.edit(c, is_overloaded=True)
    yield "drain", {c}
    p.edit(c, is_overloaded=False)
    yield "undrain", {c}
    graph = jax_sparse.compile_ell(p.jax_ls)
    k0 = graph.bands[0].k
    near = {root} | {adj.other_node_name for adj in p.adj(root).adjacencies}
    target = next(n for n in graph.node_names[: graph.bands[0].rows] if n not in near)
    have = {adj.other_node_name for adj in p.adj(target).adjacencies}
    peers = [n for n in nodes if n not in near and n != target and n not in have]
    peers = peers[: k0 + 1 - len(have)]
    p.fan_in(target, peers)
    yield "widen", {target, *peers}


@pytest.mark.parametrize("kind", ["mesh", "grid", "fat_tree"])
def test_ell_patch_and_edge_changes_match_reference(kind):
    topo, root = _topology(kind)
    p = Pair(topo)
    jax_graph = jax_sparse.compile_ell(p.jax_ls)
    graph = port_sparse.compile_ell(p.ls)
    _assert_graph_equal(graph, jax_graph)
    checked = []
    for event, affected in _events(p, root):
        jax_v, v = p.jax_ls.topology_version, p.ls.topology_version
        assert jax_v == v
        names = sorted(affected)
        for widen in (False, True):
            want = jax_sparse.ell_patch(jax_graph, p.jax_ls, names, widen=widen)
            got = port_sparse.ell_patch(graph, p.ls, names, widen=widen)
            assert (got is None) == (want is None), (event, widen)
            if got is None:
                assert event == "widen" and not widen
                continue
            _assert_graph_equal(got, want)
            assert got.node_names is graph.node_names
            assert got.node_index is graph.node_index
        assert port_sparse.band_row_edge_changes(graph, got) == [
            tuple(int(x) for x in t) for t in jax_sparse.band_row_edge_changes(jax_graph, want)
        ]
        delta = port_sparse.band_row_edge_delta(graph, got)
        assert delta == [
            tuple(int(x) for x in t) for t in jax_sparse.band_row_edge_delta(jax_graph, want)
        ]
        for inc in (delta, [port_sparse._FORCE_RESET_EDGE], delta * 3):
            for x, y in zip(port_sparse.pad_increase_edges(inc),
                            jax_sparse.pad_increase_edges(inc)):
                np.testing.assert_array_equal(x, y)
        checked.append(event)
        jax_graph, graph = want, got
    assert checked[-1] == "widen" and graph.widened


def _counters(module):
    return {k: int(module.ELL_COUNTERS[k]) for k in ELL_KEYS}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


class Resident:
    """A reference EllState and the port's, stepped together; every
    step's packed view is held against both the reference and the port's
    cold solve over the same graph."""

    def __init__(self, p: Pair, root: str):
        self.p, self.root = p, root
        self.jax_state = jax_sparse.EllState(jax_sparse.compile_ell(p.jax_ls))
        self.state = port_sparse.EllState(port_sparse.compile_ell(p.ls), CPU)
        self.steps = 0

    def patch(self, affected):
        want = jax_sparse.ell_patch(self.jax_state.graph, self.p.jax_ls, sorted(affected), widen=True)
        got = port_sparse.ell_patch(self.state.graph, self.p.ls, sorted(affected), widen=True)
        assert want is not None and got is not None
        return want, got

    def apply(self, affected) -> dict:
        want, got = self.patch(affected)
        j0, p0 = _counters(jax_sparse), _counters(port_sparse)
        self.jax_state.apply_patch(want)
        self.state.apply_patch(got)
        d = _delta(_counters(port_sparse), p0)
        assert d == _delta(_counters(jax_sparse), j0)
        _assert_graph_equal(self.state.graph, self.jax_state.graph)
        return d

    def solve(self, affected=None) -> dict:
        if affected:
            want, got = self.patch(affected)
        else:
            want, got = self.jax_state.graph, self.state.graph
        srcs = port_sparse.ell_source_batch(got, self.p.ls, self.root)
        assert srcs == [int(s) for s in jax_sparse.ell_source_batch(want, self.p.jax_ls, self.root)]
        j0, p0 = _counters(jax_sparse), _counters(port_sparse)
        want_packed = np.asarray(self.jax_state.reconverge(want, srcs))
        packed = self.state.reconverge(got, srcs).numpy()
        d = _delta(_counters(port_sparse), p0)
        assert d == _delta(_counters(jax_sparse), j0), self.steps
        np.testing.assert_array_equal(packed, want_packed)
        cold = port_sparse.ell_view_batch_packed(self.state.graph, srcs, CPU).numpy()
        np.testing.assert_array_equal(packed, cold)
        fresh = port_sparse.compile_ell(self.p.ls)
        if fresh.node_names == self.state.graph.node_names:
            # no class change since the compile: ids agree with a fresh one
            np.testing.assert_array_equal(
                packed, port_sparse.ell_view_batch_packed(fresh, srcs, CPU).numpy()
            )
        self.steps += 1
        return d


@pytest.mark.parametrize("kind", ["mesh", "grid", "fat_tree"])
def test_reconverge_through_churn_matches_reference_and_cold(kind):
    topo, root = _topology(kind)
    p = Pair(topo)
    r = Resident(p, root)
    total = {k: 0 for k in ELL_KEYS}

    def add(d):
        for k in d:
            total[k] += d[k]
        return d

    assert add(r.solve())["ell_cold_solves"] == 1
    for event, affected in _events(p, root):
        d = add(r.solve(affected))
        assert d["ell_warm_solves"] == 1 and d["ell_cold_solves"] == 0, event
        if event in ("drain", "undrain", "link down", "link up"):
            assert d["ell_structural_warm_solves"] == 1, event
        if event == "widen":
            assert d["ell_widen_events"] >= 1
    # two stacked patches, then one solve: they merge warm
    nodes = sorted(p.jax_ls.get_adjacency_databases())
    a = nodes[3]
    o = p.adj(a).adjacencies[0].other_node_name
    p.set_metric(a, 0, 2)
    assert add(r.apply({a, o}))["ell_incremental_syncs"] == 1
    p.set_metric(a, 0, 30)
    b = nodes[-3]
    p.edit(b, is_overloaded=True)
    d = add(r.solve({a, o, b}))
    assert d["ell_warm_solves"] == 1 and d["ell_patch_merges"] == 1
    # the journal was drained by the solve: the next event is warm too
    p.set_metric(a, 0, 4)
    assert add(r.solve({a, o}))["ell_warm_solves"] == 1
    # every patch was scattered: seven events, the stacked pair, one more
    assert total["ell_cold_solves"] == 1
    assert total["ell_incremental_syncs"] == 10


def test_apply_patch_then_reconverge_at_the_same_version():
    # the solve-free sync (the KSP2 path's) followed by a view solve of
    # the same graph stays warm and exact
    topo, root = _topology("mesh")
    p = Pair(topo)
    r = Resident(p, root)
    r.solve()
    o = p.adj("node-4").adjacencies[0].other_node_name
    p.set_metric("node-4", 0, 18)
    assert r.apply({"node-4", o})["ell_incremental_syncs"] == 1
    d = r.solve()
    assert d["ell_warm_solves"] == 1 and d["ell_cold_solves"] == 0


def test_a_new_source_batch_solves_cold():
    topo, root = _topology("grid")
    p = Pair(topo)
    r = Resident(p, root)
    r.solve()
    r.root = "node-5"
    assert r.solve()["ell_cold_solves"] == 1


def test_failed_solve_leaves_the_state_torn(monkeypatch):
    topo, root = _topology("grid")
    p = Pair(topo)
    state = port_sparse.EllState(port_sparse.compile_ell(p.ls), CPU)
    srcs = port_sparse.ell_source_batch(state.graph, p.ls, root)
    state.reconverge(state.graph, srcs)
    graph = state.graph
    p.set_metric("node-1", 0, 9)
    patched = port_sparse.ell_patch(graph, p.ls, ["node-0", "node-1"], widen=True)

    def boom(*args):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(port_sparse, "_ell_relax", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        state.reconverge(patched, srcs)
    # the rows were scattered, but the graph did not move: torn
    assert state.torn and state.graph is graph
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="torn"):
        state.reconverge(patched, srcs)
    with pytest.raises(RuntimeError, match="torn"):
        state.apply_patch(patched)


def test_solver_drops_a_failed_resident_state_and_compiles_cold(monkeypatch):
    monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", 3)
    from tests.test_torch_solver import Twin

    topo, root = _topology("grid")
    twin = Twin(topo)
    solver = port_solver.SpfSolver(root, backend="device", device="cpu")
    host = port_solver.SpfSolver(root, backend="host", device="cpu")
    areas = {twin.area: twin.ls}
    solver.build_route_db(root, areas, twin.ps)
    twin.set_adj(replace(twin.adj("node-1"), adjacencies=(
        replace(twin.adj("node-1").adjacencies[0], metric=9),) + twin.adj("node-1").adjacencies[1:]))
    real = port_sparse._ell_reconverge

    def boom(*args):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(port_sparse, "_ell_reconverge", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        solver.build_route_db(root, areas, twin.ps)
    assert twin.ls not in solver._resident._cache
    monkeypatch.setattr(port_sparse, "_ell_reconverge", real)
    c0 = dict(port_solver.get_spf_counters())
    got = solver.build_route_db(root, areas, twin.ps)
    assert port_solver.get_spf_counters()["decision.ell_full_compiles"] == (
        c0["decision.ell_full_compiles"] + 1
    )
    want = host.build_route_db(root, areas, twin.ps)
    assert carry.route_db_to_plain(got.to_route_db(root)) == carry.route_db_to_plain(
        want.to_route_db(root)
    )


def _solver_counters(module):
    return {k: int(v) for k, v in module.get_spf_counters().items() if k in SOLVER_KEYS}


@pytest.mark.parametrize("algo", ["sp", "ksp2"])
@pytest.mark.parametrize("kind", ["mesh", "fat_tree"])
def test_solver_churn_counters_match_reference(kind, algo, monkeypatch):
    # the sparse regime at test size, both packages' KSP2 in its chunked
    # mode over the resident bands; every event takes the patch path
    monkeypatch.setattr(jax_solver, "SPARSE_NODE_THRESHOLD", 3)
    monkeypatch.setattr(port_solver, "SPARSE_NODE_THRESHOLD", 3)
    monkeypatch.setattr(jax_ksp2, "ENGINE_MAX_NODES", 0)
    monkeypatch.setattr(port_ksp2, "ENGINE_MAX_NODES", 0)
    monkeypatch.setattr(jax_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    monkeypatch.setattr(port_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    if kind == "mesh":
        topo = jax_topologies.random_mesh(16, degree=4, seed=6, max_metric=9)
        topo.prefix_dbs.update({n: replace(pdb, prefix_entries=tuple(
            replace(e, forwarding_type=JaxFwdType.SR_MPLS) for e in pdb.prefix_entries))
            for n, pdb in topo.prefix_dbs.items()})
    else:
        topo = jax_topologies.fat_tree(2, ssw_per_plane=2, fsw_per_pod=2, rsw_per_pod=3,
                                       forwarding_type=JaxFwdType.SR_MPLS)
    if algo == "ksp2":
        topo.prefix_dbs.update({n: replace(pdb, prefix_entries=tuple(
            replace(e, forwarding_algorithm=JaxAlgo.KSP2_ED_ECMP) for e in pdb.prefix_entries))
            for n, pdb in topo.prefix_dbs.items()})
    w = Worlds({"0": topo})
    w.step()
    nodes = sorted(topo.adj_dbs)
    fsw = next((n for n in nodes if n.startswith("fsw")), nodes[3])
    j0, p0 = _solver_counters(jax_solver), _solver_counters(port_solver)
    slot = {}
    events = [
        lambda: w.set_metric("0", fsw, 0, 12),
        lambda: w.set_metric("0", fsw, 0, 2),
        lambda: slot.setdefault("adj", w.adj("0", nodes[5])),
        lambda: w.edit("0", nodes[5], adjacencies=slot["adj"].adjacencies[1:]),
        lambda: w.set_adj("0", slot["adj"]),
        lambda: w.edit("0", nodes[7], is_overloaded=True),
        lambda: w.edit("0", nodes[7], is_overloaded=False),
    ]
    for event in events:
        event()
        w.step()
        d = _delta(_solver_counters(port_solver), p0)
        assert d == _delta(_solver_counters(jax_solver), j0)
    assert d["decision.ell_full_compiles"] == 0
    assert d["decision.ell_patches"] >= 5
    assert d["decision.ell_warm_solves"] >= 5


def test_stager_copies_never_alias_the_host_arrays():
    stager = port_sparse.UploadStager(CPU)
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    b = np.array([True, False, True])
    ta, tb = stager.upload([("bands", a), ("overloaded", b)])
    a[0, 0] = 99
    assert ta.dtype == torch.int32 and tuple(ta.shape) == (3, 4) and int(ta[0, 0]) == 0
    assert tb.tolist() == [1, 0, 1]
    assert stager.bytes == {"bands": 48, "overloaded": 12}


def test_get_spf_counters_reports_the_ell_counters_under_decision():
    counters = port_solver.get_spf_counters()
    for key in SOLVER_KEYS + ("decision.sp_route_reuses", "decision.spf_host_fallback"):
        assert key in counters
    jax_keys = set(jax_solver.get_spf_counters())
    assert set(counters) <= jax_keys


def test_reset_device_state_and_set_backend():
    topo, root = _topology("grid")
    p = Pair(topo)
    solver = port_solver.SpfSolver(root, backend="device", device="cpu")
    solver._resident.state_for(p.ls)
    assert p.ls in solver._resident._cache
    c0 = dict(port_solver.SPF_COUNTERS)
    solver.set_backend("device")
    assert port_solver.SPF_COUNTERS["decision.backend_switches"] == c0["decision.backend_switches"]
    solver.set_backend("host")
    assert solver.backend == "host" and p.ls not in solver._resident._cache
    assert port_solver.SPF_COUNTERS["decision.backend_switches"] == c0["decision.backend_switches"] + 1
    assert port_solver.SPF_COUNTERS["decision.device_state_resets"] == (
        c0["decision.device_state_resets"] + 1
    )
    # "native" is a backend since the native SPF core was ported; an
    # unknown name still raises
    with pytest.raises(ValueError):
        solver.set_backend("plugin")
