"""The port's native SPF core against ``openr_tpu.graph.native_spf``.

The same random graphs (seeded edge lists with parallel links, drained
nodes, and a component the root cannot reach: distances at INF) go through
both packages: each builds its own link-state database and host snapshot
and calls its own library, built from its own copy of ``spfcore.cpp``.
All-pairs distances, first-hop matrices and traced link ids must be equal
exactly (int32, link lists in order); there is no tolerance. The batch
tracer is held against the reference's on the same int arrays (also when
the output buffer starts too small and grows), and against the Python
tracer through the engine; ``SpfSolver(backend="native")`` route
databases against the reference's native backend and the host backend.
"""

from __future__ import annotations

import copy
import random
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

from openr_tpu.decision import spf_solver as jax_solver
from openr_tpu.decision.prefix_state import PrefixState as JaxPrefixState
from openr_tpu.graph import native_spf as jax_native
from openr_tpu.graph.linkstate import LinkState as JaxLinkState
from openr_tpu.graph.snapshot import compile_snapshot as jax_compile_snapshot
from openr_tpu.models import topologies as jax_topologies
from openr_tpu_torch import carry
from openr_tpu_torch.decision import ksp2_engine as port_ksp2
from openr_tpu_torch.decision import spf_solver as port_solver
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.graph import native_spf
from openr_tpu_torch.graph.linkstate import LinkState
from openr_tpu_torch.graph.snapshot import compile_snapshot
from openr_tpu_torch.kernels import LAUNCHES
from openr_tpu_torch.models import topologies
from openr_tpu_torch.ops.minplus import INF

from test_torch_ksp2_engine import SCENARIOS, Trio, _drive

SEEDS = (1, 2, 3, 4, 5)


def _edges(seed: int, n: int = 24):
    """A connected random graph of ``n`` nodes with parallel links (a
    pair drawn twice is a LAG member), and a separate 3-node component."""
    rng = random.Random(seed)
    edges = []
    for k in range(1, n):
        edges.append((f"n{k:02d}", f"n{rng.randrange(k):02d}", rng.randint(1, 9)))
    for _ in range(n):
        a, b = rng.sample(range(n), 2)
        edges.append((f"n{a:02d}", f"n{b:02d}", rng.randint(1, 9)))
    for _ in range(3):
        edges.append(edges[rng.randrange(len(edges))])  # parallel links
    edges += [("z0", "z1", 2), ("z1", "z2", 3)]  # unreachable from n00
    return edges


def _drained(seed: int):
    rng = random.Random(seed + 100)
    return {f"n{rng.randrange(1, 24):02d}" for _ in range(2)}


def _load(pkg_topologies, ls_cls, edges, drained):
    topo = pkg_topologies.build_topology("mesh", edges)
    ls = ls_cls(area=topo.area)
    for name in sorted(topo.adj_dbs):
        db = topo.adj_dbs[name]
        if name in drained:
            db = replace(db, is_overloaded=True)
        ls.update_adjacency_database(db)
    return topo, ls


def _pair(seed):
    edges, drained = _edges(seed), _drained(seed)
    _, jax_ls = _load(jax_topologies, JaxLinkState, edges, drained)
    _, ls = _load(topologies, LinkState, edges, drained)
    return jax_ls, ls


@pytest.fixture(autouse=True)
def _no_launches():
    yield
    # the native core is host C++: no kernel launch is counted
    assert all(count == 0 for count in LAUNCHES.values()), LAUNCHES


@pytest.mark.parametrize("seed", SEEDS)
def test_all_pairs_and_first_hops_match_reference(seed):
    jax_ls, ls = _pair(seed)
    jax_snap, snap = jax_compile_snapshot(jax_ls), compile_snapshot(ls)
    assert snap.node_names == jax_snap.node_names
    d = native_spf.all_pairs_distances(snap)
    want = jax_native.all_pairs_distances(jax_snap)
    assert d.dtype == np.int32 and d.shape == (snap.n, snap.n)
    np.testing.assert_array_equal(d, want)
    # INF toward the other component, and its drained nodes transit nothing
    assert (d[snap.node_index["n00"], snap.node_index["z2"]]) == INF
    for name in snap.node_names:
        sid = snap.node_index[name]
        fh = native_spf.first_hop_matrix(snap, sid, d[sid], d)
        np.testing.assert_array_equal(
            fh, jax_native.first_hop_matrix(jax_snap, sid, want[sid], want))
        # the host Dijkstra agrees on the root's row
        spf = ls.get_spf_result(name)
        row = [spf[nm].metric if nm in spf else INF for nm in snap.node_names]
        np.testing.assert_array_equal(d[sid], row)


def _trace_inputs(seed):
    """The same candidate arrays, rows and exclusions for both cores,
    from the port's engine structures."""
    jax_ls, ls = _pair(seed)
    solver = port_solver.SpfSolver("n00", backend="device", device="cpu")
    graph = solver._resident.state_for(ls).graph
    src = "n00"
    cands_of = port_ksp2.make_cands_of(ls, graph.node_index)
    blocked = {nm for nm in graph.node_names if ls.is_node_overloaded(nm) and nm != src}
    arrays = port_ksp2._TraceArrays(graph, cands_of, blocked)
    spf = ls.get_spf_result(src)
    row = np.full(graph.n_pad, INF, np.int32)
    for nm, res in spf.items():
        row[graph.node_index[nm]] = res.metric
    dsts = [nm for nm in graph.node_names if nm != src]
    return ls, graph, cands_of, blocked, arrays, row, dsts


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_batch_matches_reference_and_python_tracer(seed):
    ls, graph, cands_of, blocked, arrays, row, dsts = _trace_inputs(seed)
    sid = graph.node_index["n00"]
    dst_ids = np.asarray([graph.node_index[d] for d in dsts], np.int32)
    first = [
        port_ksp2.trace_paths_from_row("n00", d, graph.node_index, row.tolist(), set(),
                                       cands_of, blocked)
        for d in dsts
    ]
    excls = [set()] * len(dsts)
    # first-path shape: one shared row, no exclusions
    off, ids = arrays._excl_arrays(excls)
    args = (graph.n_pad, len(arrays.links), arrays.off, arrays.link, arrays.uid,
            arrays.w, sid, arrays.blocked, dst_ids, row, True, off, ids)
    got = native_spf.trace_batch(*args)
    assert got == jax_native.trace_batch(*args)
    assert arrays.trace(sid, dst_ids, row, True, excls) == first
    assert any(len(p) > 1 for p in first)  # ECMP: more than one path somewhere
    assert any(not p for p in first)  # the other component: no path
    # second-path shape: a distinct perturbed row a destination, each
    # excluding its first paths' links
    rng = np.random.default_rng(seed)
    excls = [{l for p in paths for l in p} for paths in first]
    rows = np.tile(row, (len(dsts), 1))
    for i in range(len(dsts)):
        bump = rng.integers(0, graph.n, size=3)
        rows[i, bump] = np.minimum(rows[i, bump] + rng.integers(1, 4, size=3), INF)
    off, ids = arrays._excl_arrays(excls)
    args = (graph.n_pad, len(arrays.links), arrays.off, arrays.link, arrays.uid,
            arrays.w, sid, arrays.blocked, dst_ids, rows, False, off, ids)
    got = native_spf.trace_batch(*args)
    assert got == jax_native.trace_batch(*args)
    want = [
        port_ksp2.trace_paths_from_row("n00", d, graph.node_index, rows[i].tolist(),
                                       excls[i], cands_of, blocked)
        for i, d in enumerate(dsts)
    ]
    assert arrays.trace(sid, dst_ids, rows, False, excls) == want
    # an output buffer far too small: the core returns -1 and the
    # binding grows it fourfold until the paths fit
    assert native_spf.trace_batch(*args, cap=4) == got


def test_trace_batch_reports_a_short_buffer():
    ls, graph, cands_of, blocked, arrays, row, dsts = _trace_inputs(1)
    lib = native_spf.library()
    dst_ids = np.asarray([graph.node_index[d] for d in dsts], np.int32)
    off, ids = arrays._excl_arrays([set()] * len(dsts))
    out = np.empty(4, np.int32)
    p = native_spf._as_i32p
    wrote = lib.ksp2_trace_batch(
        graph.n_pad, len(arrays.links), p(arrays.off), p(arrays.link), p(arrays.uid),
        p(arrays.w), graph.node_index["n00"], native_spf._as_u8p(arrays.blocked),
        len(dsts), p(dst_ids), p(row), 1, p(off), p(ids), p(out), 4)
    assert wrote == -1


def test_exclusions_key_links_by_value():
    """A link that flapped down and up is a new but equal object: its
    exclusion must still hold (the arrays key links by value)."""
    ls, graph, cands_of, blocked, arrays, row, dsts = _trace_inputs(2)
    link = arrays.links[0]
    twin = copy.copy(link)
    assert twin is not link and twin == link
    off, ids = arrays._excl_arrays([{twin}])
    assert ids.tolist() == [0]


class _TracerTrio(Trio):
    """The KSP2 engine trio, with a fourth solver: the port's engine on
    the Python tracer, on its own databases."""

    def __init__(self, topos, extra, root):
        super().__init__(topos, extra, root)
        self.py = self._world(topos, extra, False)
        self.py_solver = port_solver.SpfSolver(root, backend="device", device="cpu")
        self._last_arrays = None
        self.in_place = 0

    def set_adj(self, jax_db) -> None:
        super().set_adj(jax_db)
        self._set_adj(self.py, jax_db, False)

    def set_prefixes(self, jax_db) -> None:
        super().set_prefixes(jax_db)
        self._set_prefixes(self.py, jax_db, False)

    def step(self, event) -> None:
        super().step(event)
        tracer = port_ksp2.TRACER
        port_ksp2.TRACER = "python"
        try:
            py_db = self.py_solver.build_route_db(self.root, *self.py)
        finally:
            port_ksp2.TRACER = tracer
        got = self.port_solver.build_route_db(self.root, *self.port)
        assert carry.route_db_to_plain(py_db.to_route_db(self.root)) == \
            carry.route_db_to_plain(got.to_route_db(self.root)), event
        (native,) = self.port_solver._ksp2_engines.values()
        (python,) = self.py_solver._ksp2_engines.values()
        (jax_engine,) = self.jax_solver._ksp2_engines.values()
        assert native.tracer == "native" and python.tracer == "python"
        for attr in ("first_paths", "second_paths"):
            keys = carry.paths_to_keys(getattr(native, attr))
            assert keys == carry.paths_to_keys(getattr(python, attr)), (event, attr)
            assert keys == carry.paths_to_keys(getattr(jax_engine, attr)), (event, attr)
        self._check_arrays(native, event)

    def _check_arrays(self, engine, event) -> None:
        """The engine's kept trace arrays, where this event brought them
        to its version, equal a whole build from the LinkState: the same
        CSR, weights, origin ids and blocked bitmap, and the same Link
        objects (routes read attributes off them). Counts the events whose
        arrays were updated in place."""
        (ls,) = self.port[0].values()
        if engine._tarrays is None:
            return
        key, arrays = engine._tarrays
        if key != (ls.topology_version, ls.attributes_version):
            return
        graph = engine.state.graph
        fresh = port_ksp2._TraceArrays(
            graph, port_ksp2.make_cands_of(ls, graph.node_index),
            port_ksp2._transit_blocked(ls, graph, engine.src_name))
        for name in ("off", "uid", "w", "blocked"):
            assert getattr(arrays, name).tolist() == getattr(fresh, name).tolist(), (event, name)
        got = [arrays.links[i] for i in arrays.link.tolist()]
        want = [fresh.links[i] for i in fresh.link.tolist()]
        assert len(got) == len(want) and all(a is b for a, b in zip(got, want)), event
        if arrays is self._last_arrays:
            self.in_place += 1
        self._last_arrays = arrays


@pytest.mark.parametrize("scenario", ["metric_cycle", "link_down_up", "transit_overload", "lag",
                                      "random_grid", "advertiser_drain", "undrain_reconnect",
                                      "label_change", "band_widening"])
def test_engine_paths_equal_under_both_tracers_and_the_reference(scenario, monkeypatch):
    monkeypatch.setattr(jax_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    monkeypatch.setattr(port_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    monkeypatch.setenv("OPENR_KSP2_FAST", "1")
    topos, extra, root, events = SCENARIOS[scenario]()
    trio = _TracerTrio(topos, extra, root)
    _drive(trio, events(trio))
    (native,) = trio.port_solver._ksp2_engines.values()
    # the cold build traced through the arrays, and booked their cost;
    # later events updated the same arrays in place
    assert native._tarrays is not None
    assert trio.port_solver.ksp2_stats.get("trace_arrays_ms", 0.0) >= 0.0
    assert trio.in_place > 0


def test_an_event_with_nothing_to_trace_builds_no_arrays(monkeypatch):
    monkeypatch.setattr(port_solver, "KSP2_DEVICE_MIN_DSTS", 1)
    monkeypatch.setenv("OPENR_KSP2_FAST", "1")
    topos, extra, root, _ = SCENARIOS["metric_cycle"]()
    trio = Trio(topos, extra, root)
    trio.step("initial build")
    (engine,) = trio.port_solver._ksp2_engines.values()
    assert engine._tarrays is not None
    built = engine._tarrays
    # a prefix-only change: no topology version moves, nothing to trace
    trio.step("no-op rebuild")
    assert engine._tarrays is built
    assert "trace_arrays_ms" not in trio.port_solver.ksp2_stats


def test_unknown_tracer_is_refused(monkeypatch):
    monkeypatch.setattr(port_ksp2, "TRACER", "fast")
    with pytest.raises(ValueError, match="unknown KSP2 tracer"):
        port_ksp2.Ksp2Engine("a", port_solver._EllResidentCache("cpu"))


# -- the native backend of SpfSolver -----------------------------------------


def _world(pkg_topologies, ls_cls, ps_cls, topo_fn):
    topo = topo_fn(pkg_topologies)
    ls = ls_cls(area=topo.area)
    for name in sorted(topo.adj_dbs):
        ls.update_adjacency_database(topo.adj_dbs[name])
    ps = ps_cls()
    for name in sorted(topo.prefix_dbs):
        ps.update_prefix_database(topo.prefix_dbs[name])
    return topo, {topo.area: ls}, ps


TOPOLOGIES = {
    "mesh": lambda t: t.random_mesh(18, degree=4, seed=3, max_metric=9),
    "grid": lambda t: t.grid(4),
    "fabric": lambda t: t.fat_tree_nodes(60),
    "lag": lambda t: t.build_topology(
        "lag", [("a", "b", 1), ("a", "b", 1), ("b", "c", 2), ("a", "c", 5), ("c", "d", 1)]),
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
@pytest.mark.parametrize("lfa", [False, True], ids=["sp", "lfa"])
def test_native_backend_route_db_matches_reference(name, lfa):
    jax_topo, jax_areas, jax_ps = _world(jax_topologies, JaxLinkState, JaxPrefixState,
                                         TOPOLOGIES[name])
    topo, areas, ps = _world(topologies, LinkState, PrefixState, TOPOLOGIES[name])
    root = sorted(topo.adj_dbs)[0]
    got = port_solver.SpfSolver(root, backend="native", compute_lfa_paths=lfa,
                                device="cpu").build_route_db(root, areas, ps)
    want = jax_solver.SpfSolver(root, backend="native", compute_lfa_paths=lfa).build_route_db(
        root, jax_areas, jax_ps)
    host = port_solver.SpfSolver(root, backend="host", compute_lfa_paths=lfa,
                                 device="cpu").build_route_db(root, areas, ps)
    plain = carry.route_db_to_plain(got.to_route_db(root))
    assert plain == carry.route_db_to_plain(want.to_route_db(root))
    assert plain == carry.route_db_to_plain(host.to_route_db(root))
    assert len(got.unicast_routes) == len(topo.adj_dbs) - 1


def test_native_backend_never_touches_a_device(monkeypatch):
    topo, areas, ps = _world(topologies, LinkState, PrefixState, TOPOLOGIES["grid"])
    solver = port_solver.SpfSolver("node-0", backend="native", device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the native view uploaded to a device")

    monkeypatch.setattr(solver._snapshots.stager, "upload", refuse)
    solver.build_route_db("node-0", areas, ps)
    snap = solver._snapshots.get(areas[topo.area])
    assert snap._dev is None


def test_set_backend_accepts_native_and_refuses_others():
    solver = port_solver.SpfSolver("a", device="cpu")
    solver.set_backend("native")
    assert solver.backend == "native"
    with pytest.raises(ValueError, match="unknown SPF backend"):
        solver.set_backend("plugin")
    with pytest.raises(ValueError, match="unknown SPF backend"):
        port_solver.SpfSolver("a", backend="tpu", device="cpu")


# -- building ------------------------------------------------------------------


def test_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    """A compiler that fails (here: a source that does not compile) is an
    error on every path: the view raises, nothing degrades to host."""
    bad = tmp_path / "spfcore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_spf, "SRC", bad)
    monkeypatch.setattr(native_spf, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_spf, "_lib", None)
    with pytest.raises(native_spf.NativeBuildError, match="build failed"):
        native_spf.library()
    topo, areas, ps = _world(topologies, LinkState, PrefixState, TOPOLOGIES["grid"])
    solver = port_solver.SpfSolver("node-0", backend="native", device="cpu")
    with pytest.raises(native_spf.NativeBuildError):
        solver.build_route_db("node-0", areas, ps)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_spf, "CXX", "no-such-compiler-g++")
    monkeypatch.setattr(native_spf, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_spf, "_lib", None)
    with pytest.raises(native_spf.NativeBuildError, match="not found"):
        native_spf.library()


def test_concurrent_builds_each_load_a_whole_library(tmp_path):
    """Processes that race to build the library on a clean tree (test
    workers) each get a library that loads: the build writes a temporary
    file and renames it into place under a file lock."""
    code = (
        "import sys; from pathlib import Path\n"
        "from openr_tpu_torch.graph import native_spf as n\n"
        f"n.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "n.library(); print(n.BUILD_INFO['compiled'])\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    compiled = [o.strip() == "True" for o, _ in outs]
    assert compiled.count(True) == 1, outs  # one built, three found it current
    assert sorted(x.name for x in tmp_path.iterdir()) == [
        "libspfcore.so", "libspfcore.so.lock", "libspfcore.so.sha256"]


def test_a_changed_source_rebuilds(tmp_path, monkeypatch):
    src = tmp_path / "spfcore.cpp"
    src.write_bytes(native_spf.SRC.read_bytes())
    monkeypatch.setattr(native_spf, "SRC", src)
    monkeypatch.setattr(native_spf, "BUILD_DIR", tmp_path / "build")
    native_spf.build()
    assert native_spf.BUILD_INFO["compiled"]
    native_spf.build()
    assert not native_spf.BUILD_INFO["compiled"]
    src.write_bytes(src.read_bytes() + b"\n// touched\n")
    native_spf.build()
    assert native_spf.BUILD_INFO["compiled"]
